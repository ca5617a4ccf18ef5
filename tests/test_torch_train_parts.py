"""Port parity: the parts of the training path, each against its JAX
counterpart on the same numpy inputs.

- dataset: byte-equal batches (numpy makes both);
- schedule: optax's values at counts 0..12 (1e-6 relative: optax computes
  in f32, the port in Python floats);
- clipped AdamW: optax's parameters after three updates, the clip active
  and inactive (1e-6: the same f32 arithmetic in another order);
- chunked cross-entropy: value and gradients, f32 (1e-5: the chunk sums
  and the log-softmax round in another order);
- config, mesh, flops and the strategy checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.data import datasets as jdata
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.train import losses as jlosses
from pytorch_distributed_nn_tpu.train import optim as joptim
from pytorch_distributed_nn_tpu.utils import flops as jflops
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.data import datasets as tdata
from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
    MeshSpec,
    batch_slice,
    data_parallel,
)
from pytorch_distributed_nn_tpu_torch.train import losses as tlosses
from pytorch_distributed_nn_tpu_torch.train import optim as toptim
from pytorch_distributed_nn_tpu_torch.utils import flops as tflops
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
    llama_params_to_jax,
)


def test_synthetic_lm_batches_are_byte_equal():
    kw = dict(seed=3, batch_size=2, seq_len=40, vocab_size=517)
    j = jdata.get_dataset("lm_synthetic", **kw)
    t = tdata.get_dataset("lm_synthetic", **kw)
    assert tdata.EVAL_STEP_OFFSET == jdata.EVAL_STEP_OFFSET
    for step in (0, 1, 2, tdata.EVAL_STEP_OFFSET):
        for a, b in zip(t.batch(step), j.batch(step)):
            assert a.dtype == b.dtype == np.int32
            assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="needs data.path"):
        tdata.get_dataset("token_file", seed=0, batch_size=1)


def test_loader_prefetches_the_batches_of_batch_at():
    ds = tdata.get_dataset("lm_synthetic", seed=1, batch_size=2, seq_len=8,
                           vocab_size=50)
    loader = DataLoader(ds, torch.device("cpu"), start_step=5, prefetch=2)
    it = iter(loader)
    for step in (5, 6, 7):
        got = next(it)
        for a, b in zip(got, loader.batch_at(step)):
            assert torch.equal(a, b)
    it.close()
    assert loader._thread is None  # joined


SCHEDULES = [dict(schedule="constant", lr=0.3),
             dict(schedule="cosine", lr=1e-4, warmup_steps=2),
             dict(schedule="cosine", lr=0.5),
             dict(schedule="linear", lr=0.2, warmup_steps=3),
             dict(schedule="linear", lr=0.2)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_matches_optax(kw):
    total = 10
    want = joptim.make_schedule(jconfig.OptimConfig(**kw), total)
    got = toptim.make_schedule(tconfig.OptimConfig(**kw), total)
    for count in range(13):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(np.float32),
            "scale": rng.randn(5).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])  # clip on, clip off
def test_clipped_adamw_matches_optax(grad_scale):
    kw = dict(name="adamw", lr=0.05, weight_decay=0.1, grad_clip_norm=1.0,
              warmup_steps=1, schedule="cosine")
    total = 4
    params = _tree(0)
    tx = joptim.make_optimizer(jconfig.OptimConfig(**kw), total)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = toptim.make_optimizer(tconfig.OptimConfig(**kw), tp.values(),
                                total)
    for i in range(3):
        grads = {k: v * grad_scale for k, v in _tree(10 + i).items()}
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
        assert (norm > 1.0) == (grad_scale > 1)
        upd, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        opt.zero_grad()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    assert opt.count == 3
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer(tconfig.OptimConfig(name="rmsprop"),
                              tp.values())


def _xent_inputs(T=64):
    rng = np.random.RandomState(5)
    h = rng.randn(2, T, 16).astype(np.float32)
    kern = (rng.randn(16, 37) * 0.3).astype(np.float32)
    y = rng.randint(0, 37, size=(2, T)).astype(np.int32)
    return h, kern, y


@pytest.mark.parametrize("T,chunk", [(64, 16), (60, 16)])  # 60: dense
def test_chunked_xent_value_and_grads_match_jax(T, chunk):
    h, kern, y = _xent_inputs(T)
    (loss_j, (dh_j, dk_j)) = jax.value_and_grad(
        lambda a, b: jlosses.chunked_lm_xent(a, b, jnp.asarray(y),
                                             chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(kern))
    th = torch.from_numpy(h.copy()).requires_grad_()
    tk = torch.from_numpy(kern.copy()).requires_grad_()
    loss = tlosses.chunked_lm_xent(th, tk, torch.from_numpy(y), chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_j),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(dk_j),
                               rtol=1e-5, atol=1e-7)
    dense = tlosses.lm_xent(torch.from_numpy(h @ kern), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-5)


@pytest.mark.parametrize("T,chunk", [(64, 16), (60, 16)])
def test_chunked_eval_matches_jax(T, chunk):
    h, kern, y = _xent_inputs(T)
    loss_j, acc_j = jlosses.chunked_lm_eval(jnp.asarray(h),
                                            jnp.asarray(kern),
                                            jnp.asarray(y), chunk=chunk)
    loss, acc = tlosses.chunked_lm_eval(torch.from_numpy(h),
                                        torch.from_numpy(kern),
                                        torch.from_numpy(y), chunk=chunk)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert acc.item() == pytest.approx(float(acc_j), abs=1e-7)
    assert tlosses.get_loss_fn("lm_synthetic") is tlosses.lm_xent
    assert tlosses.get_loss_fn("mnist") is tlosses.softmax_xent
    assert tlosses.get_loss_fn("mlm_synthetic") is tlosses.masked_lm_xent
    assert tlosses.get_loss_fn("token_file") is tlosses.lm_xent
    with pytest.raises(KeyError, match="unknown dataset"):
        tlosses.get_loss_fn("token_files")


def test_longcontext_preset_matches_jax():
    got = tconfig.get_config("llama3_longcontext")
    want = jconfig.get_config("llama3_longcontext")
    for section in ("optim", "data", "parallel", "mesh"):
        g = vars(getattr(got, section))
        w = vars(getattr(want, section))
        assert g == {k: w[k] for k in g}, section
    assert vars(got.model) == vars(want.model)
    for name in ("preset", "seed", "steps", "log_every", "eval_every",
                 "eval_batches", "xent_chunk"):
        assert getattr(got, name) == getattr(want, name), name
    # the serve entry still reads the 8B preset's model part
    assert tconfig.get_config("llama3_8b_zero").model.name == "llama3_8b"


@pytest.mark.parametrize("field", ["profile_dir", "metrics_path",
                                   "prom_path"])
def test_unported_fields_fail_as_unknown(field):
    with pytest.raises(AttributeError, match="unknown config field"):
        tconfig.get_config("llama3_longcontext", **{field: "1"})


def test_mesh_resolves_as_jax_and_refuses_more_than_one_device():
    for kw, n in ((dict(), 8), (dict(data=2, fsdp=-1), 8),
                  (dict(seq=2, data=-1), 4)):
        assert (MeshSpec(**kw).resolve(n).sizes()
                == dict(zip(("pipe", "data", "fsdp", "expert", "seq",
                             "tensor"), JMeshSpec(**kw).resolve(n).shape)))
    # the port resolves the data-parallel, seq, pipe and tensor degrees
    # against the process group's world size (every pipe stage in one
    # process where the world does not divide by the fixed axes, pipe
    # among them); seq inside a tensor-parallel layer raises
    assert data_parallel(MeshSpec(seq=1, data=-1), 1).world_size() == 1
    four = data_parallel(MeshSpec(data=2, fsdp=-1), 4)
    assert four.data_degree() == 4 and four.sizes()["fsdp"] == 2
    assert data_parallel(MeshSpec(seq=2, data=-1), 4).data_degree() == 2
    assert data_parallel(MeshSpec(pipe=2, data=-1), 4).data_degree() == 2
    assert data_parallel(MeshSpec(pipe=4, data=-1), 1).sizes()["pipe"] == 4
    assert data_parallel(MeshSpec(tensor=2, data=-1), 4).data_degree() == 2
    local = data_parallel(MeshSpec(pipe=2, tensor=2, data=-1), 2)
    assert (local.pipe, local.tensor, local.data) == (2, 2, 1)
    st = data_parallel(MeshSpec(seq=2, tensor=2, data=-1), 4)
    assert (st.seq, st.tensor, st.data) == (2, 2, 1)
    assert [batch_slice(12, r, 3) for r in range(3)] == [
        slice(0, 4), slice(4, 8), slice(8, 12)]
    with pytest.raises(ValueError, match="divisible"):
        batch_slice(10, 0, 3)


@pytest.mark.parametrize("override,err,match", [
    ({"parallel.strategy": "ps"}, NotImplementedError,
     "remaining sharded strat"),
    # zero runs under seq > 1 now; what the port still refuses there is
    # an attention that is not sequence-parallel (the JAX package warns)
    ({"parallel.strategy": "zero", "mesh.seq": "2"}, ValueError,
     "needs model.extra.attn_impl 'ring' or 'ulysses'"),
    ({"parallel.strategy": "bogus"}, ValueError, "unknown strategy"),
    ({"parallel.grad_accum": "2"}, ValueError, "not divisible"),
    ({"parallel.grad_accum": "0"}, ValueError, "accum"),
    ({"data.seq_len": "3000"}, ValueError, "not divisible"),
])
def test_make_train_step_refuses_what_is_not_ported(override, err, match):
    cfg = tconfig.get_config("llama3_longcontext", **override)
    with pytest.raises(err, match=match):
        make_train_step(cfg, tlosses.lm_xent)


@pytest.mark.parametrize("override", [
    {"parallel.strategy": "zero", "parallel.zero_stage": "1"},
    {"parallel.strategy": "zero", "parallel.zero_stage": "3"},
    {"parallel.strategy": "zero", "parallel.zero_stage": "3",
     "mesh.seq": "2", "model.extra": '{"attn_impl": "ring"}'},
    {"parallel.strategy": "pipeline", "mesh.pipe": "2", "xent_chunk": "0"},
])
def test_make_train_step_builds_zero_and_pipeline(override):
    cfg = tconfig.get_config("llama3_longcontext", **override)
    step, place = make_train_step(cfg, tlosses.lm_xent)
    assert callable(step) and callable(place)


def test_chunked_loss_only_where_seq_exceeds_a_chunk():
    from pytorch_distributed_nn_tpu_torch.parallel import api

    seen = []
    orig = api.make_chunked_loss
    api.make_chunked_loss = lambda c: seen.append(c) or orig(c)
    try:
        make_train_step(tconfig.get_config("llama3_longcontext"),
                        tlosses.lm_xent)
        make_train_step(tconfig.get_config(
            "llama3_longcontext", **{"data.seq_len": "1024"}),
            tlosses.lm_xent)
    finally:
        api.make_chunked_loss = orig
    assert seen == [2048]


def test_remat_offload_raises():
    # offload without remat has no saved boundaries to move: it raises,
    # as the JAX model does, instead of running a job that may not fit
    from pytorch_distributed_nn_tpu_torch.models import get_model

    cfg = tconfig.get_config("llama3_longcontext",
                             **{"model.remat_offload": "true",
                                "model.remat": "false"})
    with pytest.raises(ValueError, match="needs model.remat=True"):
        get_model(cfg.model, device="meta")


def test_interop_round_trip():
    tree = {"layer0": {"attn": {"query": {"kernel": np.ones((4, 2, 2),
                                                            np.float32)}}},
            "final_norm": {"scale": np.arange(3, dtype=np.float32)}}
    back = llama_params_to_jax(llama_params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_flops_closed_form_matches_jax_and_halves_causal_attention():
    args = (146_000_000, 8, 32768, 1024)
    assert tflops.lm_train_flops_per_token(*args) == \
        jflops.lm_train_flops_per_token(*args)
    full = tflops.lm_train_flops_per_token(*args)
    causal = tflops.lm_train_flops_per_token(*args, causal=True)
    assert full - causal == 6.0 * 8 * 32768 * 1024

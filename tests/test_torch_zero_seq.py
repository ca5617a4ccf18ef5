"""Port parity of ZeRO under sequence parallelism and of sequence x tensor
parallelism (``parallel/zero.py`` with ``mesh.seq > 1``), on 4 gloo ranks
(one ``torchrun`` gang for every case), against the JAX package.

The model is ``llama3_longcontext``'s Llama at tiny dims where ZeRO's
leaves split (2 layers, d 64, 4/2 heads, MLP 256, vocab 512: the token
table, the head and the MLP kernels), T 256, ``xent_chunk`` 64 (the
chunked loss reads ``lm_head.kernel`` itself, held gathered under
ZeRO-3), f32, adamw at the preset's lr with warmup 1, 3 steps, from the
port's seeded init, carried into the JAX Trainer by ``utils.interop``.

- ZeRO stages 1 and 3 on fsdp 2 x seq 2 with ring attention (its
  ``pallas`` path, the block kernel's and the flash backward's plain
  versions on the CPU) and with Ulysses; ZeRO-3 on fsdp 2 x seq 2 with
  ``grad_accum`` 2; ``dp`` on seq 2 x tensor 2 with ring attention at
  2/1 heads a rank; batch 4. Every case against the JAX ``Trainer`` on a
  4-device CPU mesh (zero-3 on fsdp 2 x seq 2, one batch a step:
  accumulation's mean of microbatch means is the batch mean) from the
  same weights: losses to 1e-5 relative, the parameters after the steps
  to 1e-4 of each leaf's largest |value|.
- Each rank's slices equal the JAX per-device shards: ZeRO-3's against
  the JAX run's own shards on its device (rank r is device r of the
  mesh), seq x tensor's against the TP rule's shards of the JAX
  parameters on a seq 2 x tensor 2 mesh.
- The first batch's reduced gradients (ZeRO-3 with the ring, and seq x
  tensor) equal, rank slice by rank slice, the JAX gradient of the mean
  loss over the whole batch from the same weights, to 1e-5 of each leaf's
  largest |value|: a mean over the wrong count of ranks shows here, where
  adamw's first steps hide the gradient's scale.
- The seq ranks hold the same slices, and only the first writes a
  checkpoint piece.
"""

import contextlib
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.parallel.sharding_rules import (
    path_str,
    spec_for,
)
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.losses import lm_xent
from pytorch_distributed_nn_tpu.train import trainer as jtrainer
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    gather_shards,
    llama_params_from_jax,
    llama_params_to_jax,
)
from test_torch_pipeline import _Gang

STEPS = 3
EXTRA = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "mlp_dim": 256, "vocab_size": 512}
# name -> (strategy, zero_stage, fsdp, tensor, attn_impl, grad_accum)
RUNS = {
    "zero1_ring": ("zero", 1, 2, 1, "ring", 1),
    "zero3_ring": ("zero", 3, 2, 1, "ring", 1),
    "zero1_ulysses": ("zero", 1, 2, 1, "ulysses", 1),
    "zero3_ulysses": ("zero", 3, 2, 1, "ulysses", 1),
    "zero3_accum2": ("zero", 3, 2, 1, "ring", 2),
    "seq2_tensor2": ("dp", 0, 1, 2, "ring", 1),
}
# the runs whose first reduced gradients are held against the JAX gradient
GRAD_RUNS = ("zero3_ring", "seq2_tensor2")


def _overrides(strategy="zero", stage=3, fsdp=2, tensor=1, impl="ring",
               accum=1):
    return {"steps": str(STEPS), "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "4", "data.seq_len": "256",
            "data.vocab_size": "512", "xent_chunk": "64",
            "model.compute_dtype": "float32",
            "model.extra": json.dumps({**EXTRA, "attn_impl": impl}),
            "optim.warmup_steps": "1", "parallel.strategy": strategy,
            "parallel.zero_stage": str(stage),
            "parallel.grad_accum": str(accum), "mesh.fsdp": str(fsdp),
            "mesh.seq": "2", "mesh.tensor": str(tensor), "mesh.data": "1"}


_WORKER = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel import sequence as sq
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out_dir, runs = sys.argv[1], json.loads(sys.argv[2])
bootstrap.initialize("cpu")
ring = sq.ring_attention


def pallas_ring(q, k, v, *, seq, causal=True, impl="auto"):
    # the kernel path, on the CPU through its plain versions
    return ring(q, k, v, seq=seq, causal=causal, impl="pallas")


sq.ring_attention = pallas_ring
res = {}
for name, run in runs.items():
    params = {k: torch.from_numpy(v) for k, v in np.load(run["init"]).items()}
    ov = dict(run["ov"], checkpoint_dir=f"{out_dir}/ckpt_{name}",
              checkpoint_every=str(100))
    with Trainer(get_config("llama3_longcontext", **ov), device="cpu",
                 params=params) as t:
        grads, zs, apply = {}, t.state.sharding, t.state.apply_gradients

        def first_grads(grads=grads, zs=zs, apply=apply):
            if not grads:  # the first batch's gradients, reduced
                for k, p in zs.named.items():
                    g = zs.shards.get(k, p).grad
                    grads[k] = g.detach().clone().numpy()
            apply()

        if run["grads"]:
            t.state.apply_gradients = first_grads
        with cc.recording() as records:
            t.train()
        t.save_checkpoint()
        t.ckpt.wait()
        res[f"{name}/writes"] = np.array(int(t.state.sharding.writes))
    res[f"{name}/losses"] = np.array(t.losses())
    res[f"{name}/shifts"] = np.array(sum(r.op == "shift" for r in records))
    for k, v in t.state.state_dict().items():
        if k.startswith("model."):
            res[f"{name}/param/{k[6:]}"] = v.detach().numpy()
    for k, g in grads.items():
        res[f"{name}/grad/{k}"] = g
np.savez(f"{out_dir}/rank{cc.rank()}.npz", **res)
bootstrap.shutdown()
"""


@contextlib.contextmanager
def compiled_init():
    """Inside the block the JAX ``Trainer`` runs its model's init as one
    compiled function instead of op by op (~7 s less a Trainer here). The
    tests replace the initial values with the port's, so only the state's
    structure and layout are used. Yields the ``Trainer`` class."""
    get_model = jtrainer.get_model

    def compiled(model_cfg):
        model = get_model(model_cfg)
        object.__setattr__(model, "init", jax.jit(
            model.init, static_argnames=("train",)))
        return model

    jtrainer.get_model = compiled
    try:
        yield jtrainer.Trainer
    finally:
        jtrainer.get_model = get_model


def _port_init():
    """The port's seeded initial weights (flax names)."""
    cfg = get_config("llama3_longcontext", **_overrides())
    model = get_model(cfg.model, device="cpu")
    model.init_params(seed=cfg.seed)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _jax_run(init):
    """The JAX zero-3 on fsdp 2 x seq 2 (4 CPU devices) from ``init``:
    (losses, final params, each leaf's shard on each device, each leaf's
    index on each device, the gradient of the first batch's mean loss at
    ``init`` on one device). Its
    attention is the plain one, the sequence all-gathered by XLA (the JAX
    package warns and allows it; the ring computes the same attention,
    and builds in 20 s here where this takes 9)."""
    ov = dict(_overrides(), **{"model.extra": json.dumps(EXTRA)})
    cfg = jconfig.get_config("llama3_longcontext", **ov)
    mesh = make_mesh(cfg.mesh.resolve(4), devices=jax.devices()[:4])
    with compiled_init() as jax_trainer:
        trainer = jax_trainer(cfg, mesh=mesh)
    x, y = trainer.dataset.batch(0)
    model = trainer.model
    grads = jax.jit(jax.grad(lambda p: lm_xent(
        model.apply({"params": p}, x), y)))(llama_params_to_jax(init))
    grads = {path_str(kp): np.asarray(g) for kp, g in
             jax.tree_util.tree_flatten_with_path(grads)[0]}
    trainer.state = trainer.state.replace(params=jax.tree.map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        llama_params_to_jax(init), trainer.state.params))
    trainer.train()
    losses = np.array(trainer.losses())
    final = jax.device_get(trainer.state.params)
    order = list(mesh.devices.reshape(-1))
    shards, index = {}, {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            trainer.state.params)[0]:
        shards[path_str(kp)] = [None] * len(order)
        for s in leaf.addressable_shards:
            shards[path_str(kp)][order.index(s.device)] = np.asarray(s.data)
        where = leaf.sharding.devices_indices_map(leaf.shape)
        index[path_str(kp)] = [where[d] for d in order]
    trainer.close()
    return losses, final, shards, index, grads


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every case on one 4-rank gang from the JAX initial weights; the
    gang runs while the JAX runs train."""
    d = tmp_path_factory.mktemp("zero_seq_gang")
    init = _port_init()
    path = str(d / "init.npz")
    np.savez(path, **{k: v.numpy() for k, v in init.items()})
    runs = {name: {"ov": _overrides(*spec), "init": path,
                   "grads": name in GRAD_RUNS}
            for name, spec in RUNS.items()}
    script = d / "worker.py"
    script.write_text(_WORKER)
    return _Gang(script, d, runs), d, init


@pytest.fixture(scope="module")
def jax_run(started):
    return _jax_run(started[2])


@pytest.fixture(scope="module")
def gang(started, jax_run):
    handle, d, init = started
    return handle.ranks(), d, init


def _flat(tree):
    return {k: v.numpy() for k, v in llama_params_from_jax(tree).items()}


def _slices(rank, name):
    pre = f"{name}/param/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in rank.items()
            if k.startswith(pre)}


def _whole(ranks, name, shapes):
    """The parameters after the run: zero-3's slices gathered over the
    fsdp ranks at seq 0 (ranks 0 and 2), seq x tensor's tensor slices
    over the tensor ranks at seq 0 (ranks 0 and 1), else rank 0's."""
    strategy, stage, fsdp, tensor, _, _ = RUNS[name]
    if stage == 3:
        return {k: v.numpy() for k, v in gather_shards(
            [_slices(ranks[r], name) for r in (0, 2)], shapes).items()}
    if tensor > 1:
        a, b = _slices(ranks[0], name), _slices(ranks[1], name)
        out = {}
        for k, v in a.items():
            if tuple(v.shape) == shapes[k]:
                out[k] = v.numpy()
            else:
                dim = next(i for i, (x, y) in enumerate(zip(v.shape,
                                                            shapes[k]))
                           if x != y)
                out[k] = torch.cat([v, b[k]], dim).numpy()
        return out
    return {k: v.numpy() for k, v in _slices(ranks[0], name).items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_zero_and_tensor_under_seq_match_the_jax_trainer(gang, jax_run,
                                                         name):
    ranks, _, init = gang
    j_losses, j_final = jax_run[:2]
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/losses"], j_losses, rtol=1e-5)
    want = _flat(j_final)
    got = _whole(ranks, name, {k: v.shape for k, v in want.items()})
    assert sorted(got) == sorted(want)
    moved = 0.0
    start = {k: v.numpy() for k, v in init.items()}
    for k, b in want.items():
        np.testing.assert_allclose(got[k], b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)
        moved = max(moved, float(np.abs(b - start[k]).max()))
    assert moved > 1e-5
    # the ring's shifts (or Ulysses' all-to-alls) ran on every rank
    if RUNS[name][4] == "ring":
        assert all(int(r[f"{name}/shifts"]) > 0 for r in ranks)


@pytest.mark.parametrize("name", ["zero3_ring", "zero3_accum2"])
def test_zero3_slices_are_the_jax_device_shards(gang, jax_run, name):
    """Rank r holds what device r of the JAX fsdp 2 x seq 2 mesh holds,
    and the two seq ranks of an fsdp coordinate hold the same slices."""
    ranks, _, _ = gang
    shards = jax_run[2]
    split = 0
    for r, rank in enumerate(ranks):
        for k, t in _slices(rank, name).items():
            want = shards[k.replace(".", "/")][r]
            assert tuple(t.shape) == want.shape, k
            np.testing.assert_allclose(
                t.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max()
                + 1e-30, err_msg=k)
            split += tuple(t.shape) != tuple(
                _slices(ranks[0], "zero1_ring")[k].shape)
            np.testing.assert_array_equal(
                t.numpy(), rank_pair(ranks, r, name)[k])
    assert split >= 3 * len(ranks)


def rank_pair(ranks, r, name):
    """The slices of rank r's seq partner (the rank that differs from it
    only in its seq coordinate, the last axis of size 2 here)."""
    return {k: v.numpy() for k, v in _slices(ranks[r ^ 1], name).items()}


def _tp_index(path, shape):
    """Each rank's index into a whole leaf under the TP rule on a JAX seq 2
    x tensor 2 mesh (rank r is device r)."""
    mesh = make_mesh(JMeshSpec(data=1, seq=2, tensor=2).resolve(4),
                     devices=jax.devices()[:4])
    where = NamedSharding(mesh, spec_for(path, shape, tensor=2)
                          ).devices_indices_map(shape)
    return [where[d] for d in mesh.devices.reshape(-1)]


def test_seq_tensor_slices_are_the_tp_device_shards(gang, jax_run):
    """seq 2 x tensor 2: rank r holds the TP rule's shard on device r of a
    JAX seq 2 x tensor 2 mesh of the parameters after the steps."""
    ranks, _, _ = gang
    whole = _flat(jax_run[1])
    split = set()
    for k, v in whole.items():
        index = _tp_index(k.replace(".", "/"), v.shape)
        for r, rank in enumerate(ranks):
            got = rank[f"seq2_tensor2/param/{k}"]
            want = v[index[r]]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * np.abs(v).max(),
                                       err_msg=k)
            if got.shape != v.shape:
                split.add(k)
    assert {"layer0.attn.query.kernel", "layer0.attn.out.kernel",
            "lm_head.kernel"} <= split


@pytest.mark.parametrize("name", GRAD_RUNS)
def test_first_reduced_gradients_are_the_jax_gradient(gang, jax_run, name):
    """The first batch's gradients as each rank hands them to the
    optimizer (a ZeRO-3 rank's fsdp slice of the mean over data x fsdp x
    seq; a seq x tensor rank's tensor slice) against the JAX gradient of
    the batch's mean loss at the same weights, cut the same way."""
    ranks, _, _ = gang
    _, _, _, zero_index, grads = jax_run
    split = 0
    for path, g in grads.items():
        k = path.replace("/", ".")
        index = (zero_index[path] if RUNS[name][1] == 3
                 else _tp_index(path, g.shape))
        for r, rank in enumerate(ranks):
            got, want = rank[f"{name}/grad/{k}"], g[index[r]]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=f"rank {r}: {k}")
            split += got.shape != g.shape
    assert split >= 3 * len(ranks)
    assert sorted(k for k in ranks[0] if k.startswith(f"{name}/grad/")) == \
        sorted(f"{name}/grad/" + p.replace("/", ".") for p in grads)


def test_only_the_first_seq_rank_writes_a_piece(gang):
    ranks, d, _ = gang
    for name in ("zero3_ring", "zero1_ulysses"):
        writes = [int(r[f"{name}/writes"]) for r in ranks]
        assert writes == [1, 0, 1, 0]  # rank = 2 * fsdp + seq
        meta = json.loads(next((d / f"ckpt_{name}").glob("*/meta.json"))
                          .read_text())
        assert meta["layout"]["mesh"]["seq"] == 2
        assert meta["parts"] == ["fsdp0", "fsdp1"]

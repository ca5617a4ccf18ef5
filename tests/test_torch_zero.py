"""Port parity of ZeRO (``parallel/zero.py``, stages 1 and 3): config 5's
strategy at tiny dims, on 4 gloo ranks (one ``torchrun`` gang for every
configuration), against the JAX package.

The model is ``llama3_8b_zero``'s Llama at dims where leaves reach
``MIN_SHARD_ELEMS`` (2^14) and split: 2 layers, d 64, 4/2 heads, MLP 256,
vocab 512 (the token table, the head and the MLP kernels split; the
attention kernels and the norms stay replicated), T 16, batch 8,
``xent_chunk`` 8 (the chunked loss reads ``lm_head.kernel`` itself), f32,
remat, adamw with the preset's clip at 1.0 (warmup 1), 3 steps, from the
JAX init carried by ``utils.interop``. The adafactor case takes d 128 and
vocab 128, where the factored moments of split leaves run (the token
table split along its second-largest dim, the MLP along the largest).

- zero-1 and zero-3 on fsdp 4, zero-3 on data 2 x fsdp 2 and zero-3 with
  ``grad_accum`` 2: losses against the JAX ``Trainer`` on one device (and,
  for zero-3, against the JAX zero-3 on 4 CPU devices) to 1e-5 relative,
  the parameters after the steps (the slices gathered by
  ``interop.gather_shards``) to 1e-4 of each leaf's largest |value|.
- zero-3's slices: each rank's parameter and adam-moment shapes equal the
  per-device shapes of the JAX ``state_shardings`` of the same leaves.
- zero-3 with lamb and with adafactor against the JAX ``Trainer``, the
  same tolerances.
- zero-3 checkpoint and resume on the gang bit for bit, and the
  checkpoint read in one process (``read_full_params``) equal to the
  straight run's parameters.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.parallel.sharding_rules import path_str
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch.train.checkpoint import read_full_params
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    gather_shards,
    llama_params_from_jax,
)
from test_torch_pipeline import _Gang

STEPS = 3
LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             mlp_dim=256, vocab_size=512)
WIDE = dict(LLAMA, d_model=128, vocab_size=128)  # adafactor factors
# name -> (mesh fsdp, mesh data, zero_stage, grad_accum, optimizer)
RUNS = {
    "zero1": (4, 1, 1, 1, "adamw"),
    "zero3": (4, 1, 3, 1, "adamw"),
    "zero3_data2": (2, 2, 3, 1, "adamw"),
    "zero3_accum2": (4, 1, 3, 2, "adamw"),
    "zero3_lamb": (4, 1, 3, 1, "lamb"),
    "zero3_adafactor": (4, 1, 3, 1, "adafactor"),
}


def _overrides(optim="adamw", accum=1, stage=3, fsdp=1, data=1,
               strategy="zero", steps=STEPS):
    extra = WIDE if optim == "adafactor" else LLAMA
    return {"steps": str(steps), "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "8", "data.seq_len": "16",
            "data.vocab_size": str(extra["vocab_size"]),
            "model.extra": json.dumps(extra),
            "model.compute_dtype": "float32", "xent_chunk": "8",
            "optim.name": optim, "optim.warmup_steps": "1",
            "parallel.strategy": strategy, "parallel.zero_stage": str(stage),
            "parallel.grad_accum": str(accum), "mesh.fsdp": str(fsdp),
            "mesh.data": str(data)}


def _jax_run(optim="adamw", accum=1, fsdp=1):
    strategy = "zero" if fsdp > 1 else "single"
    cfg = jconfig.get_config("llama3_8b_zero", **_overrides(
        optim, accum, fsdp=fsdp, strategy=strategy))
    mesh = make_mesh(cfg.mesh.resolve(fsdp), devices=jax.devices()[:fsdp])
    trainer = JTrainer(cfg, mesh=mesh)
    init = jax.device_get(trainer.state.params)  # before donation
    shards = {}
    if fsdp > 1:  # each leaf's per-device shape under state_shardings
        for tree in (trainer.state.params, trainer.state.opt_state):
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                if hasattr(leaf, "sharding") and leaf.ndim:
                    shards[path_str(kp)] = tuple(
                        leaf.sharding.shard_shape(leaf.shape))
    trainer.train()
    final = jax.device_get(trainer.state.params)
    trainer.close()
    return init, np.array(trainer.losses()), final, shards


_WORKER = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out_dir, runs = sys.argv[1], json.loads(sys.argv[2])
bootstrap.initialize("cpu")


def trainer(ov, init, ckpt=None):
    ov = dict(ov)
    if ckpt:
        ov.update({"checkpoint_dir": ckpt, "checkpoint_every": "2"})
    params = {k: torch.from_numpy(v) for k, v in np.load(init).items()}
    return Trainer(get_config("llama3_8b_zero", **ov), device="cpu",
                   params=params)


res = {}
for name, run in runs.items():
    ckpt = run.get("ckpt")
    with trainer(run["ov"], run["init"], ckpt and ckpt + "/straight") as t:
        with cc.recording() as records:
            t.train()
    res[f"{name}/records"] = np.array(
        [(r.op, r.bytes_payload, r.bytes_wire) for r in records
         if r.op in ("all_gather", "reduce_scatter")], dtype=object)
    res[f"{name}/losses"] = np.array(t.losses())
    sd = t.state.state_dict()
    for k, v in sd.items():
        if k.startswith("model."):
            res[f"{name}/param/{k[6:]}"] = v.detach().numpy()
        elif k.startswith("opt.mu."):
            res[f"{name}/mu_shape/{k[7:]}"] = np.array(v.shape)
    if ckpt:
        with trainer(run["ov"], run["init"], ckpt + "/resumed") as b:
            b.train(steps=2)
        with trainer(run["ov"], run["init"], ckpt + "/resumed") as c:
            resumed_from = c.data_step
            c.train()
        got = c.state.state_dict()
        res[f"{name}/resume"] = np.array([resumed_from] + [
            int(torch.equal(sd[k], got[k])) for k in sorted(sd)])
        res[f"{name}/resumed_losses"] = np.array(c.losses())
np.savez(f"{out_dir}/rank{cc.rank()}.npz", **res)
bootstrap.shutdown()
"""


def _jax_init(optim="adamw"):
    """The JAX ``Trainer``'s initial weights (no step run)."""
    cfg = jconfig.get_config("llama3_8b_zero", **_overrides(
        optim, strategy="single"))
    trainer = JTrainer(cfg, mesh=make_mesh(cfg.mesh.resolve(1),
                                           devices=jax.devices()[:1]))
    init = jax.device_get(trainer.state.params)
    trainer.close()
    return init


def _jax_key(name):
    _, _, _, accum, optim = RUNS[name]
    return "accum2" if accum > 1 else optim


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every configuration on one 4-rank gang, started from the JAX
    initial weights; the gang runs while the JAX runs train."""
    d = tmp_path_factory.mktemp("zero_gang")
    inits = {}
    for key in ("adamw", "adafactor"):
        sd = llama_params_from_jax(_jax_init(key))
        inits[key] = str(d / f"init_{key}.npz")
        np.savez(inits[key], **{k: v.numpy() for k, v in sd.items()})
    runs = {name: {"ov": _overrides(optim, accum, stage, fsdp, data),
                   "init": inits["adafactor" if optim == "adafactor"
                                 else "adamw"]}
            for name, (fsdp, data, stage, accum, optim) in RUNS.items()}
    runs["ckpt_zero3"] = {"ov": _overrides(steps=4, fsdp=4),
                          "init": inits["adamw"], "ckpt": str(d / "ckpt")}
    script = d / "worker.py"
    script.write_text(_WORKER)
    return _Gang(script, d, runs), d


@pytest.fixture(scope="module")
def jax_runs(started):
    return {"adamw": _jax_run(), "accum2": _jax_run(accum=2),
            "lamb": _jax_run("lamb"), "adafactor": _jax_run("adafactor"),
            "zero3": _jax_run(fsdp=4)}


@pytest.fixture(scope="module")
def gang(started, jax_runs):
    handle, d = started
    return handle.ranks(), d


def _slices(rank, name):
    pre = f"{name}/param/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in rank.items()
            if k.startswith(pre)}


def _whole(ranks, name, shapes):
    """The parameters: zero-1's as any rank holds them, zero-3's gathered
    from the fsdp ranks of data replica 0 (ranks 0 ... fsdp - 1)."""
    fsdp, _, stage, _, _ = RUNS[name]
    if stage == 1:
        return {k: v.numpy() for k, v in _slices(ranks[0], name).items()}
    return {k: v.numpy() for k, v in gather_shards(
        [_slices(ranks[i], name) for i in range(fsdp)], shapes).items()}


def _close_params(got, want, init):
    assert sorted(got) == sorted(want)
    moved = 0.0
    for k, b in want.items():
        np.testing.assert_allclose(got[k], b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)
        moved = max(moved, float(np.abs(b - init[k]).max()))
    assert moved > 1e-5


def _flat(tree):
    return {k: v.numpy() for k, v in llama_params_from_jax(tree).items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_zero_matches_the_jax_trainer(gang, jax_runs, name):
    ranks, _ = gang
    init, j_losses, j_final, _ = jax_runs[_jax_key(name)]
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/losses"], j_losses, rtol=1e-5)
    want = _flat(j_final)
    shapes = {k: v.shape for k, v in want.items()}
    _close_params(_whole(ranks, name, shapes), want, _flat(init))


@pytest.mark.parametrize("name", ["zero3", "zero3_data2"])
def test_zero3_matches_the_jax_zero3(gang, jax_runs, name):
    ranks, _ = gang
    init, j_losses, j_final, _ = jax_runs["zero3"]
    np.testing.assert_allclose(ranks[0][f"{name}/losses"], j_losses,
                               rtol=1e-5)
    want = _flat(j_final)
    shapes = {k: v.shape for k, v in want.items()}
    _close_params(_whole(ranks, name, shapes), want, _flat(init))


def test_zero3_slices_are_the_jax_per_device_shards(gang, jax_runs):
    ranks, _ = gang
    whole = _flat(jax_runs["zero3"][0])
    jax_shards = jax_runs["zero3"][3]
    split = set()
    for r in ranks:
        for k, t in _slices(r, "zero3").items():
            path = k.replace(".", "/")
            assert tuple(t.shape) == jax_shards[path], k
            mu = [v for p, v in jax_shards.items()
                  if p.endswith("mu/" + path)]
            assert [tuple(r[f"zero3/mu_shape/{k}"])] == mu, k
            if tuple(t.shape) != whole[k].shape:
                split.add(k)
    assert {"tok_embed.embedding", "lm_head.kernel",
            "layer0.gate_proj.kernel"} <= split


@pytest.mark.parametrize("name,stage", [("zero3", 3), ("zero1", 1)])
def test_zero_records_its_gathers_and_reduce_scatters(gang, jax_runs, name,
                                                      stage):
    """The collective recorder sees one reduce-scatter a split gradient a
    step (the whole gradient's bytes), and gathers of the slices (a
    slice's bytes each): at stage 1 once a split parameter a step, after
    the update."""
    ranks, _ = gang
    whole = _flat(jax_runs["zero3"][0])
    split = {k for k, t in _slices(ranks[0], "zero3").items()
             if tuple(t.shape) != whole[k].shape}
    full_bytes = sum(whole[k].size * 4 for k in split)
    recs = ranks[0][f"{name}/records"]
    rs = [(p, w) for op, p, w in recs if op == "reduce_scatter"]
    ag = [(p, w) for op, p, w in recs if op == "all_gather"]
    assert len(rs) == len(split) * STEPS
    assert sum(p for p, _ in rs) == full_bytes * STEPS
    assert all(w == p * 3 / 4 for p, w in rs)
    assert all(w == p * 3 for p, w in ag)  # a slice to 3 ranks' worth
    # stage 3: a unit's slices before its forward and again before its
    # backward; the head, which the chunked loss reads itself, once (it
    # is held from the forward to its gradient)
    times = {k: 1 if stage == 1 or k == "lm_head.kernel" else 2
             for k in split}
    assert sum(p for p, _ in ag) == sum(
        whole[k].size * 4 // 4 * times[k] for k in split) * STEPS


def test_zero1_keeps_parameters_whole_and_moments_sliced(gang):
    ranks, _ = gang
    r = ranks[1]
    params = _slices(r, "zero1")
    sliced = [k for k in params
              if tuple(r[f"zero1/mu_shape/{k}"]) != tuple(params[k].shape)]
    assert sliced and "tok_embed.embedding" in sliced
    for k in sliced:  # every rank holds the same whole parameter
        np.testing.assert_array_equal(params[k].numpy(),
                                      ranks[0][f"zero1/param/{k}"])


def test_zero3_resume_bit_for_bit_and_full_read(gang):
    ranks, d = gang
    for r in ranks:
        flags = r["ckpt_zero3/resume"]
        assert flags[0] == 2 and flags[1:].all()
        np.testing.assert_array_equal(r["ckpt_zero3/resumed_losses"],
                                      r["ckpt_zero3/losses"][2:])
    full = read_full_params(d / "ckpt" / "straight")
    shapes = {k: v.shape for k, v in full.items()}
    want = {k: v.numpy() for k, v in gather_shards(
        [_slices(ranks[i], "ckpt_zero3") for i in range(4)],
        shapes).items()}
    assert sorted(full) == sorted(want)
    for k, v in full.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


_PATHS = [
    ("tok_embed.embedding", (512, 64)), ("pos_embed.embedding", (1024, 64)),
    ("lm_head.kernel", (64, 512)), ("layer0.gate_proj.kernel", (64, 256)),
    ("layer0.down_proj.kernel", (256, 64)), ("layer0.attn_norm.scale", (64,)),
    ("block0.attn.query.kernel", (64, 8, 8)),
    ("block0.attn.out.kernel", (8, 8, 64)), ("block0.mlp_in.bias", (256,)),
    ("block0.mlp_in.kernel", (512, 2048)), ("x.kernel", (1023, 131)),
    ("moe.wi", (8, 64, 256)), ("moe.wo", (8, 256, 64)),
    ("mlm_decoder.kernel", (768, 30522)), ("block0.attn.key.kernel",
                                           (64, 2, 8)),
]


@pytest.mark.parametrize("tensor,fsdp,expert,min_elems", [
    (1, 1, 1, 2 ** 14), (1, 2, 1, 2 ** 14), (1, 4, 1, 2 ** 14),
    (1, 8, 1, 1), (4, 1, 1, 2 ** 14), (4, 2, 1, 1), (2, 2, 2, 1),
    (1, 3, 1, 1)])
def test_spec_for_is_the_jax_rule(tensor, fsdp, expert, min_elems):
    """The port's rule gives each dim the axis the JAX ``spec_for`` gives
    it (``PartitionSpec`` entries as a tuple), the dotted names as the
    '/'-joined ones."""
    from pytorch_distributed_nn_tpu.parallel.sharding_rules import (
        spec_for as jspec_for,
    )
    from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
        spec_for,
    )

    for path, shape in _PATHS:
        kw = dict(tensor=tensor, fsdp=fsdp, expert=expert,
                  min_elems=min_elems)
        want = tuple(jspec_for(path.replace(".", "/"), shape, **kw))
        assert spec_for(path, shape, **kw) == want, (path, shape, kw)


def test_shard_params_are_the_jax_device_slices():
    """``interop.shard_params`` takes the slice a ``NamedSharding`` puts
    on the device at each fsdp coordinate; ``gather_shards`` undoes it."""
    from jax.sharding import NamedSharding

    from pytorch_distributed_nn_tpu.parallel.sharding_rules import (
        spec_for as jspec_for,
    )
    from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec
    from pytorch_distributed_nn_tpu_torch.utils.interop import shard_params

    mesh = make_mesh(MeshSpec(fsdp=4, data=1).resolve(4),
                     devices=jax.devices()[:4])
    rng = np.random.default_rng(0)
    sd = {path: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for path, shape in _PATHS[:6]}
    parts = [shard_params(sd, 4, i) for i in range(4)]
    for path, t in sd.items():
        arr = jax.device_put(t.numpy(), NamedSharding(
            mesh, jspec_for(path.replace(".", "/"), tuple(t.shape),
                            fsdp=4)))
        by_device = {s.device: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for i, dev in enumerate(mesh.devices.reshape(-1)):
            np.testing.assert_array_equal(parts[i][path].numpy(),
                                          by_device[dev], err_msg=path)
    back = gather_shards(parts, {k: v.shape for k, v in sd.items()})
    for k in sd:
        assert torch.equal(back[k], sd[k]), k

"""Port parity of the expert axis: ``parallel/expert.py`` (the explicit
all-to-all pair), ``models/moe_lm.py`` and ``moe_lm_ep`` on ZeRO-3 over
``expert``, against the JAX package on the CPU. Inputs are seeded numpy
arrays; weights are the JAX init, carried by ``utils.interop``. The
routing, the layer and the model's forward are ``test_torch_moe_layer.py``.
- Training on one process: 4 steps at the JAX test's dims
  (``tests/test_moe.py``) against the JAX ``Trainer``: losses to 2e-5
  relative, parameters to 1e-4 of each leaf's largest |value|; the
  load-balance weight 0.01 against 0 changes the loss by the term.
- On a 4-rank gloo gang (one ``torchrun`` for every configuration):
  expert 4 x data 1, expert 2 x data 2, expert 4 with ``grad_accum`` 2 and
  expert 4 with the clip, each against the JAX single-device ``Trainer``
  and (but the clip) the JAX run on 4 CPU devices at the same mesh (same
  tolerances); expert 4 with lamb, with adafactor and with dropout 0.1,
  and expert 2 x fsdp 2 (the experts split along ff too), against the
  port on one process; each rank's slices are the JAX per-device shards; the
  collectives recorded at expert 4 x data 1 are exactly the chosen
  transport's (one all-gather of the experts' outputs and one all-reduce
  of the tokens' gradient a layer a step, nothing else); resume at
  expert 2 x fsdp 2 is bit for bit, the pieces off expert 0 hold only the
  expert slices, and ``read_full_params`` returns the whole parameters;
  ``ep_dispatch`` / ``ep_combine`` equal the JAX pair under ``shard_map``
  and round-trip.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.parallel import expert as jexpert
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.parallel.expert import (
    collect_aux_losses,
    expert_capacity,
)
from pytorch_distributed_nn_tpu_torch.train.checkpoint import read_full_params
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    gather_shards,
    params_from_jax,
    shard_params,
)
from test_torch_pipeline import _Gang

STEPS = 4
LR = 3e-4  # the preset's peak lr
# the JAX test's dims (tests/test_moe.py)
EXTRA = dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
             num_experts=4, k=2, capacity_factor=2.0, vocab_size=128,
             max_len=64)
# the gang's runs: name -> the mesh and options (_overrides' arguments)
RUNS = {"ep4": dict(expert=4), "ep2_data2": dict(expert=2, data=2),
        "ep4_accum2": dict(expert=4, accum=2),
        "ep4_clip": dict(expert=4, clip=0.05),
        "ep4_lamb": dict(expert=4, optim="lamb"),
        "ep4_adafactor": dict(expert=4, optim="adafactor"),
        # MLP 128: the stacked experts reach 2^14 elements and fsdp splits
        # them along ff too (each rank holds (2, 32, 64) of (4, 32, 128))
        "ep2_fsdp2": dict(expert=2, fsdp=2, wide=True),
        # the expert ranks draw the same dropout masks (their rows are
        # the same): those of the one process, whose rank is 0
        "ep4_dropout": dict(expert=4, dropout=0.1)}
# held against the JAX run on the same 4-device mesh as well
JAX_MESH_RUNS = ("ep4", "ep2_data2", "ep4_accum2")
# held against the port on one process (the lamb, adafactor and seeded-
# init paths there are held against the JAX package by their own tests)
PORT_RUNS = ("ep4_lamb", "ep4_adafactor", "ep2_fsdp2", "ep4_dropout")
CKPT = "ep2_fsdp2"  # also checkpointed and resumed


def _np(t):
    return t.detach().float().numpy().copy()


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _overrides(expert=1, data=1, fsdp=1, accum=1, clip=0.0, optim="adamw",
               wide=False, dropout=0.0, steps=STEPS, aux=None):
    extra = dict(EXTRA, mlp_dim=128) if wide else dict(EXTRA)
    if aux is not None:
        extra["aux_loss_weight"] = aux
    if dropout:
        extra["dropout"] = dropout
    return {"steps": str(steps), "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "8", "data.seq_len": "16",
            "data.vocab_size": "128", "model.extra": json.dumps(extra),
            "model.compute_dtype": "float32", "optim.name": optim,
            "parallel.grad_accum": str(accum),
            "optim.grad_clip_norm": str(clip), "mesh.expert": str(expert),
            "mesh.data": str(data), "mesh.fsdp": str(fsdp)}


def _single(run):
    """The one-process counterpart of a gang run's options."""
    return {k: v for k, v in run.items()
            if k not in ("expert", "data", "fsdp")}


def _jax_trainer(steps=STEPS, **run):
    cfg = jconfig.get_config("moe_lm_ep", **_overrides(steps=steps, **run))
    n = run.get("expert", 1) * run.get("data", 1)
    return JTrainer(cfg, mesh=make_mesh(cfg.mesh.resolve(n),
                                        devices=jax.devices()[:n]))


def _jax_run(**run):
    """Losses, final parameters and, on a mesh, each device's shard of
    every parameter (in the port's rank order)."""
    t = _jax_trainer(**run)
    t.train()
    final = jax.device_get(t.state.params)
    shards = []
    if run.get("expert", 1) * run.get("data", 1) > 1:
        devices = list(t.mesh.devices.reshape(-1))
        flat = jax.tree_util.tree_flatten_with_path(t.state.params)[0]
        for dev in devices:
            shards.append({"/".join(str(k.key) for k in kp): np.asarray(
                next(s.data for s in leaf.addressable_shards
                     if s.device == dev)) for kp, leaf in flat})
    t.close()
    return np.array(t.losses()), final, shards


@pytest.fixture(scope="module")
def jax_init():
    t = _jax_trainer()
    init = jax.device_get(t.state.params)
    t.close()
    return init


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _close_params(got, want, init):
    """Each parameter to 1e-4 of its largest |value|; the attention key
    biases, whose gradient is zero in exact arithmetic (both runs move them
    by rounding noise through adam), to the lr's scale."""
    assert sorted(got) == sorted(want)
    moved = 0.0
    for k, b in want.items():
        if k.endswith("attn.key.bias"):
            assert np.abs(got[k]).max() <= STEPS * LR
            assert np.abs(b).max() <= STEPS * LR
            continue
        _close(got[k], b, 1e-4, k)
        moved = max(moved, float(np.abs(b - init[k]).max()))
    assert moved > 1e-5


def test_trainer_matches_the_jax_trainer(jax_init, jax_runs):
    j_losses, j_final, _ = jax_runs["single"]
    t = Trainer(get_config("moe_lm_ep", **_overrides()), device="cpu",
                params=params_from_jax(jax_init))
    t.train()
    np.testing.assert_allclose(t.losses(), j_losses, rtol=2e-5)
    _close_params({k: _np(v) for k, v in t.model.state_dict().items()},
                  _flat(j_final), _flat(jax_init))


def test_aux_loss_reaches_the_training_loss(jax_init):
    """Weight 0.01 against 0: the first step's loss differs by exactly the
    layers' load-balance terms, and the JAX run with weight 0 agrees."""
    losses, terms = {}, {}
    for w in (0.01, 0.0):
        t = Trainer(get_config("moe_lm_ep", **_overrides(steps=1, aux=w)),
                    device="cpu", params=params_from_jax(jax_init))
        x, y = t.loader.batch_at(0)
        with collect_aux_losses(t.model) as aux:
            t.model(x)
        terms[w] = sum(float(v.detach()) for v in aux.values())
        t.train()
        losses[w] = t.losses()[0]
    assert terms[0.0] == 0.0 and terms[0.01] > 0.0
    assert losses[0.01] - losses[0.0] == pytest.approx(terms[0.01],
                                                       rel=1e-3)
    cfg = jconfig.get_config("moe_lm_ep", **_overrides(steps=1, aux=0.0))
    jt = JTrainer(cfg, mesh=make_mesh(cfg.mesh.resolve(1),
                                      devices=jax.devices()[:1]))
    jt.train()
    jt.close()
    assert jt.losses()[0] == pytest.approx(losses[0.0], rel=2e-5)


# --------------------------------------------------------------------------
# the 4-rank gang
# --------------------------------------------------------------------------

_WORKER = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel.expert import (
    ep_combine, ep_dispatch)
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out_dir, runs = sys.argv[1], json.loads(sys.argv[2])
bootstrap.initialize("cpu")
rank = cc.rank()


def trainer(ov, init, ckpt=None):
    ov = dict(ov)
    if ckpt:
        ov.update({"checkpoint_dir": ckpt, "checkpoint_every": "2"})
    params = None  # the model's seeded init
    if init:
        params = {k: torch.from_numpy(v) for k, v in np.load(init).items()}
    return Trainer(get_config("moe_lm_ep", **ov), device="cpu",
                   params=params)


res = {}
x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
    (8, 3, 5)).astype(np.float32))
local = ep_dispatch(x, None, 4)
res["a2a/local"] = local.numpy()
res["a2a/back"] = ep_combine(local, None, 4).numpy()
res["a2a/x"] = x.numpy()
for name, run in runs.items():
    ckpt = run.get("ckpt")
    with trainer(run["ov"], run["init"], ckpt and ckpt + "/straight") as t:
        with cc.recording() as records:
            t.train()
    res[f"{name}/records"] = np.array(
        [(r.op, r.bytes_payload, r.bytes_wire) for r in records],
        dtype=object)
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
np.savez(f"{out_dir}/rank{rank}.npz", **res)
bootstrap.shutdown()
"""


@pytest.fixture(scope="module")
def started(tmp_path_factory, jax_init):
    """Every configuration on one 4-rank gang, from the JAX initial
    weights; the gang runs while the JAX runs train."""
    d = tmp_path_factory.mktemp("moe_gang")
    init = str(d / "init.npz")
    np.savez(init, **_flat(jax_init))
    runs = {name: {"ov": _overrides(**run),
                   "init": None if run.get("wide") else init}
            for name, run in RUNS.items()}
    runs[CKPT]["ckpt"] = str(d / "ckpt")
    script = d / "worker.py"
    script.write_text(_WORKER)
    return _Gang(script, d, runs), d


@pytest.fixture(scope="module")
def jax_runs(started):
    out = {"single": _jax_run()}
    for name in ("ep4_accum2", "ep4_clip"):
        out[f"single_{name}"] = _jax_run(**_single(RUNS[name]))
    for name in JAX_MESH_RUNS:
        out[name] = _jax_run(**RUNS[name])
    return out


@pytest.fixture(scope="module")
def port_runs(jax_init):
    """The port on one process: (losses, final parameters, initial)."""
    out = {}
    for name in PORT_RUNS:
        run = _single(RUNS[name])
        t = Trainer(get_config("moe_lm_ep", **_overrides(**run)),
                    device="cpu", params=None if run.get("wide")
                    else params_from_jax(jax_init))
        init = {k: _np(v) for k, v in t.model.state_dict().items()}
        t.train()
        out[name] = (np.array(t.losses()),
                     {k: _np(v) for k, v in t.model.state_dict().items()},
                     init)
    return out


@pytest.fixture(scope="module")
def gang(started, jax_runs):
    handle, d = started
    return handle.ranks(), d


def _slices(rank, name):
    pre = f"{name}/param/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in rank.items()
            if k.startswith(pre)}


def _whole(ranks, name, shapes):
    """The parameters gathered from the ranks of data replica 0, in
    (expert, fsdp) order: rank r sits at data r // (fsdp expert), fsdp
    r // expert % fsdp, expert r % expert."""
    expert, fsdp = RUNS[name]["expert"], RUNS[name].get("fsdp", 1)
    pieces = [_slices(ranks[f * expert + e], name)
              for e in range(expert) for f in range(fsdp)]
    return {k: v.numpy() for k, v in gather_shards(
        pieces, shapes, expert=expert).items()}


@pytest.mark.parametrize("name", [n for n in RUNS if n not in PORT_RUNS])
def test_expert_split_matches_the_jax_trainer(gang, jax_runs, jax_init,
                                              name):
    """Each configuration against the JAX single-device Trainer and (the
    three of ``JAX_MESH_RUNS``) the JAX run on the same 4-device mesh: the
    router's gradient, the tokens' and the load-balance term each count
    once."""
    ranks, _ = gang
    single = f"single_{name}" if f"single_{name}" in jax_runs else "single"
    want = _flat(jax_runs[single][1])
    shapes = {k: v.shape for k, v in want.items()}
    for ref in (single, name) if name in JAX_MESH_RUNS else (single,):
        j_losses = jax_runs[ref][0]
        for r in ranks:
            np.testing.assert_allclose(r[f"{name}/losses"], j_losses,
                                       rtol=2e-5)
        _close_params(_whole(ranks, name, shapes), _flat(jax_runs[ref][1]),
                      _flat(jax_init))


@pytest.mark.parametrize("name", PORT_RUNS)
def test_expert_split_matches_one_process(gang, port_runs, name):
    """lamb (its trust ratio's norms), adafactor (its block RMS), the
    experts split over fsdp too, and dropout (the masks follow the rows),
    against the port on one process: losses to 2e-5 relative, parameters
    to 1e-4 of each leaf's largest |value|."""
    ranks, _ = gang
    losses, final, init = port_runs[name]
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/losses"], losses, rtol=2e-5)
    shapes = {k: v.shape for k, v in final.items()}
    _close_params(_whole(ranks, name, shapes), final, init)
    if RUNS[name].get("fsdp", 1) > 1:
        assert _slices(ranks[0], name)["block0.moe.wi"].shape == (2, 32, 64)


@pytest.mark.parametrize("name", ["ep4", "ep2_data2"])
def test_slices_are_the_jax_per_device_shards(gang, jax_runs, name):
    ranks, _ = gang
    expert = RUNS[name]["expert"]
    shards = jax_runs[name][2]
    whole = _flat(jax_runs[name][1])
    for r, rank in enumerate(ranks):
        got = _slices(rank, name)
        assert sorted(got) == sorted(k.replace("/", ".")
                                     for k in shards[r])
        for path, want in shards[r].items():
            k = path.replace("/", ".")
            assert tuple(got[k].shape) == want.shape, k
            assert tuple(rank[f"{name}/mu_shape/{k}"]) == want.shape, k
            if not k.endswith("attn.key.bias"):  # see _close_params
                _close(got[k].numpy(), want, 1e-4, k)
        for k in ("block0.moe.wi", "block1.moe.wo"):
            assert got[k].shape[0] == whole[k].shape[0] // expert
    # interop's pieces are the same slices of the whole parameters
    for r in range(4):
        e = r % expert
        sliced = shard_params({k: torch.from_numpy(v)
                               for k, v in whole.items()},
                              1, 0, expert=expert, expert_index=e)
        for path, want in shards[r].items():
            _close(sliced[path.replace("/", ".")].numpy(), want, 1e-4, path)


def test_the_transport_is_one_gather_and_one_reduce_a_layer(gang):
    """Expert 4 x data 1: a step issues, per MoE layer, one all-gather of
    the (E/n, G C, d) expert outputs in the forward and one all-reduce of
    the (G, g, d) tokens' gradient in the backward; no gradient or loss
    crosses a wire (every rank holds the same rows)."""
    ranks, _ = gang
    B, T, d = 8, 16, EXTRA["d_model"]
    E = EXTRA["num_experts"]
    C = expert_capacity(T, E, EXTRA["k"], EXTRA["capacity_factor"])
    gather = E // 4 * B * C * d * 4  # f32 bytes a rank contributes
    reduce_ = B * T * d * 4
    layers = EXTRA["num_layers"]
    for r in ranks:
        recs = [tuple(x) for x in r["ep4/records"]]
        assert sorted(recs) == sorted(
            [("all_gather", gather, gather * 3.0)] * layers * STEPS
            + [("all_reduce", reduce_, 2.0 * reduce_ * 3 / 4)]
            * layers * STEPS)


def test_resume_bit_for_bit_and_full_read(gang):
    """Expert 2 x fsdp 2: every rank resumes bit for bit; the pieces off
    expert 0 hold only their expert slices and those slices' moments (a
    replicated tensor is written once); ``read_full_params`` reassembles
    the whole E from the (expert, fsdp) pieces."""
    ranks, d = gang
    for r in ranks:
        flags = r[f"{CKPT}/resume"]
        assert flags[0] == 2 and flags[1:].all()
        np.testing.assert_array_equal(r[f"{CKPT}/resumed_losses"],
                                      r[f"{CKPT}/losses"][2:])
    step = d / "ckpt" / "straight" / "4"
    experts = sorted(f"block{i}.moe.{w}" for i in range(2)
                     for w in ("wi", "wo"))
    for f in range(2):
        off = torch.load(step / f"model-expert1-fsdp{f}.pt",
                         weights_only=True)
        assert sorted(off) == [f"model.{k}" for k in experts]
        optim = torch.load(step / f"optim-expert1-fsdp{f}.pt",
                           weights_only=True)
        assert sorted(optim) == sorted(f"opt.{m}.{k}" for k in experts
                                       for m in ("mu", "nu"))
        assert not torch.load(step / f"train-expert1-fsdp{f}.pt",
                              weights_only=True)
    full = read_full_params(d / "ckpt" / "straight")
    shapes = {k: v.shape for k, v in full.items()}
    want = _whole(ranks, CKPT, shapes)
    assert sorted(full) == sorted(want)
    for k, v in full.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert full["block0.moe.wi"].shape[0] == EXTRA["num_experts"]


def test_ep_dispatch_and_combine_match_the_jax_pair(gang):
    """Each rank's ``ep_dispatch`` output equals the JAX ``ep_dispatch``
    on that device under ``shard_map``; ``ep_combine`` undoes it."""
    ranks, _ = gang
    n = 4
    xs = np.stack([r["a2a/x"] for r in ranks])  # (n, E, C, d)
    mesh = make_mesh(MeshSpec(expert=n, data=1), devices=jax.devices()[:n])

    def body(x_local):
        return jexpert.ep_dispatch(x_local[0], axis="expert")[None]

    want = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("expert"),
                                 out_specs=P("expert"), check_vma=False))(
        jnp.asarray(xs))
    for i, r in enumerate(ranks):
        assert r["a2a/local"].shape == (8 // n, n * 3, 5)
        np.testing.assert_array_equal(r["a2a/local"], np.asarray(want[i]))
        np.testing.assert_array_equal(r["a2a/back"], r["a2a/x"])

"""Port parity of the tensor axis (``parallel/tensor.py``, Megatron's
layout over ``mesh.tensor``) against the JAX package, on the CPU.

- Layout: the port's ``spec_for`` equals the JAX ``spec_for`` on every
  leaf of the tiny transformer LM, Llama, BERT and MoE LM at tensor 2 and
  4 with fsdp and expert; each rank's slice (``sharding_rules.local_slice``,
  and the leaves of a model cut by ``split_tensor_layers``) equals the
  shard a ``NamedSharding`` puts on the JAX CPU device at the same mesh
  coordinates (the ranks in the row-major order of the JAX CPU mesh).
- One 4-rank gloo gang (``torchrun --standalone``: a free port, a nonce
  and a world check, a hard timeout), started before the JAX runs train:
  the tiny LM of ``tests/test_tensor_parallel.py`` (2 layers, d 64, 4
  heads, MLP 128, vocab 128, T 16, batch 16, f32, 4 adam steps) at
  tensor 2 x data 2, tensor 4 and tensor 2 x fsdp 2 under ZeRO-3 against
  the JAX ``Trainer`` on one device: losses at rtol 2e-5 and atol 1e-5
  (the JAX test's), the parameters after the steps (read whole from the
  run's checkpoint by ``read_full_params``) at 1e-4 of each leaf's largest
  |value|; the all-reduces and all-gathers one forward and one backward
  record; the gradients of the leaves the rules leave whole equal on the
  tensor ranks of a data coordinate, bit for bit; one step each of the
  tiny Llama (GQA, 4/2 heads, tensor 2 x data 2), BERT (tensor 2 x data
  2) and MoE LM (expert 2 x tensor 2) against the JAX ``Trainer``; a
  ZeRO-3 x tensor checkpoint resumed bit for bit, and refused
  (``LayoutError``) by another layout.
"""

import json
import subprocess
import sys
import uuid
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.parallel.sharding_rules import (
    spec_for as jspec_for,
)
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
    local_slice,
    spec_for,
)
from pytorch_distributed_nn_tpu_torch.parallel.tensor import (
    split_tensor_layers,
)
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AXES, AxisGroup
from pytorch_distributed_nn_tpu_torch.train.checkpoint import read_full_params
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
    params_from_jax,
)
from test_torch_sequence import _env

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300
WORLD = 4
LOSS_RTOL, LOSS_ATOL, PARAM_TOL = 2e-5, 1e-5, 1e-4

LM = dict(num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
          vocab_size=128, max_len=32)
LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             mlp_dim=128, vocab_size=512)
BERT = dict(num_layers=2, d_model=32, num_heads=4, mlp_dim=64,
            vocab_size=96, max_len=32)
MOE = dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64, num_experts=4,
           k=2, capacity_factor=2.0, vocab_size=128, max_len=64)
# preset, model.extra and the options every run of a family shares
FAMILIES = {
    "lm": ("transformer_lm_pp", LM, {
        "steps": "4", "data.batch_size": "16", "data.seq_len": "16",
        "data.vocab_size": "128", "model.remat": "false",
        "parallel.strategy": "dp", "mesh.pipe": "1"}),
    "llama": ("llama3_longcontext", LLAMA, {
        "steps": "1", "data.batch_size": "2", "data.seq_len": "64",
        "data.vocab_size": "512", "xent_chunk": "32",
        "optim.warmup_steps": "0"}),
    "bert": ("bert_base_buckets", BERT, {
        "steps": "1", "data.batch_size": "4", "data.seq_len": "16",
        "data.vocab_size": "96", "parallel.strategy": "dp",
        "optim.warmup_steps": "0"}),
    "moe": ("moe_lm_ep", MOE, {
        "steps": "1", "data.batch_size": "8", "data.seq_len": "16",
        "data.vocab_size": "128", "mesh.expert": "1",
        "optim.warmup_steps": "0"}),
}
# the gang's runs: name -> (family, mesh and options of the run)
RUNS = {
    "tp2_dp2": ("lm", {"mesh.tensor": "2", "mesh.data": "2"}),
    "tp4": ("lm", {"mesh.tensor": "4", "mesh.data": "1"}),
    "tp2_zero3": ("lm", {"mesh.tensor": "2", "mesh.fsdp": "2",
                         "mesh.data": "1", "parallel.strategy": "zero",
                         "parallel.zero_stage": "3"}),
    "llama_tp2": ("llama", {"mesh.tensor": "2", "mesh.data": "2"}),
    "bert_tp2": ("bert", {"mesh.tensor": "2", "mesh.data": "2"}),
    "moe_ep2_tp2": ("moe", {"mesh.tensor": "2", "mesh.expert": "2",
                            "mesh.data": "1"}),
}
CKPT_RUN = "tp2_zero3"  # also resumed, on its layout and on tp2_dp2


def _overrides(family, **extra):
    preset, model, ov = FAMILIES[family]
    return {"log_every": "1", "data.prefetch": "0",
            "model.compute_dtype": "float32",
            "model.extra": json.dumps(model), **ov, **extra}


# --------------------------------------------------------------------------
# the layout: the rules and each rank's slice
# --------------------------------------------------------------------------

def _port_shapes(family):
    preset, _, _ = FAMILIES[family]
    cfg = get_config(preset, **_overrides(family))
    model = get_model(cfg.model, device="cpu")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("tensor,fsdp,expert", [
    (2, 1, 1), (4, 1, 1), (2, 2, 1), (4, 2, 1), (2, 1, 2), (2, 2, 2)])
def test_spec_for_is_the_jax_rule_on_every_leaf(family, tensor, fsdp,
                                                expert):
    for min_elems in (2 ** 14, 1):
        kw = dict(tensor=tensor, fsdp=fsdp, expert=expert,
                  min_elems=min_elems)
        for name, shape in _port_shapes(family).items():
            want = tuple(jspec_for(name.replace(".", "/"), shape, **kw))
            assert spec_for(name, shape, **kw) == want, (name, shape, kw)


def _coords(mesh, device):
    where = np.argwhere(mesh.devices == device)[0]
    return dict(zip(mesh.axis_names, (int(i) for i in where)))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("tensor,fsdp,expert", [
    (2, 2, 1), (4, 2, 1), (2, 2, 2), (2, 4, 1)])
def test_rank_slices_are_the_jax_device_shards(family, tensor, fsdp,
                                              expert):
    """Every leaf, cut by ``local_slice`` at a device's (tensor, fsdp,
    expert) coordinates, is the shard the JAX ``NamedSharding`` of its
    ``spec_for`` (min_elems 1, so that the tiny leaves split) puts on that
    device."""
    spec = JMeshSpec(tensor=tensor, fsdp=fsdp, expert=expert, data=-1)
    mesh = make_mesh(spec.resolve(8))
    assert tuple(mesh.axis_names) == AXES
    rng = np.random.default_rng(0)
    for name, shape in _port_shapes(family).items():
        whole = rng.standard_normal(shape).astype(np.float32)
        jspec = jspec_for(name.replace(".", "/"), shape, tensor=tensor,
                          fsdp=fsdp, expert=expert, min_elems=1)
        arr = jax.device_put(whole, NamedSharding(mesh, P(*jspec)))
        for shard in arr.addressable_shards:
            c = _coords(mesh, shard.device)
            got = local_slice(name, torch.from_numpy(whole),
                              tensor=(tensor, c["tensor"]),
                              fsdp=(fsdp, c["fsdp"]),
                              expert=(expert, c["expert"]), min_elems=1)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{name} at {c}")


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("tensor", [2, 4])
def test_split_model_holds_the_jax_tensor_shards(family, tensor):
    """``split_tensor_layers`` (no collective: it only cuts) leaves each
    parameter the JAX tensor shard of the whole leaf, and a layer whose
    heads do not split the GQA way raises."""
    preset, model_kw, _ = FAMILIES[family]
    cfg = get_config(preset, **_overrides(family))
    whole = get_model(cfg.model, device="cpu").init_params(seed=3)
    sd = {k: v.detach().clone() for k, v in whole.named_parameters()}
    mesh = make_mesh(JMeshSpec(tensor=tensor, data=-1).resolve(8))
    for index in range(tensor):
        model = get_model(cfg.model, device="cpu").init_params(seed=3)
        if family == "llama" and tensor == 4:  # 2 kv heads, 4 ranks
            with pytest.raises(NotImplementedError, match="GQA group"):
                split_tensor_layers(model, AxisGroup(None, index, tensor))
            return
        split = split_tensor_layers(model, AxisGroup(None, index, tensor))
        assert split, family
        for name, p in model.named_parameters():
            jspec = jspec_for(name.replace(".", "/"), tuple(sd[name].shape),
                              tensor=tensor)
            arr = jax.device_put(sd[name].numpy(),
                                 NamedSharding(mesh, P(*jspec)))
            want = next(np.asarray(s.data) for s in arr.addressable_shards
                        if _coords(mesh, s.device)["tensor"] == index)
            np.testing.assert_array_equal(p.detach().numpy(), want,
                                          err_msg=name)
            assert (name in split) == ("tensor" in str(jspec)), name


# --------------------------------------------------------------------------
# the gang
# --------------------------------------------------------------------------

_WORKER = r"""
import json, shutil, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel.tensor import (
    split_tensor_layers)
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
    MeshSpec, process_mesh)
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out_dir, runs, nonce = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
ckpt_run = sys.argv[4]
proc = bootstrap.initialize("cpu")
ranks = [None] * proc.world_size
torch.distributed.all_gather_object(ranks, (proc.rank, nonce))
res = {"nonce": nonce, "world": proc.world_size, "gang": json.dumps(ranks)}


def load(path):
    return {k: torch.from_numpy(v) for k, v in np.load(path).items()}


def trainer(run, **extra):
    ov = dict(run["ov"], **extra)
    return Trainer(get_config(run["preset"], **ov), device="cpu",
                   params=load(run["init"]))


def local(state):
    return {k: v.detach().clone() for k, v in state.state_dict().items()}


for name, run in runs.items():
    ckpt = f"{out_dir}/ckpt_{name}"
    steps = run["ov"]["steps"]
    with trainer(run, checkpoint_dir=ckpt, checkpoint_every=steps) as t:
        t.train()
        res[f"{name}/losses"] = np.array(t.losses())
        res[f"{name}/mesh"] = json.dumps(t.mesh.spec.sizes())
        split = t.model.tensor_split
        res[f"{name}/split"] = json.dumps(sorted(split))
        straight = local(t.state)
        for k, _ in t.model.named_parameters():
            if k not in split:  # whole on every tensor rank
                res[f"{name}/whole/{k}"] = straight[f"model.{k}"].numpy()
    if name != ckpt_run:
        continue
    with trainer(run, checkpoint_dir=f"{ckpt}_resumed",
                 checkpoint_every="2") as b:
        b.train(steps=2)
    if proc.rank == 0:  # step 2 alone, for the resume on another layout
        shutil.copytree(f"{ckpt}_resumed", f"{ckpt}_other")
    torch.distributed.barrier()
    with trainer(run, checkpoint_dir=f"{ckpt}_resumed") as c:
        resumed_from = c.data_step
        c.train()
        got = local(c.state)
    res[f"{name}/resume"] = np.array([resumed_from] + [
        int(torch.equal(straight[k], got[k])) for k in sorted(straight)])
    # the step-2 checkpoint of tensor 2 x fsdp 2 (ZeRO-3) resumed on
    # tensor 2 x data 2: resharded on read
    with trainer(runs["tp2_dp2"], checkpoint_dir=f"{ckpt}_other") as o:
        res[f"{name}/other_layout"] = np.array(
            [o.data_step, int(o.ckpt.last_restore["resharded"])])
        o.train()
        res[f"{name}/other_losses"] = np.array(o.losses())

# one forward and one backward of the tiny LM cut over a tensor = 2 x
# data = 2 mesh, every rank on the same rows: the Megatron collectives,
# and the gradients of the whole leaves on each tensor rank
lm = runs["tp2_dp2"]
cfg = get_config(lm["preset"], **lm["ov"])
mesh = process_mesh(MeshSpec(tensor=2, data=2), proc.rank, proc.world_size)
model = get_model(cfg.model, device="cpu")
model.load_state_dict(load(lm["init"]))
split = split_tensor_layers(model, mesh.tensor)
x = torch.from_numpy(np.load(f"{out_dir}/batch.npz")["x"])
y = torch.from_numpy(np.load(f"{out_dir}/batch.npz")["y"])
with cc.recording() as fwd:
    logits = model(x)
loss = torch.nn.functional.cross_entropy(
    logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())
with cc.recording() as bwd:
    loss.backward()
res["collectives/forward"] = np.array([r.op for r in fwd])
res["collectives/backward"] = np.array([r.op for r in bwd])
res["collectives/loss"] = loss.item()
res["tensor_index"] = mesh.tensor.index
res["data_index"] = mesh.data.index
for k, p in model.named_parameters():
    if k not in split:
        res[f"grad/{k}"] = p.grad.numpy()
np.savez(f"{out_dir}/rank{proc.rank}.npz", **res)
bootstrap.shutdown()
"""


def _jax_trainer(family, steps=None):
    preset, _, _ = FAMILIES[family]
    ov = _overrides(family, **{"parallel.strategy": "single"}
                    if family in ("lm", "bert") else {})
    if steps is not None:
        ov["steps"] = str(steps)
    cfg = jconfig.get_config(preset, **ov)
    return JTrainer(cfg, mesh=make_mesh(cfg.mesh.resolve(1),
                                        devices=jax.devices()[:1]))


def _to_port(family, tree):
    return (llama_params_from_jax if family == "llama"
            else params_from_jax)(tree)


class _Gang:
    """The ``torchrun`` gang in the background (the JAX runs go on
    meanwhile); :meth:`ranks` waits for it with a hard timeout and checks
    that every rank's file is this gang's."""

    def __init__(self, script, out_dir, runs, *args):
        self.nonce = uuid.uuid4().hex
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(WORLD), str(script), str(out_dir),
               json.dumps(runs), self.nonce, *map(str, args)]
        self.out_dir = Path(out_dir)
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=_env(),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self._ranks = None

    def ranks(self):
        if self._ranks is None:
            try:
                out, err = self.proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, (out[-2000:], err[-4000:])
            ranks = [dict(np.load(self.out_dir / f"rank{r}.npz"))
                     for r in range(WORLD)]
            want = [[r, self.nonce] for r in range(WORLD)]
            for r in ranks:
                assert str(r["nonce"]) == self.nonce
                assert int(r["world"]) == WORLD
                assert json.loads(str(r["gang"])) == want
            self._ranks = ranks
        return self._ranks


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The JAX Trainer of each family and its initial weights (no step
    run), and the gang started from them."""
    d = tmp_path_factory.mktemp("tensor_gang")
    inits, trainers = {}, {}
    for family in FAMILIES:
        t = trainers[family] = _jax_trainer(family)
        init = inits[family] = jax.device_get(t.state.params)
        np.savez(d / f"init_{family}.npz", **{
            k: v.numpy() for k, v in _to_port(family, init).items()})
    rng = np.random.default_rng(5)
    np.savez(d / "batch.npz", x=rng.integers(0, 128, (16, 16)),
             y=rng.integers(0, 128, (16, 16)))
    runs = {name: {"preset": FAMILIES[family][0],
                   "ov": _overrides(family, **ov),
                   "init": str(d / f"init_{family}.npz")}
            for name, (family, ov) in RUNS.items()}
    script = d / "worker.py"
    script.write_text(_WORKER)
    return _Gang(script, d, runs, CKPT_RUN), d, inits, trainers


@pytest.fixture(scope="module")
def jax_runs(started):
    out = {}
    for family, t in started[3].items():
        t.train()
        out[family] = (np.array(t.losses()),
                       jax.device_get(t.state.params))
        t.close()
    return out


@pytest.fixture(scope="module")
def gang(started, jax_runs):
    handle, d, inits, _ = started
    return handle.ranks(), d, inits


def _params_close(got, want, init):
    assert sorted(got) == sorted(want)
    moved = 0.0
    for k, b in want.items():
        a, b = got[k].float().numpy(), b.float().numpy()
        if k.endswith("attn.key.bias"):
            # no gradient in exact arithmetic: each side's adam steps on
            # rounding noise, up to ~lr (tests/test_torch_bert.py)
            assert np.abs(a).max() <= 1e-2 and np.abs(b).max() <= 1e-2, k
            continue
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=PARAM_TOL * np.abs(b).max(),
                                   err_msg=k)
        moved = max(moved, float(np.abs(b - init[k].float().numpy()).max()))
    assert moved > 1e-6


@pytest.mark.parametrize("name", list(RUNS))
def test_tensor_runs_match_the_jax_trainer(gang, jax_runs, name):
    ranks, d, inits = gang
    family, ov = RUNS[name]
    j_losses, j_final = jax_runs[family]
    for r in ranks:
        mesh = json.loads(str(r[f"{name}/mesh"]))
        assert mesh["tensor"] == int(ov["mesh.tensor"]), mesh
        np.testing.assert_allclose(r[f"{name}/losses"], j_losses,
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert json.loads(str(r[f"{name}/split"])), name  # it cut layers
    got = read_full_params(d / f"ckpt_{name}")
    _params_close(got, _to_port(family, j_final),
                  _to_port(family, inits[family]))


@pytest.mark.parametrize("name", list(RUNS))
def test_whole_leaves_stay_equal_on_the_tensor_ranks(gang, name):
    """The leaves the rules leave whole (norms, the row-parallel and
    q/k/v biases, the router) end the run equal, bit for bit, on every
    tensor rank of a data (and expert) coordinate: their gradients were."""
    ranks, _, _ = gang
    t = int(RUNS[name][1]["mesh.tensor"])
    pre = f"{name}/whole/"
    keys = [k for k in ranks[0] if k.startswith(pre)]
    assert keys
    for start in range(0, WORLD, t):
        for r in range(start + 1, start + t):
            for k in keys:
                np.testing.assert_array_equal(ranks[r][k], ranks[start][k],
                                              err_msg=f"{k} rank {r}")


def test_megatron_collectives_one_forward_and_backward(gang):
    """A block all-reduces twice forward (after attention and after the
    MLP) and, backward, into its attention's and its MLP's input and once
    for each of its q/k/v biases; the two vocab-split embeddings reduce
    forward; the head gathers its logits forward and reduces into its
    input backward. No other collective runs."""
    ranks, _, _ = gang
    L = LM["num_layers"]
    for r in ranks:
        assert list(r["collectives/forward"]) == (
            ["all_reduce"] * (2 + 2 * L) + ["all_gather"])
        assert list(r["collectives/backward"]) == (
            ["all_reduce"] * (1 + 5 * L))


def test_whole_leaves_get_the_same_gradient_on_each_tensor_rank(gang):
    ranks, _, _ = gang
    by = {(int(r["data_index"]), int(r["tensor_index"])): r for r in ranks}
    keys = [k for k in ranks[0] if k.startswith("grad/")]
    assert any(k.endswith("ln1.scale") for k in keys)
    assert any(k.endswith("mlp_out.bias") for k in keys)
    for data in (0, 1):
        for k in keys:
            np.testing.assert_array_equal(by[(data, 1)][k], by[(data, 0)][k],
                                          err_msg=k)
    assert float(ranks[0]["collectives/loss"]) == float(
        ranks[3]["collectives/loss"])


def test_tensor_checkpoint_resumes_bit_for_bit_and_refuses_another_layout(
        gang):
    """The resume on the same layout bit for bit; the same checkpoint
    (tensor 2 x fsdp 2, ZeRO-3, at step 2) resumed on tensor 2 x data 2
    reshards on read and continues the straight run, to the JAX checkpoint
    test's tolerances (it was refused before resharding was ported)."""
    ranks, _, _ = gang
    for r in ranks:
        resume = r[f"{CKPT_RUN}/resume"]
        assert int(resume[0]) == 2 and resume[1:].all(), resume
        data_step, resharded = r[f"{CKPT_RUN}/other_layout"]
        assert int(data_step) == 2 and int(resharded) == 1
        straight = r[f"{CKPT_RUN}/losses"]
        np.testing.assert_allclose(r[f"{CKPT_RUN}/other_losses"],
                                   straight[2:], rtol=2e-5, atol=1e-5)
        assert len(straight) > 2

"""Port parity of resuming onto another layout (``train/checkpoint.py``:
a checkpoint restores into the template's layout, as orbax reshards on
read), against the straight runs and the JAX package.

One 4-rank gloo gang trains each source layout 2 steps of 4 from the
port's seeded init (carried into the JAX Trainer by ``utils.interop``) and
saves at step 2, then resumes some of those checkpoints on another layout
of 4 ranks; this process resumes others at world 1. Every resumed run restores
``data_step`` 2 (no batch replayed) and its steps 3 and 4 continue the
straight run: the losses to the JAX test's tolerances (rtol 2e-5, atol
1e-5), as JAX ``tests/test_checkpoint.py::test_restore_across_topology``
holds its resumed run.

- Llama (``llama3_8b_zero`` at the tiny dims of ``test_torch_zero.py``,
  where ZeRO splits the token table, the head and the MLP kernels;
  adamw, warmup 1): dp on data 4 -> ZeRO-3 on fsdp 4 (the counterpart of
  the JAX test), against the JAX ``Trainer``'s straight run and the
  port's; ZeRO-3 -> replicated (world 1); ZeRO-1 -> ZeRO-3 and ZeRO-3 ->
  ZeRO-1 on fsdp 4; ZeRO-3 on data 4 -> data 2 x fsdp 2; tensor 2 x data
  2 -> world 1. The resumed parameters and moments are the source's,
  resharded: a world-1 restore equals ``read_full_params``.
- The MoE LM (``moe_lm_ep`` tiny) on expert 2 x data 2 -> world 1,
  from the port's seeded init carried into the JAX ``Trainer``: the
  source's losses and the resumed run's against the JAX straight run.
- The Llama on a pipeline (pipe 2 x data 2) onto a replicated run: the
  JAX package stacks the stages (its checkpoint of them fails to restore
  into the dp state), and the port raises ``LayoutError`` saying so.
"""

import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train import trainer as jtrainer
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
    LayoutError,
    read_full_params,
)
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_to_jax,
    params_to_jax,
)
from test_torch_pipeline import _Gang
from test_torch_zero_seq import compiled_init

STEPS, SPLIT = 4, 2
RTOL, ATOL = 2e-5, 1e-5  # JAX tests/test_checkpoint.py's
LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             mlp_dim=256, vocab_size=512)
MOE = dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64, num_experts=4,
           capacity_factor=2.0, vocab_size=128, max_len=64)
# layout -> the mesh and strategy overrides of a Llama run
LAYOUTS = {
    "single": {"parallel.strategy": "single"},
    "dp4": {"parallel.strategy": "dp", "mesh.data": "4"},
    "zero1_f4": {"parallel.zero_stage": "1", "mesh.fsdp": "4"},
    "zero3_f4": {"mesh.fsdp": "4"},
    "zero3_d4": {"mesh.data": "4"},
    "zero3_d2f2": {"mesh.data": "2", "mesh.fsdp": "2"},
    "tp2_d2": {"parallel.strategy": "dp", "mesh.tensor": "2",
               "mesh.data": "2"},
}
# the gang's resumes: target layout <- source layout
GANG_PAIRS = {"zero3_f4": "dp4", "zero3_f4_from_zero1": "zero1_f4",
              "zero1_f4": "zero3_f4", "zero3_d2f2": "zero3_d4"}
# this process's resumes at world 1: source layouts
WORLD1_SOURCES = ("zero3_f4", "tp2_d2")


def _llama(layout, steps=STEPS):
    return {"steps": str(steps), "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "8", "data.seq_len": "16",
            "data.vocab_size": "512", "model.extra": json.dumps(LLAMA),
            "model.compute_dtype": "float32", "xent_chunk": "8",
            "optim.warmup_steps": "1", "parallel.strategy": "zero",
            "parallel.zero_stage": "3", "mesh.fsdp": "1", "mesh.data": "1",
            **LAYOUTS[layout]}


def _moe(expert):
    return {"steps": str(STEPS), "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "8", "data.seq_len": "16",
            "data.vocab_size": "128", "model.extra": json.dumps(MOE),
            "model.compute_dtype": "float32", "optim.warmup_steps": "1",
            "mesh.expert": str(expert), "mesh.data": str(expert)}


def _pipe():
    """The Llama on pipe 2 x data 2 (gpipe, 2 microbatches; the pipeline
    takes no chunked loss)."""
    return dict(_llama("single"), **{
        "parallel.strategy": "pipeline", "mesh.pipe": "2", "mesh.data": "2",
        "parallel.microbatches": "2", "xent_chunk": "0"})


_WORKER = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out_dir, jobs = sys.argv[1], json.loads(sys.argv[2])
bootstrap.initialize("cpu")
res = {}
for name, job in jobs.items():
    params = None
    if job.get("init"):
        params = {k: torch.from_numpy(v)
                  for k, v in np.load(job["init"]).items()}
    ov = dict(job["ov"])
    if job.get("save"):  # the source: 2 steps, saved at step 2
        ov.update(checkpoint_dir=job["save"], checkpoint_every="2")
    if job.get("resume"):
        ov.update(checkpoint_dir=job["resume"])
    with Trainer(get_config(job["preset"], **ov), device="cpu",
                 params=params) as t:
        res[f"{name}/data_step"] = np.array(t.data_step)
        res[f"{name}/restore"] = json.dumps(
            t.ckpt.last_restore if t.ckpt else {})
        t.train(steps=2 if job.get("save") else None)
    res[f"{name}/losses"] = np.array(t.losses())
np.savez(f"{out_dir}/rank{cc.rank()}.npz", **res)
bootstrap.shutdown()
"""


def _port_init(preset="llama3_8b_zero", ov=None):
    """The port's seeded initial weights of ``preset`` (flax names)."""
    cfg = get_config(preset, **(ov or _llama("single")))
    model = get_model(cfg.model, device="cpu")
    model.init_params(seed=cfg.seed)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _jax_moe(init):
    """The JAX ``moe_lm_ep`` Trainer's straight run on one device from
    ``init`` (its losses)."""
    cfg = jconfig.get_config("moe_lm_ep", **_moe(1))
    trainer = jtrainer.Trainer(cfg, mesh=make_mesh(
        cfg.mesh.resolve(1), devices=jax.devices()[:1]))
    trainer.state = trainer.state.replace(params=jax.tree.map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        params_to_jax(init), trainer.state.params))
    trainer.train()
    trainer.close()
    return np.array(trainer.losses())


def _jax_pipe_refusal(dp, model, root):
    """What the JAX package raises restoring a pipe-2 checkpoint of
    ``model`` into its dp state ``dp``: the state a pipeline Trainer
    saves, the stages' blocks stacked by ``stack_stage_params`` (as
    ``restore_unstacked_params`` builds it, no pipeline mesh needed),
    written by its ``CheckpointManager``, whose restore (the JAX
    Trainer's) falls back past every step that fails. None if it
    restores."""
    from pytorch_distributed_nn_tpu.parallel.pipeline import (
        partition_for,
        stack_stage_params,
    )
    from pytorch_distributed_nn_tpu.train.checkpoint import (
        CheckpointManager as JCheckpointManager,
    )
    from pytorch_distributed_nn_tpu.train.state import TrainState

    stacked = TrainState.create(
        apply_fn=dp.apply_fn, tx=dp.tx, rng=jax.random.key(1),
        params=stack_stage_params(jax.device_get(dp.params),
                                  partition_for(model), 2))
    mgr = JCheckpointManager(root, async_save=False)
    try:
        mgr.save(stacked, data_step=0)
        mgr.wait()
        try:
            mgr.restore(dp)
        except Exception as e:  # noqa: BLE001 -- whatever it raises
            return [type(e).__name__, str(e)]
    finally:
        mgr.close()
    return None


def _jax_llama(init, root, pool):
    """The JAX ``Trainer``'s straight run on one device from ``init`` (its
    losses), and :func:`_jax_pipe_refusal` of its state, on ``pool``
    while it trains."""
    cfg = jconfig.get_config("llama3_8b_zero", **_llama("single"))
    trainer = jtrainer.Trainer(cfg, mesh=make_mesh(
        cfg.mesh.resolve(1), devices=jax.devices()[:1]))
    trainer.state = trainer.state.replace(params=jax.tree.map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        llama_params_to_jax(init), trainer.state.params))
    # a copy: the step donates the state's buffers
    refused = pool.submit(_jax_pipe_refusal, jax.tree.map(
        lambda x: x.copy(), trainer.state), trainer.model, root)
    trainer.train()
    trainer.close()
    return np.array(trainer.losses()), refused.result()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every source and every 4-rank resume on one gang, from the port's
    initial weights; the gang runs while the JAX runs do."""
    d = tmp_path_factory.mktemp("reshard_gang")
    init = _port_init()
    path = str(d / "init.npz")
    np.savez(path, **{k: v.numpy() for k, v in init.items()})
    jobs = {"straight_dp4": {"preset": "llama3_8b_zero", "init": path,
                             "ov": _llama("dp4")}}
    for layout in sorted({*GANG_PAIRS.values(), *WORLD1_SOURCES}):
        jobs[f"src_{layout}"] = {"preset": "llama3_8b_zero", "init": path,
                                 "ov": _llama(layout),
                                 "save": str(d / f"ckpt_{layout}")}
    moe = _port_init("moe_lm_ep", _moe(1))
    moe_path = str(d / "moe_init.npz")
    np.savez(moe_path, **{k: v.numpy() for k, v in moe.items()})
    jobs["src_moe"] = {"preset": "moe_lm_ep", "init": moe_path,
                       "ov": _moe(2), "save": str(d / "ckpt_moe")}
    jobs["src_pipe"] = {"preset": "llama3_8b_zero", "init": path,
                        "ov": _pipe(), "save": str(d / "ckpt_pipe")}
    for target, source in GANG_PAIRS.items():
        jobs[f"to_{target}"] = {"preset": "llama3_8b_zero", "init": path,
                                "ov": _llama(target.split("_from")[0]),
                                "resume": str(d / f"ckpt_{source}")}
    script = d / "worker.py"
    script.write_text(_WORKER)
    return _Gang(script, d, jobs), d, path, init, moe


@pytest.fixture(scope="module")
def jax_runs(started):
    """The JAX straight run's losses, what the JAX pipeline checkpoint's
    restore onto dp raised, and the JAX MoE straight run's losses (the
    three on threads of their own: they compile at once)."""
    with compiled_init(), ThreadPoolExecutor(2) as pool:
        moe = pool.submit(_jax_moe, started[4])
        llama = _jax_llama(started[3], started[1] / "jax_pipe", pool)
        return (*llama, moe.result())


@pytest.fixture(scope="module")
def jax_losses(jax_runs):
    return jax_runs[0]


@pytest.fixture(scope="module")
def gang(started, jax_runs):
    handle, d, path = started[:3]
    return handle.ranks(), d, path


def _world1(d, preset, ov, source, init=None):
    """A world-1 Trainer resumed from a copy of ``source``'s checkpoint
    (the copy keeps the gang's directory as it was)."""
    ckpt = d / f"w1_{source}"
    if not ckpt.exists():
        shutil.copytree(d / f"ckpt_{source}", ckpt)
    params = None if init is None else {
        k: torch.from_numpy(v) for k, v in np.load(init).items()}
    return Trainer(get_config(preset, **dict(ov, checkpoint_dir=str(ckpt))),
                   device="cpu", params=params)


def _continues(got, straight):
    assert len(got) == STEPS - SPLIT
    np.testing.assert_allclose(got, straight[SPLIT:], rtol=RTOL, atol=ATOL)


def test_dp_resumes_onto_zero3(gang, jax_losses):
    """The counterpart of the JAX ``test_restore_across_topology``: dp on
    data 4 saved at step 2, resumed on ZeRO-3 over fsdp 4."""
    ranks, _, _ = gang
    for r in ranks:
        src = r["src_dp4/losses"]
        np.testing.assert_allclose(src, jax_losses[:SPLIT], rtol=RTOL,
                                   atol=ATOL)
        assert int(r["to_zero3_f4/data_step"]) == SPLIT
        restore = json.loads(str(r["to_zero3_f4/restore"]))
        assert restore["resharded"] and restore["step"] == SPLIT
        got = r["to_zero3_f4/losses"]
        _continues(got, jax_losses)
        _continues(got, r["straight_dp4/losses"])
        np.testing.assert_allclose(np.concatenate([src, got]), jax_losses,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("target", ["zero3_f4_from_zero1", "zero1_f4",
                                    "zero3_d2f2"])
def test_zero_resumes_onto_another_zero_layout(gang, jax_losses, target):
    """ZeRO-1 -> ZeRO-3 and ZeRO-3 -> ZeRO-1 on fsdp 4, ZeRO-3 on data 4
    -> data 2 x fsdp 2."""
    ranks, _, _ = gang
    for r in ranks:
        assert int(r[f"to_{target}/data_step"]) == SPLIT
        assert json.loads(str(r[f"to_{target}/restore"]))["resharded"]
        _continues(r[f"to_{target}/losses"], jax_losses)


@pytest.mark.parametrize("source", WORLD1_SOURCES)
def test_sharded_resumes_at_world_one(gang, jax_losses, source):
    """ZeRO-3 on fsdp 4 and tensor 2 x data 2 resumed by one process
    (replicated): the restored parameters are ``read_full_params`` of the
    checkpoint, and the run continues the straight one."""
    ranks, d, path = gang
    np.testing.assert_allclose(ranks[0][f"src_{source}/losses"],
                               jax_losses[:SPLIT], rtol=RTOL, atol=ATOL)
    full = read_full_params(d / f"ckpt_{source}")
    with _world1(d, "llama3_8b_zero", _llama("single"), source, path) as t:
        assert t.data_step == SPLIT and t.ckpt.last_restore["resharded"]
        live = t.model.state_dict()
        assert sorted(live) == sorted(full)
        for k, v in full.items():
            assert torch.equal(live[k], v), k
        t.train()
    _continues(np.array(t.losses()), jax_losses)


def test_expert_split_resumes_at_world_one(gang, jax_runs):
    """The MoE LM on expert 2 x data 2 saved at step 2, resumed by one
    process (every expert whole), against the JAX Trainer's straight
    world-1 run from the same weights."""
    ranks, d, _ = gang
    straight = jax_runs[2]
    for r in ranks:
        np.testing.assert_allclose(r["src_moe/losses"], straight[:SPLIT],
                                   rtol=RTOL, atol=ATOL)
    with _world1(d, "moe_lm_ep", _moe(1), "moe") as t:
        assert t.data_step == SPLIT and t.ckpt.last_restore["resharded"]
        t.train()
    _continues(np.array(t.losses()), straight)


def test_pipeline_onto_another_layout_is_refused_in_both(gang, jax_runs):
    """A pipeline's checkpoint onto ``dp``: the JAX package fails to
    restore its stacked stages (every kept step fails), the port raises
    ``LayoutError`` naming the JAX Trainer's rule."""
    _, d, _ = gang
    with pytest.raises(LayoutError, match="JAX Trainer restores a "
                       "pipeline's stacked stages only onto the same"):
        _world1(d, "llama3_8b_zero", _llama("single"), "pipe")
    name, message = jax_runs[1]
    assert name == "RuntimeError" and "failed to restore" in message

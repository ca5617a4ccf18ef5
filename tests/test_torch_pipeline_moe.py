"""Port parity of the pipeline over the MoE LM (``parallel/pipeline.py``
with ``models/moe_lm.py``): 4 gloo ranks (one ``torchrun`` gang a file
for its configurations) against the JAX pipeline and the JAX ``Trainer``
on one device, as ``tests/test_pipeline.py`` holds the JAX pipeline. This
file holds the ``moe_every`` 1 runs on pipe 4, the aux terms and the
refusals; ``test_torch_pipeline_moe_ep.py`` the ``moe_every`` 2 runs, the
expert axis and the resume, with the helpers here.

Tiny dims, the JAX tests' ``TINY_MOE``: 4 layers (8 for the interleaved
runs), d 32, 4 experts of MLP 64, top-2, capacity 2.0, routing groups of
16 (one sequence), T 16, vocab 101, batch 16, 4 microbatches, f32, no
remat, 3 steps of the preset's adam (warmup 1). The weights are the JAX
init, carried by ``utils.interop``.

- ``moe_every`` 1 under gpipe, 1f1b (pipe 4) and interleaved (pipe 4,
  2 chunks of 8 layers); ``moe_every`` 2 under 1f1b and interleaved
  (pipe 2 x data 2); pipe 2 x expert 2 (gpipe, and 1f1b with
  ``moe_every`` 2): losses, the load-balance terms included, within 1e-5
  relative of the JAX pipeline's and of the JAX single-device run's; the
  parameters after the steps within 1e-4 of each leaf's largest |value|
  (the attention key biases, whose gradient is zero in exact arithmetic,
  to the lr's scale). Under the expert axis each rank holds E/2 experts
  of each MoE layer of its stage: the slices at its expert coordinate.
- The aux terms reach the objective once: a run with ``aux_loss_weight``
  0 differs by the terms' size, and the run with them matches the JAX
  losses. The pipeline's evaluation (the terms left out) against the JAX
  pipeline's and the replicated evaluation of the same parameters: loss
  within 1e-5 relative, accuracy within 1e-6.
- A stage (or chunk) whose blocks do not divide by ``moe_every`` is
  refused before any work, with the JAX package's message; a MoE
  placement off the period is refused.
- 1f1b on pipe 2 x expert 2 with a checkpoint every 2 steps: the parts
  are ``pipe<d>-expert<e>``, a resumed Trainer is bit for bit the
  straight run, and ``read_full_params`` reads the whole model, equal to
  the straight run's.

Every subprocess has a hard timeout, so a hang fails the test.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch.utils.interop import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 420
STEPS = 3
LR = 3e-4  # the preset's peak lr
E = 4  # experts
TINY_MOE = dict(num_layers=4, d_model=32, num_heads=2, mlp_dim=64,
                vocab_size=101, max_len=64, num_experts=E, k=2,
                capacity_factor=2.0, group_size=16, moe_every=1)
MOE2 = dict(TINY_MOE, moe_every=2)
# name -> (extra, schedule, pipe_chunks, mesh {pipe, data, expert})
GOLDEN = {
    "moe1_gpipe": (TINY_MOE, "gpipe", 1, dict(pipe=4, data=1, expert=1)),
    "moe1_1f1b": (TINY_MOE, "1f1b", 1, dict(pipe=4, data=1, expert=1)),
    "moe1_interleaved": (dict(TINY_MOE, num_layers=8), "interleaved", 2,
                         dict(pipe=4, data=1, expert=1)),
    "moe2_1f1b": (MOE2, "1f1b", 1, dict(pipe=2, data=2, expert=1)),
    "moe2_interleaved": (dict(MOE2, num_layers=8), "interleaved", 2,
                         dict(pipe=2, data=2, expert=1)),
    "ep_gpipe": (TINY_MOE, "gpipe", 1, dict(pipe=2, data=1, expert=2)),
    "ep_moe2_1f1b": (MOE2, "1f1b", 1, dict(pipe=2, data=1, expert=2)),
}


def _key(extra):
    """The single-device run a configuration is held to."""
    return f"e{extra['moe_every']}_l{extra['num_layers']}"


def _overrides(extra, schedule="gpipe", chunks=1, steps=STEPS, pipe=4,
               data=1, expert=1, strategy="pipeline"):
    """The preset at tiny dims, as both packages take it."""
    return {"steps": str(steps), "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "16", "data.seq_len": "16",
            "data.vocab_size": "101", "model.name": "moe_lm",
            "model.extra": json.dumps(extra),
            "model.compute_dtype": "float32", "model.remat": "false",
            "optim.warmup_steps": "1", "parallel.microbatches": "4",
            "parallel.strategy": strategy,
            "parallel.pipeline_schedule": schedule,
            "parallel.pipe_chunks": str(chunks), "mesh.pipe": str(pipe),
            "mesh.data": str(data), "mesh.expert": str(expert)}


def _jax_trainer(ov, n):
    cfg = jconfig.get_config("transformer_lm_pp", **ov)
    return JTrainer(cfg, mesh=make_mesh(cfg.mesh.resolve(n),
                                        devices=jax.devices()[:n]))


def _jax_single(extra):
    """The JAX single-device run: (initial params, losses, final params)."""
    trainer = _jax_trainer(_overrides(extra, pipe=1, strategy="single"), 1)
    init = jax.device_get(trainer.state.params)  # before donation
    trainer.train()
    final = jax.device_get(trainer.state.params)
    trainer.close()
    return init, np.array(trainer.losses()), final


def _jax_pipeline(extra, schedule, chunks, mesh):
    """The JAX pipeline: (losses, the final params unstacked, its
    evaluation's (loss, accuracy) over 2 batches)."""
    from pytorch_distributed_nn_tpu.parallel.pipeline import (
        partition_for,
        unstack_stage_params,
    )

    trainer = _jax_trainer(_overrides(extra, schedule, chunks, **mesh), 4)
    trainer.train()
    ev = trainer.evaluate(num_batches=2)
    flat = unstack_stage_params(jax.device_get(trainer.state.params),
                                partition_for(trainer.model),
                                n_chunks=chunks,
                                chunked=schedule == "interleaved")
    trainer.close()
    return np.array(trainer.losses()), flat, (ev.loss, ev.accuracy)


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
rank = cc.rank()


def trainer(ov, init, ckpt=None):
    ov = dict(ov)
    if ckpt:
        ov.update({"checkpoint_dir": ckpt, "checkpoint_every": "2"})
    params = None
    if init:
        params = {k: torch.from_numpy(v) for k, v in np.load(init).items()}
    return Trainer(get_config("transformer_lm_pp", **ov), device="cpu",
                   params=params)


res = {}
for name, run in runs.items():
    ckpt = run.get("ckpt")
    t = trainer(run["ov"], run.get("init"), ckpt and ckpt + "/straight")
    st = t.state.sharding
    res[f"{name}/coords"] = np.array([st.devices[0], st.expert.index])
    t.train()
    t.close()
    res[f"{name}/losses"] = np.array(t.losses())
    ev = t.evaluate(num_batches=2)
    res[f"{name}/eval"] = np.array([ev.loss, ev.accuracy])
    for k, v in t.model.state_dict().items():
        res[f"{name}/param/{k}"] = v.numpy()
    if ckpt:
        res[f"{name}/part"] = np.array(st.part_name)
        # 2 steps saved at step 2, then a fresh Trainer resumes there
        with trainer(run["ov"], run.get("init"), ckpt + "/resumed") as b:
            b.train(steps=2)
        with trainer(run["ov"], run.get("init"), ckpt + "/resumed") as c:
            resumed_from = c.data_step
            c.train()
        want, got = t.state.state_dict(), c.state.state_dict()
        res[f"{name}/resume"] = np.array([resumed_from] + [
            int(torch.equal(want[k], got[k])) for k in sorted(want)])
        res[f"{name}/resumed_losses"] = np.array(c.losses())
np.savez(f"{out_dir}/rank{rank}.npz", **res)
bootstrap.shutdown()
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    return env


class _Gang:
    """A ``torchrun`` gang of 4 gloo ranks started in the background (the
    JAX runs go on meanwhile); :meth:`ranks` waits for it, with a hard
    timeout, and returns each rank's results."""

    def __init__(self, script, out_dir, runs, nproc=4):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), str(script), str(out_dir),
               json.dumps(runs)]
        self.out_dir, self.nproc = Path(out_dir), nproc
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
            self._ranks = [dict(np.load(self.out_dir / f"rank{r}.npz",
                                        allow_pickle=True))
                           for r in range(self.nproc)]
        return self._ranks


def _save_init(path, init):
    sd = params_from_jax(init)
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return str(path)


def _jax_init(extra):
    """The JAX ``Trainer``'s initial weights (no step run)."""
    trainer = _jax_trainer(_overrides(extra, pipe=1, strategy="single"), 1)
    init = jax.device_get(trainer.state.params)
    trainer.close()
    return init


HERE = ("moe1_gpipe", "moe1_1f1b", "moe1_interleaved")


def _singles(names):
    return {_key(GOLDEN[n][0]): GOLDEN[n][0] for n in names}


def start_gang(tmp_path_factory, names, more_runs):
    """Configurations ``names`` (and ``more_runs(inits, dir)``'s) on one
    4-rank gang, started from the JAX initial weights; the gang runs while
    the JAX runs train."""
    d = tmp_path_factory.mktemp("pipe_moe_gang")
    inits = {k: _save_init(d / f"init_{k}.npz", _jax_init(extra))
             for k, extra in _singles(names).items()}
    runs = {name: {"ov": _overrides(extra, schedule, chunks, **mesh),
                   "init": inits[_key(extra)]}
            for name, (extra, schedule, chunks, mesh) in
            ((n, GOLDEN[n]) for n in names)}
    runs.update(more_runs(inits, d))
    script = d / "worker.py"
    script.write_text(_WORKER)
    return _Gang(script, d, runs), runs, d


def jax_runs_for(names):
    """The JAX single-device runs and the JAX pipelines of ``names``."""
    singles = {k: _jax_single(extra) for k, extra in _singles(names).items()}
    pipes = {name: _jax_pipeline(*GOLDEN[name]) for name in names}
    return singles, pipes


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return start_gang(tmp_path_factory, HERE, lambda inits, d: {
        "no_aux": {"ov": _overrides(dict(TINY_MOE, aux_loss_weight=0.0),
                                    "1f1b"),
                   "init": inits[_key(TINY_MOE)]}})


@pytest.fixture(scope="module")
def jax_runs(started):
    return jax_runs_for(HERE)


@pytest.fixture(scope="module")
def gang(started, jax_runs):
    handle, runs, d = started
    return handle.ranks(), runs, d


def _params(ranks, name, expert=1):
    """The whole model from every rank's stages; an expert-split leaf's
    slices concatenated in expert order (data replicas agree)."""
    pre = f"{name}/param/"
    pieces: dict[str, dict[int, np.ndarray]] = {}
    for r in ranks:
        e = int(r[f"{name}/coords"][1])
        for k, v in r.items():
            if k.startswith(pre):
                pieces.setdefault(k[len(pre):], {}).setdefault(e, v)
    out = {}
    for k, by_e in pieces.items():
        split = expert > 1 and k.rsplit(".", 1)[-1] in ("wi", "wo")
        out[k] = (np.concatenate([by_e[e] for e in range(expert)])
                  if split else by_e[0])
    return out


def _close_params(got, want, init):
    """Each parameter to 1e-4 of its largest |value| (key biases to the
    lr's scale), and the weights moved."""
    assert sorted(got) == sorted(want)
    moved = 0.0
    for k, b in want.items():
        a = np.asarray(got[k], np.float32)
        b = np.asarray(b, np.float32)
        if k.endswith("attn.key.bias"):
            assert np.abs(a).max() <= 3 * LR and np.abs(b).max() <= 3 * LR
            continue
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)
        moved = max(moved, float(np.abs(b - np.asarray(init[k])).max()))
    assert moved > 1e-5


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def check_schedule(gang, jax_runs, name, against):
    """Configuration ``name``'s losses and final parameters against the JAX
    single-device run or the JAX pipeline."""
    ranks, _, _ = gang
    singles, pipes = jax_runs
    extra, _, _, mesh = GOLDEN[name]
    init, j_losses, j_final = singles[_key(extra)]
    want = _flat(j_final)
    if against == "jax_pipeline":
        j_losses, flat, _ = pipes[name]
        want = _flat(flat)
    for r in ranks:  # every stage reports the reduced loss
        np.testing.assert_allclose(r[f"{name}/losses"], j_losses, rtol=1e-5)
    _close_params(_params(ranks, name, mesh["expert"]), want, _flat(init))


@pytest.mark.parametrize("against", ["jax_single", "jax_pipeline"])
@pytest.mark.parametrize("name", HERE)
def test_moe_schedule_matches_jax(gang, jax_runs, name, against):
    check_schedule(gang, jax_runs, name, against)


def check_eval(gang, jax_runs, name):
    """``PipelineStages.evaluate`` on the trained stages against the JAX
    pipeline's evaluation (which leaves the load-balance terms out) and
    against the port's replicated evaluation of the same parameters."""
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    ranks, runs, _ = gang
    _, _, (j_loss, j_acc) = jax_runs[1][name]
    extra, _, _, mesh = GOLDEN[name]
    for r in ranks:  # every stage reports the last one's
        loss, acc = r[f"{name}/eval"]
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
        assert acc == pytest.approx(j_acc, abs=1e-6)
    params = {k: torch.from_numpy(v) for k, v in
              _params(ranks, name, mesh["expert"]).items()}
    t = Trainer(get_config("transformer_lm_pp", **_overrides(
        extra, pipe=1, strategy="single")), device="cpu", params=params)
    want = t.evaluate(num_batches=2)
    np.testing.assert_allclose(ranks[0][f"{name}/eval"][0], want.loss,
                               rtol=1e-5)


@pytest.mark.parametrize("name", HERE)
def test_moe_pipeline_eval_matches_jax_and_leaves_the_aux_out(gang, jax_runs,
                                                             name):
    check_eval(gang, jax_runs, name)


def test_aux_terms_reach_the_pipeline_loss_once(gang, jax_runs):
    ranks, _, _ = gang
    with_aux = ranks[0]["moe1_1f1b/losses"]
    without = ranks[0]["no_aux/losses"]
    # 4 MoE layers of 0.01 x ~1: about 0.04 on a loss of ~4.6
    assert 0.02 < with_aux[0] - without[0] < 0.08
    # a factor of M (4) or of the stages (4) on the terms would miss
    singles, _ = jax_runs
    np.testing.assert_allclose(with_aux, singles[_key(TINY_MOE)][1],
                               rtol=1e-5)


def test_pipeline_refuses_stages_that_split_a_moe_group():
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    match = "not divisible by moe_every=2"
    # 4 layers over 4 stages: 1 a stage
    with pytest.raises(ValueError, match=match):
        Trainer(get_config("transformer_lm_pp", **_overrides(
            MOE2, "1f1b")), device="cpu")
    # 8 layers over 2 stages x 4 chunks: 1 a chunk
    with pytest.raises(ValueError, match=match):
        Trainer(get_config("transformer_lm_pp", **_overrides(
            dict(MOE2, num_layers=8), "interleaved", 4, pipe=2)),
            device="cpu")
    # the JAX package refuses the same stacking
    from pytorch_distributed_nn_tpu.models import get_model
    from pytorch_distributed_nn_tpu.parallel.pipeline import (
        partition_for,
        stack_stage_params,
    )

    cfg = jconfig.get_config("transformer_lm_pp", **_overrides(MOE2))
    model = get_model(cfg.model)
    params = model.init(jax.random.key(0), np.zeros((1, 8), np.int32),
                        train=False)["params"]
    with pytest.raises(ValueError, match=match):
        stack_stage_params(params, partition_for(model), 4)


def test_partition_takes_the_moe_cadence_and_refuses_another():
    from pytorch_distributed_nn_tpu_torch.config import ModelConfig
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.parallel.pipeline import (
        partition_for,
        stage_blocks,
    )

    model = get_model(ModelConfig(name="moe_lm", compute_dtype="float32",
                                  extra=dict(MOE2, num_layers=8)),
                      device="cpu")
    part = partition_for(model)
    assert part.period == 2 and part.block_names[-1] == "block7"
    assert stage_blocks(part, 2, 2, 1) == ["block2", "block3"]
    # a model whose MoE layers sit off the period
    model.block0.ffn_name, model.block1.ffn_name = "moe", None
    with pytest.raises(ValueError, match="period-2 pattern"):
        partition_for(model)

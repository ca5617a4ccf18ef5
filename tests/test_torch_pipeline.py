"""Port parity of the pipeline (``parallel/pipeline.py``): config 4's
strategy at tiny dims, the port's stages on 4 gloo ranks (one
``torchrun`` gang for every configuration) against the JAX package.

Tiny dims, the JAX tests' ``TINY_TLM``/``TINY_LLAMA``: 4 layers (8 for
the interleaved runs), d 32, T 16, vocab 101, batch 16, 4 microbatches,
f32, no remat, 3 steps of the preset's adam (warmup 1). The weights are
the JAX init, carried by ``utils.interop``.

- gpipe, 1f1b and interleaved (v 1 and v 2 on 8 layers) for the
  transformer LM and 1f1b for the Llama, on ``pipe = 4``: losses against
  the JAX ``Trainer`` on one device and against the JAX pipeline on 4 CPU
  devices to 1e-5 relative; the parameters after the steps (the JAX
  pipeline's stacked stages through ``interop.unstack_stage_params``) to
  1e-4 of each leaf's largest |value| (the attention key biases, whose
  gradient is zero in exact arithmetic, to the lr's scale).
- 1f1b with a masked loss (``mlm_synthetic``) against gpipe on
  ``pipe = 2 x data = 2``, and gpipe's and 1f1b's dropout masks (rate 0.2):
  the losses to 1e-5 relative.
- The pipeline's evaluation against the replicated evaluation of the same
  parameters: loss to 1e-5 relative, accuracy to 1e-6.
- The local transport (every stage in one process) against the gloo
  transport: losses and parameters bit for bit.
- 1f1b checkpoint and resume on the gang bit for bit, and the
  checkpoint's parameters read in one process (``read_full_params``)
  equal to the straight run's.
- 1f1b holds at most 2(S - s) - 1 microbatches on stage s.

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
from pytorch_distributed_nn_tpu_torch.train.checkpoint import read_full_params
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    params_from_jax,
    unstack_stage_params,
)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300
STEPS = 3
LR = 3e-4  # the preset's peak lr
TINY_TLM = dict(num_layers=4, d_model=32, num_heads=2, mlp_dim=64,
                vocab_size=101, max_len=64)
TINY_LLAMA = dict(num_layers=4, d_model=32, num_heads=4, num_kv_heads=2,
                  mlp_dim=64, vocab_size=101)
# name -> (model, extra, schedule, pipe_chunks); all on pipe = 4
GOLDEN = {
    "gpipe": ("transformer_lm", TINY_TLM, "gpipe", 1),
    "1f1b": ("transformer_lm", TINY_TLM, "1f1b", 1),
    "interleaved_v1": ("transformer_lm", dict(TINY_TLM, num_layers=8),
                       "interleaved", 1),
    "interleaved_v2": ("transformer_lm", dict(TINY_TLM, num_layers=8),
                       "interleaved", 2),
    "llama_1f1b": ("llama3_8b", TINY_LLAMA, "1f1b", 1),
}


def _overrides(model, extra, schedule="gpipe", chunks=1, steps=STEPS,
               pipe=4, data=1, dataset="lm_synthetic"):
    """The preset at tiny dims, as both packages take it."""
    return {"steps": str(steps), "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "16", "data.seq_len": "16",
            "data.vocab_size": "101", "data.dataset": dataset,
            "model.name": model, "model.extra": json.dumps(extra),
            "model.compute_dtype": "float32", "model.remat": "false",
            "optim.warmup_steps": "1", "parallel.microbatches": "4",
            "parallel.pipeline_schedule": schedule,
            "parallel.pipe_chunks": str(chunks), "mesh.pipe": str(pipe),
            "mesh.data": str(data)}


def _jax_run(model, extra, strategy, schedule="gpipe", chunks=1):
    ov = _overrides(model, extra, schedule, chunks)
    ov["parallel.strategy"] = strategy
    n = 4 if strategy == "pipeline" else 1
    if strategy != "pipeline":
        ov["mesh.pipe"] = "1"
    cfg = jconfig.get_config("transformer_lm_pp", **ov)
    mesh = make_mesh(cfg.mesh.resolve(n), devices=jax.devices()[:n])
    trainer = JTrainer(cfg, mesh=mesh)
    init = jax.device_get(trainer.state.params)  # before donation
    trainer.train()
    final = jax.device_get(trainer.state.params)
    trainer.close()
    return init, np.array(trainer.losses()), final


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
    t = trainer(run["ov"], run.get("init"),
                ckpt and ckpt + "/straight")
    t.train()
    t.close()
    res[f"{name}/losses"] = np.array(t.losses())
    res[f"{name}/live"] = np.array([t.state.sharding.peak_live[d]
                                    for d in t.state.sharding.devices])
    if run.get("eval"):
        ev = t.evaluate(num_batches=2)
        res[f"{name}/eval"] = np.array([ev.loss, ev.accuracy])
    for k, v in t.model.state_dict().items():
        res[f"{name}/param/{k}"] = v.numpy()
    if ckpt:
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


def _jax_init(model, extra):
    """The JAX ``Trainer``'s initial weights (no step run)."""
    ov = dict(_overrides(model, extra), **{"parallel.strategy": "single",
                                           "mesh.pipe": "1"})
    cfg = jconfig.get_config("transformer_lm_pp", **ov)
    trainer = JTrainer(cfg, mesh=make_mesh(cfg.mesh.resolve(1),
                                           devices=jax.devices()[:1]))
    init = jax.device_get(trainer.state.params)
    trainer.close()
    return init


SINGLES = {"tlm4": ("transformer_lm", TINY_TLM),
           "tlm8": ("transformer_lm", dict(TINY_TLM, num_layers=8)),
           "llama4": ("llama3_8b", TINY_LLAMA)}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every configuration on one 4-rank gang, started from the JAX
    initial weights; the gang runs while the JAX runs train."""
    d = tmp_path_factory.mktemp("pipe_gang")
    inits = {k: _save_init(d / f"init_{k}.npz", _jax_init(*v))
             for k, v in SINGLES.items()}
    runs = {}
    for name, (model, extra, schedule, chunks) in GOLDEN.items():
        runs[name] = {"ov": _overrides(model, extra, schedule, chunks),
                      "init": inits[_single_key(name)]}
    runs["1f1b"]["eval"] = True
    runs["ckpt_1f1b"] = {"ov": _overrides("transformer_lm", TINY_TLM,
                                          "1f1b", steps=4),
                         "init": inits["tlm4"], "ckpt": str(d / "ckpt")}
    for sched in ("gpipe", "1f1b"):
        runs[f"masked_{sched}"] = {"ov": _overrides(
            "transformer_lm", TINY_TLM, sched, pipe=2, data=2,
            dataset="mlm_synthetic")}
        runs[f"dropout_{sched}"] = {"ov": _overrides(
            "transformer_lm", dict(TINY_TLM, dropout=0.2), sched)}
    script = d / "worker.py"
    script.write_text(_WORKER)
    return _Gang(script, d, runs), runs, d


@pytest.fixture(scope="module")
def jax_runs(started):
    """The JAX single-device runs (one a model) and the JAX pipelines."""
    singles = {k: _jax_run(model, extra, "single")
               for k, (model, extra) in SINGLES.items()}
    pipes = {name: _jax_run(model, extra, "pipeline", schedule, chunks)
             for name, (model, extra, schedule, chunks) in GOLDEN.items()}
    return singles, pipes


def _single_key(name):
    model, extra, _, _ = GOLDEN[name]
    if model == "llama3_8b":
        return "llama4"
    return "tlm8" if extra["num_layers"] == 8 else "tlm4"


@pytest.fixture(scope="module")
def gang(started, jax_runs):
    """Each rank's results, the configurations and the gang's directory."""
    handle, runs, d = started
    return handle.ranks(), runs, d


def _params(ranks, name):
    """The whole model from every rank's stages (data replicas agree)."""
    out = {}
    pre = f"{name}/param/"
    for r in ranks:
        for k, v in r.items():
            if k.startswith(pre):
                out.setdefault(k[len(pre):], v)
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


@pytest.mark.parametrize("against", ["jax_single", "jax_pipeline"])
@pytest.mark.parametrize("name", list(GOLDEN))
def test_schedule_matches_jax(gang, jax_runs, name, against):
    ranks, _, _ = gang
    singles, pipes = jax_runs
    init, j_losses, j_final = singles[_single_key(name)]
    if against == "jax_single":
        want = _flat(j_final)
    else:
        _, j_losses, stacked = pipes[name]
        model, extra, schedule, chunks = GOLDEN[name]
        names = [f"{'layer' if model == 'llama3_8b' else 'block'}{i}"
                 for i in range(extra["num_layers"])]
        want = {k: v.numpy() for k, v in unstack_stage_params(
            stacked, names, chunks,
            chunked=schedule == "interleaved").items()}
    for r in ranks:  # every stage reports the reduced loss
        np.testing.assert_allclose(r[f"{name}/losses"], j_losses, rtol=1e-5)
    _close_params(_params(ranks, name), want, _flat(init))


def test_1f1b_masked_loss_matches_gpipe(gang):
    ranks, _, _ = gang
    g, f = ranks[0]["masked_gpipe/losses"], ranks[0]["masked_1f1b/losses"]
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(f, g, rtol=1e-5)


def test_gpipe_dropout_matches_1f1b(gang):
    ranks, _, _ = gang
    g, f = ranks[0]["dropout_gpipe/losses"], ranks[0]["dropout_1f1b/losses"]
    np.testing.assert_allclose(f, g, rtol=1e-5)
    # the masks are drawn: the run differs from the one without dropout
    assert np.abs(g - ranks[0]["gpipe/losses"]).max() > 1e-3


def test_pipeline_eval_matches_dp_eval(gang):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    ranks, runs, _ = gang
    ov = dict(runs["1f1b"]["ov"], **{"parallel.strategy": "single",
                                     "mesh.pipe": "1"})
    params = {k: torch.from_numpy(v) for k, v in _params(ranks,
                                                         "1f1b").items()}
    t = Trainer(get_config("transformer_lm_pp", **ov), device="cpu",
                params=params)
    want = t.evaluate(num_batches=2)
    for r in ranks:
        loss, acc = r["1f1b/eval"]
        np.testing.assert_allclose(loss, want.loss, rtol=1e-5)
        assert acc == pytest.approx(want.accuracy, abs=1e-6)


@pytest.mark.parametrize("name", ["1f1b", "interleaved_v2"])
def test_local_transport_matches_gloo_bit_for_bit(gang, name):
    """Every stage in this one process (the one-card run's transport)."""
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    ranks, runs, _ = gang
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each gang rank runs
    try:
        params = {k: torch.from_numpy(v)
                  for k, v in np.load(runs[name]["init"]).items()}
        t = Trainer(get_config("transformer_lm_pp", **runs[name]["ov"]),
                    device="cpu", params=params)
        assert t.mesh.pipe_local and t.state.sharding.devices == [0, 1, 2, 3]
        t.train()
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(t.losses(), ranks[0][f"{name}/losses"])
    got = {k: v.numpy() for k, v in t.model.state_dict().items()}
    want = _params(ranks, name)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_1f1b_resume_bit_for_bit_and_full_read(gang):
    ranks, _, d = gang
    for r in ranks:
        flags = r["ckpt_1f1b/resume"]
        assert flags[0] == 2 and flags[1:].all()
        np.testing.assert_array_equal(r["ckpt_1f1b/resumed_losses"],
                                      r["ckpt_1f1b/losses"][2:])
    full = read_full_params(d / "ckpt" / "straight")
    want = _params(ranks, "ckpt_1f1b")
    assert sorted(full) == sorted(want)
    for k, v in full.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_1f1b_holds_at_most_2_s_minus_s_minus_1_microbatches(gang):
    ranks, _, _ = gang
    S, M = 4, 4
    live = [int(r["1f1b/live"][0]) for r in ranks]  # a rank's one stage
    assert live == [min(M, 2 * (S - s) - 1) for s in range(S)]
    gp = [int(r["gpipe/live"][0]) for r in ranks]
    assert gp == [M] * S  # gpipe holds every microbatch


@pytest.mark.parametrize("override,match", [
    ({"mesh.pipe": "1"}, "mesh.pipe >= 2"),
    ({"data.batch_size": "12"}, "not divisible by 8 microbatches"),
    ({"parallel.grad_accum": "2"}, "microbatches its own schedule"),
    ({"xent_chunk": "8", "data.seq_len": "16"}, "xent_chunk is not"),
    ({"parallel.pipe_chunks": "2"}, "only takes effect"),
    ({"parallel.pipeline_schedule": "zigzag"}, "unknown pipeline_schedule"),
    ({"parallel.pipeline_schedule": "interleaved",
      "parallel.microbatches": "6"}, "divisible by stages"),
])
def test_pipeline_refuses_what_the_jax_package_refuses(override, match):
    from pytorch_distributed_nn_tpu_torch import config as tconfig
    from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
    from pytorch_distributed_nn_tpu_torch.train import losses as tlosses

    cfg = tconfig.get_config("transformer_lm_pp", **override)
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, tlosses.lm_xent)


def test_partition_refuses_indivisible_layers():
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch import config as tconfig
    from pytorch_distributed_nn_tpu_torch.parallel.pipeline import (
        partition_for,
        stage_blocks,
    )

    cfg = tconfig.get_config("transformer_lm_pp", **_overrides(
        "transformer_lm", TINY_TLM))
    part = partition_for(get_model(cfg.model, device="cpu"))
    assert stage_blocks(part, 2, 1, 1) == ["block2", "block3"]
    assert stage_blocks(part, 2, 2, 3) == ["block3"]
    with pytest.raises(ValueError, match="not divisible"):
        stage_blocks(part, 3, 1, 0)
    with pytest.raises(ValueError, match="TransformerLM/Llama"):
        partition_for(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("n_stages,n_chunks", [(2, 1), (4, 1), (2, 2),
                                               (4, 2)])
def test_stacked_tree_is_the_jax_stack(n_stages, n_chunks):
    """``interop.stack_stage_params`` of the port's names equals the JAX
    ``stack_stage_params`` of the same flax tree, and unstacks back."""
    from pytorch_distributed_nn_tpu.models import get_model as jget_model
    from pytorch_distributed_nn_tpu.parallel.pipeline import (
        partition_for as jpartition_for,
    )
    from pytorch_distributed_nn_tpu.parallel.pipeline import (
        stack_stage_params as jstack,
    )
    from pytorch_distributed_nn_tpu_torch.utils.interop import (
        stack_stage_params,
    )

    extra = dict(TINY_TLM, num_layers=8)
    cfg = jconfig.get_config("transformer_lm_pp", **_overrides(
        "transformer_lm", extra))
    model = jget_model(cfg.model)
    tree = jax.device_get(model.init(jax.random.key(0),
                                     np.zeros((1, 8), np.int32),
                                     train=False)["params"])
    want = jax.device_get(jstack(tree, jpartition_for(model), n_stages,
                                 n_chunks=n_chunks))
    names = [f"block{i}" for i in range(8)]
    sd = params_from_jax(tree)
    got = stack_stage_params(sd, names, n_stages, n_chunks)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = unstack_stage_params(got, names, n_chunks)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k

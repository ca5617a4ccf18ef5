"""Checkpoint and resume in the port (``train/checkpoint.py``, the
``Trainer``'s restore, save cadence and preemption notice) against the JAX
package's contract (``tests/test_checkpoint.py``).

The oracle: train 6 steps straight through against 3 steps, a save, a
fresh ``Trainer`` that resumes and 3 more steps. The data stream is keyed
by (seed, step), so a replayed or skipped batch would show at once.
``mlp_mnist`` at a tiny width (features (64, 10), batch 32, momentum with
a warmup and a cosine schedule so the lr moves every step), from the JAX
``Trainer``'s initial weights (``utils.interop``).

Tolerances: within the port, resume is bit for bit the straight run
(losses and every parameter, buffer and moment). Against the JAX
``Trainer``'s straight run: f32 losses to 1e-5 relative, as
``tests/test_torch_train.py`` holds the port's steps. A checkpoint written
by 2 gloo ranks and resumed by one process: the 2-rank steps' losses
agree with the one-process run to 8 float32 ULPs a step
(``tests/test_torch_dp.py``'s budget), checked here to 1e-6 relative.

Subprocesses have a hard timeout of 180 s, so a hang fails the test.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.runtime import failure
from pytorch_distributed_nn_tpu_torch.train import checkpoint as tckpt
from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    vision_params_from_jax,
)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 180
STEPS, SPLIT = 6, 3
OV = {"steps": str(STEPS), "log_every": "1", "data.prefetch": "0",
      "data.batch_size": "32", "model.extra": '{"features": [64, 10]}',
      "optim.warmup_steps": "2", "optim.schedule": "cosine"}


@pytest.fixture(scope="module")
def jax_run():
    cfg = jconfig.get_config("mlp_mnist", **OV)
    t = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=1),
                                     devices=jax.devices()[:1]))
    params = jax.device_get(t.state.params)
    t.train()
    t.close()
    return vision_params_from_jax(params, None), t.losses()


def _cfg(tmp_path, **ov):
    return tconfig.get_config(
        "mlp_mnist", **{**OV, "checkpoint_dir": str(tmp_path / "ckpt"),
                        **ov})


def _state_equal(a, b):
    sa, sb = a.state.state_dict(), b.state.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_resume_matches_the_straight_run(tmp_path, jax_run):
    init, j_losses = jax_run
    straight = Trainer(_cfg(tmp_path, checkpoint_dir=""), device="cpu",
                       params=init)
    straight.train()
    full = straight.losses()

    with Trainer(_cfg(tmp_path), device="cpu", params=init) as first:
        first.train(SPLIT)
        assert first.save_checkpoint()
    with Trainer(_cfg(tmp_path), device="cpu") as resumed:  # resume=True
        assert resumed.state.step == SPLIT and resumed.data_step == SPLIT
        assert resumed.state.optimizer.count == SPLIT
        resumed.train(STEPS - SPLIT)
    got = first.losses() + resumed.losses()
    assert got == full  # bit for bit in the port
    _state_equal(resumed, straight)
    np.testing.assert_allclose(got, j_losses, rtol=1e-5)


def test_resume_respects_the_total_step_budget(tmp_path, jax_run):
    with Trainer(_cfg(tmp_path), device="cpu", params=jax_run[0]) as first:
        first.train(SPLIT)
        first.save_checkpoint()
    with Trainer(_cfg(tmp_path), device="cpu") as resumed:
        resumed.train()  # no count: the remaining budget, as the CLI runs
    assert resumed.data_step == resumed.state.step == STEPS
    assert [r.step for r in resumed.history] == list(range(SPLIT, STEPS))
    # resume=False starts over
    with Trainer(_cfg(tmp_path, resume="false"), device="cpu") as fresh:
        assert fresh.data_step == fresh.state.step == 0


def test_periodic_saves_keep_the_newest_three(tmp_path):
    with Trainer(_cfg(tmp_path, checkpoint_every="1"), device="cpu") as t:
        t.train()
        t.ckpt.wait()
        assert t.ckpt.all_steps() == [4, 5, 6]
        assert t.ckpt.latest_step() == STEPS
        meta = json.loads((t.ckpt.directory / "6" / "meta.json").read_text())
        assert meta == {"data_step": 6, "step": 6}
        assert not t.ckpt.save(t.state, data_step=t.data_step)  # saved


def test_a_torn_latest_step_falls_back_to_the_one_before(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_every="2")
    with Trainer(cfg, device="cpu") as t:
        t.train(4)
    want = Trainer(_cfg(tmp_path, checkpoint_dir=""), device="cpu")
    want.train(2)
    torn = t.ckpt.directory / "4" / "model.pt"
    torn.write_bytes(torn.read_bytes()[: torn.stat().st_size // 2])
    with Trainer(cfg, device="cpu") as resumed:
        assert resumed.data_step == resumed.state.step == 2
        _state_equal(resumed, want)
        # an explicit step is restored as asked, or raises
        with pytest.raises(ValueError, match="manifest"):
            resumed.ckpt.restore(resumed.state, step=4)


def test_a_missing_step_or_directory_raises(tmp_path):
    mgr = CheckpointManager(tmp_path / "empty")
    assert mgr.latest_step() is None and mgr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore(None)
    with pytest.raises(FileNotFoundError):
        mgr.restore(None, step=7)
    mgr.close()


def test_an_async_save_holds_the_saved_step_under_in_place_updates(
        tmp_path, monkeypatch, jax_run):
    """The writer runs after the trainer has updated the state in place
    twice more: the file still holds step 2, and a trainer resumed from
    it trains on as the straight run does. (The cadence is then turned
    off: a second save would first wait for the held-back write.)"""
    init = jax_run[0]
    straight = Trainer(_cfg(tmp_path, checkpoint_dir=""), device="cpu",
                       params=init)
    straight.train()
    gate = threading.Event()
    save = torch.save

    def slow_save(obj, path):
        gate.wait(timeout=60)
        save(obj, path)

    monkeypatch.setattr(tckpt.torch, "save", slow_save)
    with Trainer(_cfg(tmp_path, checkpoint_every="2"), device="cpu",
                 params=init) as t:
        t.train(2)  # saves at 2, held back
        t.cfg.checkpoint_every = 0
        t.train(2)  # updates in place while the write waits
        gate.set()
    monkeypatch.setattr(tckpt.torch, "save", save)
    with Trainer(_cfg(tmp_path), device="cpu") as resumed:
        _, meta = resumed.ckpt.restore(resumed.state, step=2)
        resumed.data_step = meta["data_step"]
        resumed.train(STEPS - 2)
    assert resumed.losses() == straight.losses()[2:]
    _state_equal(resumed, straight)


def test_a_save_waits_for_the_previous_write(tmp_path, monkeypatch):
    """Saves at every step with a slow writer: each snapshot is taken
    only after the previous one is on disk, so at most one is alive."""
    alive, most = [0], [0]
    lock = threading.Lock()
    snapshot, write = tckpt._snapshot, CheckpointManager._write

    def counted_snapshot(state):
        with lock:
            alive[0] += 1
            most[0] = max(most[0], alive[0])
        return snapshot(state)

    def slow_write(self, *item):
        time.sleep(0.2)
        write(self, *item)
        with lock:
            alive[0] -= 1

    monkeypatch.setattr(tckpt, "_snapshot", counted_snapshot)
    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    with Trainer(_cfg(tmp_path, checkpoint_every="1"), device="cpu") as t:
        t.train(4)
    assert most[0] == 1 and alive[0] == 0
    assert t.ckpt.all_steps() == [2, 3, 4]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    return env


def _argv(cfg_ov: dict) -> list[str]:
    argv = ["--preset", "mlp_mnist", "--device", "cpu"]
    for k, v in {**OV, **cfg_ov}.items():
        argv += [f"--{k}", v]
    return argv


def test_a_checkpoint_of_two_ranks_resumes_in_one_process(tmp_path,
                                                          jax_run):
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m",
           "pytorch_distributed_nn_tpu_torch.train",
           *_argv({"steps": str(SPLIT), "checkpoint_dir": str(ckpt),
                   "checkpoint_every": str(SPLIT)})]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    two = json.loads(next(line for line in out.stdout.splitlines()
                          if line.startswith('{"losses"')))["losses"]
    assert CheckpointManager(ckpt).all_steps() == [SPLIT]
    with Trainer(_cfg(tmp_path), device="cpu") as resumed:
        assert resumed.data_step == SPLIT
        resumed.train()
    one = Trainer(_cfg(tmp_path, checkpoint_dir=""), device="cpu")
    one.train()
    np.testing.assert_allclose(two + resumed.losses(), one.losses(),
                               rtol=1e-6)


def test_sigterm_saves_and_exits_83_with_a_checkpoint_that_resumes(
        tmp_path):
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch.train",
           *_argv({"steps": "100000", "checkpoint_dir": str(ckpt)})]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(_env(), TPUNN_PREEMPT="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.monotonic() + TIMEOUT
        for line in proc.stderr:  # the log: wait until steps are running
            if "step 2 loss" in line or time.monotonic() > deadline:
                break
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == failure.GRACEFUL_EXIT_CODE, err[-3000:]
    mgr = CheckpointManager(ckpt)
    saved = mgr.latest_step()
    assert saved is not None and saved >= 3
    with Trainer(_cfg(tmp_path), device="cpu") as resumed:
        assert resumed.data_step == resumed.state.step == saved
        resumed.train(2)
    assert np.all(np.isfinite(resumed.losses()))


def test_the_preemption_handler_is_installed_only_when_asked(monkeypatch):
    monkeypatch.delenv(failure.ENV_PREEMPT, raising=False)
    assert not failure.install_preemption_handler()
    monkeypatch.setenv(failure.ENV_PREEMPT, "1")
    try:
        assert failure.install_preemption_handler()
        assert not failure.preempt_requested()
        os.kill(os.getpid(), signal.SIGTERM)  # a flag, not a kill
        assert failure.preempt_requested()
    finally:
        failure.uninstall_preemption_handler()
    assert not failure.preempt_requested()

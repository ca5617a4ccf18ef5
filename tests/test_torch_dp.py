"""Golden equivalence of the port's data parallelism on the CPU: the train
entry point under ``python -m torch.distributed.run --standalone
--nproc_per_node 2`` (gloo) against the one-process run of the same
preset, and the tiny ResNet's ``dp_explicit`` on 2 ranks against the JAX
package's ``dp_explicit`` on 2 CPU devices.

ULP budget (the one ``tests/test_dp_golden.py`` holds the JAX package
to): each step's loss within 8 float32 ULPs per elapsed step of the
one-process loss. Step 0:

- ``mlp_mnist`` (``dp`` and ``dp_explicit``): bitwise equal, as in the JAX
  package (each rank's mean over its 64 rows, then the mean of the two,
  rounds as the one-process mean over 128 does here).
- the tiny ResNet with ``dp`` (SyncBN): not bitwise. The BatchNorm sums are
  all-reduced across the ranks (two partial sums added) where one process
  sums all rows in one reduction, and the loss is the mean of two means;
  the float32 sums round otherwise. Step 0 is bounded by 4 ULPs, the later
  steps by the same 8 ULPs per step.

Against the JAX package (``dp_explicit``, BatchNorm statistics local to
each rank's 8 rows, the running statistics averaged): f32 losses to 1e-5
relative, parameters and running statistics after three steps to 1e-4, as
``tests/test_torch_vision.py`` holds the one-process runs.

Every subprocess has a hard timeout of 180 s, so a hang fails the test.
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
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 180
TINY = ('{"stage_sizes": [1, 1, 1, 1], "width": 8, "num_classes": 10, '
        '"bn_impl": "pallas"}')
RESNET = {"data.dataset": "cifar10", "data.batch_size": "16",
          "optim.warmup_steps": "0", "model.compute_dtype": "float32",
          "model.extra": TINY}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    return env


def _torchrun(args, cwd=ROOT):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", *args]
    out = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return out.stdout


def _argv(preset, steps, overrides):
    argv = ["--preset", preset, "--device", "cpu", "--steps", str(steps),
            "--log_every", "1"]
    for k, v in overrides.items():
        argv += [f"--{k}", v]
    return argv


def _losses(out):
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"losses"')]
    assert len(lines) == 1, out  # rank 0 alone prints
    return np.asarray(lines[0]["losses"], np.float32)


def _two_rank_losses(preset, steps, overrides):
    return _losses(_torchrun(["-m", "pytorch_distributed_nn_tpu_torch.train",
                              *_argv(preset, steps, overrides)]))


def _one_process_losses(preset, steps, overrides):
    """The same entry point in one process, with the ranks' thread count
    (a CPU matmul's summation order may follow it)."""
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch.train",
         *_argv(preset, steps, overrides)], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return _losses(out.stdout)


def ulp_distance(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("preset,steps,overrides,step0_ulps", [
    ("mlp_mnist", 6, {"parallel.strategy": "dp"}, 0),
    ("mlp_mnist", 6, {"parallel.strategy": "dp_explicit"}, 0),
    ("resnet50_dp", 4, {"parallel.strategy": "dp", **RESNET}, 4),
], ids=["mlp-dp", "mlp-dp_explicit", "tiny_resnet-dp_syncbn"])
def test_two_gloo_ranks_match_one_process(preset, steps, overrides,
                                          step0_ulps):
    one = _one_process_losses(preset, steps, overrides)
    two = _two_rank_losses(preset, steps, overrides)
    assert len(one) == len(two) == steps and np.all(np.isfinite(two))
    ulps = ulp_distance(two, one)
    budget = 8 * np.arange(steps)
    budget[0] = step0_ulps
    assert (ulps <= budget).all(), (ulps, budget, one, two)
    if preset == "mlp_mnist":
        assert two[-1] < two[0]


_WORKER = r"""
import sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap

init, out = np.load(sys.argv[1]), sys.argv[2]
overrides = dict(a.split("=", 1) for a in sys.argv[3:])
params = {k: torch.from_numpy(init[k]) for k in init.files}
trainer = Trainer(get_config("resnet50_dp", **overrides), device="cpu",
                  params=params)
trainer.train()
if trainer.is_coordinator:
    np.savez(out, losses=np.asarray(trainer.losses(), np.float32),
             **{k: v.detach().numpy() for k, v in
                trainer.model.state_dict().items()})
bootstrap.shutdown()
"""


def test_tiny_resnet_dp_explicit_matches_the_jax_package(tmp_path):
    from pytorch_distributed_nn_tpu_torch.utils.interop import (
        vision_params_from_jax,
        vision_params_to_jax,
    )

    ov = {"steps": "3", "log_every": "1", "data.prefetch": "0",
          "parallel.strategy": "dp_explicit", **RESNET}
    cfg = jconfig.get_config("resnet50_dp", **ov)
    jt = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=2),
                                      devices=jax.devices()[:2]))
    init = jax.device_get((jt.state.params,
                           jt.state.model_state["batch_stats"]))
    jt.train()
    j_losses = jt.losses()
    j_final = jax.device_get((jt.state.params,
                              jt.state.model_state["batch_stats"]))
    jt.close()
    np.savez(tmp_path / "init.npz", **{
        k: v.numpy() for k, v in vision_params_from_jax(*init).items()})
    (tmp_path / "worker.py").write_text(_WORKER)
    _torchrun([str(tmp_path / "worker.py"), str(tmp_path / "init.npz"),
               str(tmp_path / "out.npz"),
               *[f"{k}={v}" for k, v in ov.items()]])
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
    final = vision_params_to_jax(
        {k: torch.from_numpy(got[k]) for k in got.files
         if k != "losses"})
    for g, w in zip(final, j_final):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max())

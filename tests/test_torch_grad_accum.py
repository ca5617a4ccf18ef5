"""Gradient accumulation in the port (``parallel/zero.py``,
``parallel.grad_accum``) against the JAX package's ``step_accum``
(``tests/test_grad_accum.py``).

- ``mlp_mnist`` (features (64, 10), batch 32, 3 steps): accum 4 against
  accum 1 in the port, and against the JAX ``Trainer``'s accum-4 run from
  the same initial weights. The averaged gradient does not depend on the
  microbatches for a stateless model, so accum 4 and accum 1 differ by the
  f32 rounding of the sums: losses to 2e-5 relative (atol 1e-5), params to
  1e-4 (atol 1e-5), the JAX test's own bounds. Against the JAX accum-4
  run: losses to 1e-5, params to 1e-4 (``tests/test_torch_train.py``'s).
- The tiny ResNet (BatchNorm): the running statistics update once a
  microbatch, against the JAX accum-2 run (1e-5 / 1e-4), and they differ
  from accum 1's.
- BERT's masked LM (tiny): each microbatch is divided by its own count of
  valid tokens, against the JAX accum-2 run (1e-5).
- On 2 gloo ranks (one ``torch.distributed.run`` launch): overlap under
  accumulation bit for bit the reduce after the backward, for the MLP and
  for BERT's token-weighted loss (whose losses also match the JAX accum-2
  run on 2 CPU devices to 1e-5); and ``mesh.seq = 2`` with ring attention,
  accum 2 against accum 1 (the JAX test's 2e-5).
- The rejections of the JAX test: a batch that accum does not divide, and
  accumulation under the pipeline.

The subprocess has a hard timeout of 180 s, so a hang fails the test.
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
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
from pytorch_distributed_nn_tpu_torch.parallel.zero import split_microbatches
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    params_from_jax,
    vision_params_from_jax,
    vision_params_to_jax,
)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 180
MLP = {"steps": "3", "log_every": "1", "data.prefetch": "0",
       "data.batch_size": "32", "model.extra": '{"features": [64, 10]}'}
RESNET = {"steps": "3", "log_every": "1", "data.prefetch": "0",
          "data.dataset": "cifar10", "data.batch_size": "16",
          "optim.warmup_steps": "0", "model.compute_dtype": "float32",
          "model.extra": json.dumps({"stage_sizes": [1, 1, 1, 1], "width": 8,
                                     "num_classes": 10, "bn_impl": "pallas"})}
BERT = {"steps": "3", "log_every": "1", "data.prefetch": "0",
        "model.extra": json.dumps({"num_layers": 2, "d_model": 32,
                                   "num_heads": 4, "mlp_dim": 64,
                                   "vocab_size": 97, "max_len": 32}),
        "model.compute_dtype": "float32", "data.vocab_size": "97",
        "data.seq_len": "16", "data.batch_size": "8",
        "parallel.strategy": "dp"}


def _jax(preset, ov, accum, devices=1):
    cfg = jconfig.get_config(preset, **ov)
    cfg.parallel.grad_accum = accum
    t = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=devices),
                                     devices=jax.devices()[:devices]))
    init = jax.device_get((t.state.params,
                           t.state.model_state.get("batch_stats")))
    t.train()
    final = jax.device_get((t.state.params,
                            t.state.model_state.get("batch_stats")))
    t.close()
    return init, t.losses(), final


def _port(preset, ov, accum, params):
    cfg = tconfig.get_config(preset, **ov,
                             **{"parallel.grad_accum": str(accum)})
    t = Trainer(cfg, device="cpu", params=params)
    t.train()
    return t


def _close_trees(got, want, rtol, atol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_accum4_matches_accum1_and_the_jax_accum4_step():
    (params, _), j_losses, (j_final, _) = _jax("mlp_mnist", MLP, 4)
    init = vision_params_from_jax(params, None)
    one, four = (_port("mlp_mnist", MLP, a, init) for a in (1, 4))
    np.testing.assert_allclose(four.losses(), one.losses(), rtol=2e-5,
                               atol=1e-5)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(four.model.state_dict()[k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(four.losses(), j_losses, rtol=1e-5)
    got, _ = vision_params_to_jax(four.model.state_dict())
    _close_trees(got, j_final, 1e-4, 1e-6)
    assert four.state.step == 3 and four.state.optimizer.count == 3
    assert all(p.grad is None for p in four.model.parameters())


def test_batchnorm_updates_once_a_microbatch():
    (params, stats), j_losses, j_final = _jax("resnet50_dp", RESNET, 2)
    init = vision_params_from_jax(params, stats)
    two = _port("resnet50_dp", RESNET, 2, init)
    one = _port("resnet50_dp", RESNET, 1, init)
    np.testing.assert_allclose(two.losses(), j_losses, rtol=1e-5)
    got = vision_params_to_jax(two.model.state_dict())
    for g, w in zip(got, j_final):
        _close_trees(g, w, 1e-4, 1e-5)
    # two running-statistics updates a step, not one
    assert any(not torch.allclose(v, one.state.model_state[k], rtol=1e-4)
               for k, v in two.state.model_state.items())


def test_the_masked_lm_weights_each_microbatch_by_its_tokens():
    (params, _), j_losses, _ = _jax("bert_base_buckets", BERT, 2)
    two = _port("bert_base_buckets", BERT, 2, params_from_jax(params))
    np.testing.assert_allclose(two.losses(), j_losses, rtol=1e-5)


_WORKER = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out, runs = sys.argv[1], json.loads(sys.argv[2])
init = np.load(sys.argv[3])
bert = {k: torch.from_numpy(init[k]) for k in init.files}
res, rank = {}, None
for tag, (preset, ov) in runs.items():
    t = Trainer(get_config(preset, **ov), device="cpu",
                params=bert if preset == "bert_base_buckets" else None)
    rank = t.process.rank
    t.train()
    res[f"{tag}:losses"] = np.asarray(t.losses(), np.float32)
    for k, v in t.model.state_dict().items():
        res[f"{tag}:{k}"] = v.detach().numpy()
np.savez(f"{out}{rank}.npz", **res)
bootstrap.shutdown()
"""

LLAMA = {"steps": "3", "log_every": "1", "data.prefetch": "0",
         "mesh.seq": "2", "data.batch_size": "4", "data.seq_len": "32",
         "data.vocab_size": "97", "xent_chunk": "0",
         "model.compute_dtype": "float32", "model.remat": "false",
         "model.extra": json.dumps({"num_layers": 2, "d_model": 64,
                                    "num_heads": 4, "num_kv_heads": 2,
                                    "mlp_dim": 128, "vocab_size": 97,
                                    "attn_impl": "ring"})}
RUNS = {
    **{f"mlp:{a}": ("mlp_mnist", {**MLP, "parallel.grad_accum": "2",
                                   "parallel.overlap": str(a)})
       for a in (False, True)},
    **{f"bert:{a}": ("bert_base_buckets", {**BERT,
                                           "parallel.grad_accum": "2",
                                           "parallel.overlap": str(a)})
       for a in (False, True)},
    **{f"seq:{a}": ("llama3_longcontext", {**LLAMA,
                                           "parallel.grad_accum": str(a)})
       for a in (1, 2)},
}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    return env


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accum")
    (params, _), j_losses, _ = _jax("bert_base_buckets", BERT, 2, devices=2)
    np.savez(tmp / "init.npz", **{k: v.numpy() for k, v in
                                  params_from_jax(params).items()})
    (tmp / "worker.py").write_text(_WORKER)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", str(tmp / "worker.py"),
           str(tmp / "out"), json.dumps(RUNS), str(tmp / "init.npz")]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)], j_losses


def _by(res, tag):
    return {k[len(tag) + 1:]: v for k, v in res.items()
            if k.startswith(tag + ":")}


@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_overlap_under_accum_is_bitwise_the_reduce_after_the_backward(
        gloo_runs, model):
    ranks, _ = gloo_runs
    off, on = _by(ranks[0], f"{model}:False"), _by(ranks[0], f"{model}:True")
    assert sorted(off) == sorted(on) and len(off) > 3
    for k, v in off.items():
        np.testing.assert_array_equal(on[k], v, err_msg=k)
        np.testing.assert_array_equal(ranks[1][f"{model}:True:{k}"], v,
                                      err_msg=k)


def test_two_ranks_accum_matches_the_jax_trainer(gloo_runs):
    ranks, j_losses = gloo_runs
    np.testing.assert_allclose(ranks[0]["bert:True:losses"], j_losses,
                               rtol=1e-5)


def test_accum_composes_with_sequence_parallelism(gloo_runs):
    ranks, _ = gloo_runs
    two, one = ranks[0]["seq:2:losses"], ranks[0]["seq:1:losses"]
    assert len(two) == 3 and np.all(np.isfinite(two))
    np.testing.assert_allclose(two, one, rtol=2e-5)
    np.testing.assert_array_equal(ranks[1]["seq:2:losses"], two)


def test_a_batch_accum_does_not_divide_is_rejected():
    cfg = tconfig.get_config("mlp_mnist", **{"parallel.grad_accum": "3"})
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(cfg, lambda a, b: 0.0)  # batch 128 % 3 != 0
    # rows a rank holds that accum does not divide: the JAX fallback to
    # chunks of the global batch would need another rank's rows
    with pytest.raises(ValueError, match="other ranks"):
        split_microbatches(torch.zeros(6, 2), 4)
    assert [c.shape[0] for c in split_microbatches(torch.zeros(8, 2), 4)] \
        == [2, 2, 2, 2]


def test_accum_is_rejected_under_the_pipeline():
    cfg = tconfig.get_config("mlp_mnist", **{"parallel.strategy": "pipeline",
                                             "parallel.grad_accum": "2"})
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(cfg, lambda a, b: 0.0)

"""Port parity for the data-parallel vision slice's Trainer (the
forwards, datasets and optimizers are ``test_torch_vision.py``): three
``Trainer`` steps of ``mlp_mnist`` and of the tiny ResNet (``stage_sizes
[1,1,1,1]``, width 8, cifar10 32x32, 10 classes, batch 16) against the JAX
``Trainer`` from the same initial weights: f32 losses to 1e-5 relative,
the parameters and the BatchNorm running statistics after three momentum
steps to 1e-4 (BatchNorm divides by small batch variances, which
amplifies the libraries' f32 rounding differences); bf16 compute: losses
to 2e-2 (each framework rounds to bf16 at other places).
"""

import json

import jax
import numpy as np
import pytest

from test_torch_vision import TINY, _close

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    vision_params_from_jax,
    vision_params_to_jax,
)


def _overrides(preset, dtype="float32", strategy="dp", extra=None):
    ov = {"steps": "3", "log_every": "1", "data.prefetch": "0",
          "parallel.strategy": strategy}
    if preset == "resnet50_dp":
        ov.update({"data.dataset": "cifar10", "data.batch_size": "16",
                   "optim.warmup_steps": "0", "model.compute_dtype": dtype,
                   "model.extra": json.dumps(extra or TINY)})
    return ov


def _jax_run(preset, ov):
    cfg = jconfig.get_config(preset, **ov)
    trainer = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=1),
                                           devices=jax.devices()[:1]))
    init = jax.device_get((trainer.state.params,
                           trainer.state.model_state.get("batch_stats")))
    trainer.train()
    final = jax.device_get((trainer.state.params,
                            trainer.state.model_state.get("batch_stats")))
    trainer.close()
    return init, trainer.losses(), final


@pytest.mark.parametrize("preset,dtype,bn_impl", [
    ("mlp_mnist", "float32", None),
    ("resnet50_dp", "float32", "pallas"),
    ("resnet50_dp", "float32", "flax"),
    ("resnet50_dp", "bfloat16", "pallas"),
])
def test_three_steps_match_the_jax_trainer(preset, dtype, bn_impl):
    extra = dict(TINY, bn_impl=bn_impl) if bn_impl else None
    ov = _overrides(preset, dtype, extra=extra)
    (params, stats), j_losses, j_final = _jax_run(preset, ov)
    trainer = Trainer(tconfig.get_config(preset, **ov), device="cpu",
                      params=vision_params_from_jax(params, stats))
    trainer.train()
    losses = trainer.losses()
    assert len(losses) == len(j_losses) == 3 and np.all(np.isfinite(losses))
    if dtype == "bfloat16":
        np.testing.assert_allclose(losses, j_losses, rtol=2e-2)
        return
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    got = vision_params_to_jax(trainer.model.state_dict())
    for g, w in zip(got, j_final):
        if w is None:  # the MLP has no BatchNorm
            assert g == {}
            continue
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            _close(a, b, 1e-4)
    moved = [np.abs(a - b).max() for a, b in
             zip(jax.tree.leaves(got[0]), jax.tree.leaves(params))]
    assert max(moved) > 1e-4

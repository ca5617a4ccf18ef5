"""Label smoothing in the port (``train/losses.py``, ``_smoothed``): the
cases of the JAX package's ``tests/test_label_smoothing.py``, each held
against the JAX ``_smoothed`` (through its ``get_loss_fn``) and against
``torch.nn.functional.cross_entropy(label_smoothing=)``, from the same
seeded numpy logits. Tolerance: 1e-5 relative (f32, reductions in another
order), as the JAX test holds its own against torch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributed_nn_tpu.train.losses import get_loss_fn as jget
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
from pytorch_distributed_nn_tpu_torch.train.losses import (
    get_loss_fn,
    lm_xent,
)


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.3])
def test_matches_jax_and_torch_classification(eps):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int64)
    got = get_loss_fn("mnist", label_smoothing=eps)(
        torch.from_numpy(logits), torch.from_numpy(labels.astype(np.int32)))
    want = F.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), label_smoothing=eps)
    jax_loss = jget("mnist", label_smoothing=eps)(
        jnp.asarray(logits), jnp.asarray(labels.astype(np.int32)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(jax_loss), rtol=1e-5)


@pytest.mark.parametrize("eps", [0.1])
def test_matches_jax_and_torch_masked_mlm(eps):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 8, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(4, 8)).astype(np.int64)
    labels[rng.random(labels.shape) < 0.6] = -1  # ignore positions
    fn = get_loss_fn("mlm_synthetic", label_smoothing=eps)
    got = fn(torch.from_numpy(logits),
             torch.from_numpy(labels.astype(np.int32)))
    want = F.cross_entropy(torch.from_numpy(logits).reshape(-1, 11),
                           torch.from_numpy(labels).reshape(-1),
                           ignore_index=-1, label_smoothing=eps)
    jax_loss = jget("mlm_synthetic", label_smoothing=eps)(
        jnp.asarray(logits), jnp.asarray(labels.astype(np.int32)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(jax_loss), rtol=1e-5)
    # the dp step's global token count replaces the local one
    assert fn.token_weighted
    valid = int((labels >= 0).sum())
    halved = fn(torch.from_numpy(logits),
                torch.from_numpy(labels.astype(np.int32)),
                denom=torch.tensor(2.0 * valid))
    np.testing.assert_allclose(float(halved), float(got) / 2, rtol=1e-6)


def test_matches_jax_and_torch_causal_lm():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 6, 13)).astype(np.float32)
    labels = rng.integers(0, 13, size=(2, 6)).astype(np.int32)
    got = get_loss_fn("lm_synthetic", label_smoothing=0.2)(
        torch.from_numpy(logits), torch.from_numpy(labels))
    want = F.cross_entropy(torch.from_numpy(logits).reshape(-1, 13),
                           torch.from_numpy(labels).reshape(-1).long(),
                           label_smoothing=0.2)
    jax_loss = jget("lm_synthetic", label_smoothing=0.2)(
        jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(jax_loss), rtol=1e-5)


def test_smoothing_zero_is_the_base_fn():
    assert get_loss_fn("lm_synthetic", label_smoothing=0.0) is lm_xent


@pytest.mark.parametrize("eps", [1.0, -0.1])
def test_invalid_smoothing_is_rejected(eps):
    with pytest.raises(ValueError, match="label_smoothing"):
        get_loss_fn("mnist", label_smoothing=eps)


def test_the_chunked_xent_rejects_smoothing():
    cfg = tconfig.get_config("llama3_longcontext", label_smoothing="0.1")
    with pytest.raises(ValueError, match="label_smoothing"):
        make_train_step(cfg, lm_xent)
    # one chunk covers the sequence: the dense loss, which smooths
    cfg = tconfig.get_config("llama3_longcontext", label_smoothing="0.1",
                             **{"data.seq_len": "2048"})
    make_train_step(cfg, lm_xent)


def test_the_trainer_with_smoothing_matches_the_jax_trainer():
    """Three ``mlp_mnist`` steps at label_smoothing 0.1 (features (64, 10),
    batch 32) from the JAX init: f32 losses to 1e-5 relative."""
    import jax

    from pytorch_distributed_nn_tpu import config as jconfig
    from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec, make_mesh
    from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils.interop import (
        vision_params_from_jax,
    )

    ov = {"steps": "3", "log_every": "1", "data.prefetch": "0",
          "data.batch_size": "32", "model.extra": '{"features": [64, 10]}',
          "label_smoothing": "0.1"}
    jt = JTrainer(jconfig.get_config("mlp_mnist", **ov),
                  mesh=make_mesh(MeshSpec(data=1), devices=jax.devices()[:1]))
    init = vision_params_from_jax(jax.device_get(jt.state.params), None)
    jt.train()
    jt.close()
    t = Trainer(tconfig.get_config("mlp_mnist", **ov), device="cpu",
                params=init)
    t.train()
    np.testing.assert_allclose(t.losses(), jt.losses(), rtol=1e-5)
    plain = Trainer(tconfig.get_config("mlp_mnist", **{
        **ov, "label_smoothing": "0"}), device="cpu", params=init)
    plain.train()
    assert not np.allclose(plain.losses(), t.losses(), rtol=1e-3)

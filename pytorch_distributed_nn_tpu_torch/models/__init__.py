"""Model registry: ``register`` / ``get_model`` as in the JAX package.
Ported so far: ``llama3_8b``, ``mlp``, ``lenet`` and ``resnet50``; BERT,
the transformer LM, ViT and the MoE LM are not (ROADMAP.md)."""

from __future__ import annotations

from typing import Any, Callable

from pytorch_distributed_nn_tpu_torch.config import ModelConfig

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register(name: str):
    def wrap(builder):
        _REGISTRY[name] = builder
        return builder

    return wrap


def get_model(cfg: ModelConfig, device="cuda", input_shape=None):
    """Build the ``nn.Module`` for a ModelConfig on ``device`` (``cuda``
    unless the caller asks for another; raises without CUDA).
    ``input_shape`` is one example's shape, which sizes a vision model's
    first layer (flax infers it from the first batch). Parameters start as
    zeros; fill them by loading a ``state_dict`` or with the model's own
    seeded ``init_params(seed)``."""
    from pytorch_distributed_nn_tpu_torch.models import (  # noqa: F401
        lenet,
        llama,
        mlp,
        resnet,
    )

    if cfg.name not in _REGISTRY:
        raise KeyError(
            f"unknown model {cfg.name!r}; have {sorted(_REGISTRY)}")
    kw = {} if input_shape is None else {"input_shape": tuple(input_shape)}
    return _REGISTRY[cfg.name](cfg, device=device, **kw)

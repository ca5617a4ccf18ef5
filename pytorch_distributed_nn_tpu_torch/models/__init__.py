"""Model registry: ``register`` / ``get_model`` as in the JAX package.
Ported: ``llama3_8b``, ``mlp``, ``lenet``, ``resnet50``, ``bert_base``,
``transformer_lm``, ``moe_lm`` and ``vit``."""

from __future__ import annotations

from typing import Any, Callable

from pytorch_distributed_nn_tpu_torch.config import ModelConfig

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register(name: str):
    def wrap(builder):
        _REGISTRY[name] = builder
        return builder

    return wrap


def get_model(cfg: ModelConfig, device="cuda", input_shape=None, seq=None):
    """Build the ``nn.Module`` for a ModelConfig on ``device`` (``cuda``
    unless the caller asks for another; raises without CUDA).
    ``input_shape`` is one example's shape, which sizes a vision model's
    first layer (flax infers it from the first batch); ``seq`` is the
    rank's sequence-parallel ring (``runtime.mesh.SeqGroup``), which only
    the Llama model takes. Parameters start as zeros; fill them by loading
    a ``state_dict`` or with the model's own seeded ``init_params(seed)``."""
    from pytorch_distributed_nn_tpu_torch.models import (  # noqa: F401
        bert,
        lenet,
        llama,
        mlp,
        moe_lm,
        resnet,
        transformer_lm,
        vit,
    )

    if cfg.name not in _REGISTRY:
        raise KeyError(
            f"unknown model {cfg.name!r}; have {sorted(_REGISTRY)}")
    if cfg.remat_offload and cfg.name != "llama3_8b":
        # only build_llama3_8b takes the flag; dropping it silently would
        # let a run expected to fit through host offload run out of memory
        raise ValueError(
            f"remat_offload is implemented for llama3_8b only; model "
            f"{cfg.name!r} would silently ignore it")
    kw = {} if input_shape is None else {"input_shape": tuple(input_shape)}
    if seq is not None:
        kw["seq"] = seq
    return _REGISTRY[cfg.name](cfg, device=device, **kw)

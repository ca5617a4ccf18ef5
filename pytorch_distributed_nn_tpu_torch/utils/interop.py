"""Weights across the two packages.

:func:`llama_params_from_jax` turns the JAX package's Llama param tree
(nested dicts with numpy leaves, e.g. ``jax.device_get(params)``, the
``Trainer``'s initial float params included) into this package's
``state_dict``; :func:`llama_params_to_jax` goes the other way. Both
packages use the flax names and layouts, so the conversion flattens (or
nests) the path at the dots and converts each leaf; it serves the float
and the int8 layouts alike.

:func:`vision_params_from_jax` and :func:`vision_params_to_jax` do the same
for the MLP, LeNet and ResNet, whose flax variables come in two
collections: ``params`` and ``batch_stats`` (the BatchNorm running
``mean`` and ``var``, buffers here). Flax convolution kernels are HWIO and
the port's are OIHW: they are transposed here, once. Nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _leaf(x: Any) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart through numpy
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _flatten(tree: Mapping[str, Any], out: dict[str, torch.Tensor],
             prefix: str = "") -> dict[str, torch.Tensor]:
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            _flatten(value, out, key + ".")
        else:
            out[key] = _leaf(value)
    return out


def _nest(flat: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split(".")
        for name in path:
            node = node.setdefault(name, {})
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[leaf] = t.contiguous().numpy()
    return out


def llama_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"layer0": {"attn": {"qkv": {"kernel_q": a}}}}`` ->
    ``{"layer0.attn.qkv.kernel_q": tensor}``."""
    return _flatten(tree, {})


def llama_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                        ) -> dict[str, Any]:
    """``{"layer0.attn.query.kernel": tensor}`` ->
    ``{"layer0": {"attn": {"query": {"kernel": array}}}}``, numpy leaves
    (bf16 leaves come out as f32, which numpy can hold)."""
    return _nest(state_dict)


def _is_conv_kernel(key: str, t: torch.Tensor) -> bool:
    return key.rsplit(".", 1)[-1] == "kernel" and t.dim() == 4


def vision_params_from_jax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any] | None = None
                           ) -> dict[str, torch.Tensor]:
    """The flax ``params`` (and ``batch_stats``, for a model with
    BatchNorm) of the MLP, LeNet or ResNet as this package's
    ``state_dict``: dotted flax paths, conv kernels HWIO -> OIHW."""
    out = _flatten(params, {})
    for key, t in out.items():
        if _is_conv_kernel(key, t):
            out[key] = t.permute(3, 2, 0, 1).contiguous()
    return _flatten(batch_stats or {}, out)


def vision_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                         ) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(params, batch_stats)`` as flax nests them, numpy leaves: the
    inverse of :func:`vision_params_from_jax`. The BatchNorm buffers
    (``mean``, ``var``) go to ``batch_stats``."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        if key.rsplit(".", 1)[-1] in ("mean", "var"):
            stats[key] = t
        else:
            params[key] = (t.permute(2, 3, 1, 0) if _is_conv_kernel(key, t)
                           else t)
    return _nest(params), _nest(stats)

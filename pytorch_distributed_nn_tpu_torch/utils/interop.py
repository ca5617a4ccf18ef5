"""Weights across the two packages.

:func:`llama_params_from_jax` turns the JAX package's Llama param tree
(nested dicts with numpy leaves, e.g. ``jax.device_get(params)``, the
``Trainer``'s initial float params included) into this package's
``state_dict``; :func:`llama_params_to_jax` goes the other way. Both
packages use the flax names and layouts, so the conversion flattens (or
nests) the path at the dots and converts each leaf; it serves the float
and the int8 layouts alike. Nothing here imports JAX.
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


def llama_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"layer0": {"attn": {"qkv": {"kernel_q": a}}}}`` ->
    ``{"layer0.attn.qkv.kernel_q": tensor}``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            key = f"{prefix}{name}"
            if isinstance(value, Mapping):
                walk(value, key + ".")
            else:
                out[key] = _leaf(value)

    walk(tree, "")
    return out


def llama_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                        ) -> dict[str, Any]:
    """``{"layer0.attn.query.kernel": tensor}`` ->
    ``{"layer0": {"attn": {"query": {"kernel": array}}}}``, numpy leaves
    (bf16 leaves come out as f32, which numpy can hold)."""
    out: dict[str, Any] = {}
    for key, value in state_dict.items():
        node = out
        *path, leaf = key.split(".")
        for name in path:
            node = node.setdefault(name, {})
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[leaf] = t.numpy()
    return out

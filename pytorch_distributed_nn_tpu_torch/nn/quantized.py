"""Weight-only int8 modules and the float -> int8 param converter.

Counterparts of the JAX package's ``nn/quantized.py``:

- :class:`Int8Dense`         <-> ``nn.Dense`` (no bias)
- :class:`Int8DenseGeneral`  <-> ``nn.DenseGeneral`` (tuple features and/or
  several trailing contraction axes: the attention projections)
- :class:`Int8Embed`         <-> ``nn.Embed`` (per-ROW scales)

Parameters keep the JAX names, shapes and layout: ``kernel_q`` (Kp, Np)
int8 and ``scale`` (1, Np) f32, padded by :func:`padded_kn`;
``embedding_q`` (V, D) int8 with ``scale`` (V, 1) f32. They are created
as zeros and hold no gradient; fill them with :func:`synthetic_int8_params`
or ``load_state_dict`` (a float model's ``state_dict``, a trained
checkpoint's, converts with :func:`quantize_state_dict`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from pytorch_distributed_nn_tpu_torch.ops.int8_matmul import (
    int8_matmul,
    padded_kn,
    quantize_weight,
)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Int8Dense(nn.Module):
    """``nn.Dense(use_bias=False)`` with an int8 kernel and a per-output-
    channel scale; computes ``int8_matmul`` and slices the N padding."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> None:
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.dtype = dtype
        kp, np_ = padded_kn(in_features, features)
        self.kernel_q = _param((kp, np_), torch.int8, device)
        self.scale = _param((1, np_), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(-1, self.in_features), self.kernel_q,
                        self.scale, out_dtype=self.dtype)
        return y[:, :self.features].reshape(*lead, self.features)


class Int8DenseGeneral(nn.Module):
    """``nn.DenseGeneral`` contracting the trailing ``in_shape`` axes into
    tuple ``features``: one padded 2-D matmul, reshaped at the boundary."""

    def __init__(self, in_shape: Sequence[int] | int,
                 features: Sequence[int] | int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> None:
        super().__init__()
        self.in_shape = ((in_shape,) if isinstance(in_shape, int)
                         else tuple(in_shape))
        self.features = ((features,) if isinstance(features, int)
                         else tuple(features))
        self.dtype = dtype
        self.k = math.prod(self.in_shape)
        self.n = math.prod(self.features)
        kp, np_ = padded_kn(self.k, self.n)
        self.kernel_q = _param((kp, np_), torch.int8, device)
        self.scale = _param((1, np_), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nin = len(self.in_shape)
        if tuple(x.shape[x.dim() - nin:]) != self.in_shape:
            raise ValueError(f"trailing axes {tuple(x.shape[-nin:])} != "
                             f"{self.in_shape}")
        lead = x.shape[:x.dim() - nin]
        y = int8_matmul(x.reshape(-1, self.k), self.kernel_q, self.scale,
                        out_dtype=self.dtype)
        return y[:, :self.n].reshape(*lead, *self.features)


class Int8Embed(nn.Module):
    """``nn.Embed`` with int8 rows and per-row scales; the product runs in
    the compute dtype, as the JAX module's does."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.embedding_q = _param((num_embeddings, features), torch.int8,
                                  device)
        self.scale = _param((num_embeddings, 1), torch.float32, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        rows = self.embedding_q[tokens].to(self.dtype)
        return rows * self.scale[tokens].to(self.dtype)


@torch.no_grad()
def synthetic_int8_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill a QUANTIZED model's parameters in place with seeded random
    values, on the parameters' own device and never through floats: int8
    leaves uniform in [-64, 64), 2-D quant scales the small constant
    2.7e-4 (the JAX package's choice, keeping 32-layer activations O(1)),
    1-D norm scales ones. Decode speed does not depend on the values."""
    gens: dict[torch.device, torch.Generator] = {}
    for name, p in model.named_parameters():
        if p.dtype == torch.int8:
            g = gens.get(p.device)
            if g is None:
                g = gens[p.device] = torch.Generator(p.device)
                g.manual_seed(seed)
            p.random_(-64, 64, generator=g)
        elif p.dim() >= 2 and name.endswith("scale"):
            p.fill_(2.7e-4)
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            raise ValueError(f"{name} {tuple(p.shape)} {p.dtype} is not a "
                             "quantized-model parameter")
    return model


def _merge_fused_projections(params: dict, target: dict) -> dict:
    """Rewrite float {query,key,value} / {gate_proj,up_proj} kernels into
    the fused 'qkv' / 'gate_up' layout when the quantized target declares
    them. Exact: per-output-channel scales are concat-invariant."""
    fused = dict(params)
    if ("qkv" in target and "qkv" not in fused
            and {"query", "key", "value"} <= fused.keys()):
        ks = [fused.pop(n)["kernel"] for n in ("query", "key", "value")]
        fused["qkv"] = {"kernel": torch.cat(ks, dim=1)}
    if ("gate_up" in target and "gate_up" not in fused
            and {"gate_proj", "up_proj"} <= fused.keys()):
        ks = [fused.pop(n)["kernel"] for n in ("gate_proj", "up_proj")]
        fused["gate_up"] = {"kernel": torch.cat(ks, dim=1)}
    return fused


def quantize_model_params(params: dict, target: dict) -> dict:
    """Convert a nested float param dict (flax names and layout) to the
    int8 modules' layout. ``target`` is the quantized model's parameter
    shapes as a nested dict keyed like its ``state_dict`` path: its
    ``kernel_q`` shapes decide how a >2-D kernel splits into contraction
    and feature axes."""
    if not isinstance(params, dict):
        return params
    params = _merge_fused_projections(params, target)
    out = {}
    for name, leaf in params.items():
        if name == "kernel" and isinstance(leaf, torch.Tensor):
            tgt = tuple(target["kernel_q"])
            matches = []
            for split in range(1, leaf.dim()):
                k = math.prod(leaf.shape[:split])
                n = math.prod(leaf.shape[split:])
                if padded_kn(k, n) == tgt and \
                        (k, n) not in [(m[1], m[2]) for m in matches]:
                    matches.append((split, k, n))
            if len(matches) != 1:
                raise ValueError(
                    f"{'ambiguous' if matches else 'no'} axis split of "
                    f"{tuple(leaf.shape)} for padded storage {tgt}")
            _, k, n = matches[0]
            out["kernel_q"], out["scale"] = quantize_weight(leaf.reshape(k, n))
        elif name == "embedding" and isinstance(leaf, torch.Tensor):
            w32 = leaf.to(torch.float32)
            absmax = w32.abs().amax(dim=1, keepdim=True)
            s = torch.where(absmax > 0, absmax / 127.0,
                            torch.ones_like(absmax))
            out["embedding_q"] = torch.clamp(
                torch.round(w32 / s), -127, 127).to(torch.int8)
            out["scale"] = s
        elif isinstance(leaf, dict):
            out[name] = quantize_model_params(leaf, target[name])
        else:
            out[name] = leaf
    return out



def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split(".")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = value
    return out


def quantize_state_dict(params: dict, model: nn.Module) -> dict:
    """A float model's flax-named ``state_dict`` ``params`` as the
    ``state_dict`` of the quantized ``model`` (:func:`quantize_model_params`
    of the nested params against the model's parameter shapes, on the
    params' device)."""
    target = _nested({k: tuple(v.shape)
                      for k, v in model.state_dict().items()})
    return _flat(quantize_model_params(_nested(dict(params)), target))

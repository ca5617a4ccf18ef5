"""The flax layers the transformer families are built of, with flax's
numerics: ``Dense``, ``Embed``, ``LayerNorm``, ``gelu`` and ``Dropout``
(the JAX package takes them from ``flax.linen``).

- :class:`Dense`: kernel (in, out) and bias, input and kernel cast to the
  compute dtype, the bias added in that dtype after the product. A decode
  step's rows go through the product in fixed blocks
  (:func:`dense_product`).
- :class:`Embed`: the ``embedding`` table in the param dtype; a lookup,
  no cast (flax's ``Embed`` without a ``dtype``).
- Over the ``tensor`` axis (``parallel/tensor.py`` sets ``tensor`` and
  ``tp_mode``): a ``"column"`` Dense holds its columns (and bias) of the
  product, a ``"row"`` Dense its rows, summing the partial products over
  the group before the whole bias; a ``"gather"`` Dense (a vocab-split
  head) gathers its logit columns before the bias; an Embed holds its
  rows of the table and looks up by a masked lookup and a sum.
- :class:`LayerNorm`: statistics in f32 (a decode step's in fixed row
  blocks, :func:`row_mean`) in flax 0.12's ``use_fast_variance`` form,
  var = max(E[x^2] - E[x]^2, 0) (not
  ``F.layer_norm``'s), then ``(x - mean) * (rsqrt(var + eps) * scale) +
  bias`` in f32, cast to the compute dtype.
- :func:`gelu`: tanh-approximate (``flax.linen.gelu`` defaults to
  ``approximate=True``; ``F.gelu`` defaults to exact erf).
- :class:`Dropout`: flax's ``select(keep, x / keep_prob, 0)``. Its mask
  comes from an explicit ``torch.Generator`` seeded from (the run's seed,
  the step, the rank, the layer's own salt), set by :func:`dropout_stream`
  around a training step, so a rematerialized block redraws the same
  mask. It is the identity in eval mode and at rate 0; threefry's masks
  cannot be reproduced, so parity with the JAX package runs at rate 0.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AxisGroup

_MASK64 = (1 << 64) - 1
_stream: Optional[tuple[int, int, int]] = None  # (seed, step, rank)


# A decode step's rows (one token a row) go through the dense products in
# blocks of this many rows, the last block padded with zero rows. A library
# product picks its summation order by its shape (cuBLAS by M), so a row's
# bits then do not depend on how many rows share the step: the serving
# engine's round (M = its slots) gives a row what generate() (M = 1) gives
# it. On the H100 a float Llama at the 8B's widths and config 4's LM
# differed by up to 8.1e-6 in the logits at 3 rows against 1 without the
# blocks and not at all with them (chip_smoke.py phase 32).
DECODE_ROW_BLOCK = 8


def dense_product(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x @ kernel`` for ``x`` (..., K) and ``kernel`` (K, N); a decode
    step's ``x`` ((B, 1, K)) in blocks of :data:`DECODE_ROW_BLOCK` rows."""
    if x.dim() != 3 or x.shape[1] != 1:
        return x @ kernel
    rows = x.reshape(x.shape[0], x.shape[2])
    m, block = rows.shape[0], DECODE_ROW_BLOCK
    pad = -m % block
    if pad:
        rows = F.pad(rows, (0, 0, 0, pad))
    ys = [rows[i:i + block] @ kernel for i in range(0, m + pad, block)]
    return (ys[0] if len(ys) == 1 else torch.cat(ys))[:m, None]


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(-1, keepdim=True)``; a decode step's ``x`` ((B, 1, K)) in
    blocks of :data:`DECODE_ROW_BLOCK` rows, as :func:`dense_product` runs
    its products. A library reduction, too, picks its summation order by
    its shape (over K split across more threads where there are fewer
    rows), so a norm's statistics then have the same bits whatever the
    number of rows in the step: without the blocks an int8 Llama at the
    8B's widths and 16 layers parted from generate() at one RMSNorm of an
    8-slot engine round (chip_smoke.py phase 7)."""
    if x.dim() != 3 or x.shape[1] != 1:
        return x.mean(-1, keepdim=True)
    rows = x.reshape(x.shape[0], x.shape[2])
    m, block = rows.shape[0], DECODE_ROW_BLOCK
    pad = -m % block
    if pad:
        rows = F.pad(rows, (0, 0, 0, pad))
    ys = [rows[i:i + block].mean(-1) for i in range(0, m + pad, block)]
    return (ys[0] if len(ys) == 1 else torch.cat(ys))[:m, None, None]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), ``bias`` (out,) unless
    ``use_bias`` is False."""

    def __init__(self, in_features: int, features: int, *, dtype,
                 param_dtype=torch.float32, use_bias: bool = True,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.fan_in = in_features
        self.kernel = nn.Parameter(torch.zeros(
            (in_features, features), dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros((features,), dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        # the tensor axis (parallel/tensor.py): "column", "row" or "gather"
        self.tensor = AxisGroup()
        self.tp_mode: Optional[str] = None

    def forward(self, x: torch.Tensor, gather: bool = True) -> torch.Tensor:
        """``gather`` False: a ``"gather"`` Dense returns its own columns
        of the product (no bias), for a vocab-parallel loss."""
        g = self.tensor
        if self.tp_mode == "gather":
            x = cc.sum_grad(x, g.group, g.size)
        y = dense_product(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.tp_mode == "row":
            y = cc.sum_forward(y, g.group, g.size)
        elif self.tp_mode == "gather":
            if not gather:
                return y
            y = cc.gather_split(y, g.group, g.size, g.index, y.dim() - 1)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` (num, features); returns rows in
    the param dtype."""

    def __init__(self, num: int, features: int, *, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(
            (num, features), dtype=param_dtype, device=device))
        self.tensor = AxisGroup()  # the rows are split over it

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        g = self.tensor
        if g.size == 1:
            return F.embedding(idx, self.embedding)
        rows = self.embedding.shape[0]
        local = idx - g.index * rows
        mine = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(mine, local, 0), self.embedding)
        out = out * mine[..., None].to(out.dtype)
        return cc.sum_forward(out, g.group, g.size)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last dim: ``scale`` and ``bias``."""

    def __init__(self, dim: int, *, eps: float, dtype,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = row_mean(x32)
        var = torch.clamp(row_mean(x32 * x32) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x32 - mean) * mul + self.bias.float()).to(self.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _mix(*words: int) -> int:
    """A 63-bit seed from integers (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    return h >> 1


def fold_in(seed: int, index: int) -> int:
    """A seed of its own for ``index`` under ``seed`` (a microbatch's)."""
    return _mix(seed, index)


@contextlib.contextmanager
def dropout_stream(seed: int, step: int, rank: int = 0):
    """Every :class:`Dropout` in training mode inside the block draws its
    mask from a generator seeded by (``seed``, ``step``, ``rank``, its
    salt). Wrap the forward AND the backward of a step, so a block that
    remat reruns in the backward draws its masks again, identically."""
    global _stream
    prev, _stream = _stream, (seed, step, rank)
    try:
        yield
    finally:
        _stream = prev


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``; ``salt`` tells the layers of one model
    apart (each draws its own mask)."""

    def __init__(self, rate: float, salt: int) -> None:
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate
        self.salt = salt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if _stream is None:
            raise RuntimeError("dropout in training mode needs a "
                               "dropout_stream(seed, step) around the step")
        g = torch.Generator(x.device)
        g.manual_seed(_mix(*_stream, self.salt))
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=g, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


@torch.no_grad()
def init_params_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights in place, in ``named_parameters`` order:
    kernels normal with std fan_in^-1/2 (the module's ``fan_in``),
    embeddings normal with std 1, biases zero, LayerNorm scales one;
    parameters a model names itself (ViT's ``cls`` and ``pos_embed``)
    follow its ``extra_init``."""
    first = next(model.parameters())
    g = torch.Generator(first.device)
    g.manual_seed(seed)
    owners = {f"{name}.kernel": m.fan_in for name, m in model.named_modules()
              if hasattr(m, "fan_in")}
    extra = getattr(model, "extra_init", {})
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in extra:
            extra[name](p, g)
        elif name in owners:
            p.normal_(0.0, owners[name] ** -0.5, generator=g)
        elif leaf == "embedding":
            p.normal_(0.0, 1.0, generator=g)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            raise ValueError(f"no initializer for parameter {name!r}")
    return model

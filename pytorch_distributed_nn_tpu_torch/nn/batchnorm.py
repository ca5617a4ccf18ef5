"""BatchNorm with the JAX package's semantics (``nn/batchnorm.py``).

:func:`batch_norm_train` is the JAX ``custom_vjp``: a forward from the two
f32 sums (sum x, sum x*x), ``var = sum x*x / m - mean^2`` (biased), the
elementwise pass in f32 cast back to x's dtype, and the closed-form
backward from (sum dy, sum dy*x). Only ``impl='pallas'`` reaches the
``bn_stats`` kernel (``ops/bn_stats.py``); the other values (``flax``,
``fused``, ``unfused``, ``unfused_fwd``, ``unfused_bwd``) choose XLA
lowerings in the JAX package and all take the sums by torch reductions
here.

The channel axis is ``dim`` (1 for the port's NCHW convolutions, whose
``channels_last`` memory makes the kernel's (M, C) view free; -1 for the
JAX package's (..., C) arrays).

Across ranks. With a process ``group`` of more than one rank the sums are
all-reduced in the forward and the backward, over the global batch (the
JAX ``dp`` step's SyncBN, where the compiler shards the batch). The
backward then uses the global sums for dx and the local ones for the
scale and bias gradients, whose mean across ranks the step takes.

:class:`TpuBatchNorm` is flax's ``BatchNorm`` as the JAX package's
``TpuBatchNorm``: running ``mean`` and ``var`` buffers, updated as
``ra = momentum * ra + (1 - momentum) * batch`` with the biased batch
variance (``torch.nn.BatchNorm2d`` differs on both).
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_distributed_nn_tpu_torch.ops import bn_stats
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc

IMPLS = ("flax", "fused", "unfused", "pallas", "unfused_fwd", "unfused_bwd")


def _channel_view(v: torch.Tensor, ndim: int, dim: int) -> torch.Tensor:
    """(C,) -> broadcastable against an ``ndim`` tensor along ``dim``."""
    shape = [1] * ndim
    shape[dim % ndim] = -1
    return v.view(shape)


def _sync(s1: torch.Tensor, s2: torch.Tensor, group
          ) -> tuple[torch.Tensor, torch.Tensor]:
    both = cc.all_reduce_sum(torch.stack([s1, s2]), group)
    return both[0], both[1]


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, impl, dim, group):
        c = x.shape[dim]
        m = x.numel() // c
        if impl == "pallas":
            s1, s2 = bn_stats.sum_and_sumsq(x, dim)
        else:
            s1, s2 = bn_stats.sum_and_sumsq_reference(x, dim)
        n = 1 if group is None else cc.world_size(group)
        if n > 1:
            s1, s2 = _sync(s1, s2, group)
            m *= n
        mean = s1 / m
        var = s2 / m - mean * mean
        rsig = torch.rsqrt(var + eps)
        # the JAX package's expression order, for the same f32 rounding
        a = rsig * scale
        b = bias - mean * rsig * scale
        y = (x.float() * _channel_view(a, x.dim(), dim)
             + _channel_view(b, x.dim(), dim)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rsig)
        ctx.dim, ctx.impl, ctx.group, ctx.m, ctx.n = dim, impl, group, m, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the batch mean/var feed the running averages only: no gradient
        # flows through them (flax's batch_stats are used the same way)
        x, scale, mean, rsig = ctx.saved_tensors
        dim, m = ctx.dim, ctx.m
        if ctx.impl == "pallas":
            sdy, sdyx = bn_stats.sum_and_dot(dy, x, dim)
        else:
            sdy, sdyx = bn_stats.sum_and_dot_reference(dy, x, dim)
        # the scale and bias gradients from this rank's rows
        dbias = sdy
        dscale = (sdyx - mean * sdy) * rsig
        if ctx.n > 1:
            sdy, sdyx = _sync(sdy, sdyx, ctx.group)
            sdyxh = (sdyx - mean * sdy) * rsig
        else:
            sdyxh = dscale
        # dx = scale * rsig * (dy - sdy / m - xhat * sdyxh / m), with mean
        # folded into the constant so the pass reads only x and dy
        g = scale * rsig
        c2 = g * rsig * sdyxh / m
        c1 = g * sdy / m - mean * c2
        nd = x.dim()
        dx = (dy.float() * _channel_view(g, nd, dim)
              - x.float() * _channel_view(c2, nd, dim)
              - _channel_view(c1, nd, dim)).to(x.dtype)
        return dx, dscale, dbias, None, None, None, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, *, epsilon: float = 1e-5,
                     impl: str = "unfused", dim: int = -1, group=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode batch norm: ``(y, batch_mean, batch_var)``; gradients
    flow through ``y`` only. ``scale`` and ``bias`` are f32 (C,)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown stats_impl {impl!r}; have {IMPLS}")
    return _BatchNormTrain.apply(x, scale, bias, epsilon, impl, dim, group)


class TpuBatchNorm(nn.Module):
    """flax ``BatchNorm`` over channel axis ``dim``: ``scale`` and
    ``bias`` parameters, ``mean`` and ``var`` buffers. In training mode it
    normalises with the batch statistics and updates the buffers; in eval
    mode it normalises with the buffers. ``sync_group`` (set by the ``dp``
    step) makes the statistics span every rank's batch."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 stats_impl: str = "unfused", dim: int = 1,
                 scale_init: float = 1.0, device=None) -> None:
        super().__init__()
        if stats_impl not in IMPLS:
            raise ValueError(f"unknown stats_impl {stats_impl!r}; have "
                             f"{IMPLS}")
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.impl = stats_impl
        self.dim = dim
        self.sync_group = None
        self.scale = nn.Parameter(torch.full((features,), scale_init,
                                             dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros((features,), dtype=param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros((features,),
                                                 dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones((features,),
                                               dtype=torch.float32,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        scale, bias = self.scale.float(), self.bias.float()
        if not self.training:
            rsig = torch.rsqrt(self.var + self.epsilon)
            a = rsig * scale
            b = bias - self.mean * rsig * scale
            return (x.float() * _channel_view(a, x.dim(), self.dim)
                    + _channel_view(b, x.dim(), self.dim)).to(x.dtype)
        y, mean, var = batch_norm_train(
            x, scale, bias, epsilon=self.epsilon, impl=self.impl,
            dim=self.dim, group=self.sync_group)
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean
                            + (1.0 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var
                           + (1.0 - self.momentum) * var)
        return y

"""Gradient bucketing: DDP's ``Reducer`` as the JAX package's
``ops/buckets.py`` writes it.

:func:`make_bucket_reduce` builds the ``grads -> mean grads`` transform of
the explicit data-parallel step: the gradients in the JAX package's leaf
order (``jax.tree.flatten`` of the flax param tree sorts the keys at every
level, which is the order of the dotted names split at the dots), reversed
(the last layers' gradients are ready first), grouped by dtype, greedily
packed into buckets of ``bucket_mb``, one all-reduce a bucket.

``quantized`` picks the wire: exact (the bucket in its own dtype), ``bf16``
(f32 buckets cast to bf16 for the all-reduce) or ``int8``: a shared scale
(the all-ranks max of |bucket| / 127), stochastic rounding to int8
(``ops/quantize.py``), an exact int32 sum across ranks and a dequantize by
scale / n. Under int8 the bucket layout sets each bucket's scale, so the
order and the packing match the JAX package's exactly.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc


def partition_buckets(sizes_bytes: Sequence[int],
                      bucket_bytes: int) -> list[list[int]]:
    """Greedy contiguous packing of leaf indices into buckets of at most
    ``bucket_bytes`` (a leaf larger than the budget gets its own)."""
    if bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be positive")
    buckets: list[list[int]] = []
    current: list[int] = []
    used = 0
    for idx, size in enumerate(sizes_bytes):
        if current and used + size > bucket_bytes:
            buckets.append(current)
            current, used = [], 0
        current.append(idx)
        used += size
    if current:
        buckets.append(current)
    return buckets


def flax_order(names: Sequence[str]) -> list[str]:
    """Dotted parameter names in ``jax.tree.flatten`` order of the nested
    param dict they flatten (sorted keys at every level)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def bucket_plan(shapes: Mapping[str, tuple[torch.Size, torch.dtype]],
                bucket_bytes: int) -> list[tuple[torch.dtype, list[str]]]:
    """The buckets, in reduction order, as (dtype, names): the JAX
    package's leaf order reversed, grouped by dtype (groups in order of
    first appearance), each group packed by :func:`partition_buckets`."""
    order = flax_order(list(shapes))[::-1]
    by_dtype: dict[torch.dtype, list[str]] = {}
    for name in order:
        by_dtype.setdefault(shapes[name][1], []).append(name)
    plan = []
    for dtype, names in by_dtype.items():
        item = torch.empty((), dtype=dtype).element_size()
        sizes = [shapes[n][0].numel() * item for n in names]
        for bucket in partition_buckets(sizes, bucket_bytes):
            plan.append((dtype, [names[j] for j in bucket]))
    return plan


def wire_mode(quantized: bool | str) -> str | None:
    mode = {False: None, True: "bf16", "": None}.get(quantized, quantized)
    if mode not in (None, "bf16", "int8"):
        raise ValueError(f"unknown quantized mode {quantized!r}")
    return mode


def make_bucket_reduce(*, bucket_mb: float = 25.0,
                       quantized: bool | str = False,
                       group=None) -> Callable:
    """``reduce_grads(grads, *, seed=0) -> dict``: the mean across the
    ranks of ``group`` of every gradient in ``grads`` (dotted flax names to
    tensors), bucket by bucket. ``seed`` (the step count) decorrelates the
    int8 rounding across steps; the rank decorrelates it across ranks."""
    bucket_bytes = int(bucket_mb * 1024 * 1024)
    mode = wire_mode(quantized)
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")

    def reduce_grads(grads: Mapping[str, torch.Tensor], *,
                     seed: int = 0) -> dict[str, torch.Tensor]:
        from pytorch_distributed_nn_tpu_torch.ops.quantize import (
            dequantize_int8,
            quantize_int8,
        )

        plan = bucket_plan({n: (g.shape, g.dtype) for n, g in grads.items()},
                           bucket_bytes)
        n = cc.world_size(group)
        rank = cc.rank(group)
        reduced: dict[str, torch.Tensor] = {}
        for counter, (dtype, names) in enumerate(plan, start=1):
            flat = torch.cat([grads[name].reshape(-1) for name in names])
            if mode == "int8" and dtype.is_floating_point:
                absmax = cc.all_reduce_max(flat.abs().max().float(), group)
                scale = torch.clamp(absmax / 127.0, min=1e-12)
                # the JAX package's seed, in int32 arithmetic
                tile_seed = (seed * 65537 + counter * 257 + rank) & 0xFFFFFFFF
                q = quantize_int8(flat.float(), scale, seed=tile_seed)
                total = cc.all_reduce_sum(q.to(torch.int32), group)
                mean = (dequantize_int8(total, scale) / n).to(dtype)
            elif mode == "bf16" and flat.element_size() > 2:
                wire = flat.to(torch.bfloat16)
                mean = cc.all_reduce_mean(wire, group).to(dtype)
            else:
                mean = cc.all_reduce_mean(flat, group)
            offset = 0
            for name in names:
                g = grads[name]
                reduced[name] = mean[offset:offset + g.numel()].view(g.shape)
                offset += g.numel()
        return reduced

    return reduce_grads

"""Gradient bucketing: DDP's ``Reducer`` as the JAX package's
``ops/buckets.py`` writes it, and its overlap with the backward.

:func:`make_bucket_reduce` builds the ``grads -> mean grads`` transform of
the explicit data-parallel step: the gradients in the JAX package's leaf
order (``jax.tree.flatten`` of the flax param tree sorts the keys at every
level, which is the order of the dotted names split at the dots), reversed
(the last layers' gradients are ready first), grouped by dtype, greedily
packed into buckets of ``bucket_mb``, one all-reduce a bucket.

:class:`OverlapReducer` is ``parallel.overlap`` (the JAX package leaves it
to XLA's asynchronous collectives): the same plan, but each bucket's
collectives are issued from the backward, from a post-accumulate-grad hook,
as soon as the last of its gradients is in, and the step waits on them
after the backward. Buckets go out in the order they become ready, which
is the same on every rank (each runs the same graph); every bucket's bytes
and collectives are the ones :func:`make_bucket_reduce` issues, so the
result is bit for bit the same. On the card a bucket's chain (the
concatenation, the int8 wire's absmax all-reduce, quantize and int32 sum)
runs on a side stream, so that the absmax wait, which holds the stream it
is made on until every collective issued before it is done, holds that
stream and not the backward's.

``quantized`` picks the wire: exact (the bucket in its own dtype), ``bf16``
(f32 buckets cast to bf16 for the all-reduce) or ``int8``: a shared scale
(the all-ranks max of |bucket| / 127), stochastic rounding to int8
(``ops/quantize.py``), an exact int32 sum across ranks and a dequantize by
scale / n. Under int8 the bucket layout sets each bucket's scale, so the
order and the packing match the JAX package's exactly.
"""

from __future__ import annotations

import functools
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


class BucketReduce:
    """``reduce(grads, *, seed=0) -> dict``: the mean across the ranks of
    ``group`` of every gradient in ``grads`` (dotted flax names to
    tensors), bucket by bucket. ``seed`` (the step count) decorrelates the
    int8 rounding across steps; the rank decorrelates it across ranks."""

    def __init__(self, bucket_bytes: int, mode: str | None, group) -> None:
        self.bucket_bytes = bucket_bytes
        self.mode = mode
        self.group = group

    def plan(self, shapes: Mapping[str, tuple[torch.Size, torch.dtype]]
             ) -> list[tuple[torch.dtype, list[str]]]:
        return bucket_plan(shapes, self.bucket_bytes)

    def start(self, grads: Sequence[torch.Tensor], dtype: torch.dtype, *,
              counter: int, seed: int) -> Callable[[], torch.Tensor]:
        """Issues the all-reduce of bucket ``counter`` (1-based, in plan
        order: it seeds the int8 rounding) and returns ``finish()``, which
        waits for it and returns the bucket's flat mean. Under int8 the
        chain absmax max -> quantize -> int32 sum is ordered by the handles
        (on NCCL by the stream; no host wait)."""
        from pytorch_distributed_nn_tpu_torch.ops.quantize import (
            dequantize_int8,
            quantize_int8,
        )

        group = self.group
        n = cc.world_size(group)
        flat = torch.cat([g.reshape(-1) for g in grads])
        if self.mode == "int8" and dtype.is_floating_point:
            absmax = flat.abs().max().float()
            cc.all_reduce_max(absmax, group, async_op=True).wait()
            scale = torch.clamp(absmax / 127.0, min=1e-12)
            # the JAX package's seed, in int32 arithmetic
            tile_seed = (seed * 65537 + counter * 257
                         + cc.rank(group)) & 0xFFFFFFFF
            total = quantize_int8(flat.float(), scale,
                                  seed=tile_seed).to(torch.int32)
            work = cc.all_reduce_sum(total, group, async_op=True)

            def finish():
                work.wait()
                return (dequantize_int8(total, scale) / n).to(dtype)
        elif self.mode == "bf16" and flat.element_size() > 2:
            wire = flat.to(torch.bfloat16)
            work = cc.all_reduce_sum(wire, group, async_op=True)

            def finish():
                work.wait()
                return wire.div_(n).to(dtype)
        else:
            work = cc.all_reduce_sum(flat, group, async_op=True)

            def finish():
                work.wait()
                return flat.div_(n)
        return finish

    def __call__(self, grads: Mapping[str, torch.Tensor], *,
                 seed: int = 0) -> dict[str, torch.Tensor]:
        plan = self.plan({n: (g.shape, g.dtype) for n, g in grads.items()})
        reduced: dict[str, torch.Tensor] = {}
        for counter, (dtype, names) in enumerate(plan, start=1):
            mean = self.start([grads[n] for n in names], dtype,
                              counter=counter, seed=seed)()
            reduced.update(split(mean, names, grads))
        return reduced


def split(flat: torch.Tensor, names: Sequence[str],
          like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Views of ``flat`` shaped as ``like[name]``, in ``names`` order."""
    out, offset = {}, 0
    for name in names:
        shape = like[name].shape
        size = like[name].numel()
        out[name] = flat[offset:offset + size].view(shape)
        offset += size
    return out


def make_bucket_reduce(*, bucket_mb: float = 25.0,
                       quantized: bool | str = False,
                       group=None) -> BucketReduce:
    """The bucketed mean of a step's gradients (:class:`BucketReduce`)
    with buckets of ``bucket_mb`` on the ``quantized`` wire."""
    bucket_bytes = int(bucket_mb * 1024 * 1024)
    mode = wire_mode(quantized)
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")
    return BucketReduce(bucket_bytes, mode, group)


def issue_order(buckets: Sequence[tuple[torch.dtype, list[str]]],
                hook_order: Sequence[str]) -> list[tuple[int, int]]:
    """When :class:`OverlapReducer` issues each bucket, given the order in
    which the gradients' hooks fire: ``(bucket, hooks fired by then)`` in
    issue order; a bucket whose last gradient never arrives goes out after
    the backward (counted as every hook fired)."""
    missing = [len(names) for _, names in buckets]
    where = {n: b for b, (_, names) in enumerate(buckets) for n in names}
    out = []
    for k, name in enumerate(hook_order, start=1):
        b = where[name]
        missing[b] -= 1
        if missing[b] == 0:
            out.append((b, k))
    issued = {b for b, _ in out}
    return out + [(b, len(hook_order)) for b in range(len(buckets))
                  if b not in issued]


class OverlapReducer:
    """``parallel.overlap`` on ``model``: each bucket of ``reduce``'s plan
    (or, with ``reduce`` None, each tensor: the ``dp`` step's per-tensor
    mean, in place) is issued from the backward once its last gradient is
    accumulated. Per step: :meth:`arm` before the backward, :meth:`finish`
    after it, which issues any bucket not yet issued (in plan order), waits
    on every handle and leaves each parameter's ``.grad`` the mean. The
    hooks stay registered and do nothing while the reducer is not armed
    (a backward outside the step, such as a check's, issues nothing).
    Under gradient accumulation the step arms it for the last microbatch's
    backward only, with the ``prepare`` that completes each gradient.

    ``last`` describes the last step: the buckets in the order they were
    issued with the count of hooks fired by then, the hooks' order, and
    the gradient bytes issued before the backward's last hook fired."""

    def __init__(self, model: torch.nn.Module,
                 reduce: BucketReduce | None = None, group=None) -> None:
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.reduce = reduce
        self.group = reduce.group if reduce is not None else group
        shapes = {n: (p.shape, p.dtype) for n, p in self.params.items()}
        if reduce is None:
            self.buckets = [(shapes[n][1], [n])
                            for n in flax_order(list(shapes))[::-1]]
        else:
            self.buckets = reduce.plan(shapes)
        self.bucket_of = {n: b for b, (_, names) in enumerate(self.buckets)
                          for n in names}
        self.nbytes = [sum(self.params[n].numel() * self.params[n].
                           element_size() for n in names)
                       for _, names in self.buckets]
        # the buckets' chains run here on the card (module docstring)
        self.stream = None
        if reduce is not None and any(p.is_cuda
                                      for p in self.params.values()):
            self.stream = torch.cuda.Stream(
                next(iter(self.params.values())).device)
        self._armed = False
        self._seed = 0
        self._prepare: Callable | None = None
        self._missing: list[int] = []
        self._pending: dict[int, Callable] = {}
        self.issued: list[tuple[int, int]] = []  # (bucket, hooks fired)
        self.hook_order: list[str] = []
        self.buckets_issued = 0  # since construction
        self.last: dict = {}
        self._handles = [p.register_post_accumulate_grad_hook(
            functools.partial(self._ready, n))
            for n, p in self.params.items()]

    def remove(self) -> None:
        """Unregister the hooks (the reducer is being replaced)."""
        self._armed = False
        for handle in self._handles:
            handle.remove()
        self._handles = []

    def arm(self, seed: int = 0,
            prepare: Callable[[torch.Tensor], None] | None = None) -> None:
        """Start a step: ``seed`` is the int8 wire's step seed; ``prepare``
        (gradient accumulation's) is called on each parameter as its hook
        fires, before its gradient is counted in, and turns the summed
        ``.grad`` into the one to reduce."""
        self._seed = seed
        self._prepare = prepare
        self._missing = [len(names) for _, names in self.buckets]
        self._pending = {}
        self.issued = []
        self.hook_order = []
        self._armed = True

    def _ready(self, name: str, param: torch.Tensor) -> None:
        if not self._armed:
            return
        if self._prepare is not None:
            self._prepare(param)
        self.hook_order.append(name)
        b = self.bucket_of[name]
        self._missing[b] -= 1
        if self._missing[b] == 0:
            self._issue(b)

    def _issue(self, b: int) -> None:
        dtype, names = self.buckets[b]
        grads = [self.params[n].grad for n in names]
        if any(g is None for g in grads):
            raise RuntimeError("a trainable parameter got no gradient")
        self.issued.append((b, len(self.hook_order)))
        self.buckets_issued += 1
        if self.stream is not None:
            # every side-stream op of a step follows an event the
            # backward's stream records in that step, after all the
            # previous step ran there: a block the side stream frees is
            # not reused while the backward's stream may still read it
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self._pending[b] = self.reduce.start(
                    grads, dtype, counter=b + 1, seed=self._seed)
            return
        if self.reduce is not None:
            self._pending[b] = self.reduce.start(
                grads, dtype, counter=b + 1, seed=self._seed)
            return
        g, n = grads[0], cc.world_size(self.group)
        work = cc.all_reduce_sum(g, self.group, async_op=True)

        def finish():
            work.wait()
            return g.div_(n)
        self._pending[b] = finish

    def finish(self) -> None:
        """Wait for every bucket; each ``.grad`` becomes its mean."""
        self._armed = False
        self._prepare = None
        for b in range(len(self.buckets)):
            if b not in self._pending:
                self._issue(b)
        if self.stream is not None:
            torch.cuda.current_stream().wait_stream(self.stream)
        hooks = len(self.hook_order)
        for b, _ in self.issued:
            mean = self._pending.pop(b)()
            if self.reduce is not None:
                names = self.buckets[b][1]
                for name, g in split(mean, names, self.params).items():
                    self.params[name].grad = g
        self.last = dict(
            buckets=len(self.issued), hooks=hooks,
            issued=list(self.issued), hook_order=list(self.hook_order),
            bytes_total=sum(self.nbytes),
            bytes_before_last_hook=sum(self.nbytes[b]
                                       for b, k in self.issued if k < hooks))

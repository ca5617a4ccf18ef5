"""Collective verbs over a ``torch.distributed`` process group (the JAX
package's ``ops/collectives.py``, whose verbs are named-axis XLA
collectives).

Each verb works in place on the tensor it is given and returns it, and
records its traffic with the process-wide :class:`CommRecorder`: the
payload (the tensor's bytes) and the bytes each rank puts on the wire by
the ring algorithm's accounting. A run wraps a step in :func:`recording`
and reads :func:`wire_bytes` (or the payloads) of what it recorded.

``group=None`` is the default (world) group. Gloo has no AVG reduction,
so a mean is a SUM divided by the group's size, on every backend alike.

The sequence-parallel verbs (:func:`shift_right`, :func:`all_to_all`)
return new tensors and are differentiable (their backward is the reverse
exchange), as the JAX verbs are under ``jax.grad``. The sharded strategies
use :func:`all_gather_into_tensor` and :func:`reduce_scatter_tensor`
(ZeRO's gather of a parameter and the sum of its gradient's shards) and
:func:`exchange` (the pipeline's point-to-point hops). The expert axis
(``parallel/expert.py``) uses two differentiable verbs for a computation
that is replicated across the group but for one split step:
:func:`gather_replicated` (the experts' outputs from every rank) and
:func:`sum_grad` (the identity whose gradient is summed over the group).
The tensor axis (``parallel/tensor.py``) adds Megatron's other operator,
:func:`sum_forward` (the sum over the group, whose gradient passes
through), and :func:`gather_split` (every rank's slice along a dim).

Every batch of point-to-point messages (:func:`exchange`, the ring's
:func:`shift_right`) gives its j-th tensor tag j, so a receive can only
match the message of its own position in the batch, whatever the sizes.
Gloo sends no CUDA tensor point to point; where the group is gloo and its
ranks share one card (``shared_card``, set by ``runtime/bootstrap`` when
it keeps such a group), a batch of CUDA messages goes through host
memory instead (:func:`_host_staged`: copied out, sent by gloo, copied
back; counted and timed in :data:`host_p2p`). NCCL's path does not change,
and gloo with CUDA tensors raises anywhere else.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterable, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass
class CommRecord:
    op: str
    bytes_payload: int  # the tensor each rank passes in
    bytes_wire: float  # ring-algorithm bytes each rank sends


class CommRecorder:
    """Appends every collective's record to each attached sink. Process-
    wide and lock-protected: collectives may run off the main thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.active: list[list[CommRecord]] = []

    def record(self, rec: CommRecord) -> None:
        with self._lock:
            for sink in self.active:
                sink.append(rec)

    def attach(self, sink: list[CommRecord]) -> None:
        with self._lock:
            self.active.append(sink)

    def detach(self, sink: list[CommRecord]) -> None:
        with self._lock:
            self.active.remove(sink)


_recorder = CommRecorder()


@contextlib.contextmanager
def recording():
    """``with recording() as records:`` collects the collectives run
    inside the block."""
    sink: list[CommRecord] = []
    _recorder.attach(sink)
    try:
        yield sink
    finally:
        _recorder.detach(sink)


def wire_bytes(records: Sequence[CommRecord]) -> float:
    return sum(r.bytes_wire for r in records)


def payload_bytes(records: Sequence[CommRecord]) -> int:
    return sum(r.bytes_payload for r in records)


def ring_wire_bytes(op: str, payload: float, n: int) -> float:
    """Bytes each of ``n`` ranks sends for one collective on ``payload``
    bytes, by the ring algorithm: an all-reduce (or a broadcast done as
    one) sends 2(n-1)/n of the payload; a ring shift or a point-to-point
    send sends the payload once (a shift nothing at n = 1); an all-to-all
    or a reduce-scatter keeps 1/n of it and sends the rest; an all-gather
    passes n - 1 shards (the payload) on."""
    if op in ("all_reduce", "broadcast"):
        return 2.0 * payload * (n - 1) / max(n, 1)
    if op == "shift":
        return float(payload) if n > 1 else 0.0
    if op == "send":
        return float(payload)
    if op in ("all_to_all", "reduce_scatter"):
        return payload * (n - 1) / max(n, 1)
    if op == "all_gather":
        return float(payload) * (n - 1)
    raise ValueError(f"unknown collective {op!r}")


def world_size(group=None) -> int:
    """The group's size; 1 where no process group exists (a one-process
    run that issues no collective needs none)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _record(op: str, x: torch.Tensor | Sequence[torch.Tensor], group,
            n: int | None = None) -> None:
    n = dist.get_world_size(group) if n is None else n
    xs = [x] if isinstance(x, torch.Tensor) else x
    payload = sum(t.numel() * t.element_size() for t in xs)
    _recorder.record(CommRecord(op=op, bytes_payload=payload,
                                bytes_wire=ring_wire_bytes(op, payload, n)))


def barrier(group=None) -> None:
    """Every rank of the group reaches this point (nothing at world 1)."""
    if world_size(group) == 1:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def all_reduce_sum(x: torch.Tensor, group=None, *, async_op: bool = False):
    """``dist.all_reduce(SUM)`` in place; returns ``x``, or with
    ``async_op`` the work handle (``x`` holds the sum once ``wait()`` has
    returned; on NCCL that wait orders the current stream after the
    collective and blocks no host thread)."""
    _record("all_reduce", x, group)
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)
    return work if async_op else x


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's ``average_gradients``: SUM, then divide by the
    group's size, in place; returns ``x``."""
    all_reduce_sum(x, group)
    return x.div_(dist.get_world_size(group))


def all_reduce_max(x: torch.Tensor, group=None, *, async_op: bool = False):
    """``dist.all_reduce(MAX)`` in place; returns ``x`` or, with
    ``async_op``, the work handle."""
    _record("all_reduce", x, group)
    work = dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group,
                           async_op=async_op)
    return work if async_op else x


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``dist.broadcast`` from global rank ``src``, in place; returns
    ``x``. The reference broadcasts rank 0's parameters at start."""
    _record("broadcast", x, group)
    dist.broadcast(x, src=src, group=group)
    return x


# the newer names of the same calls where this torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather_into_tensor(out: torch.Tensor, x: torch.Tensor,
                           group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 into ``out`` (rank order
    of the group); returns ``out``. The payload is ``x``, the shard."""
    _record("all_gather", x, group)
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out


def reduce_scatter_tensor(out: torch.Tensor, x: torch.Tensor,
                          group=None) -> torch.Tensor:
    """The sum over the group's ranks of ``x``, of which rank i keeps the
    i-th of the group-size equal pieces along dim 0, into ``out``;
    returns ``out``. The payload is ``x``, the whole tensor."""
    _record("reduce_scatter", x, group)
    _REDUCE_SCATTER(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def exchange(sends: Sequence[tuple[int, torch.Tensor]],
             recvs: Sequence[tuple[int, torch.Tensor]],
             group=None) -> None:
    """One hop of point-to-point traffic as one ``batch_isend_irecv``:
    each ``(peer, tensor)`` of ``sends`` goes to the peer (its index in
    the group), each of ``recvs`` is filled from its peer. Between two
    ranks, the sends of one and the receives of the other come in the same
    order (NCCL matches them by order). Waits for all of them."""
    if not sends and not recvs:
        return
    for _, t in sends:
        _record("send", t, group, n=2)
    _p2p([(p, t.contiguous()) for p, t in sends], recvs, group)


def _p2p(sends: Sequence[tuple[int, torch.Tensor]],
         recvs: Sequence[tuple[int, torch.Tensor]], group) -> None:
    """``sends`` and ``recvs`` (each ``(peer index in the group, tensor)``)
    as one ``batch_isend_irecv``, waited for. The j-th message between two
    ranks carries tag j on both sides (sends and receives counted apart,
    per peer), so each receive takes the message of its own place in the
    batch and no other; NCCL, which matches by order, ignores the tags."""
    def tagged(op, pairs):
        count: dict[int, int] = {}
        out = []
        for peer, t in pairs:
            tag = count.get(peer, 0)
            count[peer] = tag + 1
            out.append(dist.P2POp(op, t, dist.get_global_rank(group, peer),
                                  group=group, tag=tag))
        return out

    if dist.get_backend(group) == "gloo" and any(
            t.is_cuda for _, t in (*sends, *recvs)):
        if not shared_card:
            raise RuntimeError(
                "gloo sends no CUDA tensor point to point; only a gloo "
                "group of ranks sharing a card stages it through host "
                "memory")
        return _host_staged(sends, recvs, tagged)
    ops = tagged(dist.isend, sends) + tagged(dist.irecv, recvs)
    for work in dist.batch_isend_irecv(ops):
        work.wait()


# ranks that share one card in a gloo group (runtime/bootstrap sets it)
shared_card = False
# the host-staged point-to-point batches on such a group: batches,
# messages, bytes sent and the seconds from the first copy out to the
# last copy back (reset by the caller)
host_p2p = dict(batches=0, messages=0, bytes=0, seconds=0.0)


def _host_staged(sends, recvs, tagged) -> None:
    """:func:`_p2p`'s batch where the group is gloo and the ranks share a
    card: every CUDA message staged through host memory."""
    t0 = time.perf_counter()
    out = [(p, t.cpu()) for p, t in sends]
    back = [(p, torch.empty(t.shape, dtype=t.dtype)) for p, t in recvs]
    for work in dist.batch_isend_irecv(tagged(dist.isend, out)
                                       + tagged(dist.irecv, back)):
        work.wait()
    for (_, t), (_, h) in zip(recvs, back):
        t.copy_(h)
    host_p2p["batches"] += 1
    host_p2p["messages"] += len(sends)
    host_p2p["bytes"] += sum(t.numel() * t.element_size() for _, t in out)
    host_p2p["seconds"] += time.perf_counter() - t0


def tree_all_reduce_mean(tensors: Iterable[torch.Tensor],
                         group=None) -> list[torch.Tensor]:
    """:func:`all_reduce_mean` of each tensor, in place: the bucketless,
    per-tensor form of gradient averaging (``ops/buckets.py`` packs
    buckets)."""
    return [all_reduce_mean(t, group) for t in tensors]


def flat_all_reduce_mean(tensors: Sequence[torch.Tensor],
                         group=None) -> None:
    """The mean across ranks of every tensor, through ONE all-reduce of
    their concatenation (for many small tensors of one dtype, such as the
    BatchNorm running statistics); written back in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_mean(flat, group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


# --------------------------------------------------------------------------
# sequence parallelism: the ring shift and the all-to-all over a group
# --------------------------------------------------------------------------

def _shift(xs: Sequence[torch.Tensor], group, size: int,
           step: int) -> list[torch.Tensor]:
    """Rank i of the group sends ``xs`` to rank (i + step) % size and
    receives the same shapes from (i - step) % size, all in one batch of
    P2P ops (Gloo takes CPU tensors, NCCL CUDA ones), tensor j under tag
    j (:func:`_p2p`)."""
    _record("shift", xs, group, n=size)
    if size == 1:
        return list(xs)
    i = dist.get_rank(group)
    dst, src = (i + step) % size, (i - step) % size
    outs = [torch.empty_like(x, memory_format=torch.contiguous_format)
            for x in xs]
    _p2p([(dst, x.contiguous()) for x in xs], [(src, o) for o in outs],
         group)
    return outs


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, size: int, *xs):
        ctx.group, ctx.size = group, size
        return tuple(_shift(xs, group, size, +1))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None, *_shift(gs, ctx.group, ctx.size, -1))


def shift_right(xs: Sequence[torch.Tensor], group,
                size: int) -> list[torch.Tensor]:
    """The ring shift i -> i + 1 (wrapping) of every tensor of ``xs`` over
    ``group`` of ``size`` ranks, in one batch: the JAX package's
    ``shift_right`` (a ppermute). At size 1 it is the identity and issues
    no P2P (a one-rank ring has no group: None is not the world there).
    Differentiable: the gradient shifts left."""
    if size == 1:
        return _shift(xs, group, size, +1)
    return list(_Shift.apply(group, size, *xs))


def _all_to_all(x: torch.Tensor, group, size: int, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    _record("all_to_all", x, group, n=size)
    if size == 1:
        return x
    send = torch.stack(x.chunk(size, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int, split_axis: int, concat_axis: int):
        ctx.args = (group, size, split_axis, concat_axis)
        return _all_to_all(x, group, size, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, size, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, group, size, concat_axis, split_axis),
                None, None, None, None)


def all_to_all(x: torch.Tensor, group, size: int, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The JAX package's tiled ``all_to_all`` over ``group`` of ``size``
    ranks: ``x`` is cut into ``size`` equal chunks along ``split_axis``,
    chunk j goes to rank j of the group, and the chunks received are
    concatenated along ``concat_axis`` in rank order
    (``dist.all_to_all_single`` on a contiguous (size, ...) buffer). At size
    1 it is the identity. Differentiable: the gradient goes back by the
    all-to-all with the two axes swapped."""
    if x.shape[split_axis] % size:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not split {size} ways")
    if size == 1:
        return _all_to_all(x, group, size, split_axis, concat_axis)
    return _AllToAll.apply(x, group, size, split_axis, concat_axis)


# --------------------------------------------------------------------------
# the expert axis: a replicated computation with one split step
# --------------------------------------------------------------------------

class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int, index: int):
        ctx.index, ctx.rows = index, x.shape[0]
        out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return all_gather_into_tensor(out, x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows), None, None, None


def gather_replicated(x: torch.Tensor, group, size: int,
                      index: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in group order (an
    all-gather), for a computation downstream that every rank of the group
    runs alike on the same values. Its gradient is then the same on every
    rank, so the backward keeps this rank's rows (``index`` in the group)
    and sends nothing. The identity at size 1."""
    if size == 1:
        return x
    return _GatherReplicated.apply(x, group, size, index)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def sum_grad(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The identity, whose gradient is summed over ``group`` (an
    all-reduce in the backward): the input of a step that each rank of the
    group computes a part of, from the same ``x``. The identity with no
    collective at size 1."""
    if size == 1:
        return x
    return _SumGrad.apply(x, group)


# --------------------------------------------------------------------------
# the tensor axis: Megatron's conjugate operators and the split gather
# --------------------------------------------------------------------------

class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_forward(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x`` (an all-reduce), whose
    gradient passes through unchanged: Megatron's operator after a
    row-parallel product, whose partial sums every rank then holds whole
    and computes on alike. The conjugate of :func:`sum_grad`; the identity
    at size 1."""
    if size == 1:
        return x
    return _SumForward.apply(x, group)


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int, index: int, dim: int):
        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((size * moved.shape[0],) + tuple(moved.shape[1:]),
                          dtype=x.dtype, device=x.device)
        all_gather_into_tensor(out, moved, group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None, None)


def gather_split(x: torch.Tensor, group, size: int, index: int,
                 dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order (one
    all-gather): the whole of a tensor split over the group, for a
    computation downstream that every rank runs alike (the loss over
    vocab-split logits). Its gradient is then the same on every rank, and
    the backward keeps this rank's slice (``index``) and sends nothing. The
    identity at size 1."""
    if size == 1:
        return x
    return _GatherSplit.apply(x, group, size, index, dim)

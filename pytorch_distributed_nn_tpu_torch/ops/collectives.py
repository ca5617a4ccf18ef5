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
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
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
    one) sends 2(n-1)/n of the payload."""
    if op not in ("all_reduce", "broadcast"):
        raise ValueError(f"unknown collective {op!r}")
    return 2.0 * payload * (n - 1) / max(n, 1)


def world_size(group=None) -> int:
    """The group's size; 1 where no process group exists (a one-process
    run that issues no collective needs none)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _record(op: str, x: torch.Tensor, group) -> None:
    n = dist.get_world_size(group)
    payload = x.numel() * x.element_size()
    _recorder.record(CommRecord(op=op, bytes_payload=payload,
                                bytes_wire=ring_wire_bytes(op, payload, n)))


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_reduce(SUM)`` in place; returns ``x``."""
    _record("all_reduce", x, group)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's ``average_gradients``: SUM, then divide by the
    group's size, in place; returns ``x``."""
    all_reduce_sum(x, group)
    return x.div_(dist.get_world_size(group))


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    _record("all_reduce", x, group)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``dist.broadcast`` from global rank ``src``, in place; returns
    ``x``. The reference broadcasts rank 0's parameters at start."""
    _record("broadcast", x, group)
    dist.broadcast(x, src=src, group=group)
    return x


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

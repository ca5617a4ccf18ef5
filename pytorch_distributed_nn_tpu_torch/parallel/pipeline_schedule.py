"""Pipeline schedules as static per-tick tables: the JAX package's
``parallel/pipeline_schedule.py``, copied (pure numpy; the port imports
nothing of the JAX package).

A schedule is DATA: a table ``(ticks, stages)`` saying which microbatch
each stage's forward and backward units process at each global tick (or
NO_OP). The port's executor (``parallel/pipeline.py``) runs each rank's
column tick by tick and derives from the same tables which activations
and cotangents cross which edge at the end of each tick, so every rank
posts the matching sends and receives without asking its neighbours.

- ``1f1b`` (PipeDream-flush), in closed form:

      fwd[t, s] = t - s              (while 0 <= t - s < M)
      bwd[t, s] = t - (2S - 1 - s)   (while in range)

  Stage s runs its f-th forward at tick s + f and its b-th backward at
  tick 2S - 1 - s + b. With one-tick message latency both dependency
  chains are tight: M + 2S - 1 ticks, and at most 2(S - s) - 1 <= 2S - 1
  microbatches in flight on stage s.
- ``interleaved`` (Megatron's virtual-chunk 1F1B): :func:`interleaved_1f1b`
  simulates the grouped unit order and allocates the inbox and
  activation slots.

gpipe (all forwards, then all backwards) needs no table of its own here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NO_OP = -1  # table entry: no microbatch scheduled for this unit


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static pipeline schedule. ``fwd``/``bwd`` are (ticks, stages)
    int32; entry [t, s] is the microbatch stage s processes at tick t
    for that unit, or NO_OP."""

    n_stages: int
    n_micro: int
    fwd: np.ndarray
    bwd: np.ndarray
    max_in_flight: int  # activation ring-buffer depth any stage needs

    @property
    def n_ticks(self) -> int:
        return self.fwd.shape[0]


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule:
    """Static interleaved (virtual-chunk) 1F1B schedule.

    ``S`` devices each hold ``v`` chunks; virtual stage ``k`` lives on
    device ``k % S`` as its chunk ``k // S`` (round-robin — the
    ``k % S == S-1 -> device 0`` wrap edge is where the interleaving
    lives, so both hops are FULL rings). All tables are
    ``(ticks, S)`` int32 with NO_OP for dead slots:

    - ``fwd_chunk``/``fwd_mb`` — which (local chunk, microbatch) the
      forward unit runs; ``bwd_chunk``/``bwd_mb`` likewise;
    - ``act_write``/``act_read`` — activation-buffer slot the forward
      saves its input to / the backward re-linearizes from;
    - ``fin_write``/``fin_read`` — fwd-inbox slot the arriving
      message lands in / the forward unit consumes from
      (unlike plain 1F1B, grouped warmup makes consume tick > arrival
      tick, so messages queue; depths are schedule-static);
    - ``bin_write``/``bin_read`` — same for backward cotangents.

    Slot lifetimes honor the tick-body order: inbox writes
    happen BEFORE unit reads (same-tick passthrough), the backward's
    act read happens BEFORE the forward's act write (tight reuse).
    """

    n_stages: int
    n_chunks: int
    n_micro: int
    fwd_chunk: np.ndarray
    fwd_mb: np.ndarray
    bwd_chunk: np.ndarray
    bwd_mb: np.ndarray
    act_write: np.ndarray
    act_read: np.ndarray
    fin_write: np.ndarray
    fin_read: np.ndarray
    bin_write: np.ndarray
    bin_read: np.ndarray
    act_depth: int
    fin_depth: int
    bin_depth: int

    @property
    def n_ticks(self) -> int:
        return self.fwd_chunk.shape[0]


class _SlotAllocator:
    """Greedy interval slot assignment. ``free_at_read=True`` frees a
    slot for same-tick rewrites (act buffer: read-before-write);
    ``False`` keeps it busy through the read tick (inboxes:
    write-before-read)."""

    def __init__(self, free_at_read: bool) -> None:
        self._free_at_read = free_at_read
        self._busy: list[tuple[int, int]] = []  # per slot: (start, end)

    def alloc(self, start: int, end: int) -> int:
        for slot, (_, prev_end) in enumerate(self._busy):
            limit = prev_end if self._free_at_read else prev_end + 1
            if start >= limit:
                self._busy[slot] = (start, end)
                return slot
        self._busy.append((start, end))
        return len(self._busy) - 1

    @property
    def depth(self) -> int:
        return len(self._busy)


def interleaved_1f1b(n_stages: int, n_chunks: int,
                     n_micro: int) -> InterleavedSchedule:
    """Build the interleaved schedule by simulating Megatron's grouped
    unit order under the one-tick message latency.

    Per device ``d`` the unit order is Megatron's
    (``forward_backward_pipelining_with_interleaving``): ``w`` warmup
    forwards with ``w = 2(S-d-1) + (v-1)S``, then strict 1F1B pairs,
    then cooldown backwards. The i-th forward processes chunk
    ``(i % Sv) // S`` of microbatch ``(i // Sv)*S + i % S`` (groups of
    S microbatches sweep the chunks in order); backwards sweep chunks
    in reverse (the JAX package's docs/design.md has the design).

    The simulation walks ticks; each device executes the prefix of its
    remaining unit list whose dependencies (producer ran at an earlier
    tick) are met, at most one forward + one backward per tick, in
    list order (blocking-recv semantics). The tables then get slot
    assignments for every message/activation lifetime. M must divide
    by S (Megatron's own constraint — partial groups stall the ring).
    """
    S, v, M = n_stages, n_chunks, n_micro
    if S < 1 or v < 1 or M < 1:
        raise ValueError(f"need S, v, M >= 1; got {S}, {v}, {M}")
    if M % S:
        raise ValueError(
            f"interleaved 1F1B needs microbatches divisible by stages "
            f"(Megatron group structure); got M={M}, S={S}"
        )
    Sv = S * v
    n = v * M  # units of each kind per device

    def fwd_unit(i: int) -> tuple[int, int]:
        g, r = divmod(i, Sv)
        return r // S, g * S + r % S  # (chunk, microbatch)

    def bwd_unit(i: int) -> tuple[int, int]:
        g, r = divmod(i, Sv)
        return v - 1 - r // S, g * S + r % S

    units: list[list[tuple[str, int, int]]] = []
    for d in range(S):
        w = min(2 * (S - d - 1) + (v - 1) * S, n)
        order = [("F", *fwd_unit(i)) for i in range(w)]
        for f, b in zip(range(w, n), range(n)):
            order.append(("F", *fwd_unit(f)))
            order.append(("B", *bwd_unit(b)))
        done_b = max(n - w, 0)
        order += [("B", *bwd_unit(i)) for i in range(done_b, n)]
        assert len(order) == 2 * n
        units.append(order)

    fwd_done: dict[tuple[int, int], int] = {}  # (virtual stage, mb) -> tick
    bwd_done: dict[tuple[int, int], int] = {}
    ptr = [0] * S
    rows_fc, rows_fm, rows_bc, rows_bm = [], [], [], []
    t = 0
    max_ticks = 4 * (2 * n + 2 * S * v) + 16  # deadlock tripwire
    while any(p < 2 * n for p in ptr):
        if t > max_ticks:
            raise RuntimeError(
                f"interleaved schedule deadlocked (S={S}, v={v}, M={M})"
            )
        row_fc, row_fm = [NO_OP] * S, [NO_OP] * S
        row_bc, row_bm = [NO_OP] * S, [NO_OP] * S
        for d in range(S):
            did = {"F": False, "B": False}
            while ptr[d] < 2 * n:
                typ, j, m = units[d][ptr[d]]
                if did[typ]:
                    break
                k = j * S + d
                if typ == "F":
                    ready = k == 0 or fwd_done.get((k - 1, m), t) < t
                else:
                    # every backward re-linearizes from its own saved
                    # forward input, so own-F must be a strict tick
                    # earlier (act read precedes act write in-body);
                    # non-last stages also need the cotangent
                    ready = fwd_done.get((k, m), t) < t and (
                        k == Sv - 1 or bwd_done.get((k + 1, m), t) < t
                    )
                if not ready:
                    break
                if typ == "F":
                    row_fc[d], row_fm[d] = j, m
                    fwd_done[(k, m)] = t
                else:
                    row_bc[d], row_bm[d] = j, m
                    bwd_done[(k, m)] = t
                did[typ] = True
                ptr[d] += 1
        rows_fc.append(row_fc)
        rows_fm.append(row_fm)
        rows_bc.append(row_bc)
        rows_bm.append(row_bm)
        t += 1

    T = len(rows_fc)
    fwd_chunk = np.asarray(rows_fc, np.int32)
    fwd_mb = np.asarray(rows_fm, np.int32)
    bwd_chunk = np.asarray(rows_bc, np.int32)
    bwd_mb = np.asarray(rows_bm, np.int32)

    # ---- slot assignment post-pass (all lifetimes are now known) ----
    act_write = np.full((T, S), NO_OP, np.int32)
    act_read = np.full((T, S), NO_OP, np.int32)
    fin_write = np.full((T, S), NO_OP, np.int32)
    fin_read = np.full((T, S), NO_OP, np.int32)
    bin_write = np.full((T, S), NO_OP, np.int32)
    bin_read = np.full((T, S), NO_OP, np.int32)
    act_depth = fin_depth = bin_depth = 1
    for d in range(S):
        acts = _SlotAllocator(free_at_read=True)
        fins = _SlotAllocator(free_at_read=False)
        bins_ = _SlotAllocator(free_at_read=False)
        # chronological allocation per device: walk ticks, allocate at
        # each lifetime's start
        for t in range(T):
            # arriving fwd message: sent by (d-1)%S's forward at t-1
            # for virtual stage k-1 -> consumed by this device's F of
            # (k, m); garbage (dead producer / last-stage output) is
            # dropped (stays NO_OP)
            p = (d - 1) % S
            if t > 0 and fwd_chunk[t - 1, p] != NO_OP:
                kp = fwd_chunk[t - 1, p] * S + p
                m = int(fwd_mb[t - 1, p])
                if kp < Sv - 1:
                    t_cons = fwd_done[(kp + 1, m)]
                    slot = fins.alloc(t, t_cons)
                    fin_write[t, d] = slot
                    fin_read[t_cons, d] = slot
            # arriving bwd cotangent: sent by (d+1)%S's backward at t-1
            # for virtual stage k -> consumed by this device's B of
            # (k-1, m)
            p = (d + 1) % S
            if t > 0 and bwd_chunk[t - 1, p] != NO_OP:
                kp = bwd_chunk[t - 1, p] * S + p
                m = int(bwd_mb[t - 1, p])
                if kp > 0:
                    t_cons = bwd_done[(kp - 1, m)]
                    slot = bins_.alloc(t, t_cons)
                    bin_write[t, d] = slot
                    bin_read[t_cons, d] = slot
            # saved forward input: written by F at t, read by the same
            # (k, m)'s B on this device
            if fwd_chunk[t, d] != NO_OP:
                k = fwd_chunk[t, d] * S + d
                m = int(fwd_mb[t, d])
                t_b = bwd_done[(k, m)]
                slot = acts.alloc(t, t_b)
                act_write[t, d] = slot
                act_read[t_b, d] = slot
        act_depth = max(act_depth, acts.depth)
        fin_depth = max(fin_depth, fins.depth)
        bin_depth = max(bin_depth, bins_.depth)

    return InterleavedSchedule(
        n_stages=S, n_chunks=v, n_micro=M,
        fwd_chunk=fwd_chunk, fwd_mb=fwd_mb,
        bwd_chunk=bwd_chunk, bwd_mb=bwd_mb,
        act_write=act_write, act_read=act_read,
        fin_write=fin_write, fin_read=fin_read,
        bin_write=bin_write, bin_read=bin_read,
        act_depth=act_depth, fin_depth=fin_depth, bin_depth=bin_depth,
    )


def one_f_one_b(n_stages: int, n_micro: int) -> Schedule:
    """The closed-form PipeDream-flush table (module docstring)."""
    S, M = n_stages, n_micro
    if S < 1 or M < 1:
        raise ValueError(f"need n_stages >= 1, n_micro >= 1; got {S}, {M}")
    n_ticks = M + 2 * S - 1
    t = np.arange(n_ticks)[:, None]
    s = np.arange(S)[None, :]
    fwd = t - s
    bwd = t - (2 * S - 1 - s)
    fwd = np.where((fwd >= 0) & (fwd < M), fwd, NO_OP).astype(np.int32)
    bwd = np.where((bwd >= 0) & (bwd < M), bwd, NO_OP).astype(np.int32)
    # stage s holds microbatch f from fwd tick s+f until bwd tick
    # 2S-1-s+f: at most 2(S-s)-1 in flight; stage 0 peaks
    max_in_flight = min(M, 2 * S - 1)
    return Schedule(n_stages=S, n_micro=M, fwd=fwd, bwd=bwd,
                    max_in_flight=max_in_flight)

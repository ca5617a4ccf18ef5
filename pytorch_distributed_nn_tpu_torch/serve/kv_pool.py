"""KV-cache pool: block allocator + per-sequence block table.

Counterpart of the JAX package's ``serve/kv_pool.py`` without its metric
and metering hooks, and without ``adopt_cached`` (the receiving side of KV
block streaming between replicas, which belongs to disaggregated serving,
ROADMAP.md §1 slice 6).

A sequence admitted with prompt length L and budget n reserves
``ceil((L + n) / block_size)`` blocks up front and holds them until it is
freed, so a running sequence never runs out of blocks mid-decode. The
engine keeps K/V rows in a dense ``(slots, S_max)`` cache; the table
governs admission and accounting, not the physical layout.

A block has three lives. *Live-exclusive*: in exactly one sequence's
table. *Live-shared*: in several tables at once, refcounted
(:meth:`KVPool.refcount`), entered through ``reserve(shared=...)`` (a
prefix-cache hit) or :meth:`KVPool.fork` (an n-best branch holds the
parent's full prompt blocks by reference, so n branches hold one prompt
block set plus n tails); it leaves circulation when its last holder frees
it. *Cached*: a refcount-0 block that its last holder freed with
``retain`` parks in an LRU ring instead of the free list, so
:mod:`serve.prefix_cache` can hand it to a later request that shares the
prefix. The free list stays the backpressure truth (``free_blocks`` never
counts cached blocks); the prefix cache sheds cached blocks with
:meth:`KVPool.release_cached` when a reservation needs them, honouring
:meth:`KVPool.pin` (a copy-on-write tail being restored must not vanish).

Thread-safety: one lock around every mutation.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable


class KVPool:
    """Fixed-size block pool with per-sequence reservations."""

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: dict[str, list[int]] = {}  # seq_id -> block ids
        # block -> live holders, for blocks entered through ``shared``
        # (an exclusively owned block has no entry)
        self._ref: dict[int, int] = {}
        # refcount-0 donated blocks, least recently parked first
        self._cached: OrderedDict[int, None] = OrderedDict()
        # cached blocks a copy-on-write restore is reading: not evictable
        self._pinned: set[int] = set()

    def blocks_for(self, tokens: int) -> int:
        """ceil(tokens / block_size)."""
        return -(-max(int(tokens), 0) // self.block_size)

    def reserve(self, seq_id: str, tokens: int,
                shared: Iterable[int] = ()) -> bool:
        """Reserve blocks for a sequence's worst-case ``tokens`` rows.
        False (and no state change) when the pool can't cover it; a second
        reserve for a live ``seq_id`` raises. ``shared`` blocks head the
        table by reference: a cached block leaves the ring and becomes live
        with one holder, a live one gains a holder; only the rest comes off
        the free list (the prefix cache's saving)."""
        shared = list(shared)
        n_fresh = self.blocks_for(tokens) - len(shared)
        if n_fresh < 0:
            raise ValueError(
                f"sequence {seq_id!r}: {len(shared)} shared blocks exceed "
                f"the reservation for {tokens} tokens")
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already holds a "
                                 f"reservation")
            live = {b for t in self._tables.values() for b in t}
            for b in shared:
                if b not in self._cached and b not in live:
                    raise ValueError(
                        f"shared block {b} is neither cached nor live: the "
                        f"prefix index is stale")
            if n_fresh > len(self._free):
                return False
            for b in shared:
                if b in self._cached:
                    del self._cached[b]
                    self._ref[b] = 1
                else:
                    self._ref[b] = self._ref.get(b, 1) + 1
            self._tables[seq_id] = shared + [
                self._free.pop() for _ in range(n_fresh)]
        return True

    def fork(self, parent_id: str, child_id: str, tokens: int, *,
             shared_tokens: int) -> bool:
        """Start an n-best branch ``child_id`` off the live ``parent_id``:
        the parent's full blocks covering ``shared_tokens`` prompt rows
        join the child's table by reference, and only the child's tail
        (the partial prompt block and its own tokens) comes off the free
        list. False (and no state change) when the tail does not fit."""
        with self._lock:
            table = self._tables.get(parent_id)
            if table is None:
                raise KeyError(
                    f"fork parent {parent_id!r} has no reservation")
            shared = table[:max(int(shared_tokens), 0) // self.block_size]
        return self.reserve(child_id, tokens, shared=shared)

    def extend(self, seq_id: str, tokens: int) -> None:
        """Check that a sequence's ``tokens`` written rows stay inside its
        reservation; raises if not (a scheduler bug)."""
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                raise KeyError(f"sequence {seq_id!r} has no reservation")
            if self.blocks_for(tokens) > len(table):
                raise ValueError(
                    f"sequence {seq_id!r} wrote {tokens} tokens past its "
                    f"{len(table)}-block reservation")

    def free(self, seq_id: str,
             retain: frozenset[int] = frozenset()) -> int:
        """Return a sequence's blocks; an unknown id is a no-op. A block
        another holder shares only drops a holder. A block that loses its
        last holder parks in the cached ring (table order, so a prefix
        chain ages together) if ``retain`` names it, and goes to the free
        list otherwise. Returns the number of blocks that reached the free
        list."""
        with self._lock:
            table = self._tables.pop(seq_id, None)
            if not table:
                return 0
            released = []
            for b in table:
                if b in self._ref:
                    self._ref[b] -= 1
                    if self._ref[b] > 0:
                        continue  # another holder keeps it live
                    del self._ref[b]
                if b in retain:
                    self._cached[b] = None
                    self._cached.move_to_end(b)
                else:
                    released.append(b)
            self._free.extend(reversed(released))
            return len(released)

    # -- the cached ring ---------------------------------------------------

    def is_cached(self, block: int) -> bool:
        with self._lock:
            return block in self._cached

    def refcount(self, block: int) -> int:
        """Live holders of a shared block (0: cached, free or exclusively
        owned)."""
        with self._lock:
            return self._ref.get(block, 0)

    def cached_lru(self) -> list[int]:
        """Cached blocks, least recently touched first: the prefix cache's
        eviction order."""
        with self._lock:
            return list(self._cached)

    def touch_cached(self, block: int) -> None:
        """Make a cached block the most recently used."""
        with self._lock:
            if block in self._cached:
                self._cached.move_to_end(block)

    def pin(self, block: int) -> None:
        """Make a cached block unevictable while the engine copies its rows
        (the copy-on-write tail's restore)."""
        with self._lock:
            self._pinned.add(block)

    def unpin(self, block: int) -> None:
        with self._lock:
            self._pinned.discard(block)

    def release_cached(self, block: int) -> bool:
        """Evict one cached block to the free list. False, and no state
        change, when it is pinned or not cached (evicted already, or live
        again through a sharer)."""
        with self._lock:
            if block in self._pinned or block not in self._cached:
                return False
            del self._cached[block]
            self._free.append(block)
            return True

    def block_table(self, seq_id: str) -> tuple[int, ...]:
        with self._lock:
            return tuple(self._tables.get(seq_id, ()))

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def cached_blocks(self) -> int:
        with self._lock:
            return len(self._cached)

    @property
    def live_sequences(self) -> int:
        with self._lock:
            return len(self._tables)

    def utilization(self) -> float:
        """Live-reserved fraction of the pool, in [0, 1]. Cached blocks
        can be reclaimed, so they count as headroom though they are off
        the free list."""
        with self._lock:
            return (self.num_blocks - len(self._free)
                    - len(self._cached)) / self.num_blocks

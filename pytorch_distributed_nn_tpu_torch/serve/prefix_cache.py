"""Content-addressed radix prefix cache over the paged KV pool.

Counterpart of the JAX package's ``serve/prefix_cache.py``. Requests that
share a system prompt or a few-shot prefix share its KV blocks: the pool
(:class:`serve.kv_pool.KVPool`) makes sharing a block one refcount, and
this module decides which blocks to share.

- **content addressing**: a block of token ids ``t`` whose parent block
  hashed to ``d`` is keyed ``sha1(d + t.tobytes())`` (int32 ids), the
  chain rooted at the adapter's seed (:func:`_root`), byte for byte the
  JAX module's keys. A key is a function of the whole prefix, so two
  requests agree on a block's key iff they agree on every token up to and
  including it, and on the LoRA adapter. The index is one dict keyed by
  digest; parent/child links exist only for leaf-only eviction;
- **admission** (:meth:`PrefixCache.admit`): the request's full blocks are
  walked through the index and every resident one is shared by reference
  (``pool.reserve(shared=)``), so the engine restores those rows from its
  device block store and prefills only the suffix. A request that
  diverges inside a block takes that block's rows copy-on-write: the
  content is restored, but its table gets a fresh private block. At most
  ``len(prompt) - 1`` tokens match, so at least one token prefills and
  the first token's logits exist;
- **eviction**: a finished sequence donates its full blocks to the index
  (:meth:`PrefixCache.release`), which parks refcount-0 blocks in the
  pool's cached ring instead of freeing them. Under pressure admission
  sheds unpinned LRU *leaf* blocks (matching needs a contiguous chain from
  block 0, so an interior eviction would orphan its descendants), never
  the blocks of its own match: the JAX module may evict them, and its
  reservation then raises on a block that is no longer cached (ROADMAP.md
  §3); where it does not, the two shed the same blocks. A copy-on-write
  tail stays pinned from the match to the end of its restore, so an
  admission in the same round cannot evict it;
- **accounting**: every hit, miss and eviction goes through
  :meth:`PrefixCache._account`, which keeps the counts that
  :meth:`PrefixCache.stats` reports (the JAX module's keys). The JAX
  module's metric registry, flight ring and chaos hooks are not ported.

Not ported: ``ingest``, the receiving side of KV block streaming between
replicas (disaggregated serving, ROADMAP.md §1 slice 6).

Threads: the engine thread admits (in the scheduler's admission pass) and
donates (at retire); client threads only :meth:`PrefixCache.peek`, which
takes the lock and changes nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Optional

import numpy as np

from pytorch_distributed_nn_tpu_torch.serve.kv_pool import KVPool


def _digest(parent: bytes, tokens: np.ndarray) -> bytes:
    return hashlib.sha1(
        parent + np.asarray(tokens, np.int32).tobytes()).digest()


def _root(adapter: int) -> bytes:
    """The chain's seed. A block's KV depends on the LoRA adapter (its
    v-projection delta is in the cached rows), so the chain is namespaced
    by adapter id. Never a valid sha1 digest (wrong length), so a root
    cannot collide with a block's key."""
    return b"a%d|" % int(adapter)


@dataclasses.dataclass
class PrefixMatch:
    """One admission's match: ``blocks`` are shared by reference (the head
    of the sequence's block table), ``tail`` is the pinned copy-on-write
    source whose rows are restored but which is NOT in the table, and
    ``tokens`` is the prefill's offset m."""

    blocks: tuple[int, ...] = ()
    tail: Optional[int] = None
    tokens: int = 0

    @property
    def restore_blocks(self) -> tuple[int, ...]:
        return self.blocks + ((self.tail,) if self.tail is not None
                              else ())


class _Node:
    __slots__ = ("digest", "parent", "tokens", "phys", "children")

    def __init__(self, digest: bytes, parent: bytes,
                 tokens: np.ndarray, phys: int) -> None:
        self.digest = digest
        self.parent = parent
        self.tokens = np.asarray(tokens, np.int32)
        self.phys = int(phys)
        self.children: set[bytes] = set()


class PrefixCache:
    """Radix index of resident KV blocks, content-addressed."""

    def __init__(self, pool: KVPool, *, max_rows: int = 0) -> None:
        self.pool = pool
        self.block_size = pool.block_size
        # the most rows the engine's row cache can restore into (a
        # copy-on-write tail whose block would overflow it is not matched)
        self.max_rows = int(max_rows) or pool.num_blocks * pool.block_size
        self._lock = threading.Lock()
        self._nodes: dict[bytes, _Node] = {}
        self._by_phys: dict[int, bytes] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0

    def _account(self, op: str, *, tokens: int = 0) -> None:
        """Every counted event (a hit, a miss, an eviction) lands here, so
        the counts cannot drift from the index."""
        if op == "hit":
            self.hits += 1
            self.tokens_saved += tokens
        elif op == "miss":
            self.misses += 1
        elif op == "evict":
            self.evictions += 1

    # -- matching ----------------------------------------------------------

    def _match_locked(self, prompt: np.ndarray,
                      adapter: int = 0) -> PrefixMatch:
        """The longest resident chain, capped at ``len(prompt) - 1``
        tokens. Read-only."""
        bs = self.block_size
        cap = len(prompt) - 1
        blocks: list[int] = []
        root = _root(adapter)
        parent = root
        j = 0
        while (j + 1) * bs <= cap:
            d = _digest(parent, prompt[j * bs:(j + 1) * bs])
            node = self._nodes.get(d)
            if node is None:
                break
            blocks.append(node.phys)
            parent = d
            j += 1
        # a partial tail: the request diverges inside the next block, and a
        # child block whose first t tokens agree is restored copy-on-write
        # (if its whole block still fits the row cache)
        tail, t = None, cap - j * bs
        if 0 < t < bs and (j + 1) * bs <= self.max_rows:
            head = self._nodes.get(parent) if parent != root else None
            kids = (head.children if head is not None
                    else {d for d, n in self._nodes.items()
                          if n.parent == root})
            rest = prompt[j * bs:cap]
            for d in sorted(kids):
                node = self._nodes.get(d)
                if node is not None and np.array_equal(
                        node.tokens[:t], rest):
                    tail = node.phys
                    break
        m = j * bs + (t if tail is not None else 0)
        return PrefixMatch(blocks=tuple(blocks), tail=tail, tokens=m)

    def peek(self, prompt, adapter: int = 0) -> int:
        """The matched-token count, read-only: no counts, no LRU touch, no
        pins."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 2:
            return 0
        with self._lock:
            return self._match_locked(prompt, adapter).tokens

    def resident_chain(self, prompt, adapter: int = 0) -> PrefixMatch:
        """The resident chain of whole blocks for ``prompt``, read-only: no
        copy-on-write tail, nothing counted or touched."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 2:
            return PrefixMatch()
        with self._lock:
            m = self._match_locked(prompt, adapter)
        return PrefixMatch(blocks=m.blocks,
                           tokens=len(m.blocks) * self.block_size)

    # -- admission ---------------------------------------------------------

    def admit(self, seq_id: str, prompt, total_tokens: int,
              adapter: int = 0) -> Optional[PrefixMatch]:
        """Match and reserve one admission. Returns the match (its tokens
        may be 0) when the reservation landed, None on backpressure (the
        scheduler treats None as ``pool.reserve`` returning False). The
        copy-on-write tail is pinned here until :meth:`finish_restore`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            match = self._match_locked(prompt, adapter)
            if match.tail is not None:
                self.pool.pin(match.tail)
            need = (self.pool.blocks_for(total_tokens)
                    - len(match.blocks))
            short = need - self.pool.free_blocks
            if short > 0:
                # never the match's own blocks: a cached block of the chain
                # that became the LRU leaf would leave the index and the
                # reservation below would share a freed block
                self._evict_locked(short, keep=frozenset(match.blocks))
            if not self.pool.reserve(seq_id, total_tokens,
                                     shared=match.blocks):
                if match.tail is not None:
                    self.pool.unpin(match.tail)
                return None
            if match.tokens > 0:
                self._account("hit", tokens=match.tokens)
            else:
                self._account("miss")
            return match

    def make_room(self, blocks: int) -> int:
        """Shed up to ``blocks`` unpinned LRU cached blocks to the free
        list; returns the number shed. A branch's tail
        (:meth:`KVPool.fork`) comes straight off the free list, past
        :meth:`admit`'s reclaim: the scheduler calls this before retrying
        a fork that found the free list parked in the cached ring."""
        with self._lock:
            return self._evict_locked(int(blocks))

    def finish_restore(self, match: PrefixMatch) -> None:
        """Unpin the copy-on-write tail once its rows were copied into the
        admitted sequence's row cache."""
        if match.tail is None:
            return
        with self._lock:
            self.pool.unpin(match.tail)

    # -- donation and eviction ---------------------------------------------

    def release(self, seq_id: str, tokens, adapter: int = 0) -> int:
        """At retire: index the finished sequence's full blocks (a block
        whose chain is resident already is not indexed again) and free its
        table, keeping exactly the indexed blocks in the pool's cached
        ring. Returns the number of blocks that reached the free list."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        root = _root(adapter)
        with self._lock:
            table = self.pool.block_table(seq_id)
            retain: set[int] = set()
            parent = root
            for j in range(min(len(tokens) // bs, len(table))):
                d = _digest(parent, tokens[j * bs:(j + 1) * bs])
                node = self._nodes.get(d)
                if node is None:
                    node = _Node(d, parent, tokens[j * bs:(j + 1) * bs],
                                 table[j])
                    self._nodes[d] = node
                    self._by_phys[node.phys] = d
                    head = (self._nodes.get(parent)
                            if parent != root else None)
                    if head is not None:
                        head.children.add(d)
                if node.phys == table[j]:
                    retain.add(table[j])
                parent = d
            return self.pool.free(seq_id, retain=frozenset(retain))

    def abandon(self, seq_id: str) -> int:
        """The failure path's release: free the sequence's table without
        indexing anything, but keep the blocks the index already maps (a
        resident chain's blocks the sequence shared) in the cached ring."""
        with self._lock:
            table = self.pool.block_table(seq_id)
            retain = frozenset(b for b in table if b in self._by_phys)
            return self.pool.free(seq_id, retain=retain)

    def _evict_locked(self, need: int,
                      keep: frozenset[int] = frozenset()) -> int:
        """Shed up to ``need`` unpinned LRU leaf blocks not in ``keep``,
        each counted."""
        shed = 0
        progress = True
        while shed < need and progress:
            progress = False
            for phys in self.pool.cached_lru():
                if phys in keep:
                    continue
                d = self._by_phys.get(phys)
                if d is None:
                    # cached but never indexed: reclaim it anyway
                    if self.pool.release_cached(phys):
                        shed += 1
                        progress = True
                    continue
                node = self._nodes[d]
                if node.children & self._nodes.keys():
                    continue  # interior: evicting orphans descendants
                if not self.pool.release_cached(phys):
                    continue  # pinned: a copy-on-write restore in flight
                self._drop_locked(node)
                self._account("evict")
                shed += 1
                progress = True
                break
        return shed

    def _drop_locked(self, node: _Node) -> None:
        del self._nodes[node.digest]
        self._by_phys.pop(node.phys, None)
        head = self._nodes.get(node.parent) if node.parent else None
        if head is not None:
            head.children.discard(node.digest)

    # -- introspection -----------------------------------------------------

    @property
    def nodes(self) -> int:
        with self._lock:
            return len(self._nodes)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return dict(
                prefix_hits=self.hits, prefix_misses=self.misses,
                prefix_evictions=self.evictions,
                prefix_tokens_saved=self.tokens_saved,
                prefix_hit_rate=(self.hits / total if total else 0.0),
                prefix_nodes=len(self._nodes),
            )

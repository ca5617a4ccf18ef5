"""Request scheduler: bounded admission queue + prefill/decode policy.

Counterpart of the JAX package's ``serve/scheduler.py``, without its
observability, chaos and metering hooks and its trace contexts (slice 6,
ROADMAP.md §1 item 5). Clients call :meth:`Scheduler.submit` from any
thread; the engine loop (one thread) calls :meth:`next_admissions` once per
round. Policy:

- **backpressure**: the queue is bounded (``max_queue``, over every
  tenant); a submit that finds it full is rejected at once with reason
  ``backpressure``; oversize requests (``too_large``) are rejected at the
  same point;
- **tenant quotas**: ``tenant_quotas={"name": n}`` caps a tenant's live
  residency (queued + running; a best-of-n request holds one) at n; a
  submit past the cap is rejected ``tenant_quota``, checked before
  backpressure. The reject order is draining, too_large, tenant_quota,
  backpressure;
- **deficit round-robin across tenants, FIFO within one, no bypass**:
  each tenant has its own queue and admission rotates through the
  tenants in order of their first submit, one request a tenant a turn
  (an emptied tenant is skipped without spending a turn; the rotation
  moves once an admission), so a flooding tenant's light neighbour is at
  most one rotation away. If the head whose turn it is does not fit
  (batch slot or KV reservation), nothing more is admitted this round,
  across tenants too, so a big request cannot be starved by small ones;
  with reservation at admission every running sequence finishes within
  its budget;
- **prefix cache**: with a :class:`~serve.prefix_cache.PrefixCache`
  attached, admission goes through :meth:`PrefixCache.admit` (a resident
  shared prefix is reserved by reference, the match stored on the request
  for the engine's restore) and retirement donates the sequence's full
  blocks to the index (:meth:`PrefixCache.release`); a request's LoRA
  ``adapter`` namespaces its blocks;
- **interleave**: at most ``max_prefills_per_round`` admissions a round;
- **branches**: a best-of-n request (``decode``, a
  :class:`~serve.decoding.DecodeSpec`) needs one free slot a branch and
  reserves its primary plus one forked tail a branch, all or nothing;
- **deadlines**: a request whose deadline passes while queued is
  rejected (``deadline``) at the next round;
- **drain**: queued requests are rejected (``draining``) and so is every
  later submit.

Every state change goes through :meth:`Scheduler._transition`, which sets
``done`` exactly once, on the terminal transition, counts the transition
by tenant and state (:meth:`Scheduler.stats`, the labels of the JAX
``serve_tenant_requests_total{tenant,state}`` counter; its registry is
slice 6) and, with a ``metrics`` logger (``utils/metrics.py``), writes a
``serve_reject`` record for each rejection.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Optional

import numpy as np

from pytorch_distributed_nn_tpu_torch.serve.decoding import (
    DecodeSpec,
    TokenStream,
)
from pytorch_distributed_nn_tpu_torch.serve.kv_pool import KVPool

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
FAILED = "failed"
_TERMINAL = (DONE, REJECTED, FAILED)

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record. ``done`` is set
    exactly once, on any terminal transition; clients block on it."""

    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    request_id: str
    deadline_s: Optional[float] = None  # absolute time.monotonic()
    state: str = QUEUED
    reject_reason: str = ""
    tokens: Optional[np.ndarray] = None  # generated tokens, (<=n,) int32
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    round_submitted: int = -1
    round_admitted: int = -1
    round_done: int = -1
    # the quota and fairness identity, the per-request LoRA adapter (0:
    # the base model), and the PrefixMatch the admission stored for the
    # engine's restore
    tenant: str = "default"
    adapter: int = 0
    prefix_match: object = None
    # how this request's tokens are chosen; None is greedy with one branch
    decode: Optional[DecodeSpec] = None
    # the TokenStream the engine's _emit_chunk feeds; None: no streaming
    stream: Optional[TokenStream] = None
    # a branched request's results, best first: [{"branch", "tokens",
    # "logprob"}]; ``tokens`` is then the winner's and ``logprob`` its
    # cumulative log-probability
    n_best: Optional[list] = None
    logprob: float = 0.0
    # True while this request counts against its tenant's live residency
    # (set on QUEUED, dropped on any terminal transition)
    quota_held: bool = False

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    @property
    def branches(self) -> int:
        """Batch rows and KV tails this request decodes in parallel."""
        return self.decode.branches if self.decode is not None else 1

    @property
    def ok(self) -> bool:
        return self.state == DONE


def branch_seq_ids(req: Request) -> list[str]:
    """Pool sequence ids of a request's branches: branch 0 is the request
    id (an unbranched request's accounting is unchanged), branch k
    ``{id}#b{k}``."""
    rid = req.request_id
    return [rid] + [f"{rid}#b{k}" for k in range(1, req.branches)]


class Scheduler:
    """Admission queue + policy over a shared :class:`KVPool`."""

    def __init__(self, pool: KVPool, *, max_queue: int = 64,
                 max_seq_len: int = 0,
                 max_prefills_per_round: int = 2,
                 tenant_quotas: Optional[dict] = None,
                 prefix_cache=None) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_prefills_per_round < 1:
            raise ValueError("max_prefills_per_round must be >= 1, got "
                             f"{max_prefills_per_round}")
        self.pool = pool
        self.max_queue = max_queue
        self.max_seq_len = int(max_seq_len)
        self.max_prefills_per_round = max_prefills_per_round
        self.tenant_quotas = dict(tenant_quotas or {})
        for tenant, quota in self.tenant_quotas.items():
            if quota < 1:
                raise ValueError(f"tenant quota must be >= 1, got "
                                 f"{quota} for {tenant!r}")
        self.prefix_cache = prefix_cache  # PrefixCache | None
        self._lock = threading.Lock()
        # a FIFO deque a tenant, and the rotation ring (tenant names in
        # rotation order; the front tenant has the next turn)
        self._queues: dict[str, collections.deque[Request]] = {}
        self._rr: collections.deque[str] = collections.deque()
        self._queued = 0  # waiting over every tenant (the max_queue cap)
        self._live: dict[str, int] = {}  # tenant -> queued + running
        # (tenant, state) -> transitions: serve_tenant_requests_total
        self._tenant_counts: dict[tuple[str, str], int] = {}
        self.round = 0  # advanced by the engine, one per round
        self.draining = False
        self.metrics = None  # a MetricsLogger, set by the owning engine

    def _transition(self, req: Request, state: str,
                    reason: str = "") -> None:
        """EVERY request state change funnels through here: counted by
        tenant and state, the tenant's live residency held from QUEUED to
        any terminal state, and terminal states release the waiting client
        exactly once."""
        req.state = state
        key = (req.tenant, state)
        self._tenant_counts[key] = self._tenant_counts.get(key, 0) + 1
        if state == QUEUED and not req.quota_held:
            req.quota_held = True
            self._live[req.tenant] = self._live.get(req.tenant, 0) + 1
        elif state in _TERMINAL and req.quota_held:
            req.quota_held = False
            self._live[req.tenant] -= 1
        if state == REJECTED:
            req.reject_reason = reason
            if self.metrics is not None:
                self.metrics.emit("serve_reject", request_id=req.request_id,
                                  reason=reason, tenant=req.tenant)
        if state in _TERMINAL:
            req.t_done = time.monotonic()
            req.round_done = self.round
            if req.stream is not None:
                # idempotent: the engine's final chunk closed a DONE
                # stream; a rejected or failed one ends empty here
                req.stream.close()
            req.done.set()

    def submit(self, prompt, max_new_tokens: int, *,
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               tenant: str = "default",
               adapter: int = 0,
               decode: Optional[DecodeSpec] = None,
               stream: bool = False) -> Request:
        """Thread-safe admission attempt. Always returns a Request; a
        rejected one is already terminal (``reject_reason`` says why).
        ``tenant`` names its quota and its queue; ``adapter`` is its LoRA
        adapter. ``decode`` chooses
        sampling and branches (an all-default spec is the greedy path and
        is dropped); ``stream`` attaches a :class:`TokenStream` (one
        branch only)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if decode is not None and not isinstance(decode, DecodeSpec):
            raise ValueError(
                f"decode must be a serve.decoding.DecodeSpec, got "
                f"{type(decode).__name__}")
        if decode == DecodeSpec():
            decode = None  # the greedy path, exactly
        if stream and decode is not None and decode.branches > 1:
            raise ValueError(
                "stream=True requires a single branch (best_of/n == 1): "
                "n-best ranking needs every full stream before it can pick "
                "a winner")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      request_id=request_id or f"req-{next(_ids)}",
                      deadline_s=deadline_s, t_submit=time.monotonic(),
                      tenant=str(tenant), adapter=int(adapter),
                      decode=decode)
        if stream:
            req.stream = TokenStream(req.request_id)
        quota = self.tenant_quotas.get(req.tenant)
        with self._lock:
            req.round_submitted = self.round
            if self.draining:
                self._transition(req, REJECTED, reason="draining")
            elif self.max_seq_len and req.total_tokens > self.max_seq_len:
                self._transition(req, REJECTED, reason="too_large")
            elif quota is not None \
                    and self._live.get(req.tenant, 0) >= quota:
                self._transition(req, REJECTED, reason="tenant_quota")
            elif self._queued >= self.max_queue:
                self._transition(req, REJECTED, reason="backpressure")
            else:
                q = self._queues.get(req.tenant)
                if q is None:
                    q = self._queues[req.tenant] = collections.deque()
                    self._rr.append(req.tenant)
                q.append(req)
                self._queued += 1
                self._transition(req, QUEUED)
        return req

    def _reserve_locked(self, head: Request) -> bool:
        """One admission's KV reservation: the primary (through the prefix
        cache when one is attached), then one forked tail a further branch
        sharing the primary's full prompt blocks, all or nothing (a tail
        that does not fit rolls the whole admission back). False is
        backpressure."""
        pc = self.prefix_cache
        if pc is not None:
            match = pc.admit(head.request_id, head.prompt, head.total_tokens,
                             adapter=head.adapter)
            if match is None:
                return False
            head.prefix_match = match
        elif not self.pool.reserve(head.request_id, head.total_tokens):
            return False
        sids = branch_seq_ids(head)
        for k, sid in enumerate(sids[1:], start=1):
            def fork():
                return self.pool.fork(head.request_id, sid,
                                      head.total_tokens,
                                      shared_tokens=len(head.prompt))
            if fork():
                continue
            if pc is not None:
                # the tail comes straight off the free list, which may sit
                # in the cached ring: reclaim as admit() does for the
                # primary, or a branched head wedges the queue once
                # donations fill the pool
                short = (self.pool.blocks_for(head.total_tokens)
                         - len(head.prompt) // self.pool.block_size
                         - self.pool.free_blocks)
                if short > 0 and pc.make_room(short) and fork():
                    continue
            for forked in sids[1:k]:
                self.pool.free(forked)
            if pc is not None:
                # unpin the tail admit() pinned, then drop the primary
                # without donating anything
                pc.finish_restore(head.prefix_match)
                head.prefix_match = None
                pc.abandon(head.request_id)
            else:
                self.pool.free(head.request_id)
            return False
        return True

    def next_admissions(self, free_slots: int) -> list[Request]:
        """Pop the requests admitted this round: deficit round-robin across
        tenants (one request a tenant a turn), strict FIFO within a tenant.
        Each must fit a free batch slot a branch AND reserve its worst-case
        KV blocks; a head that cannot ends the round, across tenants too
        (no bypass). A head whose deadline passed is rejected without
        spending its tenant's turn."""
        admitted: list[Request] = []
        now = time.monotonic()
        with self._lock:
            while (self._queued and free_slots > 0
                   and len(admitted) < self.max_prefills_per_round):
                # the front of the rotation with work; an emptied tenant
                # is passed over without spending a turn
                for _ in range(len(self._rr)):
                    if self._queues[self._rr[0]]:
                        break
                    self._rr.rotate(-1)
                q = self._queues[self._rr[0]]
                head = q[0]
                if head.deadline_s is not None and now > head.deadline_s:
                    q.popleft()
                    self._queued -= 1
                    self._transition(head, REJECTED, reason="deadline")
                    continue
                if head.branches > free_slots:
                    break  # n branches need n rows now: no bypass
                if not self._reserve_locked(head):
                    break  # no bypass: wait for blocks to free
                q.popleft()
                self._queued -= 1
                head.t_admit = now
                head.round_admitted = self.round
                self._transition(head, RUNNING)
                admitted.append(head)
                free_slots -= head.branches
                self._rr.rotate(-1)  # this tenant's turn is spent
        return admitted

    def retire(self, req: Request, tokens: np.ndarray) -> None:
        """A sequence finished (eos or budget): free its blocks and hand
        the tokens to the waiting client. With a prefix cache the release
        is a donation: the full blocks of the written rows (the prompt and
        every emitted token but the last, whose KV row was never computed)
        are indexed and parked in the cached ring; the engine has saved
        their rows to its block store already."""
        req.tokens = np.asarray(tokens, np.int32)
        if self.prefix_cache is not None:
            covered = (np.concatenate([req.prompt, req.tokens[:-1]])
                       if len(req.tokens) else req.prompt)
            self.prefix_cache.release(req.request_id, covered,
                                      adapter=req.adapter)
        else:
            self.pool.free(req.request_id)
        with self._lock:
            self._transition(req, DONE)

    def release_branch(self, req: Request, seq_id: str) -> None:
        """Free ONE branch's reservation of a best-of-n request when it
        hits eos or its budget, while its siblings decode on (shared
        prompt blocks stay live until their last holder frees them).
        Branches never donate to the prefix index (n near-duplicate chains
        would churn it for no reuse), but every branch goes through
        ``abandon``, so the resident blocks the branches share stay with
        their chains whichever branch frees them last. (The JAX scheduler
        abandons the primary only: a later branch that frees a resident
        block last sends it to the free list while the index still maps
        it, ROADMAP.md §3.)"""
        if self.prefix_cache is not None:
            self.prefix_cache.abandon(seq_id)
        else:
            self.pool.free(seq_id)

    def finish_branches(self, req: Request, tokens, n_best: list,
                        logprob: float) -> None:
        """The terminal transition of a branched request, whose branches
        were all released: ``tokens`` are the winner's, ``n_best`` the
        ranked results."""
        req.tokens = np.asarray(tokens, np.int32)
        req.n_best = n_best
        req.logprob = float(logprob)
        with self._lock:
            self._transition(req, DONE)

    def fail(self, req: Request, reason: str) -> None:
        """Evict a running sequence (engine error path): every branch's
        blocks freed (a branch already released is a no-op), the client
        sees FAILED, not a hang."""
        for sid in branch_seq_ids(req):
            if self.prefix_cache is not None:
                self.prefix_cache.abandon(sid)  # as release_branch
            else:
                self.pool.free(sid)
        with self._lock:
            req.reject_reason = reason
            self._transition(req, FAILED)

    def drain(self) -> int:
        """Stop admitting and reject everything still queued (reason
        ``draining``). Returns the number rejected."""
        with self._lock:
            self.draining = True
            n = self._queued
            for q in self._queues.values():
                while q:
                    self._transition(q.popleft(), REJECTED,
                                     reason="draining")
            self._queued = 0
        return n

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._queued

    def stats(self) -> dict:
        """``{"serve_tenant_requests_total": {tenant: {state: n}}}``: the
        transitions into each state, by tenant (a request counts once in
        each state it passed through)."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            for (tenant, state), n in sorted(self._tenant_counts.items()):
                out.setdefault(tenant, {})[state] = n
        return {"serve_tenant_requests_total": out}

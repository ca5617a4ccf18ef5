"""Continuous-batching decode engine.

Counterpart of the JAX package's ``serve/engine.py``: a dense batched KV
cache of ``max_slots`` rows, stepped one token per round for every active
row, with finished rows retired mid-batch and newly admitted requests
prefilled into the freed rows. Policy is the scheduler's
(:mod:`serve.scheduler`); this module executes it. The KV cache is the
per-layer dict of :func:`inference.generate.init_cache`, written in place.

Correctness contract: greedy decode through the engine gives, for every
request, the tokens of a solo sequential ``inference.generate.generate``
of its prompt. Every row's attention is masked to its own filled cache
prefix and masked slots contribute exact zeros after the softmax, so
sharing a batch with strangers does not change a row's tokens. On the card
the bits also need each op to reduce a row in an order that the other
rows and the cache length do not change: the W8A16 kernel does so by
design, the float models' dense products take a decode step's rows in
fixed blocks of 8 (``nn.layers.dense_product``), and the attention's
products and the norms' row reductions do at the decode shapes
(``chip_smoke.py`` phase 7 holds the int8 8B's tokens, phase 32 a float
Llama's and the transformer LM's logits bit for bit); a
reduction's order does follow the number of rows from some count up, so
the prefill runs the prompt's own L rows with ``last_only``, as
``generate()`` does, not a padded bucket.

Hot loop: :meth:`ServingEngine._decode_round` keeps slot state (last
token, per-row depth, active mask, and the sampling rows: temperature,
top_k, top_p, seed, branch, step and cumulative log-probability) on the
device across rounds, makes no host->device copy, and fetches one (slots,)
array of tokens to the host per round. Admission and retirement push the
refreshed slot arrays once.

Decoding policy (``serve/decoding.py``): a batch of greedy rows runs
:func:`_serve_step`, the greedy step as it always was, so default requests
keep their tokens bit for bit; a batch with any sampled row runs
:func:`_serve_step_sample`, the same forward with per-row seeded sampling
(a greedy row in it still takes exactly its argmax). A best-of-n request
decodes its branches in ordinary rows from one prefill, each retiring at
its own eos or budget (:meth:`ServingEngine._retire_branch`), and is
ranked by cumulative log-probability. Streaming requests get their tokens
through the one :meth:`ServingEngine._emit_chunk` funnel, in chunks of
``stream_chunk_tokens``.

Prefix cache (``prefix_cache=True``, the default, as in the JAX engine;
``serve/prefix_cache.py``): a retiring sequence's full KV blocks are copied
into a device block store of ``num_blocks x block_size`` rows for every
cache tensor (the int8 cache's scales included) and indexed by content; an
admission whose prompt starts with a resident chain has those rows copied
from the store into its row cache and prefills only the suffix, at its
offset, through the model's ``cache_positions``. The store is indexed by
pool block id and written only at retire, for the ``depth // block_size``
full blocks the index then takes, so a block is never restored before its
rows were saved. The restored rows are the donor's bits; the suffix's rows
are what a full prefill computes for them where every op reduces a row in
an order that the number of rows does not change: W8A16 and the norms do,
the prefill's attention runs on fixed blocks of query rows
(``nn/attention.py``), and a suffix short enough to take the decode
step's attention re-prefills the rows before it
(``nn.attention.suffix_prefill_start``).
``chip_smoke.py`` phase 31 holds the tokens against the engine with the
cache off.

LoRA (``lora_bank``, ``nn/lora.py``, the Llama family): ``submit(adapter=
n)`` picks a request's adapter; a per-slot mirror of adapter ids rides the
decode step, so rows on different adapters share one batch, and the prefix
cache keys blocks by adapter, so adapters never share KV.

Tenants (``tenant_quotas``, ``submit(tenant=)``): the scheduler's quotas
and its deficit round-robin across tenants (``serve/scheduler.py``); each
finished record names its tenant, and :meth:`ServingEngine.summary` carries
the per-tenant counts by state.

Records: with ``metrics`` (a ``utils.metrics.MetricsLogger``) every
finished request is written as a ``serve_request`` record and every
rejection as ``serve_reject``, with the JAX records' keys.

Not ported (slice 6, ROADMAP.md §1 item 5): metering (and its per-tenant
split), audit, chaos (its ``tenant_flood`` drill included) and trace hooks
(the scheduler's ``trace_ctx``), the per-tenant TTFT histogram, and the
block export/ingest of disaggregated serving.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.inference.generate import (
    decode_step_ragged,
    init_cache,
)
from pytorch_distributed_nn_tpu_torch.nn.attention import (
    suffix_prefill_start,
)
from pytorch_distributed_nn_tpu_torch.nn.lora import num_adapters
from pytorch_distributed_nn_tpu_torch.serve import decoding
from pytorch_distributed_nn_tpu_torch.serve.kv_pool import KVPool
from pytorch_distributed_nn_tpu_torch.serve.prefix_cache import PrefixCache
from pytorch_distributed_nn_tpu_torch.serve.scheduler import (
    Request,
    Scheduler,
    branch_seq_ids,
)


def _serve_prefill(model, cache: dict, tokens: torch.Tensor, start: int,
                   **extra) -> torch.Tensor:
    """Batch-of-one prefill of the (1, T) prompt suffix: fills rows
    [start, start + T) of ``cache`` (the (1, pad) row cache, rows
    [0, start) restored from the prefix cache) in place, its queries
    attending to positions [0, start + t], and returns the (1, V)
    next-token logits (``last_only``, as ``generate()``'s prefill).
    ``extra`` is the per-request LoRA (``lora_bank``, ``adapter_ids``),
    given only with a bank, so models without LoRA see no unknown
    arguments."""
    starts = torch.full((1,), start, dtype=torch.int32, device=tokens.device)
    return model(tokens, cache=cache, cache_positions=starts,
                 last_only=True, **extra)[:, -1]


def _sample_first(next_logits: torch.Tensor, n: int, spec):
    """The first token of each of a request's ``n`` branches from one
    prefill's (1, V) logits: branch k draws with the key of (seed, k, 0),
    the derivation every decode step uses. Returns ((n,) int32
    tokens, (n,) f32 log-probabilities under the model's distribution)."""
    dev = next_logits.device
    logits = next_logits[:1].expand(n, -1)

    def full(v, dtype):
        return torch.full((n,), v, dtype=dtype, device=dev)

    keys = decoding.row_keys(full(spec.seed, torch.int64),
                             torch.arange(n, device=dev),
                             full(0, torch.int64))
    toks = decoding.sample_rows(
        logits, full(spec.temperature, torch.float32),
        full(spec.top_k, torch.int32), full(spec.top_p, torch.float32),
        keys).to(torch.int32)
    return toks, decoding.token_logprobs(logits, toks)


def _serve_step(model, cache: dict, last_tok: torch.Tensor,
                lengths: torch.Tensor, active: torch.Tensor, **extra):
    """One decode round over all slots: feed every row its last token at
    its own cache depth, take the greedy argmax. Inactive rows still flow
    through the batched forward; their token and depth stay frozen, and
    their cache writes land in retired rows that the next occupant's
    prefill overwrites (clamped at the buffer's end, as the JAX code's
    ``dynamic_update_slice`` clamps). ``extra``: the per-row LoRA, as in
    :func:`_serve_prefill`."""
    logits = decode_step_ragged(model, cache, last_tok, lengths, **extra)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt = torch.where(active, nxt, last_tok)
    lengths = torch.where(active, lengths + 1, lengths)
    return nxt, lengths


def _serve_step_sample(model, cache: dict, last_tok, lengths, active,
                       temps, top_ks, top_ps, seeds, branches, steps,
                       logprob, **extra):
    """The sampled twin of :func:`_serve_step`: the same forward (a greedy
    row of the batch sees the same logits and takes its argmax), then
    per-row seeded sampling. Each active row's step and cumulative
    log-probability advance on the device, so the round needs no other
    host transfer."""
    logits = decode_step_ragged(model, cache, last_tok, lengths, **extra)
    keys = decoding.row_keys(seeds, branches, steps)
    drawn = decoding.sample_rows(logits, temps, top_ks, top_ps,
                                 keys).to(torch.int32)
    logprob = torch.where(
        active, logprob + decoding.token_logprobs(logits, drawn), logprob)
    nxt = torch.where(active, drawn, last_tok)
    lengths = torch.where(active, lengths + 1, lengths)
    steps = torch.where(active, steps + 1, steps)
    return nxt, lengths, steps, logprob


def _insert_row(batch_cache: dict, row_cache: dict, slot: int) -> None:
    """Copy a prefilled batch-of-one cache into batch row ``slot`` (rows
    [0, pad) of it), in place: every per-row tensor (K/V and, for the int8
    cache, their scales). The 0-d counters (``cache_index``,
    ``pos_index``) are untouched: per-row mode never reads them."""
    for key, b in batch_cache.items():
        r = row_cache[key]
        if isinstance(b, dict):
            _insert_row(b, r, slot)
        elif b.dim() >= 2:
            b[slot:slot + 1, :r.shape[1]].copy_(r)


def _block_store(cache: dict, num_blocks: int, block_size: int) -> dict:
    """The prefix cache's device block store for a decode cache: for every
    per-row tensor (K/V and, for the int8 cache, their scales) zeros of
    (num_blocks, block_size, ...) in its dtype on its device. The 0-d
    counters have no rows and no entry."""
    out = {}
    for key, v in cache.items():
        if isinstance(v, dict):
            out[key] = _block_store(v, num_blocks, block_size)
        elif v.dim() >= 2:
            out[key] = torch.zeros((num_blocks, block_size) + v.shape[2:],
                                   dtype=v.dtype, device=v.device)
    return out


def _save_blocks(cache: dict, store: dict, slot: int,
                 table: torch.Tensor) -> None:
    """Copy rows [0, n * block_size) of batch row ``slot`` into the store's
    blocks ``table`` ((n,) int64 on the device), block j's rows into
    ``store[table[j]]``: the retire side's donation."""
    for key, st in store.items():
        c = cache[key]
        if isinstance(st, dict):
            _save_blocks(c, st, slot, table)
            continue
        n, bs = table.numel(), st.shape[1]
        st[table] = c[slot, :n * bs].reshape((n, bs) + st.shape[2:])


def _restore_blocks(row_cache: dict, store: dict,
                    table: torch.Tensor) -> None:
    """Copy the store's blocks ``table`` ((n,) int64 on the device) into
    rows [0, n * block_size) of a batch-of-one row cache: the admission
    side's restore (the row cache holds at least n * block_size rows)."""
    for key, st in store.items():
        r = row_cache[key]
        if isinstance(st, dict):
            _restore_blocks(r, st, table)
            continue
        rows = table.numel() * st.shape[1]
        r[0, :rows] = st[table].reshape((rows,) + st.shape[2:])


def _bucket_len(n: int, floor: int = 16) -> int:
    """Round a prompt length up to a power of two (>= ``floor``): the row
    cache a prefill fills then takes O(log max_seq_len) shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


class _Slot:
    """Host-side mirror of one batch row (one decode branch)."""

    __slots__ = ("req", "emitted", "tokens", "depth", "cached", "seq_id",
                 "branch", "streamed")

    def __init__(self, req: Request, first_token: int, depth: int,
                 cached: int = 0, seq_id: str = "", branch: int = 0) -> None:
        self.req = req
        self.tokens = [int(first_token)]
        self.emitted = 1
        self.depth = depth  # cache rows filled (prompt + emitted - 1)
        self.cached = cached  # prompt tokens restored from the prefix cache
        # the pool sequence this row extends (the request id for branch
        # 0) and the branch's RNG lane
        self.seq_id = seq_id or req.request_id
        self.branch = branch
        self.streamed = 0  # tokens already pushed to req.stream


class ServingEngine:
    """Continuous-batching engine over one model (its parameters live in
    the module, on its device). ``prefix_cache`` (default on) shares the
    KV of resident prompt prefixes; ``lora_bank`` (``nn/lora.py``) serves
    per-request adapters; ``tenant_quotas`` caps each named tenant's live
    requests; ``metrics`` writes the request records."""

    def __init__(self, model, *, max_slots: int = 4,
                 max_seq_len: int = 256, block_size: int = 16,
                 max_queue: int = 64, max_prefills_per_round: int = 2,
                 eos_token: Optional[int] = None, metrics=None,
                 prefix_cache: bool = True,
                 lora_bank: Optional[dict] = None,
                 tenant_quotas: Optional[dict] = None,
                 stream_chunk_tokens: int = 1) -> None:
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        self.max_seq_len = int(max_seq_len)
        self.eos_token = eos_token
        self.metrics = metrics  # MetricsLogger or None
        # the stacked adapter factors, on the model's device
        self.lora_bank = None if lora_bank is None else {
            k: v.to(self.device) for k, v in lora_bank.items()}
        pool = KVPool(
            num_blocks=max_slots * (-(-self.max_seq_len // block_size)),
            block_size=block_size)
        self._cache = init_cache(model, max_slots, self.max_seq_len)
        if prefix_cache:
            self.prefix_cache: Optional[PrefixCache] = PrefixCache(
                pool, max_rows=self.max_seq_len)
            # retiring sequences donate their blocks' rows here; admissions
            # with a match restore from here (never aliased into _cache)
            self._store: Optional[dict] = _block_store(
                self._cache, pool.num_blocks, block_size)
        else:
            self.prefix_cache = None
            self._store = None
        self.scheduler = Scheduler(
            pool, max_queue=max_queue, max_seq_len=self.max_seq_len,
            max_prefills_per_round=max_prefills_per_round,
            tenant_quotas=tenant_quotas, prefix_cache=self.prefix_cache)
        self.scheduler.metrics = metrics
        self._slots: list[Optional[_Slot]] = [None] * max_slots
        self._h_last = np.zeros((max_slots,), np.int32)
        self._h_depth = np.zeros((max_slots,), np.int32)
        self._h_active = np.zeros((max_slots,), bool)
        self._h_adapter = np.zeros((max_slots,), np.int64)
        # the sampling rows, synced with the three above; the sampled step
        # reads them as per-row tensors, and advances the steps and the
        # cumulative log-probabilities on the device
        self._h_temp = np.zeros((max_slots,), np.float32)
        self._h_topk = np.zeros((max_slots,), np.int32)
        self._h_topp = np.zeros((max_slots,), np.float32)
        self._h_seed = np.zeros((max_slots,), np.int64)
        self._h_branch = np.zeros((max_slots,), np.int64)
        self._h_step = np.zeros((max_slots,), np.int64)
        self._d_logprob = torch.zeros((max_slots,), device=self.device)
        # prefill-drawn first-token log-probabilities, merged into
        # _d_logprob at the next sync (slot -> value)
        self._pending_logprob: dict[int, float] = {}
        self._n_sampled = 0  # active rows that need the sampled step
        # best-of-n: request_id -> {branch: (tokens, logprob)}
        self._branch_done: dict[str, dict[int, tuple]] = {}
        self.stream_chunk_tokens = max(int(stream_chunk_tokens), 1)
        self._sync_slots()
        # bench/report feed: per-round wall seconds + finished requests
        self.round_seconds: list[float] = []
        self.completed: list[dict] = []
        self._occ_sum = 0  # sum of per-round active-slot counts

    # -- client surface ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, **kw) -> Request:
        adapter = int(kw.get("adapter", 0))
        if self.lora_bank is not None:
            n = num_adapters(self.lora_bank)
            if not 0 <= adapter < n:
                raise ValueError(
                    f"adapter {adapter} out of range for a LoRA bank "
                    f"of {n} adapters")
        elif adapter != 0:
            raise ValueError(
                f"adapter {adapter} requested but the engine has no "
                f"LoRA bank (pass lora_bank= to ServingEngine)")
        spec = kw.get("decode")
        if spec is not None \
                and getattr(spec, "branches", 1) > self.max_slots:
            raise ValueError(
                f"best_of={getattr(spec, 'branches', 1)} branches can "
                f"never fit a {self.max_slots}-slot engine")
        return self.scheduler.submit(prompt, max_new_tokens, **kw)

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def has_work(self) -> bool:
        return self.active_slots > 0 or self.scheduler.queue_depth > 0

    # -- engine loop pieces (one driving thread) ---------------------------

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler round: admit + prefill into free slots, one batched
        decode round, retire finished rows. False when there was nothing
        to do."""
        self.scheduler.round += 1
        changed = self._admit()
        if self.active_slots == 0:
            return changed
        host_tok, dt = self._decode_round()
        self.round_seconds.append(dt)
        self._occ_sum += self.active_slots
        if self._collect(host_tok):
            self._sync_slots()
        return True

    def run_until_idle(self) -> None:
        """Drive rounds until queue and batch are both empty."""
        while self.has_work:
            self.step()

    def drain(self) -> int:
        """Graceful shutdown: reject everything queued, finish every
        in-flight sequence. Returns the number of requests rejected."""
        rejected = self.scheduler.drain()
        while self.active_slots > 0:
            self.step()
        return rejected

    # -- internals ---------------------------------------------------------

    def _admit(self) -> bool:
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return False
        admitted = self.scheduler.next_admissions(len(free))
        if not admitted:
            return False
        for req in admitted:
            # a branched request takes one row a branch (the scheduler
            # counted them against the free slots)
            self._prefill_into([free.pop(0) for _ in range(req.branches)],
                               req)
        # a budget-1 (or instant-eos) request retires in the same pass
        self._retire_finished()
        self._sync_slots()
        return True

    def _lora(self, ids: torch.Tensor) -> dict:
        """The model's LoRA arguments for rows on adapters ``ids``; none
        without a bank."""
        if self.lora_bank is None:
            return {}
        return dict(lora_bank=self.lora_bank, adapter_ids=ids)

    def _prefill_into(self, slots: list, req: Request) -> None:
        """Prefill ONE request into ``len(slots)`` batch rows. The rows of
        a prefix-cache match are copied from the block store into a
        batch-of-one row cache of a power-of-two length (at least the
        restored top and the prompt), and the rest of the prompt runs
        once, unpadded (``generate()``'s rows: on the card a row
        reduction's order follows the number of rows), at its offset; the
        row cache is copied into every branch's row, and each branch draws
        its first token from the same logits with its own RNG lane."""
        L = len(req.prompt)
        spec = req.decode
        sampled = spec is not None and spec.sampled
        match = req.prefix_match
        m = match.tokens if match is not None else 0
        bs = self.scheduler.pool.block_size
        restore = match.restore_blocks if match is not None else ()
        row_cache = init_cache(self.model, 1, min(
            _bucket_len(max(L, len(restore) * bs)), self.max_seq_len))
        if m > 0:
            _restore_blocks(row_cache, self._store, torch.tensor(
                restore, dtype=torch.int64, device=self.device))
        ids = torch.full((1,), req.adapter, dtype=torch.int64,
                         device=self.device)
        # a suffix that would take the decode step's attention (another
        # summation order) starts earlier, so its bits are the full
        # prefill's
        start = suffix_prefill_start(m, L)
        logits = _serve_prefill(self.model, row_cache, torch.tensor(
            req.prompt[None, start:], device=self.device), start,
            **self._lora(ids))
        if match is not None:
            # the restored rows are copied: the tail's pin can drop
            self.prefix_cache.finish_restore(match)
            req.prefix_match = None
        logps = None
        if not sampled:  # the greedy first token
            firsts = [int(torch.argmax(logits, dim=-1).cpu()[0])]
        else:
            toks, lps = _sample_first(logits, len(slots), spec)
            firsts = toks.cpu().tolist()
            logps = lps.cpu().tolist()
        req.t_first_token = time.monotonic()
        sids = branch_seq_ids(req)
        for k, slot in enumerate(slots):
            _insert_row(self._cache, row_cache, slot)
            s = _Slot(req, firsts[k], depth=L, cached=m, seq_id=sids[k],
                      branch=k)
            self._slots[slot] = s
            self._h_last[slot] = firsts[k]
            self._h_depth[slot] = L
            self._h_active[slot] = True
            self._h_adapter[slot] = req.adapter
            # slots are reused: a greedy row on a retired sampled row must
            # read temperature 0 (the sampled step's per-row greedy arm)
            self._h_temp[slot] = spec.temperature if sampled else 0.0
            self._h_topk[slot] = spec.top_k if sampled else 0
            self._h_topp[slot] = spec.top_p if sampled else 0.0
            self._h_seed[slot] = spec.seed if sampled else 0
            self._h_branch[slot] = k
            self._pending_logprob[slot] = logps[k] if sampled else 0.0
            if k == 0:
                self._emit_chunk(s)  # the first chunk: the TTFT event

    def _decode_round(self):
        """THE hot loop body: no host->device copies, device-resident slot
        state, one (slots,) device->host fetch."""
        t0 = time.monotonic()
        lora = self._lora(self._d_adapter)
        if self._n_sampled == 0:
            # an all-greedy batch: the greedy step as it always was
            nxt, depth = _serve_step(self.model, self._cache, self._d_last,
                                     self._d_depth, self._d_active, **lora)
        else:
            nxt, depth, self._d_step, self._d_logprob = _serve_step_sample(
                self.model, self._cache, self._d_last, self._d_depth,
                self._d_active, self._d_temp, self._d_topk, self._d_topp,
                self._d_seed, self._d_branch, self._d_step,
                self._d_logprob, **lora)
        self._d_last, self._d_depth = nxt, depth
        host_tok = nxt.cpu().numpy()
        return host_tok, time.monotonic() - t0

    def _collect(self, host_tok: np.ndarray) -> int:
        """Fold one round's tokens into the host mirrors and retire rows
        that hit eos or budget. Returns the number retired."""
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            tok = int(host_tok[i])
            s.tokens.append(tok)
            s.emitted += 1
            s.depth += 1
            self._h_last[i] = tok
            self._h_depth[i] = s.depth
            self.scheduler.pool.extend(s.seq_id, s.depth)
            if s.req.stream is not None and \
                    len(s.tokens) - s.streamed >= self.stream_chunk_tokens:
                self._emit_chunk(s)
        return self._retire_finished()

    def _done(self, s: _Slot) -> bool:
        if s.emitted >= s.req.max_new_tokens:
            return True
        return self.eos_token is not None and \
            s.tokens[-1] == self.eos_token

    def _retire_finished(self) -> int:
        retired = 0
        for i, s in enumerate(self._slots):
            if s is None or not self._done(s):
                continue
            self._slots[i] = None
            self._h_active[i] = False
            retired += 1
            if s.req.branches > 1:
                self._retire_branch(i, s)
                continue
            if self._store is not None:
                # save BEFORE retire: the release indexes the blocks, so
                # their rows must be in the store when a match can find them
                self._donate_blocks(i, s)
            # the closing chunk is in the stream before done wakes the
            # client
            self._emit_chunk(s, final=True)
            self.scheduler.retire(s.req, np.asarray(s.tokens, np.int32))
            self._finish_record(s)
        return retired

    def _retire_branch(self, slot: int, s: _Slot) -> None:
        """Retire ONE branch of a best-of-n request at its own eos or
        budget: bank its tokens and cumulative log-probability and free
        its KV tail while its siblings decode on. The request retires with
        its last branch: ranked by log-probability (branch index breaking
        ties), the top ``n`` handed to the client."""
        req = s.req
        # the retirement path may fetch; a branch that retires in the
        # pass that prefilled it has its value still pending
        lp = self._pending_logprob.pop(slot, None)
        if lp is None:
            lp = float(self._d_logprob[slot].cpu())
        self.scheduler.release_branch(req, s.seq_id)
        done = self._branch_done.setdefault(req.request_id, {})
        done[s.branch] = (list(s.tokens), lp)
        if len(done) < req.branches:
            return
        del self._branch_done[req.request_id]
        order = sorted(done.items(), key=lambda kv: (-kv[1][1], kv[0]))
        n_best = [dict(branch=k, tokens=list(t), logprob=v)
                  for k, (t, v) in order][:req.decode.n]
        win_tokens, win_lp = done[order[0][0]]
        s.tokens = win_tokens  # the record carries the winner
        s.emitted = len(win_tokens)
        self.scheduler.finish_branches(
            req, np.asarray(win_tokens, np.int32), n_best, win_lp)
        self._finish_record(s)

    def _emit_chunk(self, s: _Slot, final: bool = False) -> None:
        """THE streaming funnel: every token chunk a client sees goes
        through this one ``TokenStream._feed`` call. No-op for a request
        that does not stream."""
        stream = s.req.stream
        if stream is None:
            return
        chunk = s.tokens[s.streamed:]
        if chunk:
            s.streamed = len(s.tokens)
            stream._feed(chunk)
        if final:
            stream.close()

    def _donate_blocks(self, slot: int, s: _Slot) -> None:
        """Copy the retiring row's full KV blocks into the block store:
        ``depth // block_size`` of them, what ``PrefixCache.release`` will
        index (depth = the prompt and every emitted token but the last).
        Saving a block the index already holds writes the same bits."""
        pool = self.scheduler.pool
        table = pool.block_table(s.req.request_id)
        nb = min(s.depth // pool.block_size, len(table))
        if nb:
            _save_blocks(self._cache, self._store, slot, torch.tensor(
                table[:nb], dtype=torch.int64, device=self.device))

    def _finish_record(self, s: _Slot) -> None:
        req = s.req
        decode = req.t_done - req.t_first_token
        # the request's timeline: queue -> prefill -> decode, and its rounds
        waterfall = dict(
            queued_s=round(max(req.t_admit - req.t_submit, 0.0), 6),
            prefill_s=round(max(req.t_first_token - req.t_admit, 0.0), 6),
            decode_s=round(max(decode, 0.0), 6),
            round_submitted=req.round_submitted,
            round_admitted=req.round_admitted,
            round_done=req.round_done,
        )
        rec = dict(
            request_id=req.request_id, prompt_len=len(req.prompt),
            new_tokens=s.emitted, ttft_s=req.t_first_token - req.t_submit,
            total_s=req.t_done - req.t_submit,
            per_token_s=decode / max(s.emitted - 1, 1),
            rounds_waited=req.round_admitted - req.round_submitted,
            kv_util=self.scheduler.pool.utilization(),
            waterfall=waterfall, tenant=req.tenant,
            adapter=req.adapter, cached_tokens=s.cached,
        )
        # absent for default requests, as in the JAX records
        if req.decode is not None:
            rec["decode"] = req.decode.to_wire()
        if req.n_best is not None:
            rec["branches"] = req.branches
            rec["logprob"] = round(req.logprob, 6)
        if req.stream is not None:
            rec["stream_chunks"] = req.stream.chunks
        self.completed.append(rec)
        if self.metrics is not None:
            self.metrics.emit("serve_request", **rec)

    def _sync_slots(self) -> None:
        """Push the host slot mirrors to the device (admission/retirement
        path only, never per round)."""
        dev = self.device
        # torch.tensor copies: a CPU tensor must not alias the mirrors
        self._d_last = torch.tensor(self._h_last, device=dev)
        self._d_depth = torch.tensor(self._h_depth, device=dev)
        self._d_active = torch.tensor(self._h_active, device=dev)
        self._d_adapter = torch.tensor(self._h_adapter, device=dev)
        # each row's RNG step is recomputed host-side (emitted tokens)
        self._n_sampled = 0
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            self._h_step[i] = s.emitted
            if s.req.decode is not None and s.req.decode.sampled:
                self._n_sampled += 1
        if self._n_sampled or self._pending_logprob:
            # the log-probabilities accumulate on the device: overlay the
            # prefill's first-token values
            h_logprob = self._d_logprob.cpu().numpy().copy()
            for slot, v in self._pending_logprob.items():
                h_logprob[slot] = v
            self._pending_logprob.clear()
            self._d_logprob = torch.tensor(h_logprob, device=dev)
        self._d_temp = torch.tensor(self._h_temp, device=dev)
        self._d_topk = torch.tensor(self._h_topk, device=dev)
        self._d_topp = torch.tensor(self._h_topp, device=dev)
        self._d_seed = torch.tensor(self._h_seed, device=dev)
        self._d_branch = torch.tensor(self._h_branch, device=dev)
        self._d_step = torch.tensor(self._h_step, device=dev)

    def summary(self) -> dict:
        """Engine-lifetime aggregates."""
        rounds = len(self.round_seconds)
        out = dict(
            rounds=rounds,
            requests_done=len(self.completed),
            tokens_out=int(sum(r["new_tokens"] for r in self.completed)),
            occupancy=self._occ_sum / max(rounds * self.max_slots, 1),
            kv_util=self.scheduler.pool.utilization(),
            queue_depth=self.scheduler.queue_depth,
        )
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        out.update(self.scheduler.stats())
        return out

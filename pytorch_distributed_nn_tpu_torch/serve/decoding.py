"""Per-request decoding policy for the serving engine: the JAX package's
``serve/decoding.py``.

A :class:`DecodeSpec` says how one request's tokens are chosen
(temperature, top-k and top-p sampling, how many branches to decode and
how many completions to return) and rides the request from
:meth:`serve.server.InferenceServer.submit` through the scheduler into
:class:`serve.engine.ServingEngine`, whose sampled step takes it as
per-row device tensors.

Contracts, as in the JAX package:

- **inert defaults**: ``DecodeSpec()`` (temperature 0, one branch) is the
  greedy path; the scheduler drops it, and the engine runs default
  requests through its greedy step, so their tokens are bit for bit what
  they were without this module;
- **seeded determinism**: a sampled token is drawn with the key
  ``fold_in(fold_in(PRNGKey(seed), branch), step)`` (:func:`row_keys`,
  JAX's threefry in ``utils/threefry.py``), a pure function of
  ``(seed, branch, step)``: the same request and seed give the same
  stream whatever batch it shares, and the JAX engine's stream;
- **per-row masking**: temperature, top_k and top_p are (slots,) tensors,
  so one step serves every mix of greedy and sampled rows; a
  temperature-0 row takes exactly its argmax;
- **n-best shares the prompt**: ``best_of`` branches share the prompt's
  refcounted KV blocks (:meth:`serve.kv_pool.KVPool.fork`) and are ranked
  by cumulative log-probability under the model's distribution.

:class:`TokenStream` is the client half of streaming: the engine's one
``_emit_chunk`` funnel feeds it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.utils import threefry

_WIRE_FIELDS = ("temperature", "top_k", "top_p", "n", "best_of", "seed")


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """How one request's tokens are chosen. Immutable; a bad spec raises
    at construction, so it never reaches the scheduler."""

    temperature: float = 0.0  # 0.0 = greedy (argmax); seed is inert
    top_k: int = 0            # 0 = no top-k mask
    top_p: float = 0.0        # 0.0 = no nucleus mask; else (0, 1]
    n: int = 1                # completions returned (req.n_best)
    best_of: int = 0          # branches decoded; 0 = n
    seed: int = 0             # per-request RNG root

    def __post_init__(self) -> None:
        if not (self.temperature >= 0.0
                and self.temperature == self.temperature):
            raise ValueError(
                f"temperature must be finite and >= 0, got "
                f"{self.temperature!r}")
        if not (isinstance(self.top_k, int) and self.top_k >= 0):
            raise ValueError(f"top_k must be an int >= 0, got "
                             f"{self.top_k!r}")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got "
                             f"{self.top_p!r}")
        if not (isinstance(self.n, int) and self.n >= 1):
            raise ValueError(f"n must be an int >= 1, got {self.n!r}")
        if not (isinstance(self.best_of, int) and self.best_of >= 0):
            raise ValueError(f"best_of must be an int >= 0, got "
                             f"{self.best_of!r}")
        if self.best_of and self.best_of < self.n:
            raise ValueError(
                f"best_of ({self.best_of}) must be >= n ({self.n}): "
                f"cannot return more completions than were decoded")
        if not (isinstance(self.seed, int) and 0 <= self.seed < 2 ** 31):
            raise ValueError(
                f"seed must be an int in [0, 2**31), got {self.seed!r}")

    @property
    def branches(self) -> int:
        """Parallel completions decoded (batch rows and KV tails the
        request occupies)."""
        return self.best_of or self.n

    @property
    def sampled(self) -> bool:
        """Whether the spec needs the sampled step. Temperature 0 with one
        branch is greedy whatever top_k/top_p say (the argmax survives any
        mask)."""
        return not (self.temperature == 0.0 and self.branches == 1)

    def to_wire(self) -> dict:
        """The fields that differ from the defaults (a default spec adds
        no key at all)."""
        default = DecodeSpec()
        return {f: getattr(self, f) for f in _WIRE_FIELDS
                if getattr(self, f) != getattr(default, f)}

    @classmethod
    def from_wire(cls, d: dict) -> "DecodeSpec":
        unknown = set(d) - set(_WIRE_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown DecodeSpec wire keys {sorted(unknown)!r}; "
                f"known: {list(_WIRE_FIELDS)}")
        return cls(**d)


class TokenStream:
    """Client-side iterator over one request's token chunks. The engine's
    ``_emit_chunk`` is the only producer (:meth:`_feed`); :meth:`close` is
    idempotent and runs on every terminal transition, so a rejected or
    failed request gives an empty, terminated stream, never a hang.
    Iterate once."""

    def __init__(self, request_id: str = "") -> None:
        self.request_id = request_id
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._closed = False
        self.chunks = 0  # chunks fed

    def _feed(self, chunk) -> None:
        """Engine only: push one token chunk."""
        self._q.put(np.asarray(chunk, np.int32))
        self.chunks += 1

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def tokens(self) -> np.ndarray:
        """Every chunk concatenated (blocks until the stream closes)."""
        chunks = list(self)
        if not chunks:
            return np.zeros((0,), np.int32)
        return np.concatenate(chunks)


# -- the sampling math, on (B, V) tensors ------------------------------------


def row_keys(seeds: torch.Tensor, branches: torch.Tensor,
             steps: torch.Tensor) -> torch.Tensor:
    """(B, 2) keys ``fold_in(fold_in(PRNGKey(seed), branch), step)``, one a
    row, on the seeds' device."""
    k = threefry.prng_key(seeds.to(torch.int64))
    k = threefry.fold_in(k, branches.to(torch.int64))
    return threefry.fold_in(k, steps.to(torch.int64))


def _mask_one(logits: torch.Tensor, top_k: torch.Tensor,
              top_p: torch.Tensor) -> torch.Tensor:
    """Each row's top-k, then top-p, mask of (B, V) f32 logits with per-row
    k (B,) and p (B,) (0 turns each off): the JAX ``_mask_one`` under
    ``vmap``. The k-th largest value comes from a sorted copy, and the
    nucleus is computed over the top-k-masked distribution: the smallest
    prefix of the sorted probabilities whose mass before a token is below
    p (the first token always stays)."""
    v = logits.shape[-1]
    inf = torch.tensor(float("inf"), device=logits.device)
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = desc.gather(-1, (top_k.clamp(1, v) - 1).to(torch.int64)[:, None])
    k_off = (top_k <= 0)[:, None]
    logits = torch.where(k_off | (logits >= kth), logits, -inf)
    desc = torch.where(k_off | (desc >= kth), desc, -inf)
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    nucleus = cum - probs < top_p[:, None]
    cutoff = torch.where(nucleus, desc, inf).amin(-1, keepdim=True)
    keep_p = (top_p <= 0.0)[:, None] | (logits >= cutoff)
    return torch.where(keep_p, logits, -inf)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor,
                top_ks: torch.Tensor, top_ps: torch.Tensor,
                keys: torch.Tensor) -> torch.Tensor:
    """(B,) tokens from (B, V) f32 logits with per-row temperature, top_k,
    top_p and (B, 2) keys: the argmax of the masked logits over max(t,
    1e-6) plus the key's Gumbel noise; a temperature-0 row takes exactly
    its argmax, whatever its mask parameters say."""
    greedy = torch.argmax(logits, dim=-1)
    masked = _mask_one(logits, top_ks, top_ps)
    scaled = masked / torch.clamp(temps, min=1e-6)[:, None]
    drawn = threefry.categorical(keys, scaled)
    return torch.where(temps == 0.0, greedy, drawn)


def token_logprobs(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """(B,) log-probabilities of the chosen tokens under the model's
    distribution (the raw logits, before masking or scaling): the n-best
    ranking scale, the same for greedy and sampled branches."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(1, toks.to(torch.int64)[:, None])[:, 0]

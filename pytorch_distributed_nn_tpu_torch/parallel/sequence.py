"""Sequence (context) parallelism over ``torch.distributed``: the JAX
package's ``parallel/sequence.py``. Two exact schemes over the ``seq``
ring of a :class:`~runtime.mesh.SeqGroup`; activations are sequence-sharded
(B, Tl, H, D), shard i holding the global positions [i Tl, (i + 1) Tl).

- :func:`ring_attention`: Q stays put, K/V shards rotate around the ring
  (:func:`ops.collectives.shift_right`, one batch of P2P ops a step) while
  an online softmax accumulates each visiting shard. ``impl='pallas'`` runs
  each step's update in the CUDA block kernel (``ops/ring_attention.py``)
  and the backward through the port's flash dq and dk/dv kernels a pair at
  a time, with f32 dk/dv accumulators riding the ring; ``impl='xla'`` is the
  plain differentiable schedule; ``'auto'`` is ``pallas`` on CUDA and
  ``xla`` on the CPU (the JAX ``'auto'`` is ``pallas`` on the TPU only).
  On a CPU tensor ``pallas`` runs the kernels' plain versions. Its
  per-pair steps (:func:`ring_order`, :func:`ring_forward_pair`,
  :func:`ring_finish`, :func:`ring_backward_pair`) are public, so a ring's
  pairs can be replayed in one process, as ``chip_smoke.py`` does on one
  card.
- :func:`ulysses_attention`: all-to-alls reshard seq <-> heads around an
  ordinary full-sequence attention over H/s heads.

The K/V that ride the ring stay grouped (Hkv heads): expanding them first
would multiply every exchange by H/Hkv. Every rank issues the same P2P ops
in the same order, forward, backward and a remat's recompute alike.
"""

from __future__ import annotations

import torch

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_delta,
)
from pytorch_distributed_nn_tpu_torch.ops.ring_attention import (
    ring_block_update,
)
from pytorch_distributed_nn_tpu_torch.runtime.mesh import SeqGroup


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   seq: SeqGroup, causal: bool = True,
                   impl: str = "auto") -> torch.Tensor:
    """Exact attention of the local query shard q (B, Tl, H, D) against
    the whole sequence, whose K/V shards (B, Tl, Hkv, D) visit around the
    ring; returns the local (B, Tl, H, D) output in q's dtype."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide q heads "
                         f"{q.shape[2]}")
    if impl == "auto":
        impl = "pallas" if q.device.type == "cuda" else "xla"
    if impl == "xla":
        return _ring_attention_xla(q, k, v, seq, causal)
    if impl == "pallas":
        return _RingAttention.apply(q, k, v, seq, causal)
    raise ValueError(f"unknown ring attention impl {impl!r}")


def _ring_attention_xla(q, k, v, seq: SeqGroup, causal: bool):
    """The plain schedule, differentiable by autograd (the shifts carry
    their gradients back around the ring): f32 logits of the expanded
    visiting shard, masked on global positions."""
    B, Tl, H, D = q.shape
    G = H // k.shape[2]
    s, idx = seq.size, seq.index
    qf = q.float()
    q_pos = idx * Tl + torch.arange(Tl, device=q.device)[:, None]
    m = torch.full((B, H, Tl, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Tl, 1), device=q.device)
    acc = torch.zeros((B, Tl, H, D), device=q.device)
    kb, vb = k, v
    for i, src in enumerate(ring_order(idx, s)):
        ke = kb.repeat_interleave(G, dim=2) if G > 1 else kb
        ve = vb.repeat_interleave(G, dim=2) if G > 1 else vb
        logits = torch.einsum("bthd,bshd->bhts", qf,
                              ke.float()) * D ** -0.5
        if causal:
            k_pos = src * Tl + torch.arange(Tl, device=q.device)[None, :]
            logits = logits.masked_fill(~(q_pos >= k_pos), NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr.transpose(1, 2) + torch.einsum(
            "bhts,bshd->bthd", p, ve.float())
        m = m_new
        if i < s - 1:  # the last shard is not passed on: nobody reads it
            kb, vb = cc.shift_right((kb, vb), seq.group, s)
    out = acc / torch.clamp(l.transpose(1, 2), min=1e-30)
    return out.to(q.dtype)


def ring_order(idx: int, s: int) -> list[int]:
    """The shard whose K/V rank ``idx`` of an ``s``-ring holds at each ring
    step: its own first (the diagonal), then each earlier rank's in turn."""
    return [(idx - i) % s for i in range(s)]


def ring_carries(q: torch.Tensor):
    """Fresh (m, l, acc) carries for the local query shard q (B, Tl, H, D):
    m = -1e30 and l = 0 as (B * H, Tl) f32, acc (B, Tl, H, D) f32 zeros."""
    B, Tl, H, D = q.shape
    return (torch.full((B * H, Tl), NEG_INF, device=q.device),
            torch.zeros((B * H, Tl), device=q.device),
            torch.zeros((B, Tl, H, D), device=q.device))


def ring_forward_pair(q, kb, vb, carries, idx: int, src: int,
                      causal: bool) -> None:
    """One ring step of rank ``idx``: update ``carries`` in place with the
    visiting K/V shard of rank ``src``, at the two shards' global
    offsets."""
    Tl = q.shape[1]
    ring_block_update(q, kb, vb, *carries, idx * Tl, src * Tl, causal=causal)


def ring_finish(carries, dtype: torch.dtype):
    """(out = acc / l in ``dtype``, lse = m + log(max(l, 1e-30)) as
    (B * H, Tl) f32) of finished carries: the output and the statistics the
    backward replays p from."""
    m, l, acc = carries
    B, Tl, H, _ = acc.shape
    l = torch.clamp(l, min=1e-30)
    out = acc / l.reshape(B, H, Tl).transpose(1, 2)[..., None]
    return out.to(dtype), m + torch.log(l)


def ring_backward_pair(q, kb, vb, do, lse, delta, idx: int, src: int,
                       causal: bool):
    """The gradient of rank ``idx``'s attention against the visiting shard
    of rank ``src``: (dq, dk, dv) partial sums in f32, or None. Under
    global causality the pair is the diagonal (causal geometry), the past
    (dense) or the future (no gradient); the flash dq and dk/dv kernels
    replay p from ``lse``."""
    if causal and src > idx:
        return None
    pair_causal = causal and src == idx
    f32 = torch.float32
    dq = flash_bwd_dq(q, kb, vb, do, lse, delta, pair_causal, out_dtype=f32)
    dk, dv = flash_bwd_dkv(q, kb, vb, do, lse, delta, pair_causal,
                           out_dtype=f32)
    return dq, dk, dv


def _ring_forward(q, k, v, seq: SeqGroup, causal: bool):
    """The kernel schedule: one block update a ring step, K/V shifted
    after each but the last. Returns (out in q's dtype, lse (B * H, Tl)
    f32)."""
    s, idx = seq.size, seq.index
    carries = ring_carries(q)
    kb, vb = k, v
    for i, src in enumerate(ring_order(idx, s)):
        ring_forward_pair(q, kb, vb, carries, idx, src, causal)
        if i < s - 1:
            kb, vb = cc.shift_right((kb, vb), seq.group, s)
    return ring_finish(carries, q.dtype)


def _ring_backward(q, k, v, out, lse, do, seq: SeqGroup, causal: bool):
    """Every ring step pairs the local Q shard with the visiting K/V shard
    (:func:`ring_backward_pair`). dq stays with Q; the f32 dk/dv
    accumulators travel one hop behind their shard and take a last shift
    home."""
    s, idx = seq.size, seq.index
    do = do.to(q.dtype).contiguous()
    delta = flash_delta(out, do)
    f32 = torch.float32
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(k.shape, dtype=f32, device=q.device)
    kb, vb = k, v
    for i, src in enumerate(ring_order(idx, s)):
        part = ring_backward_pair(q, kb, vb, do, lse, delta, idx, src, causal)
        if part is not None:
            dq += part[0]
            dk += part[1]
            dv += part[2]
        if i < s - 1:
            kb, vb, dk, dv = cc.shift_right((kb, vb, dk, dv), seq.group, s)
    dk, dv = cc.shift_right((dk, dv), seq.group, s)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The JAX package's ``_ring_attention_fused`` (a ``custom_vjp``): the
    kernel schedule forward, :func:`_ring_backward` backward; neither
    builds a (Tl, Tl) score block."""

    @staticmethod
    def forward(ctx, q, k, v, seq: SeqGroup, causal: bool):
        out, lse = _ring_forward(q, k, v, seq, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seq, ctx.causal = seq, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, do, ctx.seq,
                                    ctx.causal)
        return dq, dk, dv, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      seq: SeqGroup, causal: bool = True,
                      impl: str = "auto") -> torch.Tensor:
    """All-to-all head scatter (DeepSpeed-Ulysses): local shards
    (B, Tl, H, D) -> full-sequence attention over H/s heads
    (``nn.attention.dot_product_attention`` with ``impl``) -> back."""
    from pytorch_distributed_nn_tpu_torch.nn.attention import (
        dot_product_attention,
    )

    s = seq.size
    H, Hkv = q.shape[2], k.shape[2]
    if H % s or Hkv % s:
        raise ValueError(f"ulysses needs heads divisible by the seq degree: "
                         f"{H}/{Hkv} vs {s}")

    def gather_seq(x):  # (B, Tl, h, D) -> (B, T, h / s, D)
        return cc.all_to_all(x, seq.group, s, split_axis=2, concat_axis=1)

    out = dot_product_attention(gather_seq(q), gather_seq(k), gather_seq(v),
                                causal=causal, impl=impl)
    return cc.all_to_all(out, seq.group, s, split_axis=1, concat_axis=2)

"""Multi-head attention for the Llama family, decode path first.

Counterpart of the JAX package's ``nn/attention.py``. The KV cache is a
plain dict of tensors per attention layer (``cached_key`` and
``cached_value`` (B, S, Hkv, D) in the compute dtype, ``cache_index`` a
0-d int32 tensor), made by ``inference.generate.init_cache`` and UPDATED IN
PLACE, where the JAX code threads a donated flax "cache" collection
through ``apply``.

Ported: ``impl="xla"`` (plain PyTorch), ``impl="flash"`` (the hand-written
CUDA kernels of ``ops/flash_attention.py`` in both directions, their plain
versions on the CPU), ``impl="auto"`` (:func:`_auto_impl`), the decode
cache with a shared ``cache_index`` or per-row ``cache_positions``, in
the compute dtype or (``cache_dtype="int8"``) as int8 payloads with
per-(token, head) f32 scales (:func:`_quantize_kv`) that fold into the
attention (:func:`_cache_attention`; a decode step by
:func:`_decode_attention`, whose bits do not depend on the batch or the
cache length), grouped-query attention that never
repeats the cached K/V,
:class:`MultiHeadAttention`'s sequence-parallel ``"ring"`` and
``"ulysses"`` (``parallel/sequence.py``) over the ``SeqGroup`` its model
hands it, and the JAX module's ``causal``, ``rotary`` and ``use_bias``
fields with a (B, S) padding ``mask`` (BERT, the transformer LM, ViT),
per-row LoRA deltas on q and v (``lora``, ``nn/lora.py``), and the
``tensor`` axis (``parallel/tensor.py``): split projections run on the
local H/t and Hkv/t heads (the cache too) with ``out`` row-parallel, and
whole projections (an int8 model's) with ``cache_tensor`` keep only the
local heads in the decode cache and gather the heads' outputs before
``out``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pytorch_distributed_nn_tpu_torch.nn.layers import dense_product
from pytorch_distributed_nn_tpu_torch.nn.lora import lora_delta
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.nn.quantized import Int8DenseGeneral
from pytorch_distributed_nn_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
)
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AxisGroup, SeqGroup

_NEG = -1e30  # the JAX package's mask value, in f32
CACHE_DTYPES = ("compute", "int8")


def rotary_embedding(q: torch.Tensor, k: torch.Tensor, *,
                     theta: float = 10000.0,
                     positions: Optional[torch.Tensor] = None):
    """Rotary position embeddings on q, k of shape (B, T, H, D), half-split
    convention; ``positions`` (B|1, T) absolute positions, per row."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError(f"rotary needs even head_dim, got {d}")
    if positions is None:
        positions = torch.arange(q.shape[1], device=q.device)[None, :]
    exps = -torch.arange(0, d // 2, device=q.device,
                         dtype=torch.float32) * 2.0 / d
    freqs = theta ** exps  # (D/2,); a scalar base: no host->device copy
    angles = positions[..., None].to(torch.float32) * freqs  # (B?, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]  # (B?, T, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]

    def rotate(x):
        # the JAX tables are weakly typed: a bf16 x rotates in bf16
        c, s = cos.to(x.dtype), sin.to(x.dtype)
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    return rotate(q), rotate(k)


# 'auto' takes the flash kernels on CUDA from this sequence length up. One
# layer's attention forward + backward at the long-context shapes (B 1,
# 8/4 heads, D 128, bf16), flash against the plain path, measured on an
# H100: flash is faster at every T swept, 128 to 4096 (PERF.md, "auto
# threshold"; chip_smoke.py phase "auto" prints the sweep). Below 128 is
# not measured.
FLASH_MIN_T = 128


def _auto_impl(q_shape, k_shape, *, has_mask: bool, device: torch.device,
               dtype: torch.dtype) -> str:
    """The 'auto' flash-vs-xla decision: flash on CUDA for bf16
    self-attention with no mask, a head_dim the kernels take, and
    T >= :data:`FLASH_MIN_T`; the plain path elsewhere, the CPU included
    (as the JAX package stays on xla off the TPU)."""
    T = q_shape[1]
    return ("flash" if device.type == "cuda" and not has_mask
            and dtype == torch.bfloat16 and q_shape[3] in KERNEL_HEAD_DIMS
            and k_shape[1] == T and T >= FLASH_MIN_T else "xla")


def dot_product_attention(q, k, v, *, causal: bool, impl: str = "xla",
                          mask: Optional[torch.Tensor] = None):
    """q: (B, T, H, D); k/v: (B, S, Hkv, D) with H % Hkv == 0. Returns
    (B, T, H, D) in q's dtype.

    ``impl``: ``'xla'`` (plain PyTorch: softmax in f32, the products f32
    products of the upcast operands, as ``preferred_element_type`` gives;
    the only one that takes a ``mask``, (B, S) padding or (B|1, T, S)
    position, and cross-length K/V), ``'flash'`` (``ops.flash_attention``:
    the CUDA kernels in both directions, K/V kept grouped) or ``'auto'``
    (:func:`_auto_impl`)."""
    if impl == "auto":
        impl = _auto_impl(q.shape, k.shape, has_mask=mask is not None,
                          device=q.device, dtype=q.dtype)
    if impl not in ("xla", "flash"):
        raise ValueError(
            f"unknown attention impl {impl!r}" + (
                "; ring and ulysses are MultiHeadAttention's "
                "sequence-parallel impls (parallel/sequence.py)"
                if impl in ("ring", "ulysses") else ""))
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if impl == "flash":
        if mask is not None:
            raise ValueError(
                "flash impl does not take a padding mask; use impl='xla'")
        return flash_attention(q, k, v, causal=causal)
    dtype = q.dtype
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * D ** -0.5
    if causal:
        causal_mask = torch.ones((T, S), dtype=torch.bool,
                                 device=q.device).tril()
        logits = logits.masked_fill(~causal_mask[None, None], _NEG)
    if mask is not None:
        keep = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        logits = logits.masked_fill(~keep, _NEG)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(),
                        v.float()).to(dtype)


def _row_update(buf: torch.Tensor, new: torch.Tensor,
                starts: torch.Tensor) -> None:
    """In place: row ``i`` of ``new`` (T leading tokens) lands at
    ``buf[i, starts[i]:starts[i]+T]``. A start that would run past the
    buffer is clamped to S - T, as ``lax.dynamic_update_slice`` clamps."""
    B, T = new.shape[0], new.shape[1]
    S = buf.shape[1]
    start = torch.clamp(starts.to(torch.int64), 0, S - T)
    idx = start[:, None] + torch.arange(T, device=buf.device)[None, :]
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, idx] = new.to(buf.dtype)


def _quantize_kv(x: torch.Tensor):
    """(B, T, H, D) -> int8 values and (B, T, H) f32 scales: symmetric
    per-(token, head) absmax over the head dim, rounded half to even. A
    zero row gets scale 1, so its stored zeros come back exactly."""
    xf = x.float()
    absmax = xf.abs().amax(-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# a prefill chunk's products run on blocks of this many query rows, the
# last block padded: every product then has one shape whatever the chunk's
# rows, so a row's bits do not depend on how many rows the chunk has (a
# library product picks its summation order by its shape). Smaller
# blocks make a long prefill bound by the loop's launches (an 8192-token
# prefill takes 1.02x one product's time at 512 rows on the H100, 1.2x
# at 128: chip_ab.py prefill)
_QUERY_BLOCK = 512

# a cached forward of at most this many rows is a decode step and takes
# _decode_attention (another summation order than a prefill chunk's)
_DECODE_ROWS = 1


def suffix_prefill_start(cached: int, total: int) -> int:
    """The first row to prefill of a ``total``-row prompt whose first
    ``cached`` rows are in the cache already, so that every row it computes
    gets the bits a prefill of the whole prompt gives it: a suffix of
    :data:`_DECODE_ROWS` rows or fewer would take the decode step's
    attention, so it prefills the cached rows before it again."""
    return min(cached, max(total - _DECODE_ROWS - 1, 0))


def _cache_attention(q, k, v, pos_mask, dtype, kscale=None, vscale=None):
    """Attention over the cache (a prefill chunk's; a decode step takes
    :func:`_decode_attention`) with GQA kept grouped: q reshapes to
    (B, T, Hkv, G, D) and the cached K/V are never repeated. The query
    rows go through in blocks of :data:`_QUERY_BLOCK` (the last padded,
    its padding masked nowhere and dropped), so a row's bits depend on its
    own q, the cache and the key count alone: a prefix-cache hit's suffix
    prefill gives its rows what a prefill of the whole prompt gives them.

    With ``kscale``/``vscale`` (both (B, S, Hkv) f32) k and v are the int8
    cache, never dequantized into a copy: each logit is linear in one
    cached K row, so K's scale multiplies the logits after QK^T; the
    output is linear in each cached V row, so V's scale multiplies the
    probabilities before PV. The int8 values enter the products as they
    are (exact in bf16, |v| <= 127).

    q: (B, T, H, D); k/v: (B, S, Hkv, D); pos_mask: (B|1, T, S) bool.
    Logits and softmax in f32; probabilities cast to ``dtype`` before PV.
    Returns (B, T, H, D) in ``dtype``."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    block = _QUERY_BLOCK
    pad = -T % block
    q5 = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad)).reshape(
        B, T + pad, Hkv, H // Hkv, D).float()
    pos_mask = torch.nn.functional.pad(pos_mask, (0, 0, 0, pad),
                                       value=True)
    kf, vf = k.to(dtype).float(), v.to(dtype).float()
    if kscale is not None:
        kscale = kscale.transpose(1, 2)[:, :, None, None, :]
    if vscale is not None:
        vscale = vscale.transpose(1, 2)[:, :, None, None, :]
    outs = []
    for i in range(0, T + pad, block):
        logits = torch.einsum("btkgd,bskd->bkgts", q5[:, i:i + block], kf)
        logits = logits * D ** -0.5
        if kscale is not None:
            logits = logits * kscale
        logits = logits.masked_fill(
            ~pos_mask[:, None, None, i:i + block], _NEG)
        probs = torch.softmax(logits, dim=-1)
        if vscale is not None:
            probs = probs * vscale
        outs.append(torch.einsum("bkgts,bskd->btkgd",
                                 probs.to(dtype).float(), vf))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    return out[:, :T].reshape(B, T, H, D).to(dtype)


def _pairwise_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` by a fixed pairwise tree (``x[0::2] +
    x[1::2]`` until one element is left, the length zero-padded to a power
    of two first): elementwise adds only. Each output's bits then depend on
    its own elements alone, not on how many rows there are (a library
    reduction or product picks its order by the shapes), and trailing zeros
    (masked keys) do not change them."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n & (n - 1):
        x = torch.nn.functional.pad(x, (0, (1 << n.bit_length()) - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


# the most bytes of one f32 product that _decode_attention materializes:
# longer caches are reduced in chunks of keys (a power of two)
DECODE_CHUNK_BYTES = 1 << 28


def _decode_attention(q, k, v, pos_mask, dtype, kscale=None, vscale=None):
    """:func:`_cache_attention` (the same arguments and math: f32 logits of
    the ``dtype``-cast operands, scaled, K's and V's int8 scales folded in,
    masked, softmax, probabilities cast to ``dtype`` before PV) with every
    sum taken by :func:`_pairwise_sum` and the maximum by ``amax``, so a
    row's output is the same bits whatever the batch around it and however
    long the cache: a decode step of the serving engine (8 rows, the
    engine's cache length) gives a row what ``generate()`` (1 row, its own
    cache length) gives it.

    The elementwise products are (B, Hkv, G, T, c, D) f32 for ``c`` keys at
    a time, ``c`` the largest power of two that keeps one within
    :data:`DECODE_CHUNK_BYTES`. The chunks are aligned subtrees of the pairwise tree
    over all S keys, so the bits do not depend on ``c``."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    c = max(1, DECODE_CHUNK_BYTES // (B * H * T * D * 4))
    c = min(1 << (c.bit_length() - 1), 1 << max(S - 1, 0).bit_length())
    starts = range(0, S, c)
    q6 = q.float().reshape(B, T, Hkv, H // Hkv, D).permute(0, 2, 3, 1, 4)

    def rows(x, s):  # cache rows [s, s + c) as (B, Hkv, 1, 1, c, D) f32
        return x[:, s:s + c].to(dtype).float().permute(0, 2, 1, 3)[
            :, :, None, None]

    logits = torch.cat([_pairwise_sum(q6[..., None, :] * rows(k, s), -1)
                        for s in starts], -1) * D ** -0.5
    if kscale is not None:
        logits = logits * kscale.transpose(1, 2)[:, :, None, None, :]
    logits = logits.masked_fill(~pos_mask[:, None, None], _NEG)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / _pairwise_sum(e, -1)[..., None]
    if vscale is not None:
        probs = probs * vscale.transpose(1, 2)[:, :, None, None, :]
    probs = probs.to(dtype).float()[..., None]
    parts = [_pairwise_sum(probs[..., s:s + c, :] * rows(v, s), -2)
             for s in starts]
    out = parts[0] if len(parts) == 1 else _pairwise_sum(
        torch.stack(parts, -2), -2)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(dtype)


class _DenseGeneral(nn.Module):
    """Float ``nn.DenseGeneral`` with the flax kernel layout (in...,
    features...) and, with ``use_bias``, a bias of shape ``features``
    added in ``dtype`` after the product; computes in ``dtype``, a decode
    step's rows in fixed blocks (``nn.layers.dense_product``). Over
    ``tensor`` (``tp_mode``): ``"column"`` holds the local heads of its
    features and slices the whole bias to them (its gradient summed over
    the group), ``"row"`` the local heads of its input, summing the partial
    products over the group before the whole bias."""

    def __init__(self, in_shape, features, *, dtype, param_dtype,
                 use_bias: bool = False, device=None) -> None:
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.features = tuple(features)
        self.dtype = dtype
        self.fan_in = math.prod(self.in_shape)
        self.kernel = nn.Parameter(torch.zeros(
            self.in_shape + self.features, dtype=param_dtype,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(
            self.features, dtype=param_dtype, device=device))
            if use_bias else None)
        self.tensor = AxisGroup()
        self.tp_mode: Optional[str] = None

    def forward(self, x):
        nin = len(self.in_shape)
        lead = x.shape[:x.dim() - nin]
        k = self.kernel.to(self.dtype).reshape(-1, math.prod(self.features))
        y = dense_product(x.to(self.dtype).reshape(*lead, -1), k).reshape(
            *lead, *self.features)
        g = self.tensor
        if self.tp_mode == "row":
            y = cc.sum_forward(y, g.group, g.size)
        if self.bias is None:
            return y
        bias = self.bias
        if self.tp_mode == "column":
            n = self.features[0]
            bias = cc.sum_grad(bias, g.group, g.size).narrow(
                0, g.index * n, n)
        return y + bias.to(self.dtype)


class MultiHeadAttention(nn.Module):
    """The JAX module's attention. Its defaults are the Llama block's
    (``causal=True, rotary=True, use_bias=False``: causal GQA with rotary
    positions); BERT and ViT pass ``causal=False, rotary=False,
    use_bias=True``, the transformer LM ``causal=True, rotary=False,
    use_bias=True``. With ``use_bias`` q/k/v carry a (heads, head_dim) bias
    and ``out`` a (d_model,) one, as ``nn.DenseGeneral`` has them.

    ``quantized`` selects int8 projections; with ``fused_qkv`` q, k and v
    come from one int8 matmul over (H + 2*Hkv, head_dim) features, split
    ``[:H]``, ``[H:H+Hkv]``, ``[H+Hkv:]``. Submodule names follow flax:
    ``query``/``key``/``value`` or ``qkv``, and ``out``.

    ``impl`` ``"ring"`` or ``"ulysses"`` runs the layer sequence-parallel
    over ``seq`` (the ring of the model's mesh; a one-rank ring when None):
    x holds shard ``seq.index`` of the sequence, rotary positions are
    global and applied before any exchange, so both schemes see the q/k a
    whole-sequence layer would. Causal, no decode cache, as in the JAX
    module."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int, *,
                 num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0,
                 impl: str = "xla", dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 causal: bool = True, rotary: bool = True,
                 use_bias: bool = False,
                 quantized: bool = False, cache_dtype: str = "compute",
                 fused_qkv: bool = False, seq: Optional[SeqGroup] = None,
                 device=None) -> None:
        super().__init__()
        if quantized and use_bias:
            raise ValueError("quantized attention is bias-free")
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"unknown cache_dtype {cache_dtype!r}; have "
                             f"{CACHE_DTYPES}")
        self.cache_dtype = cache_dtype
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        self.rope_theta = rope_theta
        self.causal = causal
        self.rotary = rotary
        self.impl = impl
        self.seq = seq or SeqGroup()
        # the tensor axis: split projections on local heads, or (whole
        # projections) the decode cache on local heads (parallel/tensor.py)
        self.tensor = AxisGroup()
        self.cache_tensor = AxisGroup()
        self.dtype = dtype
        self.fused = quantized and fused_qkv
        if quantized:
            def dense(in_shape, feats):
                return Int8DenseGeneral(in_shape, feats, dtype=dtype,
                                        device=device)
        else:
            def dense(in_shape, feats):
                return _DenseGeneral(in_shape, feats, dtype=dtype,
                                     param_dtype=param_dtype,
                                     use_bias=use_bias, device=device)
        h, hkv = num_heads, self.num_kv_heads
        if self.fused:
            self.qkv = dense((d_model,), (h + 2 * hkv, head_dim))
        else:
            self.query = dense((d_model,), (h, head_dim))
            self.key = dense((d_model,), (hkv, head_dim))
            self.value = dense((d_model,), (hkv, head_dim))
        self.out = dense((h, head_dim), (d_model,))

    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> dict:
        """This layer's decode cache for a (batch_size, max_len) stream,
        zeros: ``cached_key`` and ``cached_value`` (B, S, Hkv, D) in the
        compute dtype, or int8 with ``cached_key_scale`` and
        ``cached_value_scale`` (B, S, Hkv) f32 under ``cache_dtype="int8"``;
        ``cache_index`` a 0-d int32."""
        kv = (batch_size, max_len,
              self.num_kv_heads // self.cache_tensor.size, self.head_dim)
        int8 = self.cache_dtype == "int8"

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        cache = {"cached_key": zeros(kv, torch.int8 if int8 else self.dtype),
                 "cached_value": zeros(kv, torch.int8 if int8
                                       else self.dtype)}
        if int8:
            cache["cached_key_scale"] = zeros(kv[:3], torch.float32)
            cache["cached_value_scale"] = zeros(kv[:3], torch.float32)
        cache["cache_index"] = zeros((), torch.int32)
        return cache

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                cache_positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                lora: Optional[tuple] = None) -> torch.Tensor:
        """``cache`` (this layer's dict) turns on decode: the fed (B, T)
        tokens' K/V are written into it in place, at the shared
        ``cache_index`` (which then advances by T) or, with
        ``cache_positions`` (B,) int, at each row's own depth (the shared
        index is neither read nor advanced). Queries attend to the cache
        slots at or before their own position. ``mask`` (B, S) bool keeps
        the keys where it is True (padding; ``impl='xla'`` only).

        ``lora``: ``(a_q, b_q, a_v, b_v)``, each row's factors (leading dim
        B, gathered from the bank by the model). The deltas land on the q/v
        projections' outputs, on the fused int8 path too, before rotary and
        before any cache write, so the cached rows hold the adapter's v
        delta (why the prefix cache keys its blocks by adapter). A zero B
        adds exact zeros."""
        h, hkv = self.num_heads, self.num_kv_heads
        x = cc.sum_grad(x, self.tensor.group, self.tensor.size)
        if self.fused:
            qkv = self.qkv(x)
            q, k, v = qkv[..., :h, :], qkv[..., h:h + hkv, :], \
                qkv[..., h + hkv:, :]
        else:
            q, k, v = self.query(x), self.key(x), self.value(x)
        if lora is not None:
            a_q, b_q, a_v, b_v = lora
            q = q + lora_delta(x, a_q, b_q)
            v = v + lora_delta(x, a_v, b_v)
        if cache is not None and not self.causal:
            raise ValueError("decode cache requires causal attention")
        if cache is not None and mask is not None:
            raise ValueError("decode mode ignores padding masks; strip "
                             "padding (or left-trim) before prefill")
        if cache_positions is not None and cache is None:
            raise ValueError("cache_positions is a decode-cache feature "
                             "(per-row cache indices); it needs a cache")
        ct = self.cache_tensor
        if ct.size > 1 and cache is not None:
            # whole projections, local cache heads: this rank attends with
            # its key/value heads and their query groups
            hl, kl = h // ct.size, hkv // ct.size
            q = q[:, :, ct.index * hl:(ct.index + 1) * hl]
            k = k[:, :, ct.index * kl:(ct.index + 1) * kl]
            v = v[:, :, ct.index * kl:(ct.index + 1) * kl]
        if self.impl in ("ring", "ulysses"):
            if cache is not None:
                raise ValueError(f"{self.impl} attention has no decode "
                                 "cache; generate with impl='auto'")
            if not self.causal or mask is not None:
                raise ValueError(f"{self.impl} attention is causal-only and "
                                 "takes no mask")
            out = self._sequence_parallel(q, k, v)
        elif cache is not None:
            B, T = x.shape[0], x.shape[1]
            ck, cv = cache["cached_key"], cache["cached_value"]
            S = ck.shape[1]
            ar = torch.arange(T, device=x.device)
            if cache_positions is None:
                idx = cache["cache_index"].clone()
                starts = idx.expand(B)
                positions = idx + ar[None]  # (1, T)
                cache["cache_index"] += T  # in place, on the device
            else:
                starts = cache_positions.to(torch.int32)
                positions = starts[:, None] + ar[None]  # (B, T)
            if self.rotary:
                q, k = rotary_embedding(q, k, theta=self.rope_theta,
                                        positions=positions)
                q, k = q.to(self.dtype), k.to(self.dtype)
            if self.cache_dtype == "int8":
                kq, ks = _quantize_kv(k)
                vq, vs = _quantize_kv(v)
                bufs = (ck, cv, cache["cached_key_scale"],
                        cache["cached_value_scale"])
                for buf, new in zip(bufs, (kq, vq, ks, vs)):
                    _row_update(buf, new, starts)
            else:
                bufs = (ck, cv)
                _row_update(ck, k, starts)
                _row_update(cv, v, starts)
            if T <= _DECODE_ROWS:
                # decode: one fixed computation whatever the batch and the
                # cache length (_decode_attention; suffix_prefill_start
                # keeps a prefix-cache hit's suffix off this branch)
                attend = _decode_attention
            else:
                # a prefill chunk reads the keys up to its last position
                # only, so that its products have the same shapes however
                # long the cache is (a host read of the positions: the
                # prefill is not the per-token loop)
                S = int(positions.max()) + 1
                bufs = tuple(b[:, :S] for b in bufs)
                attend = _cache_attention
            pos_mask = (torch.arange(S, device=x.device)[None, None, :]
                        <= positions[:, :, None])  # (B|1, T, S)
            scales = dict(zip(("kscale", "vscale"), bufs[2:]))
            out = attend(q, bufs[0], bufs[1], pos_mask, self.dtype, **scales)
        else:
            if self.rotary:
                q, k = rotary_embedding(q, k, theta=self.rope_theta)
                q, k = q.to(self.dtype), k.to(self.dtype)
            out = dot_product_attention(q, k, v, causal=self.causal,
                                        impl=self.impl, mask=mask)
        if ct.size > 1 and cache is not None:
            out = cc.gather_split(out.contiguous(), ct.group, ct.size,
                                  ct.index, 2)
        return self.out(out)

    def _sequence_parallel(self, q, k, v):
        from pytorch_distributed_nn_tpu_torch.parallel.sequence import (
            ring_attention,
            ulysses_attention,
        )

        if self.rotary:
            Tl = q.shape[1]
            positions = self.seq.index * Tl + torch.arange(Tl,
                                                           device=q.device)
            q, k = rotary_embedding(q, k, theta=self.rope_theta,
                                    positions=positions[None])
            q, k = q.to(self.dtype), k.to(self.dtype)
        attend = ulysses_attention if self.impl == "ulysses" else \
            ring_attention
        return attend(q, k, v, seq=self.seq, causal=True)

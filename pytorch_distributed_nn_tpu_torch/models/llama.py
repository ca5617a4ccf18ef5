"""Llama-3-style decoder: RMSNorm, rotary GQA attention, SwiGLU MLP, no
biases, untied LM head. Counterpart of the JAX package's
``models/llama.py``; the ``llama3_8b`` builder defaults to the real 8B
dims. Submodules and parameters keep the flax names and layout, so a
``state_dict`` key is the flattened flax path (``layer0.attn.qkv.kernel_q``).

Float parameters are trainable (f32 by default; every dense layer casts
input and kernel to the compute dtype, so gradients flow back through the
cast). ``remat`` reruns each block's forward in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat``);
``remat_offload`` keeps the block inputs that remat saves (the JAX model's
``block_in`` names) in pinned host memory between the forward and the
backward, instead of on the card; the result is the same bit for bit.
Serving runs under ``torch.inference_mode()``, where none of this
applies.

Sequence parallelism (``attn_impl`` ``"ring"`` or ``"ulysses"``): the
model is built with the rank's ``SeqGroup`` (``runtime/mesh.py``) and takes
the rank's shard of each token row; only attention exchanges anything.
Under remat the recompute reruns the ring forward, its P2P included,
inside the backward, at the same point of the graph on every rank: the
blocks are recomputed in the same reverse order everywhere, and each block
recomputes in full, the ring before the MLP whose saved tensors end it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import register
from pytorch_distributed_nn_tpu_torch.nn.attention import MultiHeadAttention
from pytorch_distributed_nn_tpu_torch.nn.dtypes import get_policy
from pytorch_distributed_nn_tpu_torch.nn.layers import Dense, Embed, row_mean
from pytorch_distributed_nn_tpu_torch.nn.lora import layer_slice
from pytorch_distributed_nn_tpu_torch.nn.quantized import Int8Dense, Int8Embed
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AxisGroup, SeqGroup
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        normed = x32 * torch.rsqrt(row_mean(x32 * x32) + self.eps)
        return (normed * self.scale).to(self.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 mlp_dim: int, *, rope_theta: float = 500000.0,
                 norm_eps: float = 1e-5, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 quantized: bool = False, cache_dtype: str = "compute",
                 fused_proj: bool = False, seq: Optional[SeqGroup] = None,
                 device=None) -> None:
        super().__init__()
        self.mlp_dim = mlp_dim
        self.fused = quantized and fused_proj
        norm = dict(eps=norm_eps, dtype=dtype, param_dtype=param_dtype,
                    device=device)
        self.attn_norm = RMSNorm(d_model, **norm)
        self.attn = MultiHeadAttention(
            d_model, num_heads, d_model // num_heads,
            num_kv_heads=num_kv_heads, rope_theta=rope_theta,
            impl=attn_impl, dtype=dtype, param_dtype=param_dtype,
            quantized=quantized,
            cache_dtype=cache_dtype, fused_qkv=self.fused, seq=seq,
            device=device)
        self.mlp_norm = RMSNorm(d_model, **norm)
        if quantized:
            def dense(i, o):
                return Int8Dense(i, o, dtype=dtype, device=device)
        else:
            def dense(i, o):
                return Dense(i, o, dtype=dtype, param_dtype=param_dtype,
                             use_bias=False, device=device)
        if self.fused:
            self.gate_up = dense(d_model, 2 * mlp_dim)
        else:
            self.gate_proj = dense(d_model, mlp_dim)
            self.up_proj = dense(d_model, mlp_dim)
        self.down_proj = dense(mlp_dim, d_model)
        self.tensor = AxisGroup()  # the MLP's (parallel/tensor.py)

    def forward(self, x, cache: Optional[dict] = None,
                cache_positions: Optional[torch.Tensor] = None,
                lora: Optional[tuple] = None):
        x = x + self.attn(self.attn_norm(x), cache=cache,
                          cache_positions=cache_positions, lora=lora)
        y = cc.sum_grad(self.mlp_norm(x), self.tensor.group, self.tensor.size)
        if self.fused:
            gate_up = self.gate_up(y)
            gate, up = gate_up[..., :self.mlp_dim], gate_up[..., self.mlp_dim:]
        else:
            gate, up = self.gate_proj(y), self.up_proj(y)
        return x + self.down_proj(F.silu(gate) * up)


class Llama(nn.Module):
    """``forward(tokens, cache=None, cache_positions=None, last_only=False,
    return_hidden=False, lora_bank=None, adapter_ids=None,
    split_logits=False)`` returns f32 logits (B, T, V), or (B, 1, V) with
    ``last_only`` (this rank's vocab slice with ``split_logits`` under a
    vocab-split head, ``parallel/tensor.py``); ``return_hidden`` skips the
    LM head and returns the final-norm'd (B, T, D) trunk output (the chunked loss applies the head
    blockwise). With ``cache`` (from ``inference.generate.init_cache``) it
    decodes against the KV cache and writes the fed tokens' K/V into it in
    place; ``cache_positions`` (B,) int gives each row its own cache depth.
    ``lora_bank`` (``nn/lora.py``'s stacked factors) with ``adapter_ids``
    (B,) int (zeros when None) gives each row its adapter's q/v deltas:
    one gather a factor a layer, so rows on different fine-tunes share the
    forward. Built on ``device`` (default ``cuda``, which raises without CUDA);
    ``seq`` is the sequence-parallel ring its attention layers use."""

    def __init__(self, *, vocab_size: int = 128256, num_layers: int = 32,
                 d_model: int = 4096, num_heads: int = 32,
                 num_kv_heads: int = 8, mlp_dim: int = 14336,
                 rope_theta: float = 500000.0, norm_eps: float = 1e-5,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 quantized: bool = False, cache_dtype: str = "compute",
                 fused_proj: bool = False, remat: bool = False,
                 remat_offload: bool = False, seq: Optional[SeqGroup] = None,
                 device="cuda") -> None:
        super().__init__()
        if remat_offload and not remat:
            raise ValueError(
                "remat_offload moves remat-saved block boundaries to host "
                "RAM -- it needs model.remat=True (without remat there are "
                "no saved boundaries to offload, and silently ignoring the "
                "flag would let a run expected to fit via offload run out "
                "of memory instead)")
        device = resolve_device(device)
        self.remat = remat
        self.remat_offload = remat_offload
        # what the last forward moved to host memory: boundaries, bytes,
        # and whether every host copy was pinned
        self.offloaded = dict(tensors=0, bytes=0, pinned=True)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.dtype = dtype
        self.quantized = quantized
        if quantized:
            self.tok_embed = Int8Embed(vocab_size, d_model, dtype=dtype,
                                       device=device)
        else:
            self.tok_embed = Embed(vocab_size, d_model,
                                   param_dtype=param_dtype, device=device)
        for i in range(num_layers):
            self.add_module(f"layer{i}", LlamaBlock(
                d_model, num_heads, num_kv_heads, mlp_dim,
                rope_theta=rope_theta, norm_eps=norm_eps,
                attn_impl=attn_impl, dtype=dtype, param_dtype=param_dtype,
                quantized=quantized, cache_dtype=cache_dtype,
                fused_proj=fused_proj, seq=seq, device=device))
        self.final_norm = RMSNorm(d_model, eps=norm_eps, dtype=dtype,
                                  param_dtype=param_dtype, device=device)
        if quantized:
            self.lm_head = Int8Dense(d_model, vocab_size,
                                     dtype=torch.float32, device=device)
        else:
            self.lm_head = Dense(d_model, vocab_size, dtype=torch.float32,
                                 param_dtype=param_dtype, use_bias=False,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The decode cache: one dict a layer, ``layer{i}`` (see
        ``MultiHeadAttention.init_cache``; int8 with f32 scales under
        ``cache_dtype="int8"``), zeros on the model's device."""
        return {f"layer{i}": getattr(self, f"layer{i}").attn.init_cache(
            batch_size, max_len, device=self.device)
            for i in range(self.num_layers)}

    def forward(self, tokens: torch.Tensor, cache: Optional[dict] = None,
                cache_positions: Optional[torch.Tensor] = None,
                last_only: bool = False,
                return_hidden: bool = False, lora_bank: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                split_logits: bool = False) -> torch.Tensor:
        if self.quantized:
            x = self.tok_embed(tokens)
        else:
            # int32 tokens index as they are (values unchanged)
            x = self.embed(tokens)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        if remat and self.remat_offload:
            self.offloaded = dict(tensors=0, bytes=0, pinned=True)
        if lora_bank is not None and adapter_ids is None:
            adapter_ids = torch.zeros((tokens.shape[0],), dtype=torch.int64,
                                      device=tokens.device)
        for i in range(self.num_layers):
            block = getattr(self, f"layer{i}")
            layer_cache = None if cache is None else cache[f"layer{i}"]
            lora = None if lora_bank is None else tuple(
                f[adapter_ids] for f in layer_slice(lora_bank, i))
            if remat and self.remat_offload:
                # the block's input, which checkpoint saves for the
                # recompute, goes to host memory; the tensors inside the
                # block are not saved at all (checkpoint's own hooks)
                with torch.autograd.graph.saved_tensors_hooks(
                        self._to_host, _to_device):
                    x = checkpoint(block, x, layer_cache, cache_positions,
                                   lora, use_reentrant=False)
            elif remat:
                x = checkpoint(block, x, layer_cache, cache_positions, lora,
                               use_reentrant=False)
            else:
                x = block(x, cache=layer_cache,
                          cache_positions=cache_positions, lora=lora)
        if last_only:
            x = x[:, -1:]
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.lm_head(x, gather=False) if split_logits else \
            self.lm_head(x)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding in the compute dtype (the float model)."""
        return self.tok_embed(tokens).to(self.dtype)

    def run_block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Layer ``name`` on ``x`` without a cache, rerun in the backward
        under remat (the pipeline's stages; no host offload there)."""
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, None, None, use_reentrant=False)
        return block(x)

    def head(self, x: torch.Tensor,
             split_logits: bool = False) -> torch.Tensor:
        """The final norm and the f32 ``lm_head``: the logits (this rank's
        vocab slice with ``split_logits``, under a split head)."""
        if split_logits:
            return self.lm_head(self.final_norm(x), gather=False)
        return self.lm_head(self.final_norm(x))

    def init_params(self, seed: int = 0) -> "Llama":
        return init_float_params(self, seed=seed)

    def _to_host(self, t: torch.Tensor):
        """Pack hook of ``remat_offload``: a copy of ``t`` in host memory
        (pinned when ``t`` is on the card, copied without a host wait: the
        unpack's copy back is queued behind it on the same stream, and the
        caching allocator reuses ``t``'s block only for work queued
        later). An empty tensor (checkpoint's own placeholder, in some
        torch versions) stays as it is."""
        if t.numel() == 0:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        self.offloaded["tensors"] += 1
        self.offloaded["bytes"] += t.numel() * t.element_size()
        self.offloaded["pinned"] &= host.is_pinned() or not t.is_cuda
        return t.device, host


def _to_device(packed) -> torch.Tensor:
    """Unpack hook of ``remat_offload``: the saved block input back on its
    device, for the backward's recompute."""
    if isinstance(packed, torch.Tensor):
        return packed
    device, host = packed
    return host.to(device, non_blocking=host.is_pinned())


@register("llama3_8b")
def build_llama3_8b(cfg: ModelConfig, device="cuda", input_shape=None,
                    seq: Optional[SeqGroup] = None) -> Llama:
    """``input_shape`` (a (T,) token row) does not size the model; ``seq``
    is the rank's sequence-parallel ring."""
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    e = cfg.extra
    return Llama(
        vocab_size=e.get("vocab_size", 128256),
        num_layers=e.get("num_layers", 32),
        d_model=e.get("d_model", 4096),
        num_heads=e.get("num_heads", 32),
        num_kv_heads=e.get("num_kv_heads", 8),
        mlp_dim=e.get("mlp_dim", 14336),
        rope_theta=e.get("rope_theta", 500000.0),
        norm_eps=e.get("norm_eps", 1e-5),
        attn_impl=e.get("attn_impl", "auto"),
        quantized=e.get("quantized", False),
        cache_dtype=e.get("cache_dtype", "compute"),
        fused_proj=e.get("fused_proj", False),
        remat=cfg.remat,
        remat_offload=cfg.remat_offload,
        seq=seq,
        dtype=policy.compute_dtype,
        param_dtype=policy.param_dtype,
        device=device,
    )


@torch.no_grad()
def init_float_params(model: Llama, seed: int = 0) -> Llama:
    """Seeded random weights for a FLOAT model, in place on its device:
    kernels and embeddings normal with std fan_in^-1/2 (1 for the
    embedding), norm scales ones."""
    g = torch.Generator(model.device)
    g.manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() == 1:
            p.fill_(1.0)
            continue
        fan_in = 1 if name.endswith("embedding") else p.shape[0]
        p.normal_(0.0, fan_in ** -0.5, generator=g)
    return model

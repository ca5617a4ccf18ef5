"""Llama-3-style decoder: RMSNorm, rotary GQA attention, SwiGLU MLP, no
biases, untied LM head. Counterpart of the JAX package's
``models/llama.py``; the ``llama3_8b`` builder defaults to the real 8B
dims. Submodules and parameters keep the flax names and layout, so a
``state_dict`` key is the flattened flax path (``layer0.attn.qkv.kernel_q``).

Float parameters are trainable (f32 by default; every dense layer casts
input and kernel to the compute dtype, so gradients flow back through the
cast). ``remat`` reruns each block's forward in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat``); serving
runs under ``torch.inference_mode()``, where none of this applies.
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
from pytorch_distributed_nn_tpu_torch.nn.quantized import Int8Dense, Int8Embed
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
        normed = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(self.dtype)


class _Dense(nn.Module):
    """Float ``nn.Dense`` (no bias), flax kernel layout (in, out)."""

    def __init__(self, in_features: int, features: int, *, dtype,
                 param_dtype, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(
            (in_features, features), dtype=param_dtype, device=device))

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 mlp_dim: int, *, rope_theta: float = 500000.0,
                 norm_eps: float = 1e-5, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 quantized: bool = False, cache_dtype: str = "compute",
                 fused_proj: bool = False, device=None) -> None:
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
            cache_dtype=cache_dtype, fused_qkv=self.fused, device=device)
        self.mlp_norm = RMSNorm(d_model, **norm)
        if quantized:
            def dense(i, o):
                return Int8Dense(i, o, dtype=dtype, device=device)
        else:
            def dense(i, o):
                return _Dense(i, o, dtype=dtype, param_dtype=param_dtype,
                              device=device)
        if self.fused:
            self.gate_up = dense(d_model, 2 * mlp_dim)
        else:
            self.gate_proj = dense(d_model, mlp_dim)
            self.up_proj = dense(d_model, mlp_dim)
        self.down_proj = dense(mlp_dim, d_model)

    def forward(self, x, cache: Optional[dict] = None,
                cache_positions: Optional[torch.Tensor] = None):
        x = x + self.attn(self.attn_norm(x), cache=cache,
                          cache_positions=cache_positions)
        y = self.mlp_norm(x)
        if self.fused:
            gate_up = self.gate_up(y)
            gate, up = gate_up[..., :self.mlp_dim], gate_up[..., self.mlp_dim:]
        else:
            gate, up = self.gate_proj(y), self.up_proj(y)
        return x + self.down_proj(F.silu(gate) * up)


class Llama(nn.Module):
    """``forward(tokens, cache=None, cache_positions=None, last_only=False,
    return_hidden=False)`` returns f32 logits (B, T, V), or (B, 1, V) with
    ``last_only``; ``return_hidden`` skips the LM head and returns the
    final-norm'd (B, T, D) trunk output (the chunked loss applies the head
    blockwise). With ``cache`` (from ``inference.generate.init_cache``) it
    decodes against the KV cache and writes the fed tokens' K/V into it in
    place; ``cache_positions`` (B,) int gives each row its own cache depth.
    Built on ``device`` (default ``cuda``, which raises without CUDA)."""

    def __init__(self, *, vocab_size: int = 128256, num_layers: int = 32,
                 d_model: int = 4096, num_heads: int = 32,
                 num_kv_heads: int = 8, mlp_dim: int = 14336,
                 rope_theta: float = 500000.0, norm_eps: float = 1e-5,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 quantized: bool = False, cache_dtype: str = "compute",
                 fused_proj: bool = False, remat: bool = False,
                 remat_offload: bool = False, device="cuda") -> None:
        super().__init__()
        if remat_offload:
            raise NotImplementedError(
                "remat_offload (XLA host offload of the remat boundaries) is "
                "not ported yet (ROADMAP.md, trainer features still to port: "
                "remat offload)")
        device = resolve_device(device)
        self.remat = remat
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
            self.tok_embed = nn.Module()
            self.tok_embed.embedding = nn.Parameter(torch.zeros(
                (vocab_size, d_model), dtype=param_dtype, device=device))
        for i in range(num_layers):
            self.add_module(f"layer{i}", LlamaBlock(
                d_model, num_heads, num_kv_heads, mlp_dim,
                rope_theta=rope_theta, norm_eps=norm_eps,
                attn_impl=attn_impl, dtype=dtype, param_dtype=param_dtype,
                quantized=quantized, cache_dtype=cache_dtype,
                fused_proj=fused_proj, device=device))
        self.final_norm = RMSNorm(d_model, eps=norm_eps, dtype=dtype,
                                  param_dtype=param_dtype, device=device)
        if quantized:
            self.lm_head = Int8Dense(d_model, vocab_size,
                                     dtype=torch.float32, device=device)
        else:
            self.lm_head = _Dense(d_model, vocab_size, dtype=torch.float32,
                                  param_dtype=param_dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def forward(self, tokens: torch.Tensor, cache: Optional[dict] = None,
                cache_positions: Optional[torch.Tensor] = None,
                last_only: bool = False,
                return_hidden: bool = False) -> torch.Tensor:
        if self.quantized:
            x = self.tok_embed(tokens)
        else:
            # int32 tokens index as they are (values unchanged)
            x = F.embedding(tokens, self.tok_embed.embedding).to(self.dtype)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"layer{i}")
            layer_cache = None if cache is None else cache[f"layer{i}"]
            if remat:
                x = checkpoint(block, x, layer_cache, cache_positions,
                               use_reentrant=False)
            else:
                x = block(x, cache=layer_cache,
                          cache_positions=cache_positions)
        if last_only:
            x = x[:, -1:]
        x = self.final_norm(x)
        return x if return_hidden else self.lm_head(x)

    def init_params(self, seed: int = 0) -> "Llama":
        return init_float_params(self, seed=seed)


@register("llama3_8b")
def build_llama3_8b(cfg: ModelConfig, device="cuda",
                    input_shape=None) -> Llama:
    """``input_shape`` (a (T,) token row) does not size the model."""
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

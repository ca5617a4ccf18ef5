"""BERT-base: BASELINE.json config 3's model (the JAX package's
``models/bert.py``). A bidirectional post-LN encoder and the masked-LM
head; pretraining reads ``mlm_synthetic`` and trains on
``train.losses.masked_lm_xent``.

Submodules keep the flax names (``tok_embed``, ``pos_embed``,
``ln_embed``, ``layer{i}.{attn,ln1,mlp_in,mlp_out,ln2}``, ``mlm_dense``,
``mlm_ln``, ``mlm_decoder``), so a ``state_dict`` key is the flattened flax
path. ``type_embed`` exists only in a model built with ``token_types``
(flax creates it only when token types are passed), so the default model's
``state_dict`` matches the JAX param tree key for key. Attention takes the
plain path (``impl="xla"``): the JAX BERT never sets ``impl``, so it never
reaches the flash kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import register
from pytorch_distributed_nn_tpu_torch.nn.attention import MultiHeadAttention
from pytorch_distributed_nn_tpu_torch.nn.dtypes import get_policy
from pytorch_distributed_nn_tpu_torch.nn.layers import (
    Dense,
    Dropout,
    Embed,
    LayerNorm,
    gelu,
    init_params_,
)
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AxisGroup
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device


class EncoderBlock(nn.Module):
    """Post-LN (original BERT): sublayer, add, LayerNorm."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int, *,
                 dropout: float = 0.0, ln_eps: float = 1e-12,
                 dtype=torch.float32, param_dtype=torch.float32,
                 salt: int = 0, device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.attn = MultiHeadAttention(
            d_model, num_heads, d_model // num_heads, causal=False,
            rotary=False, use_bias=True, impl="xla", **kw)
        self.drop_attn = Dropout(dropout, salt)
        self.ln1 = LayerNorm(d_model, eps=ln_eps, **kw)
        self.mlp_in = Dense(d_model, mlp_dim, **kw)
        self.mlp_out = Dense(mlp_dim, d_model, **kw)
        self.drop_mlp = Dropout(dropout, salt + 1)
        self.ln2 = LayerNorm(d_model, eps=ln_eps, **kw)
        self.tensor = AxisGroup()  # the MLP's (parallel/tensor.py)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.ln1(x + self.drop_attn(self.attn(x, mask=mask)))
        h = cc.sum_grad(x, self.tensor.group, self.tensor.size)
        y = self.drop_mlp(self.mlp_out(gelu(self.mlp_in(h))))
        return self.ln2(x + y)


class Bert(nn.Module):
    """``forward(tokens, attention_mask=None, token_types=None)`` returns
    f32 MLM logits (B, T, vocab). ``attention_mask`` (B, T) bool keeps the
    keys where it is True. Built on ``device`` (default ``cuda``, which
    raises without CUDA)."""

    def __init__(self, *, vocab_size: int = 30522, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 512, type_vocab: int = 2,
                 token_types: bool = False, dropout: float = 0.0,
                 ln_eps: float = 1e-12, dtype=torch.float32,
                 param_dtype=torch.float32, device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.max_len = max_len
        self.dtype = dtype
        emb = dict(param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.tok_embed = Embed(vocab_size, d_model, **emb)
        self.pos_embed = Embed(max_len, d_model, **emb)
        self.type_embed = (Embed(type_vocab, d_model, **emb) if token_types
                           else None)
        self.ln_embed = LayerNorm(d_model, eps=ln_eps, **kw)
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderBlock(
                d_model, num_heads, mlp_dim, dropout=dropout, ln_eps=ln_eps,
                salt=2 * i, **kw))
        self.mlm_dense = Dense(d_model, d_model, **kw)
        self.mlm_ln = LayerNorm(d_model, eps=ln_eps, **kw)
        self.mlm_decoder = Dense(d_model, vocab_size, dtype=torch.float32,
                                 param_dtype=param_dtype, device=device)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def forward(self, tokens: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_types: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = tokens.shape[1]
        if T > self.max_len:
            raise ValueError(
                f"sequence length {T} exceeds max_len {self.max_len}")
        pos = torch.arange(T, device=tokens.device)[None]
        x = self.tok_embed(tokens) + self.pos_embed(pos)
        if token_types is not None:
            if self.type_embed is None:
                raise ValueError("token_types given to a model built without "
                                 "them (model.extra token_types: true)")
            x = x + self.type_embed(token_types)
        x = self.ln_embed(x.to(self.dtype))
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, mask=attention_mask)
        x = self.mlm_ln(gelu(self.mlm_dense(x)))
        return self.mlm_decoder(x)

    def init_params(self, seed: int = 0) -> "Bert":
        return init_params_(self, seed)


@register("bert_base")
def build_bert_base(cfg: ModelConfig, device="cuda",
                    input_shape=None) -> Bert:
    """``input_shape`` (a (T,) token row) does not size the model."""
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    e = cfg.extra
    return Bert(
        vocab_size=e.get("vocab_size", 30522),
        num_layers=e.get("num_layers", 12),
        d_model=e.get("d_model", 768),
        num_heads=e.get("num_heads", 12),
        mlp_dim=e.get("mlp_dim", 3072),
        max_len=e.get("max_len", 512),
        type_vocab=e.get("type_vocab", 2),
        token_types=e.get("token_types", False),
        dropout=e.get("dropout", 0.0),
        ln_eps=e.get("ln_eps", 1e-12),
        dtype=policy.compute_dtype,
        param_dtype=policy.param_dtype,
        device=device,
    )

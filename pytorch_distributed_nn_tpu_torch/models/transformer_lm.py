"""Decoder-only transformer LM: BASELINE.json config 4's model (the JAX
package's ``models/transformer_lm.py``). GPT-style pre-LN blocks with
learned positions, a final LayerNorm ``ln_f`` and an f32 ``lm_head``.

Submodules keep the flax names (``tok_embed``, ``pos_embed``,
``block{i}.{ln1,attn,ln2,mlp_in,mlp_out}``, ``ln_f``, ``lm_head``). A
subclass swaps a block's dense MLP for another FFN through
:meth:`TransformerLM.layer_ffn` (the JAX ``DecoderBlock.ffn`` hook): the
MoE LM (``models/moe_lm.py``) puts its expert layers there, as
``block{i}.moe``.
``remat`` reruns each block's forward in the backward
(``torch.utils.checkpoint``, the JAX model's ``nn.remat`` per block).
Attention's ``attn_impl="auto"`` takes the flash kernels on the card in
bf16 from T = 128 at head_dim 64 or 128 (``nn/attention.py``), and the
plain path elsewhere. The decode cache (:meth:`TransformerLM.init_cache`)
holds each block's K/V and the model's own ``pos_index``: the learned
positions are taken at each row's cache position, from that counter or
from per-row ``cache_positions``. The pipeline (``parallel/pipeline.py``)
runs the model's three parts by themselves: :meth:`TransformerLM.embed`,
:meth:`TransformerLM.run_block` and :meth:`TransformerLM.head`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


class DecoderBlock(nn.Module):
    """A pre-LN block. ``ffn`` is ``(name, module)`` of an FFN that takes
    the place of the dense ``mlp_in``/``mlp_out`` (None: the dense MLP)."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int, *,
                 dropout: float = 0.0, ln_eps: float = 1e-5,
                 attn_impl: str = "auto", dtype=torch.float32,
                 param_dtype=torch.float32, salt: int = 0,
                 ffn: Optional[tuple[str, nn.Module]] = None,
                 device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.ln1 = LayerNorm(d_model, eps=ln_eps, **kw)
        self.attn = MultiHeadAttention(
            d_model, num_heads, d_model // num_heads, causal=True,
            rotary=False, use_bias=True, impl=attn_impl, **kw)
        self.drop_attn = Dropout(dropout, salt)
        self.ln2 = LayerNorm(d_model, eps=ln_eps, **kw)
        self.ffn_name = None
        if ffn is None:
            self.mlp_in = Dense(d_model, mlp_dim, **kw)
            self.mlp_out = Dense(mlp_dim, d_model, **kw)
        else:
            self.ffn_name = ffn[0]
            self.add_module(*ffn)
        self.drop_mlp = Dropout(dropout, salt + 1)
        self.tensor = AxisGroup()  # the dense MLP's (parallel/tensor.py)

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                cache_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = x + self.drop_attn(self.attn(self.ln1(x), cache=cache,
                                         cache_positions=cache_positions))
        y = self.ln2(x)
        if self.ffn_name is None:
            g = self.tensor  # the column products' input: its gradient summed
            y = cc.sum_grad(y, g.group, g.size)
            y = self.mlp_out(gelu(self.mlp_in(y)))
        else:
            y = getattr(self, self.ffn_name)(y)
        return x + self.drop_mlp(y)


class TransformerLM(nn.Module):
    """``forward(tokens, positions=None, last_only=False,
    return_hidden=False, cache=None, cache_positions=None,
    split_logits=False)`` returns f32 logits (B, T, V), or (B, 1, V) with
    ``last_only`` (this rank's vocab slice with ``split_logits`` under a
    vocab-split head, ``parallel/tensor.py``); ``return_hidden``
    skips the LM head and returns the ``ln_f``'d (B, T, D) trunk output
    (the chunked loss applies the head blockwise). With ``cache`` (from
    :meth:`init_cache`) it decodes against the KV cache, writing the fed
    tokens' K/V in place; ``cache_positions`` (B,) int gives each row its
    own cache depth. Built on ``device`` (default ``cuda``, which raises
    without CUDA)."""

    # a subclass whose routing spans a whole group of tokens (the MoE LM)
    # turns this off: cached decode would not equal full recompute
    supports_decode = True

    def __init__(self, *, vocab_size: int = 32000, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 2048, dropout: float = 0.0,
                 ln_eps: float = 1e-5, remat: bool = False,
                 attn_impl: str = "auto", dtype=torch.float32,
                 param_dtype=torch.float32, device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.max_len = max_len
        self.remat = remat
        self.dtype = dtype
        emb = dict(param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.tok_embed = Embed(vocab_size, d_model, **emb)
        self.pos_embed = Embed(max_len, d_model, **emb)
        for i in range(num_layers):
            self.add_module(f"block{i}", DecoderBlock(
                d_model, num_heads, mlp_dim, dropout=dropout, ln_eps=ln_eps,
                attn_impl=attn_impl, salt=2 * i,
                ffn=self.layer_ffn(i, d_model=d_model, mlp_dim=mlp_dim,
                                   **kw), **kw))
        self.ln_f = LayerNorm(d_model, eps=ln_eps, **kw)
        self.lm_head = Dense(d_model, vocab_size, dtype=torch.float32,
                             param_dtype=param_dtype, use_bias=False,
                             device=device)

    def layer_ffn(self, i: int, **block) -> Optional[tuple[str, nn.Module]]:
        """The FFN of block ``i`` as ``(flax name, module)``, made from the
        block's ``d_model``, ``mlp_dim``, ``dtype``, ``param_dtype`` and
        ``device``; None for the dense MLP, as here everywhere. The MoE
        subclass returns expert layers on its cadence."""
        return None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    def _refuse_decode(self) -> None:
        if not self.supports_decode:
            raise ValueError(
                f"{type(self).__name__} does not support decode caching: "
                "its routing spans a whole group of tokens")

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The decode cache: ``block{i}``'s attention cache (see
        ``MultiHeadAttention.init_cache``) and ``pos_index``, the 0-d int32
        position counter of the shared-index mode; zeros on the model's
        device."""
        self._refuse_decode()
        cache = {f"block{i}": getattr(self, f"block{i}").attn.init_cache(
            batch_size, max_len, device=self.device)
            for i in range(self.num_layers)}
        cache["pos_index"] = torch.zeros((), dtype=torch.int32,
                                         device=self.device)
        return cache

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False, return_hidden: bool = False,
                cache: Optional[dict] = None,
                cache_positions: Optional[torch.Tensor] = None,
                split_logits: bool = False) -> torch.Tensor:
        T = tokens.shape[1]
        if T > self.max_len:
            raise ValueError(
                f"sequence length {T} exceeds max_len {self.max_len}")
        if cache is not None:
            self._refuse_decode()
            if positions is not None:
                raise ValueError(
                    "decode mode derives positions from the cache counter; "
                    "an explicit `positions` argument would be ignored")
            ar = torch.arange(T, device=tokens.device)[None]
            if cache_positions is not None:
                # per-row depths; the shared counter stays untouched
                positions = cache_positions.to(torch.int64)[:, None] + ar
            else:
                positions = cache["pos_index"].to(torch.int64) + ar
                cache["pos_index"] += T  # in place, on the device
        elif cache_positions is not None:
            raise ValueError("cache_positions is a decode-cache feature "
                             "(per-row cache indices); it needs a cache")
        x = self.embed(tokens, positions)
        for i in range(self.num_layers):
            name = f"block{i}"
            if cache is None:
                x = self.run_block(name, x)
            else:
                x = getattr(self, name)(x, cache=cache[name],
                                        cache_positions=cache_positions)
        if last_only:
            x = x[:, -1:]
        x = self.ln_f(x)
        return x if return_hidden else self.lm_head(
            x, gather=not split_logits)

    def embed(self, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token plus position embeddings, in the compute dtype."""
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None]
        return (self.tok_embed(tokens) + self.pos_embed(positions)).to(
            self.dtype)

    def run_block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Block ``name`` on ``x``, rerun in the backward under remat."""
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)

    def head(self, x: torch.Tensor,
             split_logits: bool = False) -> torch.Tensor:
        """``ln_f`` and the f32 ``lm_head``: the logits (this rank's vocab
        slice of them with ``split_logits``, under a split head)."""
        return self.lm_head(self.ln_f(x), gather=not split_logits)

    def init_params(self, seed: int = 0) -> "TransformerLM":
        return init_params_(self, seed)


@register("transformer_lm")
def build_transformer_lm(cfg: ModelConfig, device="cuda",
                         input_shape=None) -> TransformerLM:
    """``input_shape`` (a (T,) token row) does not size the model."""
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    e = cfg.extra
    return TransformerLM(
        vocab_size=e.get("vocab_size", 32000),
        num_layers=e.get("num_layers", 12),
        d_model=e.get("d_model", 768),
        num_heads=e.get("num_heads", 12),
        mlp_dim=e.get("mlp_dim", 3072),
        max_len=e.get("max_len", 2048),
        dropout=e.get("dropout", 0.0),
        ln_eps=e.get("ln_eps", 1e-5),
        remat=cfg.remat,
        attn_impl=e.get("attn_impl", "auto"),
        dtype=policy.compute_dtype,
        param_dtype=policy.param_dtype,
        device=device,
    )

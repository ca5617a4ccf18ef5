"""Vision Transformer (the JAX package's ``models/vit.py``): a patchify
convolution, a CLS token, learned positions, pre-LN encoder blocks, a
final LayerNorm and an f32 head on the CLS token. No preset uses it.

Names follow flax (``patch_embed``, ``cls``, ``pos_embed``,
``layer{i}.{ln1,attn,ln2,mlp_in,mlp_out}``, ``ln_f``, ``head``). Takes NHWC
(or (B, H, W) grayscale) batches; the patch convolution runs in NCHW with
an OIHW kernel (``utils/interop.py`` transposes flax's HWIO). flax sizes
``pos_embed`` from the first batch; here ``input_shape`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import register
from pytorch_distributed_nn_tpu_torch.models.lenet import Conv, nhwc_to_nchw
from pytorch_distributed_nn_tpu_torch.nn.attention import MultiHeadAttention
from pytorch_distributed_nn_tpu_torch.nn.dtypes import get_policy
from pytorch_distributed_nn_tpu_torch.nn.layers import (
    Dense,
    Dropout,
    LayerNorm,
    gelu,
    init_params_,
)
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AxisGroup
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device


class EncoderBlock(nn.Module):
    """Pre-LN (ViT-style) encoder block."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int, *,
                 dropout: float = 0.0, attn_impl: str = "xla",
                 ln_eps: float = 1e-12, dtype=torch.float32,
                 param_dtype=torch.float32, salt: int = 0,
                 device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.ln1 = LayerNorm(d_model, eps=ln_eps, **kw)
        self.attn = MultiHeadAttention(
            d_model, num_heads, d_model // num_heads, causal=False,
            rotary=False, use_bias=True, impl=attn_impl, **kw)
        self.drop_attn = Dropout(dropout, salt)
        self.ln2 = LayerNorm(d_model, eps=ln_eps, **kw)
        self.tensor = AxisGroup()  # the MLP's (parallel/tensor.py)
        self.mlp_in = Dense(d_model, mlp_dim, **kw)
        self.mlp_out = Dense(mlp_dim, d_model, **kw)
        self.drop_mlp = Dropout(dropout, salt + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_attn(self.attn(self.ln1(x)))
        h = cc.sum_grad(self.ln2(x), self.tensor.group, self.tensor.size)
        y = self.mlp_out(gelu(self.mlp_in(h)))
        return x + self.drop_mlp(y)


class ViT(nn.Module):
    """``forward(images)`` returns f32 logits (B, num_classes)."""

    def __init__(self, input_shape: Sequence[int] = (32, 32, 3),
                 num_classes: int = 10, *, patch_size: int = 4,
                 num_layers: int = 6, d_model: int = 192, num_heads: int = 3,
                 mlp_dim: int = 768, dropout: float = 0.0,
                 attn_impl: str = "xla", ln_eps: float = 1e-12,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        h, w = input_shape[:2]
        c = input_shape[2] if len(input_shape) == 3 else 1
        p = patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch_size {p}")
        self.patch_size = p
        self.num_layers = num_layers
        self.d_model = d_model
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.patch_embed = Conv(c, d_model, p, stride=p, **kw)  # VALID
        self.patch_embed.fan_in = c * p * p
        self.cls = nn.Parameter(torch.zeros((1, 1, d_model),
                                            dtype=param_dtype, device=device))
        n = (h // p) * (w // p) + 1
        self.pos_embed = nn.Parameter(torch.zeros(
            (1, n, d_model), dtype=param_dtype, device=device))
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderBlock(
                d_model, num_heads, mlp_dim, dropout=dropout,
                attn_impl=attn_impl, ln_eps=ln_eps, salt=2 * i, **kw))
        self.ln_f = LayerNorm(d_model, eps=ln_eps, **kw)
        self.head = Dense(d_model, num_classes, dtype=torch.float32,
                          param_dtype=param_dtype, device=device)
        # flax's initializers of the two raw parameters
        self.extra_init = {
            "cls": lambda t, g: t.zero_(),
            "pos_embed": lambda t, g: t.normal_(0.0, 0.02, generator=g)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # grayscale (B, H, W) -> NHWC
            x = x[..., None]
        H, W = x.shape[1], x.shape[2]
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} not divisible by patch_size {p}")
        x = self.patch_embed(nhwc_to_nchw(x).to(self.dtype))
        B = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.d_model)  # (B, N, D)
        cls = self.cls.expand(B, 1, self.d_model).to(self.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        x = self.ln_f(x)
        return self.head(x[:, 0])  # the CLS token

    def init_params(self, seed: int = 0) -> "ViT":
        return init_params_(self, seed)


@register("vit")
def build_vit(cfg: ModelConfig, device="cuda",
              input_shape: Sequence[int] = (32, 32, 3)) -> ViT:
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    e = cfg.extra
    return ViT(
        input_shape,
        num_classes=e.get("num_classes", 10),
        patch_size=e.get("patch_size", 4),
        num_layers=e.get("num_layers", 6),
        d_model=e.get("d_model", 192),
        num_heads=e.get("num_heads", 3),
        mlp_dim=e.get("mlp_dim", 768),
        ln_eps=e.get("ln_eps", 1e-12),
        dropout=e.get("dropout", 0.0),
        attn_impl=e.get("attn_impl", "xla"),
        dtype=policy.compute_dtype,
        param_dtype=policy.param_dtype,
        device=device,
    )

"""2-layer MLP, the reference's minimal ``Net`` (the JAX package's
``models/mlp.py``). Layers keep flax's auto names (``Dense_0``, ...) and
kernel layout (in, out), so a ``state_dict`` key is the flax path."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import register
from pytorch_distributed_nn_tpu_torch.nn.dtypes import get_policy
from pytorch_distributed_nn_tpu_torch.nn.layers import Dense
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def init_normal_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights in place: every kernel (a parameter named
    ``kernel``) normal with std fan_in^-1/2, biases zero, BatchNorm scales
    one (bn3 of a bottleneck zero, as the JAX init) and running statistics
    (0, 1). fan_in is the product of all kernel dims but the output one."""
    g = torch.Generator(next(module.parameters()).device)
    g.manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            out_dim = 0 if p.dim() == 4 else -1  # OIHW conv, (in, out) dense
            fan_in = p.numel() // p.shape[out_dim]
            p.normal_(0.0, fan_in ** -0.5, generator=g)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(0.0 if name.endswith("bn3.scale") else 1.0)
    for name, b in module.named_buffers():
        b.fill_(1.0 if name.endswith("var") else 0.0)
    return module


class MLP(nn.Module):
    def __init__(self, in_features: int = 784,
                 features: Sequence[int] = (128, 10), *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_layers = len(features)
        dims = [in_features, *features]
        for i in range(self.num_layers):
            self.add_module(f"Dense_{i}", Dense(
                dims[i], dims[i + 1], dtype=dtype, param_dtype=param_dtype,
                device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x

    def init_params(self, seed: int = 0) -> "MLP":
        return init_normal_(self, seed)


@register("mlp")
def build_mlp(cfg: ModelConfig, device="cuda",
              input_shape: Sequence[int] = (28, 28)) -> MLP:
    """``input_shape``: one example's shape (flax infers the first
    layer's width from the first batch; here it is given)."""
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    return MLP(in_features=math.prod(input_shape),
               features=tuple(cfg.extra.get("features", (128, 10))),
               dtype=policy.compute_dtype, param_dtype=policy.param_dtype,
               device=device)

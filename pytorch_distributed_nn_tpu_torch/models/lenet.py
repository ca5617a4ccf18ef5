"""LeNet-style CNN for MNIST/CIFAR (the JAX package's ``models/lenet.py``).

The JAX model runs NHWC; this one takes the same NHWC (or (B, H, W)
grayscale) batches, runs its convolutions in NCHW (``channels_last``
memory) and flattens the last feature map in NHWC order, so the first
dense layer's (in, out) kernel is the JAX one unpermuted. Conv kernels are
OIHW (``utils/interop.py`` transposes flax's HWIO once).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import register
from pytorch_distributed_nn_tpu_torch.models.mlp import Dense, init_normal_
from pytorch_distributed_nn_tpu_torch.nn.dtypes import get_policy
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device


class Conv(nn.Module):
    """flax ``nn.Conv`` in NCHW: ``kernel`` (O, I, kh, kw) in channels_last
    memory, optional ``bias``; input and weights cast to the compute
    dtype. ``padding`` is ((top, bottom), (left, right))."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 stride: int = 1, padding=((0, 0), (0, 0)),
                 use_bias: bool = True, dtype, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        (top, bottom), (left, right) = padding
        self.symmetric = top == bottom and left == right
        self.padding = (top, left) if self.symmetric else (left, right, top,
                                                           bottom)
        self.kernel = nn.Parameter(torch.zeros(
            (out_ch, in_ch, kernel, kernel), dtype=param_dtype,
            device=device).contiguous(memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros((out_ch,), dtype=param_dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.symmetric:
            pad = self.padding
        else:  # F.pad drops channels_last; the conv gets it back
            x = F.pad(x, self.padding).contiguous(
                memory_format=torch.channels_last)
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias,
                        stride=self.stride, padding=pad)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch as NCHW in channels_last memory: a view, no copy."""
    return x.permute(0, 3, 1, 2)


class LeNet(nn.Module):
    def __init__(self, input_shape: Sequence[int] = (32, 32, 3),
                 num_classes: int = 10, *, dtype=torch.float32,
                 param_dtype=torch.float32, device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        h, w = input_shape[:2]
        c = input_shape[2] if len(input_shape) == 3 else 1
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dtype = dtype
        self.Conv_0 = Conv(c, 6, 5, padding=((2, 2), (2, 2)), **kw)  # SAME
        self.Conv_1 = Conv(6, 16, 5, **kw)  # VALID
        h, w = (h // 2 - 4) // 2, (w // 2 - 4) // 2
        self.Dense_0 = Dense(16 * h * w, 120, **kw)
        self.Dense_1 = Dense(120, 84, **kw)
        self.Dense_2 = Dense(84, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # grayscale (B, H, W)
            x = x[..., None]
        x = nhwc_to_nchw(x).to(self.dtype)
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2)
        # flatten in NHWC order, as the JAX model does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)

    def init_params(self, seed: int = 0) -> "LeNet":
        return init_normal_(self, seed)


@register("lenet")
def build_lenet(cfg: ModelConfig, device="cuda",
                input_shape: Sequence[int] = (32, 32, 3)) -> LeNet:
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    return LeNet(input_shape, num_classes=cfg.extra.get("num_classes", 10),
                 dtype=policy.compute_dtype, param_dtype=policy.param_dtype,
                 device=device)

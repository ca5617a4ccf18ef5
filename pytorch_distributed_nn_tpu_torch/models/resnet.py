"""ResNet-50 (the JAX package's ``models/resnet.py``): bottleneck blocks
(3, 4, 6, 3), torch geometry (symmetric paddings), BatchNorm with running
statistics as buffers.

The JAX model runs NHWC. This one takes the same NHWC batches and runs
NCHW tensors in ``channels_last`` memory, so each BatchNorm input is an
(M, C) channels-minor matrix with no copy (the ``bn_stats`` kernel's
layout) and cuDNN runs its NHWC convolutions. Dtypes as in the JAX model:
bf16 convolutions over f32 parameters, the BatchNorm elementwise pass in
f32 cast back to bf16, the pooled features in bf16 before the f32 head.

Stems: ``conv7`` (7x7 stride 2, torchvision's) and ``s2d`` (a 2x2
space-to-depth, then a 4x4 stride-1 convolution: the same map with the
kernel regrouped by :func:`conv7_to_s2d_kernel`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import register
from pytorch_distributed_nn_tpu_torch.models.lenet import Conv, nhwc_to_nchw
from pytorch_distributed_nn_tpu_torch.models.mlp import init_normal_
from pytorch_distributed_nn_tpu_torch.nn.batchnorm import TpuBatchNorm
from pytorch_distributed_nn_tpu_torch.nn.dtypes import get_policy
from pytorch_distributed_nn_tpu_torch.nn.layers import Dense
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C), channel order (bh, bw, c)."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"H/W {h}x{w} not divisible by block {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // block, w // block, block * block * c)


def conv7_to_s2d_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The (7, 7, C, F) HWIO stride-2/pad-3 kernel as the (4, 4, 4C, F)
    stride-1/pad-(2, 1) kernel over the 2x2 space-to-depth input: pad one
    zero tap on the left (offset -4) to 8x8, then space-to-depth the tap
    grid as the input is. HWIO in and out, as the JAX function."""
    k = F.pad(kernel, (0, 0, 0, 0, 1, 0, 1, 0))  # 8x8xCxF
    kh, kw, c, f = k.shape
    k = k.reshape(kh // 2, 2, kw // 2, 2, c, f)
    return k.permute(0, 2, 1, 3, 4, 5).reshape(kh // 2, kw // 2, 4 * c, f)


def s2d_kernel_to_conv7(kernel: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`conv7_to_s2d_kernel`: (4, 4, 4C, F) -> the
    (7, 7, C, F) kernel."""
    kh, kw, c4, f = kernel.shape
    k = kernel.reshape(kh, kw, 2, 2, c4 // 4, f).permute(0, 2, 1, 3, 4, 5)
    return k.reshape(kh * 2, kw * 2, c4 // 4, f)[1:, 1:]


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int, *, norm,
                 conv) -> None:
        super().__init__()
        self.conv1 = conv(in_ch, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride=strides,
                          padding=((1, 1), (1, 1)))
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        # zero-init final BN scale: the residual branch starts as identity
        self.bn3 = norm(filters * 4, scale_init=0.0)
        self.project = in_ch != filters * 4 or strides != 1
        if self.project:
            self.conv_proj = conv(in_ch, filters * 4, 1, stride=strides)
            self.bn_proj = norm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.bn_proj(self.conv_proj(x)) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``forward(x)``: x (N, H, W, C) NHWC, as the JAX model's batches;
    returns f32 logits (N, num_classes)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, num_classes: int = 1000, *,
                 in_channels: int = 3, stem: str = "conv7",
                 bn_impl: str = "flax", dtype=torch.bfloat16,
                 param_dtype=torch.float32, device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.stem = stem
        self.dtype = dtype

        def conv(i, o, k, **kw):
            return Conv(i, o, k, use_bias=False, dtype=dtype,
                        param_dtype=param_dtype, device=device, **kw)

        def norm(c, **kw):
            return TpuBatchNorm(c, dtype=dtype, param_dtype=param_dtype,
                                stats_impl=bn_impl, dim=1, device=device,
                                **kw)

        if stem == "s2d":
            self.conv_init_s2d = conv(4 * in_channels, width, 4,
                                      padding=((2, 1), (2, 1)))
        elif stem == "conv7":
            self.conv_init = conv(in_channels, width, 7, stride=2,
                                  padding=((3, 3), (3, 3)))
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.bn_init = norm(width)
        ch = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = width * 2 ** stage
                self.add_module(f"stage{stage}_block{block}", BottleneckBlock(
                    ch, filters, strides, norm=norm, conv=conv))
                ch = filters * 4
        self.head = Dense(ch, num_classes, dtype=torch.float32,
                          param_dtype=param_dtype, device=device)

    def batch_norms(self) -> list[TpuBatchNorm]:
        return [m for m in self.modules() if isinstance(m, TpuBatchNorm)]

    def set_bn_impl(self, impl: str) -> None:
        for bn in self.batch_norms():
            bn.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = self.conv_init_s2d(nhwc_to_nchw(space_to_depth(x, 2)))
        else:
            x = self.conv_init(nhwc_to_nchw(x))
        x = F.relu(self.bn_init(x))
        # torch MaxPool2d(3, 2, padding=1) geometry
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"stage{stage}_block{block}")(x)
        pooled = x.mean(dim=(2, 3))  # f32 accumulation, x's dtype out
        return self.head(pooled)

    def init_params(self, seed: int = 0) -> "ResNet":
        return init_normal_(self, seed)


@register("resnet50")
def build_resnet50(cfg: ModelConfig, device="cuda",
                   input_shape: Sequence[int] = (224, 224, 3)) -> ResNet:
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    e = cfg.extra
    return ResNet(
        stage_sizes=tuple(e.get("stage_sizes", (3, 4, 6, 3))),
        width=e.get("width", 64),
        num_classes=e.get("num_classes", 1000),
        in_channels=input_shape[-1] if len(input_shape) == 3 else 1,
        stem=e.get("stem", "conv7"),
        bn_impl=e.get("bn_impl", "flax"),
        dtype=policy.compute_dtype,
        param_dtype=policy.param_dtype,
        device=device,
    )

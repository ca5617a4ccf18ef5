"""Analytic FLOP counts, for MFU reports on the card: the JAX package's
``utils/flops.py`` closed form for the transformer LM, and ResNet's from
its geometry (the JAX package asks XLA's cost analysis for that one)."""

from __future__ import annotations


def lm_train_flops_per_token(n_params: int, n_layers: int, seq_len: int,
                             d_model: int, *, causal: bool = False) -> float:
    """6N + 12*L*T*d (PaLM appendix B): training FLOPs per token of a dense
    transformer LM with N matmul-participating parameters. The second term
    is attention's two (T, T) products, forward and backward; a causal mask
    halves the work a kernel that skips masked tiles needs, so ``causal``
    counts 6*L*T*d. Recompute (remat) is not counted: this is the model's
    work, the numerator of MFU."""
    attn = 12.0 * n_layers * seq_len * d_model
    return 6.0 * n_params + (attn / 2 if causal else attn)


def resnet_forward_flops(stage_sizes=(3, 4, 6, 3), width: int = 64,
                         num_classes: int = 1000, image_hw=(224, 224),
                         in_channels: int = 3, stem: str = "conv7") -> float:
    """Forward FLOPs of one example through ``models/resnet.py``'s ResNet:
    2 x the multiply-adds of every convolution and of the head, from the
    model's geometry (torch paddings, bottleneck blocks, projections where
    the shape changes). The JAX package reads the same number from XLA's
    cost analysis; BatchNorm, ReLU and pooling are not counted. Standard
    ResNet-50 at 224x224: 8.2 GFLOP."""
    def conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
        return 2 * h * w * cout * cin * k * k

    h, w = image_hw
    if stem == "s2d":  # 4x4 stride-1 conv over the 2x2 space-to-depth
        h, w = h // 2, w // 2
        flops = conv(h, w, 4 * in_channels, width, 4)
    elif stem == "conv7":  # 7x7 stride 2, padding 3
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        flops = conv(h, w, in_channels, width, 7)
    else:
        raise ValueError(f"unknown stem {stem!r}")
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # 3x3 stride-2 max pool
    ch = width
    for stage, n_blocks in enumerate(stage_sizes):
        filters = width * 2 ** stage
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            flops += conv(h, w, ch, filters, 1)  # conv1
            flops += conv(ho, wo, filters, filters, 3)  # conv2, strided
            flops += conv(ho, wo, filters, 4 * filters, 1)  # conv3
            if ch != 4 * filters or stride != 1:
                flops += conv(ho, wo, ch, 4 * filters, 1)  # projection
            h, w, ch = ho, wo, 4 * filters
    return float(flops + 2 * ch * num_classes)


def resnet_train_flops_per_example(**geometry) -> float:
    """3 x :func:`resnet_forward_flops`: the forward, and the backward's
    two products (input and weight gradients) of each layer. Standard
    ResNet-50 at 224x224: 24.5 GFLOP."""
    return 3.0 * resnet_forward_flops(**geometry)

"""Analytic FLOP counts, for MFU reports on the card (MFU = model FLOPs /
step time / 989 TFLOP/s, the H100 SXM's dense bf16 rate): the JAX
package's ``utils/flops.py`` closed form for the transformer families
(Llama, the transformer LM, BERT, ViT), ResNet's from its geometry, and
the MoE LM's from its routing geometry (the JAX package asks XLA's cost
analysis for those two), and the datasets' example shapes from the config
(:func:`input_spec`)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.parallel.expert import (
    MoEMLP,
    expert_capacity,
)


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


def matmul_param_count(model: torch.nn.Module) -> int:
    """N of :func:`lm_train_flops_per_token`: the parameters that take part
    in a matmul for every token, every ``kernel`` (dense, attention
    projections, heads, ViT's patch convolution, which is a matmul per
    patch) outside the MoE layers (:func:`moe_forward_flops_per_token`
    counts those). Embedding tables (lookups), biases and norm scales are
    not counted. BERT-base: 108.97M (109.12M with its biases and LayerNorm
    parameters)."""
    moe = tuple(f"{n}." for n, m in model.named_modules()
                if isinstance(m, MoEMLP))
    return sum(p.numel() for n, p in model.named_parameters()
               if n.rsplit(".", 1)[-1] == "kernel" and not n.startswith(moe))


def moe_forward_flops_per_token(layer: MoEMLP, d_model: int,
                                seq_len: int) -> float:
    """Forward FLOPs a token of one MoE layer (``parallel/expert.py``) in
    rows of ``seq_len``: the router 2 d E, and over the E C slots of its
    routing group of g tokens the dispatch and the combine 2 E C d each
    and the experts' two products 4 E C d ff / g (every slot runs, full or
    not). The JAX package's XLA count adds the routing's and gelu's
    elementwise work, 0.3% more at moe_lm_ep's widths."""
    E, ff = layer.num_experts, layer.mlp_dim
    g = min(layer.group_size, seq_len)
    C = expert_capacity(g, E, layer.k, layer.capacity_factor)
    return 2.0 * d_model * E + 4.0 * E * C * d_model * (1.0 + ff / g)


def transformer_train_flops_per_token(model: torch.nn.Module, seq_len: int,
                                      *, causal: bool) -> float:
    """6N + 12 L T d (bidirectional: BERT, ViT) or 6N + 6 L T d (causal:
    the transformer LM, Llama) for a model with ``num_layers`` and
    ``d_model``, plus 3 x :func:`moe_forward_flops_per_token` for each MoE
    layer. BERT-base at T = 128: 6 x 108.96M + 12 x 12 x 128 x 768 =
    0.668 GFLOP a token; moe_lm_ep at T = 1024: 1.507 GFLOP a token."""
    moe = sum(moe_forward_flops_per_token(m, model.d_model, seq_len)
              for m in model.modules() if isinstance(m, MoEMLP))
    return lm_train_flops_per_token(matmul_param_count(model),
                                    model.num_layers, seq_len, model.d_model,
                                    causal=causal) + 3.0 * moe


def lm_tokens_per_card(batch_size: int, seq_len: int, data_degree: int,
                       seq_degree: int) -> float:
    """Tokens one card trains a step: B T / (data x seq). Under sequence
    parallelism a card holds T / seq tokens of a row, but its FLOPs per
    token are those of the whole sequence (:func:`lm_train_flops_per_token`
    at the global T: each query still attends over all T keys)."""
    return batch_size * seq_len / (data_degree * seq_degree)


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


# the example shapes of the synthetic and token datasets, from the config
# alone: counting FLOPs must not read a data file for its ``spec``
_IMAGE_SPECS = {"mnist": (28, 28), "cifar10": (32, 32, 3),
                "imagenet_synthetic": (224, 224, 3)}
_TOKEN_DATASETS = ("lm_synthetic", "mlm_synthetic", "token_file")


def input_spec(cfg) -> tuple[tuple[int, ...], np.dtype]:
    """(per-example shape, dtype) of ``cfg.data``'s batches without
    building the dataset where the format or the config fixes them (the
    JAX ``utils/flops._input_spec``): an MNIST idx header is read for its
    dims, an image folder is not scanned; ``array_file`` is loaded for its
    arrays' shape."""
    data = cfg.data
    if data.dataset in _IMAGE_SPECS:
        return _IMAGE_SPECS[data.dataset], np.dtype(np.float32)
    if data.dataset in _TOKEN_DATASETS:
        return (data.seq_len,), np.dtype(np.int32)
    if data.dataset == "cifar10_bin":
        return (32, 32, 3), np.dtype(np.float32)
    if data.dataset == "mnist_idx":
        # idx files may hold any dims: the header says which
        if data.path:
            from pytorch_distributed_nn_tpu_torch.data.readers import (
                find_one,
                read_idx_header,
            )

            imgs = find_one(Path(data.path), "train-images-idx3-ubyte")
            if imgs is not None:
                return tuple(read_idx_header(imgs)[1][1:]), \
                    np.dtype(np.float32)
        return (28, 28), np.dtype(np.float32)  # the standard layout
    if data.dataset == "image_folder":
        s = data.image_size
        return (s, s, 3), np.dtype(np.float32)
    from pytorch_distributed_nn_tpu_torch.data.datasets import get_dataset

    spec = get_dataset(data.dataset, seed=0, batch_size=1,
                       seq_len=data.seq_len, vocab_size=data.vocab_size,
                       path=data.path, token_dtype=data.token_dtype,
                       image_size=data.image_size).spec
    return spec.x_shape, spec.x_dtype

"""Config / flag system: the JAX package's ``config.py``, with the fields
the ported slices read.

Typed dataclasses with dotted CLI overrides (``--optim.lr=0.1``,
``--model.extra '{"quantized": true}'``) and the named presets the port
runs. A field the port does not read yet is not declared, so an override
naming it (``--checkpoint_dir``, ``--multistep_k``, ``--parallel.overlap``)
fails as an unknown field instead of being ignored.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Any

from pytorch_distributed_nn_tpu_torch.runtime.mesh import MeshSpec


@dataclass
class OptimConfig:
    name: str = "sgd"  # sgd | momentum | adamw
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip_norm: float = 0.0  # 0 = off
    warmup_steps: int = 0
    schedule: str = "constant"  # constant | cosine | linear | step
    # schedule="step" (torch StepLR): decay by step_gamma at these
    # fractions of the post-warmup run
    step_milestones: tuple[float, ...] = (0.5, 0.75)
    step_gamma: float = 0.1


@dataclass
class DataConfig:
    # mnist | cifar10 | imagenet_synthetic | lm_synthetic
    dataset: str = "mnist"
    batch_size: int = 128  # global batch size
    seq_len: int = 512
    vocab_size: int = 32000
    prefetch: int = 2  # background batches kept ready (0 = sync)


@dataclass
class ModelConfig:
    name: str = "mlp"  # mlp | lenet | resnet50 | llama3_8b
    dtype: str = "float32"  # param dtype
    compute_dtype: str = "bfloat16"
    remat: bool = False  # torch.utils.checkpoint on every block
    remat_offload: bool = False  # not ported: raises when set
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class ParallelConfig:
    strategy: str = "dp"  # single | dp | dp_explicit
    # dp_explicit's DDP-style bucket controller (ops/buckets.py): bucket
    # size in MB (<= 0: no buckets, one all-reduce a tensor, unless a
    # quantized wire asks for one large bucket)
    bucket_mb: float = 25.0
    quantized_allreduce: str = ""  # "" | "bf16" | "int8" (dp_explicit)
    grad_accum: int = 1  # > 1 is not ported: raises


@dataclass
class TrainConfig:
    preset: str = ""
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    eval_every: int = 0  # 0 = no eval; else eval every N steps
    eval_batches: int = 8  # batches per eval pass (held-out stream)
    # chunk the LM softmax-xent over T (tokens per chunk; 0 = dense
    # logits): one (B, chunk, V) logits block is live instead of (B, T, V)
    xent_chunk: int = 0
    mesh: MeshSpec = field(default_factory=MeshSpec)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def override(self, **dotted: Any) -> "TrainConfig":
        cfg = copy.deepcopy(self)  # nested sub-configs must not alias self's
        for key, value in dotted.items():
            _set_dotted(cfg, key.replace("-", "_"), value)
        return cfg


def _set_dotted(obj: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for part in parts[:-1]:
        if not hasattr(obj, part):
            raise AttributeError(f"unknown config field {dotted!r}")
        obj = getattr(obj, part)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"unknown config field {dotted!r}")
    current = getattr(obj, leaf)
    if current is not None and not isinstance(value, type(current)):
        if isinstance(current, bool):
            value = str(value).lower() in ("1", "true", "yes", "on")
        elif isinstance(current, (int, float)):
            value = type(current)(value)
        elif isinstance(current, dict):
            value = json.loads(value)  # e.g. --model.extra '{"d_model":64}'
        elif isinstance(current, (tuple, list)):
            value = type(current)(json.loads(value))
    setattr(obj, leaf, value)


def parse_overrides(argv: list[str]) -> dict[str, str]:
    """Parse ``--a.b=c`` / ``--a.b c`` style CLI overrides."""
    out: dict[str, str] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument {arg!r}")
        arg = arg[2:]
        if "=" in arg:
            key, value = arg.split("=", 1)
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"flag --{arg} expects a value")
            key, value = arg, argv[i + 1]
            i += 1
        out[key] = value
        i += 1
    return out


def _llama3_8b_zero() -> TrainConfig:
    # Config 5: Llama-3-8B sharded data-parallel. Its ZeRO training is
    # multi-card work (ROADMAP slice 4); the serve entry uses its model.
    return TrainConfig(
        preset="llama3_8b_zero",
        steps=20,
        mesh=MeshSpec(fsdp=-1, data=1),
        optim=OptimConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                          grad_clip_norm=1.0, warmup_steps=10,
                          schedule="cosine"),
        data=DataConfig(dataset="lm_synthetic", batch_size=16, seq_len=4096,
                        vocab_size=128256),
        model=ModelConfig(name="llama3_8b", remat=True),
        parallel=ParallelConfig(strategy="zero"),
        xent_chunk=2048,
    )


def _llama3_longcontext() -> TrainConfig:
    # 32k-token causal-LM training on one card: flash attention in both
    # directions, remat on every block, chunked cross-entropy. head_dim 128
    # is the real Llama-3 per-head geometry (4096 / 32).
    return TrainConfig(
        preset="llama3_longcontext",
        steps=10,
        mesh=MeshSpec(seq=1, data=-1),
        optim=OptimConfig(name="adamw", lr=1e-4, weight_decay=0.1,
                          grad_clip_norm=1.0, warmup_steps=2,
                          schedule="cosine"),
        data=DataConfig(dataset="lm_synthetic", batch_size=1,
                        seq_len=32768, vocab_size=32000),
        model=ModelConfig(name="llama3_8b", remat=True,
                          extra=dict(num_layers=8, d_model=1024,
                                     num_heads=8, num_kv_heads=4,
                                     mlp_dim=3584, vocab_size=32000)),
        parallel=ParallelConfig(strategy="dp"),
        xent_chunk=2048,
    )


def _mlp_mnist() -> TrainConfig:
    # Config 1: "2-layer MLP on MNIST, single process (gloo backend, CPU)".
    return TrainConfig(
        preset="mlp_mnist",
        steps=200,
        optim=OptimConfig(name="momentum", lr=0.01),
        data=DataConfig(dataset="mnist", batch_size=128),
        model=ModelConfig(name="mlp", compute_dtype="float32"),
        parallel=ParallelConfig(strategy="dp"),
    )


def _lenet_cifar10() -> TrainConfig:
    # The reference's classic small-net config (LeNet-ish CNN on CIFAR-10).
    return TrainConfig(
        preset="lenet_cifar10",
        steps=200,
        optim=OptimConfig(name="momentum", lr=0.05),
        data=DataConfig(dataset="cifar10", batch_size=128),
        model=ModelConfig(name="lenet", compute_dtype="float32"),
        parallel=ParallelConfig(strategy="dp"),
    )


def _resnet50_dp() -> TrainConfig:
    # Config 2: "ResNet-50 / ImageNet, pure data-parallel DDP allreduce".
    # The JAX preset also sets overlap=True; the port reduces after the
    # backward (overlap is a later speed item, ROADMAP.md).
    return TrainConfig(
        preset="resnet50_dp",
        steps=100,
        optim=OptimConfig(name="momentum", lr=0.1, weight_decay=1e-4,
                          warmup_steps=5, schedule="cosine"),
        data=DataConfig(dataset="imagenet_synthetic", batch_size=1024),
        model=ModelConfig(name="resnet50"),
        parallel=ParallelConfig(strategy="dp", bucket_mb=25.0),
    )


PRESETS = {
    "mlp_mnist": _mlp_mnist,
    "lenet_cifar10": _lenet_cifar10,
    "resnet50_dp": _resnet50_dp,
    "llama3_8b_zero": _llama3_8b_zero,
    "llama3_longcontext": _llama3_longcontext,
}


def get_config(preset: str, **overrides: Any) -> TrainConfig:
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[preset]()
    return cfg.override(**overrides) if overrides else cfg

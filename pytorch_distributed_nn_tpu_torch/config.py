"""Config / flag system: the JAX package's ``config.py``, with the fields
the ported slices read.

Typed dataclasses with dotted CLI overrides (``--optim.lr=0.1``,
``--model.extra '{"quantized": true}'``) and the named presets the port
runs. A field the port does not read yet is not declared, so an override
naming it (``--metrics_path``, ``--profile_dir``) fails as an unknown
field instead of being ignored.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Any

from pytorch_distributed_nn_tpu_torch.runtime.mesh import MeshSpec


@dataclass
class OptimConfig:
    # sgd | momentum | adam | adamw | lamb | lion | adafactor
    name: str = "sgd"
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
    # skip weight decay on 1-D params (norm scales, biases); False decays
    # every parameter, as torch does
    decay_mask_norms: bool = False
    # momentum/adam/adamw/lion first moments stored in this dtype ("" =
    # the param dtype); rejected for lamb, sgd and adafactor
    mu_dtype: str = ""


@dataclass
class DataConfig:
    # mnist | cifar10 | imagenet_synthetic | lm_synthetic | mlm_synthetic
    # | token_file (causal LM from a memory-mapped .bin/.npy token dump)
    # | array_file (classification from a .npz with arrays x, y)
    # | mnist_idx (LeCun idx files; a t10k-* pair is the eval split)
    # | cifar10_bin (data_batch_*.bin; test_batch.bin is the eval split)
    # | image_folder (root/<class>/<image>, decoded lazily with PIL;
    #   train/ + val/ directories are taken as the split)
    dataset: str = "mnist"
    path: str = ""  # file or directory of the file-backed datasets
    # image_folder: the decoded size (short side scaled, then a center
    # crop: torchvision's eval transform)
    image_size: int = 224
    token_dtype: str = "uint16"  # a raw .bin token file's integer type
    # the finite datasets' sampling: "shuffle" (a permutation an epoch,
    # torch DistributedSampler semantics) or "replacement" (i.i.d.)
    sample: str = "shuffle"
    # token_file/array_file (and the readers without a test split): the
    # fraction held out for evaluation (0 = none: the evaluation then
    # draws from the training examples, in-sample)
    holdout_frac: float = 0.0
    batch_size: int = 128  # global batch size
    seq_len: int = 512
    vocab_size: int = 32000
    prefetch: int = 2  # background batches kept ready (0 = sync)
    # image_folder's decode threads a batch (torch DataLoader num_workers:
    # 0 = inline, -1 = one a core, at most 16)
    num_workers: int = -1


@dataclass
class ModelConfig:
    # mlp | lenet | resnet50 | bert_base | transformer_lm | moe_lm | vit |
    # llama3_8b
    name: str = "mlp"
    dtype: str = "float32"  # param dtype
    compute_dtype: str = "bfloat16"
    remat: bool = False  # torch.utils.checkpoint on every block
    # keep the remat-saved block boundaries in pinned host memory instead
    # of on the device (needs remat=True; Llama only)
    remat_offload: bool = False
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class ParallelConfig:
    strategy: str = "dp"  # single | dp | dp_explicit | zero | pipeline
    # dp_explicit's DDP-style bucket controller (ops/buckets.py): bucket
    # size in MB (<= 0: no buckets, one all-reduce a tensor, unless a
    # quantized wire asks for one large bucket)
    bucket_mb: float = 25.0
    # issue each bucket's (or, under dp, each tensor's) all-reduce from the
    # backward as soon as its gradients are in (ops/buckets.py,
    # OverlapReducer); the result is bit for bit the one after the backward
    overlap: bool = True
    quantized_allreduce: str = ""  # "" | "bf16" | "int8" (dp_explicit)
    # zero: 1 = optimizer state sharded over fsdp, parameters replicated;
    # 3 = parameters too (0 = the dp step)
    zero_stage: int = 3
    # pipeline: microbatches a step (the batch splits into this many)
    microbatches: int = 1
    # gradient accumulation (single/dp/zero): the global batch runs as
    # this many microbatches, their gradients summed in f32, one update
    grad_accum: int = 1
    # pipeline: "gpipe" (all forwards, then all backwards), "1f1b"
    # (PipeDream-flush: at most 2(S - s) - 1 microbatches live on stage s)
    # or "interleaved" (pipe_chunks virtual stages a device)
    pipeline_schedule: str = "gpipe"
    # virtual chunks a device under pipeline_schedule "interleaved" (the
    # layers divide by stages x chunks, the microbatches by stages)
    pipe_chunks: int = 1


@dataclass
class TrainConfig:
    preset: str = ""
    seed: int = 0
    steps: int = 100
    # k optimizer steps a dispatch (train/multistep.py): one captured CUDA
    # graph on the card, a loop of k steps on the CPU; the same math as k
    # steps. Checkpoint and eval cadences round up to a dispatch boundary
    multistep_k: int = 1
    # 0: every step trains on a fresh batch. N > 0: step i of a dispatch
    # trains on batch i % N of a pool of N device-resident batches
    # (a device-rate benchmark's setting: it repeats data)
    multistep_pool: int = 0
    log_every: int = 10
    eval_every: int = 0  # 0 = no eval; else eval every N steps
    eval_batches: int = 8  # batches per eval pass (held-out stream)
    # chunk the LM softmax-xent over T (tokens per chunk; 0 = dense
    # logits): one (B, chunk, V) logits block is live instead of (B, T, V)
    xent_chunk: int = 0
    # torch CrossEntropyLoss(label_smoothing=...) semantics; not with the
    # chunked loss
    label_smoothing: float = 0.0
    checkpoint_dir: str = ""  # "" = no checkpoints
    checkpoint_every: int = 0  # 0 = only on request and on preemption
    resume: bool = True  # restore the newest checkpoint at construction
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
    # Config 5: "Llama-3-8B sharded data-parallel (allgather params +
    # reduce-scatter grads)": ZeRO stage 3 over fsdp; the serve entry uses
    # its model.
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
        parallel=ParallelConfig(strategy="zero", zero_stage=3),
        xent_chunk=2048,
    )


def _moe_lm_ep() -> TrainConfig:
    # The mixture-of-experts LM (models/moe_lm.py): the experts split over
    # the `expert` axis (every rank, -1), the batch over data x fsdp,
    # ZeRO stage 3; no remat. The model's own defaults make it 12 layers,
    # d 768, 12 heads of 64, 8 experts of MLP 3072, top-2, capacity 1.25.
    return TrainConfig(
        preset="moe_lm_ep",
        steps=50,
        mesh=MeshSpec(expert=-1, data=1),
        optim=OptimConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                          warmup_steps=10, schedule="cosine"),
        data=DataConfig(dataset="lm_synthetic", batch_size=32, seq_len=1024),
        model=ModelConfig(name="moe_lm", remat=False),
        parallel=ParallelConfig(strategy="zero", zero_stage=3),
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


def _llama3_longcontext_96k() -> TrainConfig:
    # The same model at T = 98304 on one card: the JAX package's preset of
    # the name, its longest single-chip length.
    cfg = _llama3_longcontext()
    cfg.preset = "llama3_longcontext_96k"
    cfg.data.seq_len = 98304
    cfg.steps = 5
    return cfg


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
    return TrainConfig(
        preset="resnet50_dp",
        steps=100,
        optim=OptimConfig(name="momentum", lr=0.1, weight_decay=1e-4,
                          warmup_steps=5, schedule="cosine"),
        data=DataConfig(dataset="imagenet_synthetic", batch_size=1024),
        model=ModelConfig(name="resnet50"),
        parallel=ParallelConfig(strategy="dp", bucket_mb=25.0, overlap=True),
    )


def _bert_base_buckets() -> TrainConfig:
    # Config 3: "BERT-base pretraining, large fused gradient buckets":
    # dp_explicit, so the 100 MB buckets run through the bucket controller
    # (ops/buckets.py), issued from the backward (overlap).
    return TrainConfig(
        preset="bert_base_buckets",
        steps=100,
        optim=OptimConfig(name="adamw", lr=1e-4, weight_decay=0.01,
                          warmup_steps=10, schedule="linear"),
        data=DataConfig(dataset="mlm_synthetic", batch_size=256, seq_len=128,
                        vocab_size=30522),
        model=ModelConfig(name="bert_base"),
        parallel=ParallelConfig(strategy="dp_explicit", bucket_mb=100.0,
                                overlap=True),
    )


def _transformer_lm_pp() -> TrainConfig:
    # Config 4: "Transformer-LM pipeline-parallel (send/recv p2p)": 4
    # stages, 8 microbatches a step (parallel/pipeline.py).
    return TrainConfig(
        preset="transformer_lm_pp",
        steps=50,
        mesh=MeshSpec(pipe=4, data=-1),
        optim=OptimConfig(name="adam", lr=3e-4, warmup_steps=10,
                          schedule="cosine"),
        data=DataConfig(dataset="lm_synthetic", batch_size=64, seq_len=1024),
        model=ModelConfig(name="transformer_lm", remat=True),
        parallel=ParallelConfig(strategy="pipeline", microbatches=8,
                                pipeline_schedule="gpipe"),
    )


PRESETS = {
    "mlp_mnist": _mlp_mnist,
    "lenet_cifar10": _lenet_cifar10,
    "moe_lm_ep": _moe_lm_ep,
    "resnet50_dp": _resnet50_dp,
    "bert_base_buckets": _bert_base_buckets,
    "transformer_lm_pp": _transformer_lm_pp,
    "llama3_8b_zero": _llama3_8b_zero,
    "llama3_longcontext": _llama3_longcontext,
    "llama3_longcontext_96k": _llama3_longcontext_96k,
}


def get_config(preset: str, **overrides: Any) -> TrainConfig:
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[preset]()
    return cfg.override(**overrides) if overrides else cfg

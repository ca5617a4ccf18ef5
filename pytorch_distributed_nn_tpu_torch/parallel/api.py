"""Strategy dispatch: config -> train step (the JAX package's
``parallel/api.py``). Every strategy has the contract

    step(state, x, y) -> (state, metrics)

Ported: ``single``, ``dp`` and ``dp_explicit`` over a process group, with
``parallel.overlap`` (the reduction issued from the backward), sequence
parallelism (``mesh.seq > 1``) and gradient accumulation
(``parallel.grad_accum``) under ``single``/``dp``/``zero``; ``zero``
(stages 1 and 3, ``parallel/zero.py``, which also splits the experts over
``mesh.expert``) and ``pipeline`` (gpipe, 1f1b,
interleaved; ``parallel/pipeline.py``), each with the tensor axis
(``mesh.tensor > 1``, ``parallel/tensor.py``): ``single``/``dp`` then run
as ZeRO's step at stage 0, as the JAX ``dp`` step does. Sequence
parallelism runs under ``single``, ``dp`` and ``zero``, with or without
the tensor axis. ``ps`` raises ``ValueError`` as in the JAX package: the
asynchronous parameter server is a process-level program
(``parallel/ps.py``, run by ``scripts/train_ps.py``), not a step;
``dp_explicit`` (the reference's hand-rolled loop over replicated
parameters) refuses ``mesh.tensor > 1``.
"""

from __future__ import annotations

import logging
from typing import Callable

from pytorch_distributed_nn_tpu_torch.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
    MeshSpec,
    ProcessMesh,
)
from pytorch_distributed_nn_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

_STRATEGIES = ("single", "dp", "dp_explicit", "zero", "pipeline")
# the datasets of (B, T) token batches of a causal LM
TOKEN_DATASETS = ("lm_synthetic", "token_file")


def make_chunked_loss(chunk: int) -> Callable:
    """LM loss that never builds the (B, T, V) logits: the model returns
    the trunk hidden (``apply_kwargs``), the head kernel comes from the
    live parameters (``needs_params``), and ``chunked_lm_xent`` projects
    and cross-entropies per T-chunk. See ``dp._loss_and_grads``."""
    from pytorch_distributed_nn_tpu_torch.train.losses import chunked_lm_xent

    def loss_fn(hidden, targets, params):
        return chunked_lm_xent(hidden, params["lm_head.kernel"], targets,
                               chunk=chunk)

    loss_fn.needs_params = True
    loss_fn.reads = ("lm_head.kernel",)  # ZeRO-3 holds it gathered
    loss_fn.apply_kwargs = {"return_hidden": True}
    return loss_fn


def _check_seq(cfg: TrainConfig, seq: int) -> None:
    """The JAX package's ``mesh.seq > 1`` validations. Where it warns and
    lets XLA all-gather the sequence around a non-sequence-parallel
    attention, the port, which has no compiler to do that, raises."""
    if cfg.data.dataset not in TOKEN_DATASETS:
        raise ValueError(
            "mesh.seq > 1 shards the sequence dim of (B, T) token batches; "
            f"dataset {cfg.data.dataset!r} has no sequence dim to shard")
    if cfg.parallel.strategy not in ("single", "dp", "zero"):
        raise ValueError(
            "mesh.seq > 1 needs the replicated or ZeRO step (single/dp/"
            f"zero): strategy {cfg.parallel.strategy!r} does not run it")
    if cfg.data.seq_len % seq:
        raise ValueError(f"seq_len {cfg.data.seq_len} not divisible by "
                         f"mesh.seq {seq}")
    impl = cfg.model.extra.get("attn_impl")
    if impl not in ("ring", "ulysses"):
        raise ValueError(
            f"mesh.seq={seq} needs model.extra.attn_impl 'ring' or "
            f"'ulysses', got {impl!r}: each rank holds 1/{seq} of every "
            "sequence, and the port has no compiler to gather the rest "
            "around another attention (the JAX package lets XLA all-gather "
            "it)")


def make_train_step(cfg: TrainConfig, loss_fn: Callable,
                    mesh: MeshSpec | None = None, *,
                    process: ProcessMesh | None = None
                    ) -> tuple[Callable, Callable[[TrainState], TrainState]]:
    """``(step_fn, place_state_fn)`` over the ranks of the default process
    group: the step, and the function that lays the freshly built state
    out across them (rank 0's broadcast; under ``zero`` and ``pipeline``
    also the rank's slices or stages and the optimizer over them, where
    the caller builds it otherwise). ``mesh`` is the resolved mesh
    (``cfg.mesh`` when None); ``process`` the rank's groups (made from
    ``cfg.mesh`` and the process group when the state is placed, if
    None). Under sequence parallelism the step's loss and gradients are
    each rank's mean over its tokens, averaged over every rank, which is
    the global mean because the shards are equal."""
    from pytorch_distributed_nn_tpu_torch.parallel import dp

    strategy = cfg.parallel.strategy
    if strategy == "ps":
        raise ValueError(
            "the async parameter-server strategy is process-level, not a "
            "step: run pytorch_distributed_nn_tpu_torch/scripts/train_ps.py "
            "(python -m pytorch_distributed_nn_tpu_torch.scripts.train_ps; "
            "see parallel/ps.py)")
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    seq = (mesh or cfg.mesh).seq
    if seq > 1:
        _check_seq(cfg, seq)
    accum = cfg.parallel.grad_accum
    if accum < 1:
        raise ValueError(f"parallel.grad_accum must be >= 1, got {accum}")
    if accum > 1:
        if strategy not in ("single", "dp", "zero"):
            raise ValueError(
                f"grad_accum needs the replicated or ZeRO step (single/dp/"
                f"zero), got strategy {strategy!r} (the pipeline "
                "microbatches its own schedule: parallel.microbatches)")
        if cfg.data.batch_size % accum:
            raise ValueError(
                f"batch_size {cfg.data.batch_size} not divisible by "
                f"grad_accum {accum}")
    if cfg.xent_chunk:
        if strategy not in ("single", "dp", "dp_explicit", "zero"):
            raise ValueError(
                f"xent_chunk is not supported under strategy {strategy!r} "
                "(needs the shared dp/zero step)")
        if cfg.data.dataset not in TOKEN_DATASETS:
            raise ValueError(
                "xent_chunk is a causal-LM loss option (datasets "
                f"{TOKEN_DATASETS}), got {cfg.data.dataset!r}")
        local_len = cfg.data.seq_len // max(seq, 1)  # a rank's tokens a row
        if local_len > cfg.xent_chunk:
            if local_len % cfg.xent_chunk:
                raise ValueError(
                    f"a rank's {local_len} tokens a row (seq_len "
                    f"{cfg.data.seq_len} / mesh.seq {seq}) not divisible "
                    f"by xent_chunk {cfg.xent_chunk} -- the dense fallback "
                    "would defeat the memory bound")
            if cfg.label_smoothing:
                raise ValueError(
                    "label_smoothing is not supported with xent_chunk (the "
                    "chunked loss computes plain nll blockwise)")
            loss_fn = make_chunked_loss(cfg.xent_chunk)
        # else: the rank's sequence fits in one chunk, and the dense loss
        # (which does support label_smoothing) is already within the
        # chunked memory bound

    def mesh_of() -> ProcessMesh:
        if process is not None:
            return process
        from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
        from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
            process_mesh,
        )

        return process_mesh(cfg.mesh, cc.rank(), cc.world_size())

    tensor = (mesh or cfg.mesh).tensor
    if tensor > 1 and strategy == "dp_explicit":
        raise ValueError(
            "mesh.tensor > 1 splits the layers: strategy 'dp_explicit' "
            "reduces replicated parameters; use 'dp', 'zero' or 'pipeline'")
    if strategy == "zero" and cfg.parallel.zero_stage != 0 or (
            tensor > 1 and strategy in ("single", "dp", "zero")):
        from pytorch_distributed_nn_tpu_torch.parallel import zero

        stage = cfg.parallel.zero_stage if strategy == "zero" else 0
        return zero.make_sharded_train_step(
            loss_fn, mesh_of, stage=stage, accum=accum,
            optim_cfg=cfg.optim, total_steps=cfg.steps)
    if strategy == "pipeline":
        from pytorch_distributed_nn_tpu_torch.parallel import pipeline

        return pipeline.make_pipeline_train_step(cfg, loss_fn, mesh_of)
    if strategy in ("single", "dp", "zero"):  # zero stage 0: the dp step
        if cfg.parallel.quantized_allreduce:
            log.warning("quantized_allreduce requires strategy='dp_explicit' "
                        "(the 'dp' step reduces exactly) -- ignoring")
        return dp.make_dp_train_step(loss_fn, accum=accum,
                                     overlap=cfg.parallel.overlap)
    quant = cfg.parallel.quantized_allreduce
    if quant.lower() in ("true", "1", "yes", "on"):  # legacy boolean flag
        quant = "bf16"
    bucket_mb = cfg.parallel.bucket_mb
    if bucket_mb <= 0 and quant:
        # the quantized wire rides the bucket path: one large bucket keeps
        # it on when bucketing is off
        bucket_mb = 1e9
    bucket_reduce = None
    if bucket_mb > 0:
        from pytorch_distributed_nn_tpu_torch.ops.buckets import (
            make_bucket_reduce,
        )

        bucket_reduce = make_bucket_reduce(bucket_mb=bucket_mb,
                                           quantized=quant or False)
    step = dp.make_dp_train_step_explicit(loss_fn,
                                          bucket_reduce=bucket_reduce,
                                          overlap=cfg.parallel.overlap)
    return step, dp.replicate_state

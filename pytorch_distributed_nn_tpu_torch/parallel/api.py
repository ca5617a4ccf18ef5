"""Strategy dispatch: config -> train step (the JAX package's
``parallel/api.py``). Every strategy has the contract

    step(state, x, y) -> (state, metrics)

Ported: ``single``, ``dp`` and ``dp_explicit`` over a process group, with
``parallel.overlap`` (the reduction issued from the backward), sequence
parallelism (``mesh.seq > 1``) and gradient accumulation
(``parallel.grad_accum``) under ``single``/``dp``. The
sharded strategies (``zero``, ``pipeline``, ``ps``) raise, naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import logging
from typing import Callable

from pytorch_distributed_nn_tpu_torch.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_nn_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

_LATER = ("zero", "pipeline", "ps")
_SHARDED = "ROADMAP.md §1 item 3, the sharded strategies"


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
    loss_fn.apply_kwargs = {"return_hidden": True}
    return loss_fn


def _check_seq(cfg: TrainConfig, seq: int) -> None:
    """The JAX package's ``mesh.seq > 1`` validations. Where it warns and
    lets XLA all-gather the sequence around a non-sequence-parallel
    attention, the port, which has no compiler to do that, raises."""
    if cfg.data.dataset != "lm_synthetic":
        raise ValueError(
            "mesh.seq > 1 shards the sequence dim of (B, T) token batches; "
            f"dataset {cfg.data.dataset!r} has no sequence dim to shard")
    if cfg.parallel.strategy not in ("single", "dp"):
        raise ValueError(
            "mesh.seq > 1 needs the replicated step (single/dp): strategy "
            f"{cfg.parallel.strategy!r} does not run it")
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
                    mesh: MeshSpec | None = None
                    ) -> tuple[Callable, Callable[[TrainState], TrainState]]:
    """``(step_fn, place_state_fn)`` over the ranks of the default process
    group: the step, and the function that lays the freshly built state
    out across them (rank 0's broadcast). ``mesh`` is the resolved mesh
    (``cfg.mesh`` when None); under sequence parallelism the step's loss
    and gradients are each rank's mean over its tokens, averaged over
    every rank, which is the global mean because the shards are equal."""
    from pytorch_distributed_nn_tpu_torch.parallel import dp

    strategy = cfg.parallel.strategy
    seq = (mesh or cfg.mesh).seq
    if seq > 1:
        _check_seq(cfg, seq)
    accum = cfg.parallel.grad_accum
    if accum < 1:
        raise ValueError(f"parallel.grad_accum must be >= 1, got {accum}")
    if accum > 1:
        # the JAX package's rule: the compiler-sharded steps (zero is not
        # ported yet and raises below)
        if strategy not in ("single", "dp", "zero"):
            raise ValueError(
                f"grad_accum needs the replicated step (single/dp/zero), "
                f"got strategy {strategy!r}")
        if cfg.data.batch_size % accum:
            raise ValueError(
                f"batch_size {cfg.data.batch_size} not divisible by "
                f"grad_accum {accum}")
    if strategy in _LATER:
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported yet ({_SHARDED}); have "
            "'single', 'dp' and 'dp_explicit'")
    if strategy not in ("single", "dp", "dp_explicit"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if cfg.xent_chunk:
        if cfg.data.dataset != "lm_synthetic":
            raise ValueError(
                "xent_chunk is a causal-LM loss option (datasets "
                f"('lm_synthetic',)), got {cfg.data.dataset!r}")
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
    if strategy in ("single", "dp"):
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

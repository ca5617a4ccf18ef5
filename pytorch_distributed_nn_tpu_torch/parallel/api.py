"""Strategy dispatch: config -> train step (the JAX package's
``parallel/api.py``). Every strategy has the contract

    step(state, x, y) -> (state, metrics)

Ported: ``single``, ``dp`` and ``dp_explicit`` over a process group. The
sharded strategies raise, naming the ROADMAP slice that ports them.
"""

from __future__ import annotations

import logging
from typing import Callable

from pytorch_distributed_nn_tpu_torch.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

_LATER = {"zero": "slice 4", "pipeline": "slice 4", "ps": "slice 4"}


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


def make_train_step(cfg: TrainConfig, loss_fn: Callable
                    ) -> tuple[Callable, Callable[[TrainState], TrainState]]:
    """``(step_fn, place_state_fn)`` over the ranks of the default process
    group: the step, and the function that lays the freshly built state
    out across them (rank 0's broadcast)."""
    from pytorch_distributed_nn_tpu_torch.parallel import dp

    strategy = cfg.parallel.strategy
    if strategy in _LATER:
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported yet (ROADMAP.md, "
            f"{_LATER[strategy]}); have 'single', 'dp' and 'dp_explicit'")
    if strategy not in ("single", "dp", "dp_explicit"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if cfg.xent_chunk:
        if cfg.data.dataset != "lm_synthetic":
            raise ValueError(
                "xent_chunk is a causal-LM loss option (datasets "
                f"('lm_synthetic',)), got {cfg.data.dataset!r}")
        if cfg.data.seq_len > cfg.xent_chunk:
            if cfg.data.seq_len % cfg.xent_chunk:
                raise ValueError(
                    f"seq_len {cfg.data.seq_len} not divisible by "
                    f"xent_chunk {cfg.xent_chunk} -- the dense fallback "
                    "would defeat the memory bound")
            loss_fn = make_chunked_loss(cfg.xent_chunk)
        # else: the whole sequence fits in one chunk, and the dense loss
        # is already within the chunked memory bound
    accum = cfg.parallel.grad_accum
    if strategy in ("single", "dp"):
        if cfg.parallel.quantized_allreduce:
            log.warning("quantized_allreduce requires strategy='dp_explicit' "
                        "(the 'dp' step reduces exactly) -- ignoring")
        return dp.make_dp_train_step(loss_fn, accum=accum)
    if accum != 1:
        raise ValueError(f"grad_accum needs the 'dp' step, got strategy "
                         f"{strategy!r}")
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
                                          bucket_reduce=bucket_reduce)
    return step, dp.replicate_state

"""Strategy dispatch: config -> train step (the JAX package's
``parallel/api.py``). Every strategy has the contract

    step(state, x, y) -> (state, metrics)

Ported: ``single`` and ``dp`` at world size 1. The others raise, naming
the ROADMAP slice that ports them.
"""

from __future__ import annotations

from typing import Callable

from pytorch_distributed_nn_tpu_torch.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.train.state import TrainState

_LATER = {"dp_explicit": "slice 3", "zero": "slice 4",
          "pipeline": "slice 4", "ps": "slice 4"}


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
    """``(step_fn, place_state_fn)``. On one device the state is built
    where it runs, so placing it changes nothing."""
    from pytorch_distributed_nn_tpu_torch.parallel import zero

    strategy = cfg.parallel.strategy
    if strategy in _LATER:
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported yet (ROADMAP.md, "
            f"{_LATER[strategy]}); have 'single' and 'dp' at world size 1")
    if strategy not in ("single", "dp"):
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
    step = zero.make_zero_train_step(loss_fn, stage=0,
                                     accum=cfg.parallel.grad_accum)
    return step, lambda state: state

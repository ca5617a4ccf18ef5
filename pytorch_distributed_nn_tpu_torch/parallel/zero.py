"""The shared train step of the JAX package's ``parallel/zero.py``
(``_build_step``), at stage 0 on one device: loss and gradients, then one
optimizer update. Sharded stages are ROADMAP slice 4; gradient
accumulation is a trainer feature still to port.
"""

from __future__ import annotations

from typing import Callable

from pytorch_distributed_nn_tpu_torch.parallel import dp
from pytorch_distributed_nn_tpu_torch.train.state import TrainState


def make_zero_train_step(loss_fn: Callable, *, stage: int = 0,
                         accum: int = 1) -> Callable:
    """``step(state, x, y) -> (state, {"loss": loss})``; the state is
    updated in place."""
    if stage != 0:
        raise NotImplementedError(
            f"zero_stage {stage} shards parameters or optimizer state "
            "across devices: not ported yet (ROADMAP.md, slice 4)")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    if accum > 1:
        raise NotImplementedError(
            "grad_accum > 1 is not ported yet (ROADMAP.md, trainer features "
            "still to port: gradient accumulation)")

    def step(state: TrainState, x, y):
        loss = dp._loss_and_grads(state, x, y, loss_fn)
        state.apply_gradients()
        return state, {"loss": loss}

    return step

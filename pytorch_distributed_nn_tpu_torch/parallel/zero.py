"""The shared train step of the JAX package's ``parallel/zero.py``
(``_build_step``) at stage 0: data parallelism with the model replicated,
loss and gradients, their mean across ranks, one optimizer update.

Across ranks this is the JAX ``dp`` step, where the compiler shards the
batch: BatchNorm statistics span the global batch (the ``dp`` place
function sets each BatchNorm's ``sync_group``), and every gradient is
all-reduced to its mean, one tensor at a time, after the backward. Sharded
stages are ROADMAP slice 4; gradient accumulation is a trainer feature
still to port.
"""

from __future__ import annotations

from typing import Callable

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel import dp
from pytorch_distributed_nn_tpu_torch.train.state import TrainState


def make_zero_train_step(loss_fn: Callable, *, stage: int = 0,
                         accum: int = 1) -> Callable:
    """``step(state, x, y) -> (state, {"loss": loss})``; the state is
    updated in place. ``loss`` is the mean over the ranks' batches."""
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
        if cc.world_size() > 1:
            cc.tree_all_reduce_mean(dp.grads_of(state).values())
            loss = cc.all_reduce_mean(loss.reshape(1))[0]
        state.apply_gradients()
        return state, {"loss": loss}

    return step

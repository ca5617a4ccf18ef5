"""The shared train step of the JAX package's ``parallel/zero.py``
(``_build_step``) at stage 0: data parallelism with the model replicated,
loss and gradients, their mean across ranks, one optimizer update.

Across ranks this is the JAX ``dp`` step, where the compiler shards the
batch: BatchNorm statistics span the global batch (the ``dp`` place
function sets each BatchNorm's ``sync_group``), and every gradient is
all-reduced to its mean, one tensor at a time: after the backward, or
with ``overlap`` from the backward as each gradient is accumulated
(``ops.buckets.OverlapReducer``; bit for bit the same). At world 1 the
mean is the identity and nothing is issued. A token-weighted loss (the
masked LM's) is divided by the global count of valid tokens, as the JAX
``dp`` step's one computation over the global batch does. Sharded stages
are ROADMAP slice 4; gradient accumulation is a trainer feature still to
port.
"""

from __future__ import annotations

from typing import Callable

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel import dp
from pytorch_distributed_nn_tpu_torch.train.state import TrainState


def make_zero_train_step(loss_fn: Callable, *, stage: int = 0,
                         accum: int = 1, overlap: bool = False) -> Callable:
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

    reducer = dp.overlap_reducer() if overlap else None

    def step(state: TrainState, x, y):
        world = cc.world_size()
        fn = loss_fn
        if world > 1 and getattr(loss_fn, "token_weighted", False):
            fn = _global_token_mean(loss_fn, y, world)
        if world > 1 and reducer is not None:
            reducer(state).arm()
        loss = dp._loss_and_grads(state, x, y, fn)
        if world > 1:
            if reducer is not None:
                reducer(state).finish()
            else:
                cc.tree_all_reduce_mean(dp.grads_of(state).values())
            loss = cc.all_reduce_mean(loss.reshape(1))[0]
        state.apply_gradients()
        return state, {"loss": loss}

    step.reducer = reducer  # the overlap hooks' owner (None without)
    return step


def _global_token_mean(loss_fn: Callable, y, world: int) -> Callable:
    """``loss_fn`` with its denominator the global count of valid tokens
    over ``world`` (clamped at 1 first): the mean across ranks of the
    ranks' losses and gradients is then the global token mean."""
    from pytorch_distributed_nn_tpu_torch.train.losses import valid_mask

    count = cc.all_reduce_sum(valid_mask(y).sum().float().reshape(1))[0]
    denom = count.clamp(min=1) / world
    return lambda out, labels: loss_fn(out, labels, denom=denom)

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
are ROADMAP.md §1 item 3, the sharded strategies.

Gradient accumulation (``accum > 1``, the JAX ``step_accum``): the batch
runs as ``accum`` microbatches, one forward and backward each, and one
optimizer update follows. Each rank gives its a-th contiguous sub-block of
rows to microbatch a, which is the JAX split of the global batch (each
data shard's a-th sub-block) where the rank's rows divide by ``accum``;
where they do not, the JAX package falls back to contiguous chunks of the
global batch, rows a rank does not hold, and the port raises instead
(:func:`split_microbatches`). The gradients are summed in f32 in
microbatch order (autograd accumulates an f32 parameter's into its
``.grad``; another dtype's are added into an f32 sum), divided by
``accum`` and cast to the parameter dtype; then they are reduced and
applied. BatchNorm's running statistics update once a microbatch, each
microbatch's dropout draws from the run's seed folded with its index, the
loss is the sum of the microbatches' losses over ``accum``, and a
token-weighted loss takes each microbatch's own global count of valid
tokens. With ``overlap`` the reduction of a gradient is issued from the
last microbatch's backward, after that gradient is complete: the hooks
issue nothing on the earlier microbatches.
"""

from __future__ import annotations

from typing import Callable

import torch

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
            "across devices: not ported yet (ROADMAP.md §1 item 3, the "
            "sharded strategies)")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")

    reducer = dp.overlap_reducer() if overlap else None

    def step(state: TrainState, x, y):
        world = cc.world_size()
        if accum == 1:
            fn = loss_fn
            if world > 1 and getattr(loss_fn, "token_weighted", False):
                fn = _global_token_mean(loss_fn, y, world)
            if world > 1 and reducer is not None:
                reducer(state).arm()
            loss = dp._loss_and_grads(state, x, y, fn)
            _reduce(state, reducer, world)
        else:
            loss = _accumulate(state, x, y, loss_fn, accum, reducer, world)
        if world > 1:
            loss = cc.all_reduce_mean(loss.reshape(1))[0]
        state.apply_gradients()
        return state, {"loss": loss}

    step.reducer = reducer  # the overlap hooks' owner (None without)
    return step


def _reduce(state: TrainState, reducer, world: int) -> None:
    """The mean of every gradient across ranks: the armed hooks' reduces
    awaited, or one per-tensor mean after the backward."""
    if world == 1:
        return
    if reducer is not None:
        reducer(state).finish()
    else:
        cc.tree_all_reduce_mean(dp.grads_of(state).values())


def split_microbatches(x: torch.Tensor, accum: int) -> tuple:
    """This rank's (rows, ...) batch as ``accum`` contiguous microbatches
    of rows / accum. Raises where the rows do not divide: the JAX package's
    fallback for that case (contiguous chunks of the global batch) needs
    rows another rank holds."""
    rows = x.shape[0]
    if rows % accum:
        raise ValueError(
            f"this rank's {rows} rows of the batch are not divisible by "
            f"grad_accum {accum}: the microbatches would need rows of other "
            "ranks (make batch_size divisible by grad_accum x the data "
            "degree)")
    return x.chunk(accum)


def _accumulate(state: TrainState, x, y, loss_fn: Callable, accum: int,
                reducer, world: int) -> torch.Tensor:
    """The microbatches' forwards and backwards; leaves each ``.grad`` the
    reduced mean of the summed gradients over ``accum`` and returns
    ``lsum / accum`` (this rank's)."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    # an f32 parameter's .grad accumulates in f32 in autograd; any other
    # dtype's microbatch gradients are added into an f32 sum
    sums = [None if p.dtype == torch.float32 else
            torch.zeros_like(p, dtype=torch.float32) for p in params]
    index = {id(p): i for i, p in enumerate(params)}

    def complete(p: torch.Tensor) -> None:
        # the last microbatch's gradient is in: the mean in the param dtype
        s = sums[index[id(p)]]
        with torch.no_grad():
            if s is None:
                p.grad.div_(accum)
            else:
                p.grad = s.add_(p.grad.float()).div_(accum).to(p.dtype)

    lsum = None
    token_weighted = getattr(loss_fn, "token_weighted", False)
    for a, (bx, by) in enumerate(zip(split_microbatches(x, accum),
                                     split_microbatches(y, accum))):
        last = a == accum - 1
        fn = loss_fn
        if world > 1 and token_weighted:
            fn = _global_token_mean(loss_fn, by, world)
        if last and world > 1 and reducer is not None:
            reducer(state).arm(prepare=complete)
        loss = dp._loss_and_grads(state, bx, by, fn, microbatch=a)
        lsum = loss if lsum is None else lsum + loss
        if not last:
            with torch.no_grad():
                for p, s in zip(params, sums):
                    if s is not None:
                        s.add_(p.grad.float())
                        p.grad = None
    if world == 1 or reducer is None:
        for p in params:
            complete(p)
    _reduce(state, reducer, world)
    return lsum / accum


def _global_token_mean(loss_fn: Callable, y, world: int) -> Callable:
    """``loss_fn`` with its denominator the global count of valid tokens
    over ``world`` (clamped at 1 first): the mean across ranks of the
    ranks' losses and gradients is then the global token mean."""
    from pytorch_distributed_nn_tpu_torch.train.losses import valid_mask

    count = cc.all_reduce_sum(valid_mask(y).sum().float().reshape(1))[0]
    denom = count.clamp(min=1) / world
    return lambda out, labels: loss_fn(out, labels, denom=denom)

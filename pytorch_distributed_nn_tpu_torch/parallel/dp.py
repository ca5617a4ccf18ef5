"""Data parallelism (the JAX package's ``parallel/dp.py``): two
implementations of the same math.

- :func:`make_dp_train_step`: the ``dp`` step, the DDP analogue where the
  JAX package lets the compiler shard the batch. Here: BatchNorm over the
  global batch (SyncBN) and the per-tensor mean of every gradient after
  the backward (``parallel/zero.py``, stage 0).
- :func:`make_dp_train_step_explicit`: the ``dp_explicit`` step, the
  reference's hand-rolled ``average_gradients`` loop: local gradients
  (BatchNorm statistics of this rank's rows), then ``bucket_reduce`` (the
  DDP-style bucket controller and its compressed wires, ``ops/buckets.py``)
  or a per-tensor mean; the BatchNorm running statistics averaged across
  ranks after the step.

With ``overlap`` (``parallel.overlap``) either step issues its reduction
from the backward (``ops.buckets.OverlapReducer``) instead of after it,
with the same result bit for bit. Dropout draws from
``nn.layers.dropout_stream`` keyed by the run's seed, the step and the
rank, around the forward and the backward.

``torch.nn.parallel.DistributedDataParallel`` is not used: it broadcasts
rank 0's buffers where the JAX package averages them, and it owns the
bucket order the int8 wire depends on.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from pytorch_distributed_nn_tpu_torch.nn.batchnorm import TpuBatchNorm
from pytorch_distributed_nn_tpu_torch.nn.layers import dropout_stream, fold_in
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.ops.buckets import OverlapReducer
from pytorch_distributed_nn_tpu_torch.parallel.expert import (
    add_aux_losses,
    collect_aux_losses,
)
from pytorch_distributed_nn_tpu_torch.parallel.tensor import whole_leaves
from pytorch_distributed_nn_tpu_torch.train.state import TrainState


def forward(state: TrainState, x: torch.Tensor, *,
            apply_kwargs: dict | None = None) -> torch.Tensor:
    """The model on ``x``; ``apply_kwargs`` are passed on (for example
    ``return_hidden=True`` for the chunked loss, which then gets the trunk
    hidden instead of logits)."""
    return state.model(x, **(apply_kwargs or {}))


def _loss_and_grads(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                    loss_fn: Callable,
                    microbatch: int | None = None) -> torch.Tensor:
    """``loss_fn(out, y)``, backpropagated into the parameters' ``.grad``;
    returns the detached loss. A loss_fn marked by
    ``api.make_chunked_loss`` gets the model output it asks for
    (``loss_fn.apply_kwargs``) and the live parameters by name
    (``loss_fn.needs_params``; those it ``reads`` whole where the tensor
    axis splits them, ``parallel.tensor.whole_leaves``). ``microbatch``
    (under gradient accumulation) folds its index into the dropout seed,
    as the JAX step
    folds it into the step's key. The MoE layers' load-balance terms
    (``parallel/expert.py``) are added to the loss, as the JAX ``forward``
    adds the sown ``"losses"``; a microbatch's are its own. The dropout
    stream is keyed by the rank, or by the layout's ``dropout_rank`` where
    ranks hold the same rows (the expert axis)."""
    apply_kwargs = getattr(loss_fn, "apply_kwargs", None)
    seed = state.generator.initial_seed()
    if microbatch is not None:
        seed = fold_in(seed, microbatch)
    rank = getattr(state.sharding, "dropout_rank", None)
    with dropout_stream(seed, state.step,
                        cc.rank() if rank is None else rank):
        with collect_aux_losses(state.model) as aux:
            out = forward(state, x, apply_kwargs=apply_kwargs)
            if getattr(loss_fn, "needs_params", False):
                params = whole_leaves(
                    state.model, getattr(loss_fn, "reads", ()),
                    dict(state.model.named_parameters()))
                loss = loss_fn(out, y, params)
            else:
                loss = loss_fn(out, y)
        loss = add_aux_losses(loss, aux)
        loss.backward()
    return loss.detach()


def overlap_reducer(reduce=None) -> Callable[[TrainState], OverlapReducer]:
    """``reducer(state)``: the :class:`OverlapReducer` of ``state.model``
    for ``reduce``, kept on the model. It is made (its hooks registered) at
    the first call; a step built with another ``reduce`` (a different
    wire) replaces it and removes its hooks, so a model carries one set."""

    def reducer(state: TrainState) -> OverlapReducer:
        model = state.model
        current = getattr(model, "overlap_reducer", None)
        if current is None or current.reduce is not reduce:
            if current is not None:
                current.remove()
            current = OverlapReducer(model, reduce)
            model.overlap_reducer = current
        return current

    return reducer


def grads_of(state: TrainState) -> dict[str, torch.Tensor]:
    """The trainable parameters' gradients by (flax) name."""
    return {n: p.grad for n, p in state.model.named_parameters()
            if p.requires_grad}


def make_dp_train_step(loss_fn: Callable, *, accum: int = 1,
                       overlap: bool = False):
    """The ``dp`` step and its place function: ``(step, place_state)``.
    Across ranks ``place_state`` broadcasts rank 0's state and makes every
    BatchNorm's statistics span the global batch."""
    from pytorch_distributed_nn_tpu_torch.parallel import zero

    def place_state(state: TrainState) -> TrainState:
        if cc.world_size() == 1:
            return state  # built where it runs; nothing to share
        for m in state.model.modules():
            if isinstance(m, TpuBatchNorm):  # None there means no sync
                m.sync_group = dist.group.WORLD
        return replicate_state(state)

    return zero.make_zero_train_step(loss_fn, stage=0, accum=accum,
                                     overlap=overlap), place_state


def make_dp_train_step_explicit(loss_fn: Callable, *,
                                bucket_reduce: Callable | None = None,
                                overlap: bool = False) -> Callable:
    """The ``dp_explicit`` step: ``step(state, x, y) -> (state,
    {"loss": loss})``. ``bucket_reduce(grads, seed=step) -> grads`` (by
    name, an ``ops.buckets.BucketReduce``) replaces the per-tensor mean
    when given; with ``overlap`` its buckets (or the per-tensor means) are
    issued from the backward, at every world size."""
    reducer = overlap_reducer(bucket_reduce) if overlap else None

    def step(state: TrainState, x, y):
        if reducer is not None:
            reducer(state).arm(seed=state.step)
        loss = _loss_and_grads(state, x, y, loss_fn)
        params = dict(state.model.named_parameters())
        grads = grads_of(state)
        if reducer is not None:
            reducer(state).finish()
        elif bucket_reduce is None:
            cc.tree_all_reduce_mean(grads.values())
        else:
            for name, g in bucket_reduce(grads, seed=state.step).items():
                params[name].grad = g
        loss = cc.all_reduce_mean(loss.reshape(1))[0]
        # the BatchNorm running statistics must agree across replicas:
        # averaged like the gradients (torch DDP broadcasts rank 0's)
        cc.flat_all_reduce_mean(list(state.model_state.values()))
        state.apply_gradients()
        return state, {"loss": loss}

    step.reducer = reducer  # the overlap hooks' owner (None without)
    return step


@torch.no_grad()
def replicate_state(state: TrainState) -> TrainState:
    """The initial broadcast of rank 0's parameters and buffers (the
    reference's ``broadcast`` at DDP construction)."""
    for t in (*state.model.parameters(), *state.model.buffers()):
        cc.broadcast(t.data, src=0)
    return state

"""Sharded data parallelism, ZeRO (the JAX package's ``parallel/zero.py``):
BASELINE.json config 5, "allgather params + reduce-scatter grads".

Stage 0 (:func:`make_zero_train_step`) is the shared data-parallel step
(the ``dp`` strategy): the model replicated, loss and gradients, their
mean across ranks, one optimizer update. Across ranks this is the JAX
``dp`` step, where the compiler shards the batch: BatchNorm statistics
span the global batch (the ``dp`` place function sets each BatchNorm's
``sync_group``), and every gradient is all-reduced to its mean, one tensor
at a time: after the backward, or with ``overlap`` from the backward as
each gradient is accumulated (``ops.buckets.OverlapReducer``; bit for bit
the same). At world 1 the mean is the identity and nothing is issued. A
token-weighted loss (the masked LM's) is divided by the global count of
valid tokens, as the JAX ``dp`` step's one computation over the global
batch does.

Stages 1 and 3 (:func:`make_sharded_train_step`), where the JAX package
lays the state out by ``sharding_rules.spec_for`` and lets XLA insert the
collectives, do the same by hand over the rank's ``fsdp`` group
(:class:`ZeroShards`): each leaf that ``spec_for`` splits over ``fsdp`` is
held as the slice the JAX device at the same ``fsdp`` coordinate holds,
and smaller leaves stay replicated.

- Stage 1: the parameters stay whole; the optimizer holds the moments of
  this rank's slice only (its parameters are views of the slices). Each
  gradient is reduce-scattered to its mean slice as it completes in the
  backward, the owner updates its slice, and the new parameter is
  all-gathered after the update.
- Stage 3: each split parameter lives as its slice; the module's tensor
  keeps its shape but no storage. A unit (a direct child of the model:
  an embedding, a block, the head) gathers its parameters before its
  forward and frees them after; before its backward (a hook on its
  output's gradient) it gathers them again, also for remat's recompute,
  and frees them once each of its gradients is complete and
  reduce-scattered. A loss that reads a parameter itself (the chunked
  LM loss reads ``lm_head.kernel``, ``loss_fn.reads``) holds that unit
  gathered from before the forward until its gradient is complete.

The expert axis (``mesh.expert > 1``, the JAX ``moe_lm_ep`` layout): the
stacked experts of each MoE layer (``moe.wi``, ``moe.wo``, split along E by
``spec_for``'s EP rule) live on each rank as the E/n slice at its
``expert`` coordinate (``MoEMLP.split_experts``) and are never gathered:
each rank computes its own experts (``parallel/expert.py``). Where
``fsdp`` splits them too, it splits the slice along another dim. Ranks that differ only in their expert
coordinate hold the same rows and compute the same replicated values, so
nothing is reduced over ``expert``: the expert slices' gradients, like
every other, are reduced over data x fsdp only. The clip's global norm
sums the slices' squares over the expert group (``ShardLayout``). A
checkpoint's part is the rank's (expert, fsdp) coordinate; the ranks off
expert 0 write only their expert slices and their moments.

The tensor axis (``mesh.tensor > 1``, ``parallel/tensor.py``): the model
is first cut to the rank's Megatron slices (``split_tensor_layers``), then
the fsdp rule picks each slice's dim from the whole shape with ``tensor``
taken into account, so a rank holds the JAX device's shard at its
(tensor, fsdp) coordinates; the vocab tables split their vocab dim over
``(tensor, fsdp)`` together. Nothing is reduced over ``tensor``: each
slice's gradient is its own, and the gradients of the leaves the rules
leave whole come out the same on every tensor rank. The clip's norm sums
the slices' squares over the tensor group. At ``tensor > 1`` the ``dp``
strategy is this step at stage 0 (nothing split over ``fsdp``), as the
JAX ``dp`` step is ZeRO's stage 0 with the TP rules: one code path
reduces over data x fsdp, lays the optimizer out and names a
checkpoint's parts (``tensor<t>-`` before the fsdp and expert part).

Replicated leaves are all-reduced to their mean over data x fsdp, as
under ``dp``; a split gradient's reduce-scattered sum over ``fsdp`` is
then summed over ``data`` and divided by data x fsdp. Under sequence
parallelism (``mesh.seq > 1``, the JAX ``zero`` step on seq-sharded
batches) the ranks of a seq ring hold the same slices and each computes
the mean over its own tokens: every mean above is taken over data x fsdp
x seq (``ProcessMesh.grad``), the split sums over data x seq, and only
the first seq rank writes a checkpoint piece. Gradient
accumulation splits the batch as the stage-0 step does
(:func:`split_microbatches`); the gradients are summed over the
microbatches in f32 and reduced once, from the last microbatch's
backward. Every collective of a step is issued in the same order on every
rank (the backward's order). At world 1 nothing is split
(``spec_for`` with fsdp 1), no hook is registered and no collective is
issued: the step is the ``dp`` step. The global-norm clip, lamb's trust
ratio and adafactor's factored moments take their sums across the
slices (``train.optim.ShardLayout``).

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

import contextlib
import math
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from pytorch_distributed_nn_tpu_torch.nn.batchnorm import TpuBatchNorm
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel import dp
from pytorch_distributed_nn_tpu_torch.parallel.expert import (
    expert_split_leaves,
    split_expert_layers,
)
from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
    fsdp_dim,
    shard_slice,
)
from pytorch_distributed_nn_tpu_torch.parallel.tensor import (
    split_tensor_layers,
    tensor_layout,
    tensor_meta,
    vocab_parallel_loss,
)
from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
    AXES,
    ProcessMesh,
    coords,
)
from pytorch_distributed_nn_tpu_torch.train.optim import (
    ShardLayout,
    make_optimizer,
)
from pytorch_distributed_nn_tpu_torch.train.state import TrainState


def make_zero_train_step(loss_fn: Callable, *, stage: int = 0,
                         accum: int = 1, overlap: bool = False) -> Callable:
    """The stage-0 step: ``step(state, x, y) -> (state, {"loss": loss})``;
    the state is updated in place. ``loss`` is the mean over the ranks'
    batches. Stages 1 and 3 are :func:`make_sharded_train_step`."""
    if stage != 0:
        raise ValueError(f"the replicated step is stage 0, got {stage} "
                         "(make_sharded_train_step runs 1 and 3)")
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


def _global_token_mean(loss_fn: Callable, y, world: int,
                       group=None) -> Callable:
    """``loss_fn`` with its denominator the global count of valid tokens
    over the ``world`` ranks of ``group`` (clamped at 1 first): the mean
    across them of the ranks' losses and gradients is then the global
    token mean."""
    from pytorch_distributed_nn_tpu_torch.train.losses import valid_mask

    count = cc.all_reduce_sum(valid_mask(y).sum().float().reshape(1),
                              group)[0]
    denom = count.clamp(min=1) / world
    return lambda out, labels: loss_fn(out, labels, denom=denom)


# --------------------------------------------------------------------------
# stages 1 and 3
# --------------------------------------------------------------------------

def _gather(full: torch.Tensor, shard: torch.Tensor, dim: int, group,
            size: int) -> None:
    """``full`` (along ``dim``) from every rank's ``shard``, in place."""
    buf = torch.empty((size * shard.shape[dim],) + tuple(
        s for i, s in enumerate(shard.shape) if i != dim),
        dtype=shard.dtype, device=shard.device)
    cc.all_gather_into_tensor(buf, shard.movedim(dim, 0), group)
    full.copy_(buf.movedim(0, dim))


def _scatter_sum(grad: torch.Tensor, dim: int, group,
                 size: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over ``group`` of
    ``grad``."""
    moved = grad.movedim(dim, 0)
    out = torch.empty((moved.shape[0] // size,) + tuple(moved.shape[1:]),
                      dtype=grad.dtype, device=grad.device)
    cc.reduce_scatter_tensor(out, moved, group)
    return out.movedim(0, dim).contiguous()


class _Unit:
    """A direct child of the model that holds split parameters (stage 3):
    gathered or freed together."""

    def __init__(self, names: list[str]) -> None:
        self.names = names  # its split parameters
        self.gathered = False
        self.in_backward = False  # gathered for its backward (and remat)
        self.held = False  # a loss reads it: kept until its gradients
        self.pending: set[str] = set()


class ZeroShards:
    """The ZeRO layout of one model on one rank (``state.sharding``): which
    slice of each parameter it owns (``dims``, ``shards``), the optimizer's
    tensors, and, at stage 3, the hooks that gather and free the units.
    Built by :func:`make_sharded_train_step`'s place function."""

    def __init__(self, model: torch.nn.Module, mesh: ProcessMesh,
                 stage: int) -> None:
        self.model = model
        self.stage = stage
        self.mesh = mesh
        self.fsdp = mesh.fsdp
        # the gradients' mean: over data x fsdp x seq, a split one's
        # reduce-scattered sum over fsdp summed over data x seq
        self.grad, self.grad_replica = mesh.grad, mesh.grad_replica
        self.expert = mesh.expert
        self.tensor = mesh.tensor
        n, ne, nt = self.fsdp.size, self.expert.size, self.tensor.size
        # the Megatron slices first, then each MoE layer keeps its E/n
        # experts
        if nt > 1 and getattr(model, "tensor_split", None) is None:
            split_tensor_layers(model, self.tensor)
        self.tensor_leaves = getattr(model, "tensor_split", None) or {}
        self.experts = set(expert_split_leaves(model, ne))  # their leaves
        split_expert_layers(model, self.expert, self.experts)
        self.named = {k: p for k, p in model.named_parameters()
                      if p.requires_grad}
        # whole shapes (an expert slice's E is n times its own; a tensor
        # slice's whole shape is the one split_tensor_layers recorded)
        self.shapes = {k: (self.tensor_leaves[k][1] if k in
                           self.tensor_leaves else
                           (p.shape[0] * ne,) + tuple(p.shape[1:])
                           if k in self.experts else tuple(p.shape))
                       for k, p in self.named.items()}
        # stage 0 (the dp step under tensor > 1) splits nothing over fsdp
        self.dims = {k: fsdp_dim(k, self.shapes[k], n if stage else 1,
                                 expert=ne, tensor=nt)
                     for k in self.named}
        self.shards: dict[str, torch.Tensor] = {}
        # dropout masks follow the rows: the rank at expert 0 and tensor 0
        # of this rank's groups keys them
        c = coords(mesh.process_spec, mesh.rank)
        stride = {a: math.prod(getattr(mesh.process_spec, b)
                               for b in AXES[AXES.index(a) + 1:])
                  for a in ("expert", "tensor")}
        self.dropout_rank = (mesh.rank - c["expert"] * stride["expert"]
                             - c["tensor"] * stride["tensor"])
        with torch.no_grad():
            for k, p in self.named.items():
                d = self.dims[k]
                if d is None:
                    continue
                part = shard_slice(p.shape[d], self.fsdp.index, n)
                view = p.detach().narrow(d, part.start, part.stop - part.start)
                shard = view.clone() if stage == 3 else view
                self.shards[k] = shard.requires_grad_()
        self._name_of = {id(p): k for k, p in self.named.items()}
        self._units: dict[str, _Unit] = {}
        self._unit_of: dict[str, _Unit] = {}
        self._last = True  # this backward's gradients are reduced
        self._accum = 1
        self._sums: dict[str, torch.Tensor] = {}
        self._reduced: set[str] = set()
        if self.active:
            self._install()
        if stage == 3:
            for unit in self._units.values():
                self._free(unit)

    @property
    def active(self) -> bool:
        """Whether anything is split or reduced (false at world 1)."""
        return (bool(self.shards) or self.grad.size > 1
                or bool(self.experts) or bool(self.tensor_leaves))

    # -- what the optimizer and the checkpoint see -----------------------

    def optimizer_params(self) -> list[torch.Tensor]:
        """The tensors the optimizer updates, in parameter order: the slice
        of a split parameter, the parameter itself otherwise."""
        return [self.shards.get(k, p) for k, p in self.named.items()]

    def layout(self) -> ShardLayout:
        return ShardLayout(dims=[self.dims[k] if k in self.shards else None
                                 for k in self.named],
                           shapes=list(self.shapes.values()),
                           group=self.fsdp.group, size=self.fsdp.size,
                           experts=[k in self.experts for k in self.named],
                           expert_group=self.expert.group,
                           expert_size=self.expert.size,
                           **tensor_layout(self.tensor_leaves, self.named,
                                           self.tensor))

    def owned_params(self) -> dict[str, torch.Tensor]:
        """The state's parameter tensors that differ from the module's: the
        slices, at stage 3 (stage 1 keeps every parameter whole)."""
        return dict(self.shards) if self.stage == 3 else {}

    def meta(self) -> dict:
        """The layout a checkpoint records: the fsdp split of each leaf
        (``split``: dim and whole shape) and the expert-split leaves
        (``experts``: whole shape)."""
        out = {"strategy": "zero", "zero_stage": self.stage,
               "mesh": self.mesh.spec.sizes(),
               "split": {k: [self.dims[k], list(self.shapes[k])]
                         for k in self.shards}}
        if self.experts:
            out["experts"] = {k: list(self.shapes[k])
                              for k in sorted(self.experts)}
        if self.tensor_leaves:
            out["tensor"] = tensor_meta(self.tensor_leaves)
        return out

    def _part(self, expert: int, fsdp: int,
              tensor: int | None = None) -> str:
        base = (f"expert{expert}-fsdp{fsdp}" if self.experts
                else f"fsdp{fsdp}")
        if self.tensor_leaves:
            t = self.tensor.index if tensor is None else tensor
            return f"tensor{t}-{base}"
        return base

    @property
    def part_name(self) -> str:
        """This rank's piece of a checkpoint."""
        return self._part(self.expert.index, self.fsdp.index)

    def parts(self) -> list[str]:
        return [self._part(e, f, t)
                for t in range(self.tensor.size if self.tensor_leaves
                               else 1)
                for e in range(self.expert.size if self.experts else 1)
                for f in range(self.fsdp.size)]

    @property
    def writes(self) -> bool:
        """Whether this rank writes its piece (the first data replica, on
        the first seq rank: the seq ranks hold the same slices)."""
        return self.mesh.replica.index == 0 and self.mesh.seq.index == 0

    def keeps(self, param: str) -> bool:
        """Whether this rank's piece holds ``param``'s tensors (its value
        and its moments): its expert slices, and on expert 0 everything
        else, so that a replicated leaf is written once."""
        return self.expert.index == 0 or param in self.experts

    def restore_parts(self) -> list[str]:
        """The pieces a rank reads back, its own first: off expert 0 also
        expert 0's, for every tensor its own piece does not hold."""
        if self.experts and self.expert.index:
            return [self.part_name, self._part(0, self.fsdp.index)]
        return [self.part_name]

    # -- stage 3: gather and free ----------------------------------------

    def _install(self) -> None:
        model = self.model
        for uname, child in model.named_children():
            names = [k for k in self.shards
                     if k.startswith(uname + ".")]
            if not names:
                continue
            unit = self._units[uname] = _Unit(names)
            for k in names:
                self._unit_of[k] = unit
            if self.stage == 3:
                child.register_forward_pre_hook(
                    lambda m, args, u=unit: self._gather_unit(u))
                child.register_forward_hook(
                    lambda m, args, out, u=unit: self._after_forward(u, out))
        for p in self.named.values():
            p.register_post_accumulate_grad_hook(
                lambda p: self._grad_ready(self._name_of[id(p)]))

    @torch.no_grad()
    def _gather_unit(self, unit: _Unit) -> None:
        if unit.gathered:
            return
        for k in unit.names:
            full = self.named[k].data
            full.untyped_storage().resize_(full.numel() * full.element_size())
            _gather(full, self.shards[k], self.dims[k], self.fsdp.group,
                    self.fsdp.size)
        unit.gathered = True
        unit.pending = set(unit.names)

    def _free(self, unit: _Unit) -> None:
        for k in unit.names:
            # the shape stays, the storage goes; a tensor that autograd
            # saved reads the data again once the unit is gathered for the
            # backward
            self.named[k].data.untyped_storage().resize_(0)
        unit.gathered = unit.in_backward = unit.held = False

    def _after_forward(self, unit: _Unit, out) -> None:
        if unit.in_backward or unit.held:
            return  # remat's recompute inside the backward, or a loss's
        if torch.is_grad_enabled() and isinstance(out, torch.Tensor) \
                and out.requires_grad:
            out.register_hook(lambda g, u=unit: self._before_backward(u))
        self._free(unit)

    def _before_backward(self, unit: _Unit) -> None:
        self._gather_unit(unit)
        unit.in_backward = True

    @contextlib.contextmanager
    def hold(self, names: Iterable[str]):
        """The units of the parameters ``names`` gathered inside; in grad
        mode they stay gathered until their gradients are complete."""
        units = {self._unit_of[k] for k in names if k in self._unit_of}
        if self.stage != 3:
            units = set()
        for u in units:
            self._gather_unit(u)
            u.held = True
        try:
            yield
        finally:
            if not torch.is_grad_enabled():
                for u in units:
                    self._free(u)

    # -- the gradients ---------------------------------------------------

    def begin(self, last: bool, accum: int) -> None:
        """A microbatch's backward follows; ``last``: its gradients are
        complete (reduced in the hooks), else summed."""
        self._last, self._accum = last, accum
        self._reduced = set()

    @torch.no_grad()
    def _grad_ready(self, k: str) -> None:
        p = self.named[k]
        if self._accum > 1:
            if p.dtype != torch.float32:  # sum another dtype in f32
                s = self._sums.get(k)
                g = p.grad.float()
                self._sums[k] = g if s is None else s.add_(g)
                p.grad = None
                if self._last:
                    p.grad = self._sums.pop(k).div_(self._accum).to(p.dtype)
            elif self._last:
                p.grad.div_(self._accum)
        if self._last:
            self._reduce(k)
        unit = self._unit_of.get(k)
        if unit is not None and self.stage == 3:
            unit.pending.discard(k)
            if not unit.pending:
                self._free(unit)

    def _reduce(self, k: str) -> None:
        p = self.named[k]
        n = self.grad.size
        if k in self.shards:
            g = _scatter_sum(p.grad, self.dims[k], self.fsdp.group,
                             self.fsdp.size)
            if self.grad_replica.size > 1:
                cc.all_reduce_sum(g, self.grad_replica.group)
            self.shards[k].grad = g.div_(n)
            p.grad = None
        elif n > 1:
            cc.all_reduce_mean(p.grad, self.grad.group)
        self._reduced.add(k)

    def end(self) -> None:
        """After a microbatch's backward: every split unit freed; on the
        last microbatch every gradient reduced."""
        if self._last and self.active:
            missing = [k for k in self.named if k not in self._reduced]
            if missing:
                raise RuntimeError(
                    f"parameters got no gradient: {missing[:5]}")
        if self.stage == 3:
            for unit in self._units.values():
                if unit.gathered:
                    self._free(unit)

    @torch.no_grad()
    def gather_updated(self) -> None:
        """Stage 1, after the update: every split parameter whole again
        from the owners' new slices."""
        for k, shard in self.shards.items():
            full = torch.empty(self.shapes[k], dtype=shard.dtype,
                               device=shard.device)
            _gather(full, shard.detach(), self.dims[k], self.fsdp.group,
                    self.fsdp.size)
            self.named[k].data.copy_(full)


def make_sharded_train_step(loss_fn: Callable, mesh_of: Callable, *,
                            stage: int, accum: int = 1,
                            optim_cfg=None, total_steps: int = 1):
    """ZeRO stages 1 and 3 (and, under ``mesh.tensor > 1``, stage 0: the
    ``dp`` step): ``(step, place_state)``. ``mesh_of()`` gives
    the rank's :class:`ProcessMesh` when the state is placed;
    ``place_state`` broadcasts rank 0's weights, lays the state out
    (:class:`ZeroShards`, kept as ``state.sharding``) and builds the
    optimizer over the rank's slices (``optim_cfg``, ``total_steps``)."""
    if stage not in (0, 1, 3):
        raise ValueError(f"zero_stage must be 0, 1 or 3, got {stage}")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    reads = tuple(getattr(loss_fn, "reads", ()))
    token_weighted = getattr(loss_fn, "token_weighted", False)

    def place_state(state: TrainState) -> TrainState:
        mesh = mesh_of()
        if mesh.data.size > 1:
            for m in state.model.modules():
                if isinstance(m, TpuBatchNorm):
                    m.sync_group = mesh.data.group or dist.group.WORLD
        if cc.world_size() > 1:
            dp.replicate_state(state)  # rank 0's whole weights
        zs = ZeroShards(state.model, mesh, stage)
        state.sharding = zs
        state.optimizer = make_optimizer(
            optim_cfg, zs.optimizer_params(), total_steps=total_steps,
            layout=(zs.layout() if zs.shards or zs.experts
                    or zs.tensor_leaves else None))
        return state

    replicated = make_zero_train_step(loss_fn, stage=0, accum=accum)

    def step(state: TrainState, x, y):
        zs: ZeroShards = state.sharding
        if not zs.active:
            return replicated(state, x, y)  # world 1: the dp step
        n = zs.grad.size
        # the LM's cross-entropy on the vocab slices, under a split head
        objective = vocab_parallel_loss(loss_fn, state.model, zs.tensor) \
            or loss_fn
        parts = (list(zip(split_microbatches(x, accum),
                          split_microbatches(y, accum)))
                 if accum > 1 else [(x, y)])
        lsum = None
        for a, (bx, by) in enumerate(parts):
            fn = objective
            if n > 1 and token_weighted:
                fn = _global_token_mean(loss_fn, by, n, zs.grad.group)
            zs.begin(last=a == len(parts) - 1, accum=accum)
            with zs.hold(reads):
                loss = dp._loss_and_grads(
                    state, bx, by, fn,
                    microbatch=a if accum > 1 else None)
            zs.end()
            lsum = loss if lsum is None else lsum + loss
        loss = lsum / accum if accum > 1 else lsum
        if n > 1:
            loss = cc.all_reduce_mean(loss.reshape(1), zs.grad.group)[0]
        state.apply_gradients()
        if stage == 1 and zs.shards:
            zs.gather_updated()
        return state, {"loss": loss}

    return step, place_state

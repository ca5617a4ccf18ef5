"""Logical parallelism degrees: ``MeshSpec`` of the JAX package's
``runtime/mesh.py``, resolved against the process group's world size.

The port runs data, sequence, sharded-data, expert, pipeline and tensor
parallelism: one process a device, the global batch split over the
``data`` and ``fsdp`` axes (:func:`batch_slice`; ranks that differ only
in their ``expert`` or ``tensor`` coordinate hold the same rows, as the
JAX ``batch_pspec`` lays them out), each row's tokens over ``seq``
(:func:`seq_slice`), the parameters over ``fsdp`` (``parallel/zero.py``),
the experts of a mixture-of-experts layer over ``expert``
(``parallel/expert.py``), the layers over ``pipe``
(``parallel/pipeline.py``) and each layer's products over ``tensor``
(``parallel/tensor.py``), in any product of them. ZeRO's parameter slices
are the same on every seq rank: a step's gradients are averaged over
data x fsdp x seq (``ProcessMesh.grad``). What is left of the sharded
strategies (the parameter server) raises, naming :data:`REMAINING`.

Rank r sits at the row-major coordinates of r over ``AXES`` in the
resolved shape (:func:`coords`), the order in which the JAX package lays
CPU devices out on its mesh. :func:`process_mesh` builds a rank's process
groups along each axis it needs (:class:`AxisGroup`). Where the world
does not divide by ``pipe`` (one process on one card), every process holds
all the pipe stages of its data coordinate and hands activations between
them in memory (``ProcessMesh.pipe_local``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch.distributed as dist

AXES: tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq", "tensor")
# what is left of the sharded strategies; every port error for it names this
REMAINING = "ROADMAP.md §1 item 3, the remaining sharded strategies"


@dataclasses.dataclass
class MeshSpec:
    """Parallelism degree per named axis; ``data = -1`` means "absorb all
    remaining devices"."""

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        bad = {name: s for name, s in sizes.items() if s < 1 and s != -1}
        if bad:
            raise ValueError(f"axis sizes must be positive or -1, got {bad}")
        wildcard = [name for name, s in sizes.items() if s == -1]
        if len(wildcard) > 1:
            raise ValueError(f"at most one -1 axis, got {wildcard}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh spec {sizes} wants {fixed} devices, have {n_devices}")
        return MeshSpec(**sizes)

    def sizes(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AXES}

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.sizes()[a] for a in AXES)

    def world_size(self) -> int:
        if -1 in self.shape:
            raise ValueError("unresolved MeshSpec; call .resolve(n_devices)")
        return math.prod(self.shape)

    def data_degree(self) -> int:
        """How many ways the global batch is split (data x fsdp)."""
        return self.data * self.fsdp


def data_parallel(spec: MeshSpec, world_size: int) -> MeshSpec:
    """``spec`` resolved on ``world_size`` processes, one device each
    (``pipe`` stages count as processes unless the world does not divide
    by them and the other fixed axes, :func:`pipe_is_local`)."""
    if pipe_is_local(spec, world_size):
        return spec.resolve(world_size * spec.pipe)
    return spec.resolve(world_size)


def pipe_is_local(spec: MeshSpec, world_size: int) -> bool:
    """Whether each process holds every ``pipe`` stage: the world does not
    divide by the product of the fixed axes, ``pipe`` among them (one
    process on one card, or one process a ``tensor`` rank on one card,
    where NCCL refuses two ranks on the same device)."""
    fixed = math.prod(s for s in spec.shape if s != -1)
    return spec.pipe > 1 and world_size % fixed != 0


def coords(spec: MeshSpec, rank: int) -> dict[str, int]:
    """Rank ``rank``'s index on every axis of the resolved ``spec``:
    row-major over ``AXES``."""
    return dict(zip(AXES, (int(i) for i in
                           np.unravel_index(rank, spec.shape))))


def axis_groups(spec: MeshSpec, axes: tuple[str, ...]
                ) -> list[tuple[int, ...]]:
    """The rank groups that vary along ``axes`` only, each in row-major
    order over them, the groups in row-major order over the other axes:
    the order every rank creates them in."""
    ranks = np.arange(spec.world_size()).reshape(spec.shape)
    inner = [AXES.index(a) for a in axes]
    outer = [i for i in range(len(AXES)) if i not in inner]
    moved = ranks.transpose(outer + inner).reshape(
        -1, math.prod(spec.shape[i] for i in inner))
    return [tuple(int(r) for r in row) for row in moved]


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """A rank's place along one axis (or a product of axes): the process
    group of the ranks that differ from it only there (None at size 1,
    where nothing is exchanged, or where one process holds the whole
    axis), its index on it, and the size."""

    group: Any = None
    index: int = 0
    size: int = 1


# a rank's place on the seq ring: the model hands it to its attention
SeqGroup = AxisGroup


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The resolved mesh as one rank sees it. ``spec`` is the whole mesh;
    with ``pipe_local`` the processes span it with ``pipe = 1`` and each
    holds every stage (``pipe.group`` is None, ``pipe.index`` 0)."""

    spec: MeshSpec
    rank: int
    seq: AxisGroup
    # the data x fsdp product: the ranks with this rank's seq shard and stage
    data: AxisGroup
    pipe: AxisGroup
    fsdp: AxisGroup  # the fsdp axis alone
    replica: AxisGroup  # the data axis alone
    # the expert axis: the ranks with this rank's rows and the other experts
    expert: AxisGroup = AxisGroup()
    pipe_local: bool = False
    # the tensor axis: the ranks with this rank's rows and the other slices
    # of each layer's products
    tensor: AxisGroup = AxisGroup()
    # the ranks a step's loss and gradients are averaged over: data x fsdp
    # x seq (every rank with this rank's parameters' slices but other
    # tokens), and data x seq (those with this rank's fsdp slice too); the
    # data and replica groups where seq is 1
    grad: AxisGroup = AxisGroup()
    grad_replica: AxisGroup = AxisGroup()

    @property
    def process_spec(self) -> MeshSpec:
        """The shape the processes span (``pipe`` 1 when it is local)."""
        if self.pipe_local:
            return dataclasses.replace(self.spec, pipe=1)
        return self.spec

    @property
    def data_index(self) -> int:
        """This rank's index on the flattened data x fsdp axis (the batch
        rows it owns, :func:`batch_slice`)."""
        c = coords(self.process_spec, self.rank)
        return c["data"] * self.spec.fsdp + c["fsdp"]


_GROUPS = (("seq", ("seq",)), ("data", ("data", "fsdp")),
           ("pipe", ("pipe",)), ("fsdp", ("fsdp",)),
           ("replica", ("data",)), ("expert", ("expert",)),
           ("tensor", ("tensor",)), ("grad", ("data", "fsdp", "seq")),
           ("grad_replica", ("data", "seq")))
# the groups that are another one's where seq is 1
_SEQ_ALIASES = {"grad": "data", "grad_replica": "replica"}


def process_mesh(spec: MeshSpec, rank: int, world_size: int) -> ProcessMesh:
    """``spec`` resolved on the process group's ``world_size`` ranks, and
    rank ``rank``'s groups. Every rank creates the groups of every axis of
    size > 1 (collective ``dist.new_group`` calls) in :data:`_GROUPS`
    order, each axis's groups in :func:`axis_groups` order; an axis of size
    1, or one that spans the whole world, makes none (the world group
    stands in for the latter, None for the former)."""
    spec = data_parallel(spec, world_size)
    local = pipe_is_local(spec, world_size)
    procs = dataclasses.replace(spec, pipe=1) if local else spec
    made: dict[str, AxisGroup] = {}
    for kind, axes in _GROUPS:
        if kind in _SEQ_ALIASES and procs.seq == 1:
            made[kind] = made[_SEQ_ALIASES[kind]]
            continue
        size = math.prod(getattr(procs, a) for a in axes)
        index = 0
        c = coords(procs, rank)
        for a in axes:
            index = index * getattr(procs, a) + c[a]
        if size == 1:
            made[kind] = AxisGroup()
        elif size == world_size:
            made[kind] = AxisGroup(dist.group.WORLD, index, size)
        else:
            for ranks in axis_groups(procs, axes):
                group = dist.new_group(list(ranks))
                if rank in ranks:
                    made[kind] = AxisGroup(group, ranks.index(rank), size)
    if local:
        made["pipe"] = AxisGroup(None, 0, spec.pipe)
    return ProcessMesh(spec, rank, made["seq"], data=made["data"],
                       pipe=made["pipe"], fsdp=made["fsdp"],
                       replica=made["replica"], expert=made["expert"],
                       pipe_local=local, tensor=made["tensor"],
                       grad=made["grad"], grad_replica=made["grad_replica"])


def batch_slice(global_batch: int, rank: int, n: int) -> slice:
    """The rows of the global batch rank ``rank`` of ``n`` owns:
    ``[rank * B / n, (rank + 1) * B / n)``, as the JAX loader's
    ``batch_pspec`` shards them over data x fsdp."""
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by data degree {n}")
    per = global_batch // n
    return slice(rank * per, (rank + 1) * per)


def seq_slice(seq_len: int, index: int, n: int) -> slice:
    """The tokens of each row that sequence shard ``index`` of ``n`` owns:
    ``[index * T / n, (index + 1) * T / n)``, as the JAX loader's
    ``batch_pspec("seq")`` shards them."""
    if seq_len % n:
        raise ValueError(f"seq_len {seq_len} not divisible by mesh.seq {n}")
    per = seq_len // n
    return slice(index * per, (index + 1) * per)

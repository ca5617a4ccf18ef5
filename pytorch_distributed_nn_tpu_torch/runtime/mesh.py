"""Logical parallelism degrees: ``MeshSpec`` of the JAX package's
``runtime/mesh.py``, resolved against the process group's world size.

The port runs data and sequence parallelism: one process a device, the
global batch split over the ``data`` and ``fsdp`` axes
(:func:`data_parallel`, :func:`batch_slice`) and each row's tokens over
``seq`` (:func:`seq_slice`). The axes that shard the model (``pipe``,
``expert``, ``tensor``) are ROADMAP.md §1 item 3 and raise.

Rank r sits at the row-major coordinates of r over ``AXES`` in the
resolved shape (:func:`coords`), the order in which the JAX package lays
CPU devices out on its mesh. :func:`process_mesh` builds a rank's process
groups: the ring of its ``seq`` axis (:class:`SeqGroup`) and the ranks that
share its sequence shard (the ``data`` x ``fsdp`` group).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch.distributed as dist

AXES: tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq", "tensor")
_MODEL_AXES = ("pipe", "expert", "tensor")


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
    """``spec`` resolved on ``world_size`` processes, one device each;
    raises ``NotImplementedError`` where an axis that shards the model
    (pipe, expert, tensor) exceeds 1."""
    model_axes = {name: getattr(spec, name) for name in _MODEL_AXES
                  if getattr(spec, name) > 1}
    if model_axes:
        raise NotImplementedError(
            f"mesh axes {model_axes} shard the model: not ported yet "
            "(ROADMAP.md §1 item 3, the sharded strategies); the port runs "
            "the data, fsdp (data-parallel) and seq (sequence-parallel) "
            "degrees")
    return spec.resolve(world_size)


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
class SeqGroup:
    """A rank's place on the ``seq`` ring: the process group of the ring
    (None at size 1, where nothing is exchanged), this rank's index on it,
    and its size. The model hands it to its attention layers."""

    group: Any = None
    index: int = 0
    size: int = 1


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The resolved mesh as one rank sees it."""

    spec: MeshSpec
    rank: int
    seq: SeqGroup
    data_group: Optional[Any]  # ranks with this rank's sequence shard

    @property
    def data_index(self) -> int:
        """This rank's index on the flattened data x fsdp axis (the batch
        rows it owns, :func:`batch_slice`)."""
        c = coords(self.spec, self.rank)
        return c["data"] * self.spec.fsdp + c["fsdp"]


def process_mesh(spec: MeshSpec, rank: int, world_size: int) -> ProcessMesh:
    """``spec`` resolved on the process group's ``world_size`` ranks, and
    rank ``rank``'s groups. With ``seq > 1`` every rank creates every seq
    ring, then every data group, in :func:`axis_groups` order (collective
    ``dist.new_group`` calls); with ``seq == 1`` the ring is trivial and the
    data group is the world."""
    spec = data_parallel(spec, world_size)
    if spec.seq == 1:
        return ProcessMesh(spec, rank, SeqGroup(), data_group=None)
    seq = data = None
    for kind, axes in (("seq", ("seq",)), ("data", ("data", "fsdp"))):
        for ranks in axis_groups(spec, axes):
            group = dist.new_group(list(ranks))
            if rank in ranks:
                if kind == "seq":
                    seq = SeqGroup(group, ranks.index(rank), len(ranks))
                else:
                    data = group
    return ProcessMesh(spec, rank, seq, data_group=data)


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

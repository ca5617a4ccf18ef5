"""Logical parallelism degrees: ``MeshSpec`` of the JAX package's
``runtime/mesh.py``, resolved against the process group's world size.

The port runs data parallelism: one process a device, the global batch
split over the ``data`` and ``fsdp`` axes (:func:`data_parallel`,
:func:`batch_slice`). The axes that shard the model or the sequence
(``pipe``, ``expert``, ``seq``, ``tensor``) are ROADMAP slice 4 and raise.
"""

from __future__ import annotations

import dataclasses
import math

AXES: tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq", "tensor")
_MODEL_AXES = ("pipe", "expert", "seq", "tensor")


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
    raises ``NotImplementedError`` where an axis that shards the model or
    the sequence exceeds 1."""
    model_axes = {name: getattr(spec, name) for name in _MODEL_AXES
                  if getattr(spec, name) > 1}
    if model_axes:
        raise NotImplementedError(
            f"mesh axes {model_axes} shard the model or the sequence: not "
            "ported yet (ROADMAP.md, slice 4); the port runs data and fsdp "
            "(data-parallel) degrees")
    return spec.resolve(world_size)


def batch_slice(global_batch: int, rank: int, n: int) -> slice:
    """The rows of the global batch rank ``rank`` of ``n`` owns:
    ``[rank * B / n, (rank + 1) * B / n)``, as the JAX loader's
    ``batch_pspec`` shards them over data x fsdp."""
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by data degree {n}")
    per = global_batch // n
    return slice(rank * per, (rank + 1) * per)

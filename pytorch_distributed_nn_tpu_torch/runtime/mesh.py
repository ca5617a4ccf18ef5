"""Logical parallelism degrees: ``MeshSpec`` of the JAX package's
``runtime/mesh.py``.

The port runs on one device so far. ``MeshSpec.resolve`` keeps the JAX
semantics (``-1`` absorbs the remaining devices); :func:`single_device`
is what the trainer calls, and raises for a spec that wants more than one
device: data parallelism is ROADMAP slice 3, sequence and sharded
strategies slice 4.
"""

from __future__ import annotations

import dataclasses
import math

AXES: tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


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


def single_device(spec: MeshSpec) -> MeshSpec:
    """``spec`` resolved on one device; raises ``NotImplementedError`` for
    a spec that needs more than one."""
    fixed = {name: s for name, s in spec.sizes().items() if s > 1}
    if fixed:
        raise NotImplementedError(
            f"mesh {fixed} needs more than one device; the port runs on one "
            "so far (ROADMAP.md: data parallelism is slice 3, sequence and "
            "sharded strategies slice 4)")
    return spec.resolve(1)

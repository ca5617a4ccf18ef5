"""Parameter-layout rules: path + shape -> the axis each dim is split
over (the JAX package's ``parallel/sharding_rules.py``, kept here as data:
the port imports nothing of the JAX package).

- **fsdp** (ZeRO, ``parallel/zero.py``): shape-driven. A leaf of at least
  :data:`MIN_SHARD_ELEMS` elements is split over ``fsdp`` along its
  largest dim that ``fsdp`` divides; the embedding and head tables along
  their vocab dim (where it divides); smaller leaves stay replicated.
- **expert**: the stacked experts of an MoE layer (``moe/wi``,
  ``moe/wo``) split along E over ``expert`` (``parallel/zero.py``
  reads it; the router stays replicated), before the fsdp rule picks
  another dim.
- **tensor**: the name-driven Megatron rules (``parallel/tensor.py``
  cuts each layer by them): q/k/v and ``attn/out`` on their heads, the
  MLP's column and row products on ff, the embeddings and heads on their
  vocab dim (with ``fsdp`` on the same dim under ZeRO), the stacked
  experts on ff. The quantized leaves (``kernel_q``, ``embedding_q``,
  ``scale``) match no rule and stay whole, as in the JAX package.

:func:`spec_for` returns the JAX ``PartitionSpec``'s entries as a tuple
(``None``, ``"fsdp"``, ``"tensor"``, ``"expert"`` or a tuple of axes, one
per dim; ``()`` where nothing is split), so a port rank holds exactly the
slice of each leaf that the JAX device at the same coordinates holds.
Paths are the port's dotted flax names or the JAX '/'-joined ones.
"""

from __future__ import annotations

import re

import numpy as np

FSDP, TENSOR, EXPERT = "fsdp", "tensor", "expert"

# Leaves smaller than this stay replicated under fsdp (gathering a bias
# costs more than it saves).
MIN_SHARD_ELEMS = 2 ** 14

# (path regex, dim split over `tensor`)
TP_RULES: list[tuple[re.Pattern, int]] = [
    (re.compile(r"(query|key|value)/kernel$"), 1),  # (d, H, Dh): heads
    (re.compile(r"attn/out/kernel$"), 0),  # (H, Dh, d): heads (row-par)
    (re.compile(r"(mlp_in|gate_proj|up_proj)/kernel$"), 1),  # (d, ff)
    (re.compile(r"(mlp_in|gate_proj|up_proj)/bias$"), 0),  # (ff,)
    (re.compile(r"(mlp_out|down_proj)/kernel$"), 0),  # (ff, d): row-par
    (re.compile(r"(tok_embed|pos_embed|type_embed)/embedding$"), 0),
    (re.compile(r"(lm_head|mlm_decoder|head)/kernel$"), 1),  # (d, V)
    (re.compile(r"moe/wi$"), 2),  # (E, d, ff): ff (column-parallel)
    (re.compile(r"moe/wo$"), 1),  # (E, ff, d): ff (row-parallel)
]

# stacked expert leaves: the leading E dim over `expert`
EP_RULES: list[tuple[re.Pattern, int]] = [
    (re.compile(r"moe/(wi|wo)$"), 0),
]

# tables whose fsdp split rides the vocab dim (with `tensor` when TP is
# on), never d_model
_VOCAB_TABLES: list[tuple[re.Pattern, int]] = [
    (re.compile(r"(tok_embed|pos_embed|type_embed)/embedding$"), 0),
    (re.compile(r"(lm_head|mlm_decoder|head)/kernel$"), 1),
]


def spec_for(path: str, shape: tuple[int, ...], *, tensor: int = 1,
             fsdp: int = 1, expert: int = 1,
             min_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """The layout rule: one entry a dim of ``shape`` (``()`` when no dim
    is split). ``path`` is the leaf's name, dotted or '/'-joined."""
    path = path.replace(".", "/")
    ndim = len(shape)
    axes: list = [None] * ndim
    if expert > 1:
        for pattern, dim in EP_RULES:
            if pattern.search(path) and dim < ndim \
                    and shape[dim] % expert == 0:
                axes[dim] = EXPERT
                break
    if tensor > 1:
        for pattern, dim in TP_RULES:
            if pattern.search(path) and dim < ndim \
                    and shape[dim] % tensor == 0 and axes[dim] is None:
                axes[dim] = TENSOR
                break
    if fsdp > 1 and int(np.prod(shape or (1,))) >= min_elems:
        for pattern, dim in _VOCAB_TABLES:
            if (pattern.search(path) and dim < ndim
                    and axes[dim] in (TENSOR, None)
                    and shape[dim] % ((tensor if axes[dim] else 1)
                                      * fsdp) == 0):
                axes[dim] = (TENSOR, FSDP) if axes[dim] else FSDP
                break
        else:
            candidates = [(size, i) for i, size in enumerate(shape)
                          if axes[i] is None and size % fsdp == 0]
            if candidates:
                _, best = max(candidates)
                axes[best] = FSDP
    if all(a is None for a in axes):
        return ()
    return tuple(axes)


def _axes_of(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def axis_dim(spec: tuple, axis: str) -> int | None:
    """The dim of ``spec`` (a :func:`spec_for` result) that ``axis``
    splits, alone or with another axis (None: not split over it)."""
    for d, entry in enumerate(spec):
        if axis in _axes_of(entry):
            return d
    return None


def fsdp_dim(path: str, shape: tuple[int, ...], fsdp: int,
             expert: int = 1, tensor: int = 1) -> int | None:
    """The dim of a leaf of whole shape ``shape`` that ``fsdp`` splits
    (None: replicated), under the fsdp, expert and tensor rules."""
    return axis_dim(spec_for(path, shape, fsdp=fsdp, expert=expert,
                             tensor=tensor), FSDP)


def local_slice(path: str, t, *, tensor: tuple[int, int] = (1, 0),
                fsdp: tuple[int, int] = (1, 0),
                expert: tuple[int, int] = (1, 0),
                min_elems: int = MIN_SHARD_ELEMS):
    """The slice of the whole leaf ``t`` (a tensor) that the rank at the
    given ``(size, index)`` of each axis holds: the part of each dim that
    :func:`spec_for` splits, taken over the axes in the spec's order (a
    dim split over ``(tensor, fsdp)`` is cut by tensor first, then fsdp
    within it: the JAX device order, tensor the slower). A view of ``t``;
    ``t`` itself where nothing is split."""
    coords = {TENSOR: tensor, FSDP: fsdp, EXPERT: expert}
    spec = spec_for(path, tuple(t.shape), tensor=tensor[0], fsdp=fsdp[0],
                    expert=expert[0], min_elems=min_elems)
    for d, entry in enumerate(spec):
        for axis in _axes_of(entry):
            if axis is None:
                continue
            n, i = coords[axis]
            part = shard_slice(t.shape[d], i, n)
            t = t.narrow(d, part.start, part.stop - part.start)
    return t


def shard_slice(size: int, index: int, n: int) -> slice:
    """The part ``index`` of ``n`` of a dim of ``size``: the rows the
    device at that coordinate holds under a ``NamedSharding``."""
    if size % n:
        raise ValueError(f"dim {size} does not split {n} ways")
    per = size // n
    return slice(index * per, (index + 1) * per)

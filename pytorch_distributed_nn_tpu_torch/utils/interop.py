"""Weights across the two packages.

:func:`llama_params_from_jax` turns the JAX package's Llama param tree
(nested dicts with numpy leaves, e.g. ``jax.device_get(params)``, the
``Trainer``'s initial float params included) into this package's
``state_dict``; :func:`llama_params_to_jax` goes the other way;
:func:`lora_bank_from_jax` carries a stacked LoRA adapter bank across. Both
packages use the flax names and layouts, so the conversion flattens (or
nests) the path at the dots and converts each leaf; it serves the float
and the int8 layouts alike.

:func:`vision_params_from_jax` and :func:`vision_params_to_jax` do the same
for the MLP, LeNet and ResNet, whose flax variables come in two
collections: ``params`` and ``batch_stats`` (the BatchNorm running
``mean`` and ``var``, buffers here). Flax convolution kernels are HWIO and
the port's are OIHW: they are transposed here, once.

:func:`params_from_jax` and :func:`params_to_jax` carry the single-
collection models (BERT, the transformer LM, ViT, and the float Llama):
flatten or nest at the dots, conv kernels (ViT's ``patch_embed``) HWIO <->
OIHW.

The sharded strategies' layouts: :func:`stack_stage_params` and
:func:`unstack_stage_params` carry the port's per-block names to and from
the JAX pipeline's stacked tree (``{"stages": ..., "rest": ...}``, leaves
(S, K, ...) or, interleaved, (S, v, Kc, ...)); :func:`shard_params` and
:func:`gather_shards` carry a whole ``state_dict`` to and from the ZeRO-3
slices each ``fsdp`` (and ``expert``) rank holds
(``parallel.sharding_rules``); :func:`shard_params` also cuts the slices
of the ``tensor`` axis, with or without ZeRO-3. The MoE LM's leaves need
nothing of their own: ``blockN/moe/{router/kernel,wi,wo}`` flatten to
``blockN.moe.{router.kernel,wi,wo}`` as any other. Nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.nn.lora import BANK_KEYS


def _leaf(x: Any) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart through numpy
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _flatten(tree: Mapping[str, Any], out: dict[str, torch.Tensor],
             prefix: str = "") -> dict[str, torch.Tensor]:
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            _flatten(value, out, key + ".")
        else:
            out[key] = _leaf(value)
    return out


def _nest(flat: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split(".")
        for name in path:
            node = node.setdefault(name, {})
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[leaf] = t.contiguous().numpy()
    return out


def llama_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"layer0": {"attn": {"qkv": {"kernel_q": a}}}}`` ->
    ``{"layer0.attn.qkv.kernel_q": tensor}``."""
    return _flatten(tree, {})


def lora_bank_from_jax(bank: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's stacked LoRA bank (``nn/lora.py``: ``a_q``,
    ``b_q``, ``a_v``, ``b_v``, numpy or JAX arrays) as this package's: the
    same names, layouts and values, f32 tensors on the CPU."""
    return {k: _leaf(bank[k]).float() for k in BANK_KEYS}


def llama_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                        ) -> dict[str, Any]:
    """``{"layer0.attn.query.kernel": tensor}`` ->
    ``{"layer0": {"attn": {"query": {"kernel": array}}}}``, numpy leaves
    (bf16 leaves come out as f32, which numpy can hold)."""
    return _nest(state_dict)


def _is_conv_kernel(key: str, t: torch.Tensor) -> bool:
    return key.rsplit(".", 1)[-1] == "kernel" and t.dim() == 4


def vision_params_from_jax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any] | None = None
                           ) -> dict[str, torch.Tensor]:
    """The flax ``params`` (and ``batch_stats``, for a model with
    BatchNorm) of the MLP, LeNet or ResNet as this package's
    ``state_dict``: dotted flax paths, conv kernels HWIO -> OIHW."""
    out = _flatten(params, {})
    for key, t in out.items():
        if _is_conv_kernel(key, t):
            out[key] = t.permute(3, 2, 0, 1).contiguous()
    return _flatten(batch_stats or {}, out)


def vision_params_to_jax(state_dict: Mapping[str, torch.Tensor]
                         ) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(params, batch_stats)`` as flax nests them, numpy leaves: the
    inverse of :func:`vision_params_from_jax`. The BatchNorm buffers
    (``mean``, ``var``) go to ``batch_stats``."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        if key.rsplit(".", 1)[-1] in ("mean", "var"):
            stats[key] = t
        else:
            params[key] = (t.permute(2, 3, 1, 0) if _is_conv_kernel(key, t)
                           else t)
    return _nest(params), _nest(stats)


def params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax ``params`` tree (BERT, the transformer LM, ViT) as this
    package's ``state_dict``: dotted paths, conv kernels HWIO -> OIHW."""
    return vision_params_from_jax(params)


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of :func:`params_from_jax`: the nested flax ``params``
    tree, numpy leaves."""
    params, stats = vision_params_to_jax(state_dict)
    if stats:
        raise ValueError(f"{sorted(stats)} are BatchNorm statistics; use "
                         "vision_params_to_jax")
    return params


def _block_tree(flat: Mapping[str, torch.Tensor], name: str
                ) -> dict[str, np.ndarray]:
    """The leaves of block ``name`` by their path inside it."""
    pre = name + "."
    return {k[len(pre):]: _numpy(v) for k, v in flat.items()
            if k.startswith(pre)}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def stack_stage_params(state_dict: Mapping[str, torch.Tensor],
                       block_names: list[str], n_stages: int,
                       n_chunks: int = 1, chunked: bool | None = None
                       ) -> dict[str, Any]:
    """The JAX ``stack_stage_params`` of a port ``state_dict``: the blocks
    stacked into ``{"stages": tree}`` with leaves (S, K, ...) (stage s holds
    blocks [sK, (s+1)K)) or, ``chunked``, device-major (S, v, Kc, ...)
    ([d, j] is virtual stage j S + d), and the other leaves nested under
    ``"rest"``; numpy leaves."""
    S, v = n_stages, n_chunks
    chunked = v > 1 if chunked is None else chunked
    L = len(block_names)
    if L % (S * v):
        raise ValueError(f"{L} blocks not divisible by {S} stages x {v} "
                         "chunks")
    trees = [_block_tree(state_dict, n) for n in block_names]
    stacked = {}
    for key in trees[0]:
        x = np.stack([t[key] for t in trees])
        if chunked:
            per = L // (S * v)
            x = np.moveaxis(x.reshape((v, S, per) + x.shape[1:]), 0, 1)
        else:
            x = x.reshape((S, L // S) + x.shape[1:])
        stacked[key] = x
    rest = {k: v_ for k, v_ in state_dict.items()
            if k.split(".", 1)[0] not in set(block_names)}
    return {"stages": _nest({k: torch.from_numpy(np.ascontiguousarray(x))
                             for k, x in stacked.items()}),
            "rest": _nest(rest)}


def unstack_stage_params(tree: Mapping[str, Any], block_names: list[str],
                         n_chunks: int = 1, chunked: bool | None = None
                         ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`stack_stage_params` (the JAX
    ``unstack_stage_params``): the port's flat ``state_dict`` from a
    stacked tree (numpy leaves, e.g. the JAX pipeline's
    ``jax.device_get(state.params)``)."""
    chunked = n_chunks > 1 if chunked is None else chunked
    out = _flatten(tree["rest"], {})
    stages = _flatten(tree["stages"], {})
    for key, x in stages.items():
        a = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        if chunked:
            a = np.moveaxis(a, 1, 0).reshape((-1,) + a.shape[3:])
        else:
            a = a.reshape((-1,) + a.shape[2:])
        if a.shape[0] != len(block_names):
            raise ValueError(f"{key}: {a.shape[0]} blocks, names for "
                             f"{len(block_names)}")
        for i, name in enumerate(block_names):
            out[f"{name}.{key}"] = _leaf(a[i]).to(x.dtype)
    return out


def shard_params(state_dict: Mapping[str, torch.Tensor], fsdp: int,
                 index: int, expert: int = 1, expert_index: int = 0,
                 tensor: int = 1,
                 tensor_index: int = 0) -> dict[str, torch.Tensor]:
    """The slice of each leaf that the rank at ``fsdp`` coordinate
    ``index`` (and ``expert`` coordinate ``expert_index``, ``tensor``
    coordinate ``tensor_index``) holds under ZeRO-3
    (``sharding_rules.local_slice``: the stacked experts' E/n along E, the
    Megatron slice over ``tensor``, the part along the fsdp dim, the vocab
    tables' ``(tensor, fsdp)`` part of their vocab dim, or the whole leaf
    where it stays replicated): the JAX ``state_shardings``' per-device
    shard. ``fsdp`` 1 gives the slices of a layout without ZeRO-3."""
    from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
        local_slice,
    )

    return {k: local_slice(k, t, tensor=(tensor, tensor_index),
                           fsdp=(fsdp, index), expert=(expert, expert_index))
            for k, t in state_dict.items()}


def gather_shards(shards: list[Mapping[str, torch.Tensor]],
                  shapes: Mapping[str, tuple[int, ...]], expert: int = 1
                  ) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every rank's slices (in rank order
    over (expert, fsdp), fsdp the faster): the inverse of
    :func:`shard_params`, each leaf's split found by the same rule on its
    whole shape (``shapes``)."""
    from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
        EXPERT,
        FSDP,
        spec_for,
    )

    fsdp = len(shards) // expert
    out = {}
    for k in shards[0]:
        spec = spec_for(k, tuple(shapes[k]), fsdp=fsdp, expert=expert)
        pieces = [shards[i][k] for i in range(0, len(shards), fsdp)]
        if FSDP in spec:
            d = spec.index(FSDP)
            pieces = [torch.cat([shards[e + f][k] for f in range(fsdp)], d)
                      for e in range(0, len(shards), fsdp)]
        out[k] = (torch.cat(pieces, spec.index(EXPERT)) if EXPERT in spec
                  else pieces[0])
    return out

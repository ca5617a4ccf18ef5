"""Tensor parallelism: Megatron-LM's layout of a layer's products over the
``tensor`` axis, written out with ``torch.distributed`` where the JAX
package lays the parameters out by ``sharding_rules.spec_for`` and lets
XLA's SPMD partitioner insert the collectives.

:func:`split_tensor_layers` cuts each parameter that the TP rules split
to the slice the JAX device at this rank's ``tensor`` coordinate holds
(``sharding_rules.local_slice``) and tells each layer how it runs on its
slice:

- **column-parallel** (q/k/v, ``mlp_in``, ``gate_proj``, ``up_proj`` and
  their split biases): the input is replicated, the output split; the
  block applies ``ops.collectives.sum_grad`` (the identity whose gradient
  is summed over ``tensor``) once to the input of its column products.
  Attention keeps H/t query and Hkv/t key/value heads (a GQA group stays
  whole on a rank); its q/k/v biases, which the rules leave whole, are
  sliced to the local heads after ``sum_grad``, so every rank gets their
  whole gradient;
- **row-parallel** (``attn/out``, ``mlp_out``, ``down_proj``): the input
  is split, the partial products are summed over ``tensor`` by
  ``ops.collectives.sum_forward`` (whose gradient passes through), then
  the whole bias is added once;
- **the vocab-split embedding** (``tok_embed``, ``pos_embed``,
  ``type_embed``): a masked lookup of the rank's rows of the table, then
  ``sum_forward``;
- **the vocab-split head** (``lm_head``, ``mlm_decoder``, ``head``):
  ``sum_grad`` on its input, the rank's columns of the logits, then an
  all-gather of the logit slices (``ops.collectives.gather_split``), and
  the whole bias after it. The logits of each vocab slice are complete
  products (no partial sum), so the gathered logits are the one-device
  logits and every loss of ``train/losses.py`` (label smoothing, the
  masked LM's, the chunked loss) and the evaluation run on them
  unchanged, at the memory of the unsplit head on every rank. The causal
  LM's plain cross-entropy (``losses.lm_xent``) takes the vocab-parallel
  form instead (:func:`vocab_parallel_loss`): the head keeps its slice
  (``split_logits``) and the max, the sum of exponentials and the
  target's logit are reduced over ``tensor``, so no rank holds the whole
  (B, T, V) logits (on one card, two ranks of config 4's LM at B 64 could
  not hold 8.4 GB of gathered f32 logits, their log-softmax and their
  gradient each);
- **the stacked experts** (``moe/wi`` on ff, ``moe/wo`` on ff): each
  expert's two products column- then row-parallel, summed over ``tensor``
  before the experts' outputs are gathered over ``expert``; the router
  stays whole.

A block then issues two all-reduces forward (after attention and after
the MLP) and two backward (into the attention's and the MLP's input),
plus one a q/k/v bias in the backward; the head one all-gather forward
and one all-reduce backward; an embedding one all-reduce forward. The
chunked LM loss reads the head's kernel itself: :func:`whole_leaves`
gathers it (``loss_fn.reads``), as ZeRO-3 gathers it over ``fsdp``.

Gradients of the leaves the rules leave whole (the norms, the
row-parallel and q/k/v biases, the router) come out the same on every
tensor rank, because everything downstream of a ``sum_forward`` or a
``gather_split`` is computed alike on every rank. The quantized leaves
(``kernel_q``, ``embedding_q``, ``scale``) match no rule and stay whole:
under :func:`shard_for_inference` an int8 model keeps its weights whole on
every rank and only its KV cache is split on the heads, as the JAX
``generate(mesh=)`` lays it out.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
    TENSOR,
    axis_dim,
    local_slice,
    spec_for,
)
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AxisGroup

# the heads whose vocab-split logits are gathered
_HEADS = re.compile(r"(^|\.)(lm_head|mlm_decoder|head)$")


def tensor_split_leaves(model: nn.Module, size: int
                        ) -> dict[str, tuple[int, tuple[int, ...]]]:
    """The parameters the TP rules split ``size`` ways, by name: ``(dim,
    whole shape)``. The shapes are the module's (whole, before
    :func:`split_tensor_layers`)."""
    out = {}
    if size <= 1:
        return out
    for k, p in model.named_parameters():
        d = axis_dim(spec_for(k, tuple(p.shape), tensor=size), TENSOR)
        if d is not None:
            out[k] = (d, tuple(p.shape))
    return out


def _cut(module: nn.Module, leaf: str, name: str, tensor: AxisGroup) -> None:
    """``module.<leaf>`` (``name`` in the model) replaced by this rank's
    slice, a parameter of its own."""
    p = getattr(module, leaf)
    part = local_slice(name, p.detach(), tensor=(tensor.size, tensor.index))
    setattr(module, leaf, nn.Parameter(part.contiguous().clone(),
                                       requires_grad=p.requires_grad))


@torch.no_grad()
def split_tensor_layers(model: nn.Module, tensor: AxisGroup
                        ) -> dict[str, tuple[int, tuple[int, ...]]]:
    """Cut ``model`` to this rank's slice over ``tensor`` in place (module
    docstring) and return the split leaves (:func:`tensor_split_leaves`);
    the model keeps them as ``model.tensor_split``. Nothing at size 1. A
    layer the rules split in a way the port has no form for raises."""
    from pytorch_distributed_nn_tpu_torch.nn.attention import (
        MultiHeadAttention,
    )
    from pytorch_distributed_nn_tpu_torch.nn.layers import Dense, Embed
    from pytorch_distributed_nn_tpu_torch.parallel.expert import MoEMLP

    if getattr(model, "tensor_split", None) is not None:
        raise ValueError("the model is split over tensor already")
    leaves = tensor_split_leaves(model, tensor.size)
    model.tensor_split = leaves
    if not leaves:
        return leaves
    modules = dict(model.named_modules())

    def split(prefix: str, leaf: str) -> bool:
        return f"{prefix}.{leaf}" in leaves

    for prefix, m in modules.items():
        if isinstance(m, MultiHeadAttention):
            _split_attention(m, prefix, leaves, tensor)
        elif isinstance(m, MoEMLP):
            got = (split(prefix, "wi"), split(prefix, "wo"))
            if any(got) and not all(got):
                raise NotImplementedError(
                    f"{prefix}: the rules split one expert kernel over "
                    "tensor and not the other")
            if all(got):
                _cut(m, "wi", f"{prefix}.wi", tensor)
                _cut(m, "wo", f"{prefix}.wo", tensor)
                m.tensor = tensor
        elif isinstance(m, Embed) and split(prefix, "embedding"):
            _cut(m, "embedding", f"{prefix}.embedding", tensor)
            m.tensor = tensor
        elif isinstance(m, Dense) and split(prefix, "kernel"):
            dim = leaves[f"{prefix}.kernel"][0]
            if dim == 1 and _HEADS.search(prefix):
                mode = "gather"
            elif dim == 1:
                mode = "column"
                owner = modules[prefix.rpartition(".")[0]]
                if not isinstance(getattr(owner, "tensor", None), AxisGroup):
                    raise NotImplementedError(
                        f"{prefix}: a column-parallel product in a "
                        f"{type(owner).__name__}, which does not enter "
                        "the tensor axis")
                owner.tensor = tensor
            else:
                mode = "row"
            _cut(m, "kernel", f"{prefix}.kernel", tensor)
            if m.bias is not None and split(prefix, "bias"):
                _cut(m, "bias", f"{prefix}.bias", tensor)
            m.tensor, m.tp_mode = tensor, mode
    cut = {k for k, _ in model.named_parameters()
           if getattr(_owner(modules, k), "tensor", AxisGroup()).size > 1}
    missing = sorted(set(leaves) - cut)
    if missing:
        raise NotImplementedError(
            f"the TP rules split {missing[:4]}, which no tensor-parallel "
            "layer of the port holds")
    return leaves


def _owner(modules: dict, name: str) -> nn.Module:
    return modules[name.rpartition(".")[0]]


def _split_attention(m, prefix: str, leaves: dict, tensor: AxisGroup
                     ) -> None:
    """Attention on its local heads: q/k/v column-parallel, ``out``
    row-parallel (all four split, or none)."""
    names = ("query", "key", "value", "out")
    got = [f"{prefix}.{n}.kernel" in leaves for n in names]
    if not any(got):
        return
    t = tensor.size
    if not all(got):
        raise NotImplementedError(
            f"{prefix}: {m.num_heads} query and {m.num_kv_heads} key/value "
            f"heads do not both split {t} ways (the GQA group stays whole "
            "on a rank)")
    for n in names:
        dense = getattr(m, n)
        _cut(dense, "kernel", f"{prefix}.{n}.kernel", tensor)
        k = dense.kernel.shape
        if n == "out":
            dense.in_shape = tuple(k[:len(dense.in_shape)])
            dense.tp_mode = "row"
        else:
            dense.features = tuple(k[len(dense.in_shape):])
            dense.tp_mode = "column"
        dense.tensor = tensor
    m.num_heads //= t
    m.num_kv_heads //= t
    m.tensor = tensor


def shard_for_inference(model: nn.Module, tensor: AxisGroup) -> nn.Module:
    """``model`` laid out for decoding over ``tensor`` in place: the split
    leaves of :func:`split_tensor_layers` (float models), and every
    attention layer whose projections stay whole (an int8 model's) keeps
    only its local key/value heads in its decode cache, where ``tensor``
    divides them, and gathers its heads' outputs before ``out``: the JAX
    ``shard_params_for_inference`` with its cache split on axis 2. Done
    once; a model split over this group already is returned as it is."""
    from pytorch_distributed_nn_tpu_torch.nn.attention import (
        MultiHeadAttention,
    )

    if tensor.size <= 1:
        return model
    if getattr(model, "tensor_split", None) is not None:
        if getattr(model, "tensor_group", None) is not tensor.group:
            raise ValueError("the model is split over another tensor group")
        return model
    split_tensor_layers(model, tensor)
    model.tensor_group = tensor.group
    for m in model.modules():
        if isinstance(m, MultiHeadAttention) and m.tensor.size == 1 \
                and m.num_kv_heads % tensor.size == 0:
            m.cache_tensor = tensor
    return model


def tensor_layout(leaves: dict, named: dict, tensor) -> dict:
    """The tensor part of the optimizer's ``ShardLayout`` over the
    parameters ``named``: the dim of each that ``leaves`` (a model's
    ``tensor_split``) splits, and the group (nothing where none is)."""
    if not leaves:
        return {}
    return dict(tensor_dims=[leaves[k][0] if k in leaves else None
                             for k in named],
                tensor_group=tensor.group, tensor_size=tensor.size)


def tensor_meta(leaves: dict) -> dict:
    """A checkpoint's record of the tensor split: each split leaf's dim
    and whole shape."""
    return {k: [d, list(shape)] for k, (d, shape) in sorted(leaves.items())}


def whole_leaves(model: nn.Module, names, params: dict) -> dict:
    """``params`` (by name) with each of ``names`` that a vocab-split head
    holds replaced by the whole kernel, gathered over ``tensor``
    (differentiable: every rank computes the loss on it alike, and its
    backward keeps the rank's slice of the gradient)."""
    split = getattr(model, "tensor_split", None) or {}
    if not split:
        return params
    modules = dict(model.named_modules())
    out = dict(params)
    for name in names:
        if name not in split or name not in out:
            continue
        owner = _owner(modules, name)
        g = owner.tensor
        out[name] = cc.gather_split(out[name], g.group, g.size, g.index,
                                    split[name][0])
    return out


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        tensor: AxisGroup) -> torch.Tensor:
    """The mean over tokens of the cross-entropy of ``targets`` under the
    softmax of the whole logits, from this rank's vocab slice ``logits``
    (..., V/t), the ``tensor.index``-th: the rows' max over every slice
    (``all_reduce_max``, no gradient: it cancels), then the sum of
    exponentials and the target's logit (nonzero on its owner only), each
    summed over ``tensor`` by ``sum_forward``. In f32, as ``lm_xent``."""
    logits = logits.float()
    width = logits.shape[-1]
    m = cc.all_reduce_max(logits.detach().amax(-1), tensor.group)
    total = cc.sum_forward(torch.exp(logits - m[..., None]).sum(-1),
                           tensor.group, tensor.size)
    local = targets.long() - tensor.index * width
    mine = (local >= 0) & (local < width)
    picked = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])
    target = cc.sum_forward(picked[..., 0] * mine, tensor.group,
                            tensor.size)
    return (torch.log(total) + m - target).mean()


def vocab_parallel_loss(loss_fn, model: nn.Module, tensor: AxisGroup):
    """The vocab-parallel form of ``loss_fn`` where it is the causal LM's
    plain cross-entropy (``losses.lm_xent``) and ``model``'s ``lm_head``
    is split over ``tensor``: ``fn(local_logits, targets)``, its
    ``apply_kwargs`` asking the model for its logit slice
    (``split_logits``). None otherwise (the gathered logits serve)."""
    from pytorch_distributed_nn_tpu_torch.train.losses import lm_xent

    split = getattr(model, "tensor_split", None) or {}
    if loss_fn is not lm_xent or "lm_head.kernel" not in split:
        return None

    def fn(logits, targets):
        return vocab_parallel_xent(logits, targets, tensor)

    fn.apply_kwargs = {"split_logits": True}
    return fn

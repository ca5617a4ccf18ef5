"""Per-request LoRA adapters for serving many fine-tunes of one model.

Counterpart of the JAX package's ``nn/lora.py``. Each adapter is a pair of
rank-``r`` factors per layer for the attention's q and v projections,
stored STACKED across adapters, so the bank is four tensors and a request
selects its adapter by one gather (``a_q[ids]``) in the forward, not by a
weight swap. A batch row's delta ``(x @ A) @ B`` is added to the
projection's output before rotary, so rows on different adapters share one
decode batch (the serving engine keeps a per-slot adapter id).

Bank layout (adapters leading, layers second)::

    a_q: (n, L, d_model, r)      b_q: (n, L, r, H,   head_dim)
    a_v: (n, L, d_model, r)      b_v: (n, L, r, Hkv, head_dim)

Adapter 0 is the base model: its B factors are zeros, so its delta is
exactly zero and a request on it decodes as without a bank.
:func:`init_lora_bank` draws a bank with random deltas for adapters >= 1;
:func:`merge_lora` folds one adapter into a float model's weights, the
oracle the per-request path must match. ``utils.interop.lora_bank_from_jax``
carries a JAX bank across.
"""

from __future__ import annotations

import torch

BANK_KEYS = ("a_q", "b_q", "a_v", "b_v")


def lora_delta(x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, d); a: (B, d, r); b: (B, r, H, Dh) -> (B, T, H, Dh) in
    x's dtype: two small products of the f32-upcast operands with f32
    accumulation (the JAX einsums' ``preferred_element_type``), cast back
    once at the end."""
    h = torch.einsum("btd,bdr->btr", x.float(), a.float())
    return torch.einsum("btr,brhk->bthk", h, b.float()).to(x.dtype)


def init_lora_bank(model, *, num_adapters: int, rank: int,
                   generator: torch.Generator, scale: float = 0.02) -> dict:
    """A stacked adapter bank shaped for ``model`` (the Llama family:
    ``num_layers``, ``d_model``, ``num_heads``, ``num_kv_heads``), f32 on
    the model's device, drawn from ``generator`` on its own device.

    Adapter 0's B factors are zeros (the base model); adapters >= 1 get
    N(0, scale) factors in A and B."""
    if num_adapters < 1:
        raise ValueError(
            f"num_adapters must be >= 1, got {num_adapters}")
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    L, d, H = model.num_layers, model.d_model, model.num_heads
    Hkv = model.num_kv_heads or H
    Dh = d // H
    n, r = num_adapters, rank
    shapes = dict(a_q=(n, L, d, r), b_q=(n, L, r, H, Dh),
                  a_v=(n, L, d, r), b_v=(n, L, r, Hkv, Dh))
    bank = {}
    for key in BANK_KEYS:
        t = torch.randn(shapes[key], generator=generator,
                        device=generator.device, dtype=torch.float32)
        bank[key] = (scale * t).to(model.device)
    bank["b_q"][0].zero_()
    bank["b_v"][0].zero_()
    return bank


def num_adapters(bank) -> int:
    return 0 if bank is None else int(bank["a_q"].shape[0])


def layer_slice(bank: dict, layer: int) -> tuple:
    """The per-layer factors the attention takes: ``(a_q, b_q, a_v,
    b_v)``, each with the layer axis removed."""
    return tuple(bank[k][:, layer] for k in BANK_KEYS)


@torch.no_grad()
def merge_lora(state_dict: dict, bank: dict, adapter: int) -> dict:
    """A copy of a FLOAT Llama's ``state_dict`` with adapter ``adapter``'s
    deltas folded into ``layer{i}.attn.{query,value}.kernel`` (d, H, Dh):
    the oracle of the per-request path (``generate()`` on the merged
    weights must give the serving engine's tokens on that adapter)."""
    n = num_adapters(bank)
    if not 0 <= adapter < n:
        raise ValueError(f"adapter must be in [0, {n}), got {adapter}")
    merged = dict(state_dict)
    for i in range(bank["a_q"].shape[1]):
        for proj, ak, bk in (("query", "a_q", "b_q"),
                             ("value", "a_v", "b_v")):
            key = f"layer{i}.attn.{proj}.kernel"
            a = bank[ak][adapter, i].float()  # (d, r)
            b = bank[bk][adapter, i].float()  # (r, H, Dh)
            delta = torch.einsum("dr,rhk->dhk", a, b)
            kern = state_dict[key]
            merged[key] = kern + delta.to(kern.device, kern.dtype)
    return merged

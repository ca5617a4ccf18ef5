"""The mixture-of-experts decoder LM (the JAX package's
``models/moe_lm.py``): the transformer LM (``models/transformer_lm.py``)
with the dense FFN of every ``moe_every``-th block swapped for a
:class:`~pytorch_distributed_nn_tpu_torch.parallel.expert.MoEMLP` named
``moe`` (``moe_every`` 1: every block, Mixtral's cadence; 2: every other,
GShard's, the last of each pair). Attention, norms, embeddings and head
are the transformer LM's, under the same names. Cached decode is refused,
as in the JAX package: the routing of a token depends on every token of
its group."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import register
from pytorch_distributed_nn_tpu_torch.models.transformer_lm import (
    TransformerLM,
)
from pytorch_distributed_nn_tpu_torch.nn.dtypes import get_policy
from pytorch_distributed_nn_tpu_torch.parallel.expert import MoEMLP


class MoETransformerLM(TransformerLM):
    supports_decode = False

    def __init__(self, *, num_experts: int = 8, k: int = 2,
                 capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, group_size: int = 1024,
                 moe_every: int = 1, **lm) -> None:
        # read by layer_ffn while the base class builds the blocks
        self.moe_kwargs = dict(num_experts=num_experts, k=k,
                               capacity_factor=capacity_factor,
                               aux_loss_weight=aux_loss_weight,
                               group_size=group_size)
        self.moe_every = moe_every
        super().__init__(**lm)

    def layer_ffn(self, i: int, **block) -> Optional[tuple[str, nn.Module]]:
        if i % self.moe_every != self.moe_every - 1:
            return None
        return "moe", MoEMLP(block["d_model"], mlp_dim=block["mlp_dim"],
                             dtype=block["dtype"],
                             param_dtype=block["param_dtype"],
                             device=block["device"], **self.moe_kwargs)

    @property
    def extra_init(self) -> dict:
        """The stacked expert kernels: normal with std fan_in^-1/2 (d for
        ``wi``, ff for ``wo``), as every kernel of ``init_params_``."""
        def normal(p: torch.Tensor, g: torch.Generator) -> None:
            p.normal_(0.0, p.shape[-2] ** -0.5, generator=g)

        return {f"{name}.{leaf}": normal
                for name, m in self.named_modules()
                if isinstance(m, MoEMLP) for leaf in ("wi", "wo")}


@register("moe_lm")
def build_moe_lm(cfg: ModelConfig, device="cuda",
                 input_shape=None) -> MoETransformerLM:
    """``input_shape`` (a (T,) token row) does not size the model."""
    policy = get_policy(cfg.dtype, cfg.compute_dtype)
    e = cfg.extra
    return MoETransformerLM(
        vocab_size=e.get("vocab_size", 32000),
        num_layers=e.get("num_layers", 12),
        d_model=e.get("d_model", 768),
        num_heads=e.get("num_heads", 12),
        mlp_dim=e.get("mlp_dim", 3072),
        num_experts=e.get("num_experts", 8),
        k=e.get("k", 2),
        capacity_factor=e.get("capacity_factor", 1.25),
        aux_loss_weight=e.get("aux_loss_weight", 0.01),
        group_size=e.get("group_size", 1024),
        moe_every=e.get("moe_every", 1),
        max_len=e.get("max_len", 2048),
        dropout=e.get("dropout", 0.0),
        remat=cfg.remat,
        attn_impl=e.get("attn_impl", "auto"),
        dtype=policy.compute_dtype,
        param_dtype=policy.param_dtype,
        device=device,
    )

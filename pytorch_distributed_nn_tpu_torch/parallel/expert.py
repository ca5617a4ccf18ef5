"""Expert parallelism: the mixture-of-experts layer and its routing (the
JAX package's ``parallel/expert.py``), GShard's capacity-based
formulation.

- **Routing by dense one-hot tensors.** Each group of tokens is routed
  with (N, E, C) ``dispatch`` and ``combine`` tensors and products over
  them, all of static shape: no gather, no scatter, no data-dependent
  shape (:func:`top_k_routing`).
- **Groups.** Tokens are routed in groups of at most ``group_size``,
  never across a sequence; each expert takes ``capacity`` tokens of a
  group (:func:`expert_capacity`) and drops the rest, whose combine weight
  is zero, so they pass through the residual alone.
- **Slots.** Slots are claimed choice-major, then token-major: every
  token's first choice before any second choice. Gates are the router
  probabilities of the k choices renormalised over them, before capacity
  drops them. ``jax.lax.top_k`` breaks ties to the lower expert index;
  the port takes the k largest by a sort that is stable on equal keys,
  which does the same.
- **Dtypes.** The router and the routing in f32; the dispatch, the
  experts' products and the combine in the compute dtype; ``gelu`` the
  tanh form.

The load-balance term (Switch's ``E · Σ_e f_e P_e``, times
``aux_loss_weight``, the mean over groups) is what the JAX layer sows into
its ``"losses"`` collection: here each layer hands it to the collector of
:func:`collect_aux_losses`, which the training loss
(``parallel/dp.py``) opens around the forward and adds up. Outside it
(evaluation) nothing is collected. ``fraction_dropped`` stays on the
:class:`Routing` (and the layer's ``last_fraction_dropped``) and is not
added to the loss, as in the JAX package.

**The expert axis.** ``wi`` (E, d, ff) and ``wo`` (E, ff, d) are split
along E over the ``expert`` group (``sharding_rules.EP_RULES``;
:meth:`MoEMLP.split_experts`): each rank keeps its E/n experts, the slice
the JAX device at its coordinate holds, and never gathers the others'.
Ranks that differ only in their expert coordinate hold the same batch
rows (the JAX ``batch_pspec``), so each computes the router, the routing
and the combine weights in full, identical on every rank, and runs its
own experts on the tokens dispatched to them. The transport is an
all-gather of the experts' outputs (``ops.collectives.gather_replicated``)
rather than the JAX compiler's all-to-all pair, because the tokens are
already on every rank:

- forward: one all-gather over the expert group of the (E/n, G·C, d)
  outputs, then the full combine on every rank;
- backward: the cotangent of the gathered outputs is the same on every
  rank (all that follows is replicated), so the gather's backward keeps
  the rank's own rows and sends nothing; the tokens' gradient through the
  dispatch is partial (this rank's experts only) and is summed over the
  expert group by an identity on the dispatch's token input
  (``ops.collectives.sum_grad``): one all-reduce.

Over ``tensor`` (``parallel/tensor.py``) each expert's ``wi`` keeps its
ff columns and ``wo`` its ff rows: the experts' outputs are summed over
``tensor`` (``ops.collectives.sum_forward``) before the gather over
``expert``, and the tokens' gradient through the experts is summed over
``tensor`` as well as over ``expert``.

So each gradient counts once. The router's gradient (through the
combine weights and the load-balance term) and the tokens' gradient
through the router are whole on every rank and cross no wire; the
tokens' gradient through the experts is summed exactly once; the
load-balance term is computed in full on every rank and no backward
collective follows it; the experts' slices get their gradient from their
own rank only. (The other form, an all-reduce of partial combines, would
leave the router's gradient partial and need a second sum.)
:func:`ep_dispatch` / :func:`ep_combine` are the explicit all-to-all pair
of the JAX module, kept for its users and held against it in the tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.nn.layers import Dense, gelu
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.runtime.mesh import AxisGroup


@dataclasses.dataclass
class Routing:
    """:func:`top_k_routing`'s result for groups of N tokens (leading dims
    are the groups')."""

    dispatch: torch.Tensor  # (..., N, E, C) 0/1: token n -> slot c of e
    combine: torch.Tensor  # (..., N, E, C) the gate weights of the return
    aux_loss: torch.Tensor  # (...) Switch load-balance loss
    fraction_dropped: torch.Tensor  # (...) (token, choice)s over capacity


def expert_capacity(num_tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Slots an expert takes from a group: ceil(k N / E x factor), at
    least 1."""
    return max(1, math.ceil(num_tokens * k * capacity_factor / num_experts))


def top_k_routing(router_logits: torch.Tensor, *, k: int,
                  capacity: int) -> Routing:
    """Capacity-based top-k routing of ``router_logits`` (..., N, E), each
    leading index a group of its own (the JAX function vmapped over
    groups). In f32; ``dispatch`` and ``combine`` come back in the logits'
    dtype."""
    N, E = router_logits.shape[-2:]
    probs = torch.softmax(router_logits.float(), dim=-1)
    # the k largest, ties to the lower index (jax.lax.top_k's order)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = top.values[..., :k]
    expert_idx = top.indices[..., :k]  # (..., N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # one-hot expert choice per (choice, token): (..., k, N, E)
    choice_mask = F.one_hot(expert_idx.transpose(-1, -2), E).float()
    # a (choice, token)'s place in its expert's queue: all first choices
    # claim slots before any second choice; within a level, token order
    pos_within = torch.cumsum(choice_mask, dim=-2) - choice_mask
    level = choice_mask.sum(-2)  # (..., k, E)
    prior = torch.cumsum(level, dim=-2) - level  # earlier levels' claims
    position = ((pos_within + prior.unsqueeze(-2)) * choice_mask).sum(-1)

    fits = position < capacity  # (..., k, N)
    kept = fits.transpose(-1, -2) & (gate_vals > 0)  # (..., N, k)
    weight = gate_vals * kept.float()
    slots = torch.arange(capacity, device=router_logits.device)
    # slot one-hots; a position past the capacity matches no slot
    slot_onehot = (position.transpose(-1, -2).unsqueeze(-1)
                   == slots).float()  # (..., N, k, C)
    expert_onehot = F.one_hot(expert_idx, E).float()  # (..., N, k, E)
    combine = None
    for j in range(k):  # at most one choice lands on an (e, c): exact
        term = ((weight[..., j, None] * expert_onehot[..., j, :])
                .unsqueeze(-1) * slot_onehot[..., j, None, :])
        combine = term if combine is None else combine + term
    dispatch = (combine > 0.0).to(router_logits.dtype)

    # Switch load balance: E * sum_e f_e P_e, f_e the fraction of (token,
    # choice) assignments routed to e, P_e the mean router probability;
    # 1 at uniform routing
    f = choice_mask.sum(dim=(-3, -2)) / (N * k)
    p = probs.mean(dim=-2)
    aux = E * (f * p).sum(-1)
    dropped = 1.0 - kept.sum(dim=(-2, -1)).float() / (N * k)
    return Routing(dispatch=dispatch, combine=combine.to(router_logits.dtype),
                   aux_loss=aux, fraction_dropped=dropped)


class MoEMLP(nn.Module):
    """The mixture-of-experts FFN (in place of a dense MLP): ``router``
    (a bias-free f32 Dense to E logits), ``wi`` (E, d, ff) and ``wo``
    (E, ff, d). After :meth:`split_experts` this rank holds E/n of them
    and runs the layer over the expert group (module docstring)."""

    def __init__(self, d_model: int, *, num_experts: int = 8,
                 mlp_dim: int = 3072, k: int = 2,
                 capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, group_size: int = 1024,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.num_experts = num_experts
        self.mlp_dim = mlp_dim
        self.k = k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.group_size = group_size
        self.dtype = dtype
        self.router = Dense(d_model, num_experts, dtype=torch.float32,
                            param_dtype=param_dtype, use_bias=False,
                            device=device)
        self.wi = nn.Parameter(torch.zeros(
            (num_experts, d_model, mlp_dim), dtype=param_dtype,
            device=device))
        self.wo = nn.Parameter(torch.zeros(
            (num_experts, mlp_dim, d_model), dtype=param_dtype,
            device=device))
        self.expert = AxisGroup()  # the group the experts are split over
        # the group each expert's ff is split over (parallel/tensor.py)
        self.tensor = AxisGroup()
        # set by collect_aux_losses: (its collector, this layer's name)
        self.aux_sink: Optional[tuple[dict, str]] = None
        self.last_fraction_dropped: Optional[torch.Tensor] = None

    @torch.no_grad()
    def split_experts(self, expert: AxisGroup) -> None:
        """Keep only this rank's E/n experts (the slice at its index on
        ``expert``) and run over that group from now on."""
        n = expert.size
        if self.num_experts % n:
            raise ValueError(f"{self.num_experts} experts do not split "
                             f"{n} ways")
        per = self.num_experts // n
        lo = expert.index * per
        self.wi = nn.Parameter(self.wi.detach()[lo:lo + per].clone())
        self.wo = nn.Parameter(self.wo.detach()[lo:lo + per].clone())
        self.expert = expert

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, d = x.shape
        E = self.num_experts
        g = min(self.group_size, S)
        if S % g:
            raise ValueError(
                f"seq_len {S} not divisible by routing group size {g}")
        G = B * (S // g)
        tokens = x.reshape(G, g, d)
        router_logits = self.router(tokens.float())  # (G, g, E), f32
        C = expert_capacity(g, E, self.k, self.capacity_factor)
        routing = top_k_routing(router_logits, k=self.k, capacity=C)
        self.last_fraction_dropped = routing.fraction_dropped.detach()

        cdt = self.dtype
        grp = self.expert
        local = self.wi.shape[0]  # E/n experts on this rank
        lo = grp.index * local
        dispatch = routing.dispatch[:, :, lo:lo + local].to(cdt)
        tp = self.tensor
        tok = cc.sum_grad(tokens.to(cdt), grp.group, grp.size)
        tok = cc.sum_grad(tok, tp.group, tp.size)
        # (G, g, El, C) x (G, g, d) -> (El, G C, d)
        expert_in = torch.einsum("gnec,gnd->egcd", dispatch, tok).reshape(
            local, G * C, d)
        h = gelu(torch.bmm(expert_in, self.wi.to(cdt)))
        expert_out = torch.bmm(h, self.wo.to(cdt))  # (El, G C, d)
        expert_out = cc.sum_forward(expert_out, tp.group, tp.size)
        expert_out = cc.gather_replicated(expert_out, grp.group, grp.size,
                                          grp.index).reshape(E, G, C, d)
        out = torch.einsum("gnec,egcd->gnd", routing.combine.to(cdt),
                           expert_out)
        if self.aux_sink is not None:
            sink, name = self.aux_sink
            sink[name] = self.aux_loss_weight * routing.aux_loss.mean()
        return out.reshape(B, S, d)


def expert_split_leaves(model: nn.Module, n: int
                        ) -> dict[str, tuple[int, ...]]:
    """The stacked expert kernels (``<layer>.wi``, ``<layer>.wo``) that the
    EP rules (``sharding_rules.spec_for``) split ``n`` ways, by name, with
    their whole shapes: those of every MoE layer whose two kernels split."""
    from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
        EXPERT,
        spec_for,
    )

    out: dict[str, tuple[int, ...]] = {}
    if n <= 1:
        return out
    for name, m in model.named_modules():
        if isinstance(m, MoEMLP):
            leaves = {f"{name}.{leaf}": tuple(getattr(m, leaf).shape)
                      for leaf in ("wi", "wo")}
            if all(EXPERT in spec_for(k, shape, expert=n)
                   for k, shape in leaves.items()):
                out.update(leaves)
    return out


def split_expert_layers(model: nn.Module, expert: AxisGroup,
                        leaves) -> None:
    """:meth:`MoEMLP.split_experts` over ``expert`` on each MoE layer of
    ``model`` whose kernels are among ``leaves``
    (:func:`expert_split_leaves`)."""
    for name, m in model.named_modules():
        if isinstance(m, MoEMLP) and f"{name}.wi" in leaves:
            m.split_experts(expert)


@contextlib.contextmanager
def collect_aux_losses(model: nn.Module):
    """``with collect_aux_losses(model) as aux:`` -- each MoE layer run
    inside puts its load-balance term in ``aux`` under its module name
    (the JAX layers' ``sow`` into the ``"losses"`` collection). A
    rematerialised layer rerun in the backward, after the block, adds
    nothing."""
    sink: dict[str, torch.Tensor] = {}
    layers = [(n, m) for n, m in model.named_modules()
              if isinstance(m, MoEMLP)]
    for name, m in layers:
        m.aux_sink = (sink, name)
    try:
        yield sink
    finally:
        for _, m in layers:
            m.aux_sink = None


def add_aux_losses(loss: torch.Tensor, aux: dict) -> torch.Tensor:
    """``loss`` plus every collected term, in the order of the JAX
    collection's leaves (sorted names)."""
    for name in sorted(aux):
        loss = loss + aux[name]
    return loss


# --------------------------------------------------------------------------
# the explicit all-to-all transport of the JAX module (shard_map form)
# --------------------------------------------------------------------------

def ep_dispatch(expert_in: torch.Tensor, group, size: int) -> torch.Tensor:
    """(E, C, d), this rank's tokens' slots for all E experts -> (E/n,
    n C, d), every rank's slots for this rank's E/n experts, by one
    all-to-all over ``group`` of ``size`` ranks."""
    E, C, d = expert_in.shape
    if E % size:
        raise ValueError(f"experts {E} not divisible by axis size {size}")
    out = cc.all_to_all(expert_in, group, size, split_axis=0, concat_axis=0)
    # rows come as n blocks of E/n experts: each local expert's slots
    # from every peer made contiguous
    return out.reshape(size, E // size, C, d).transpose(0, 1).reshape(
        E // size, size * C, d)


def ep_combine(expert_out: torch.Tensor, group, size: int) -> torch.Tensor:
    """The inverse of :func:`ep_dispatch`: (E/n, n C, d) -> (E, C, d)."""
    El, nC, d = expert_out.shape
    C = nC // size
    x = expert_out.reshape(El, size, C, d).transpose(0, 1).reshape(
        size * El, C, d)
    return cc.all_to_all(x, group, size, split_axis=0, concat_axis=0)

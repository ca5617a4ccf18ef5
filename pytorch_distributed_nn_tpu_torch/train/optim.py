"""Optimizer and learning-rate schedule with optax's semantics: the JAX
package's ``train/optim.py`` for ``adamw`` with global-norm clipping.

Three places where a plain torch setup differs from optax, each written
out here:

- the schedule is evaluated at the update count BEFORE the increment
  (update 0 uses ``schedule(0)``), and a warmup joins its decay schedule
  by restarting the decay's count at the boundary (``join_schedules``);
- ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm`` (torch's ``clip_grad_norm_`` divides by
  ``norm + 1e-6`` always);
- decoupled weight decay applies to every parameter, norm scales included
  (``decay_mask_norms`` is not ported, and its default is off).

``torch.optim.AdamW`` then computes optax's ``adamw`` update: bias
corrections with count + 1, eps outside the square root, the decay scaled
by the scheduled lr and taken on the parameters before the update.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from pytorch_distributed_nn_tpu_torch.config import OptimConfig

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    # optax.linear_schedule
    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return fn


def _cosine(init: float, decay_steps: int) -> Schedule:
    # optax.cosine_decay_schedule with alpha = 0, exponent = 1
    def fn(count: int) -> float:
        c = min(max(count, 0), decay_steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    return fn


def make_schedule(cfg: OptimConfig, total_steps: int) -> Schedule:
    """lr as a function of the update count (0 for the first update)."""
    span = max(total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        def base(count: int) -> float:
            return cfg.lr
    elif cfg.schedule == "cosine":
        base = _cosine(cfg.lr, span)
    elif cfg.schedule == "linear":
        base = _linear(cfg.lr, 0.0, span)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps <= 0:
        return base
    warmup = _linear(0.0, cfg.lr, cfg.warmup_steps)
    boundary = cfg.warmup_steps

    def joined(count: int) -> float:
        return warmup(count) if count < boundary else base(count - boundary)

    return joined


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    when the global norm reaches ``max_norm`` every gradient becomes
    ``g / norm * max_norm``; below it nothing changes. Returns the norm."""
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    denom = torch.where(keep, one, norm)
    mult = torch.where(keep, one, torch.full_like(one, max_norm))
    for g in grads:
        g.div_(denom).mul_(mult)
    return norm


class Optimizer:
    """optax's ``chain(clip_by_global_norm, adamw(schedule))`` over
    ``params``: :meth:`step` applies the ``.grad`` of each parameter with
    the lr of update ``count``, then counts one update."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimConfig, total_steps: int) -> None:
        if cfg.name != "adamw":
            raise NotImplementedError(
                f"optimizer {cfg.name!r} is not ported yet (ROADMAP.md: "
                "sgd/momentum/adam come with slice 3); have 'adamw'")
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg, total_steps)
        self.grad_clip_norm = cfg.grad_clip_norm
        self.count = 0
        self.inner = torch.optim.AdamW(
            self.params, lr=0.0, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
            weight_decay=cfg.weight_decay)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a trainable parameter got no gradient")
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter],
                   total_steps: int = 10_000) -> Optimizer:
    return Optimizer(params, cfg, total_steps)

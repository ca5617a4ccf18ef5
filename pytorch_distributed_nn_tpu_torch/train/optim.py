"""Optimizer and learning-rate schedule with optax's semantics: the JAX
package's ``train/optim.py`` for ``sgd``, ``momentum``, ``adam``,
``adamw``, ``lamb``, ``lion`` and ``adafactor``, with global-norm clipping,
``decay_mask_norms`` and ``mu_dtype``, and the ``constant``, ``cosine``,
``linear`` and ``step`` schedules.

Places where a plain torch setup differs from optax, each written out
here:

- the schedule is evaluated at the update count BEFORE the increment
  (update 0 uses ``schedule(0)``), and a warmup joins its decay schedule
  by restarting the decay's count at the boundary (``join_schedules``);
- ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm`` (torch's ``clip_grad_norm_`` divides by
  ``norm + 1e-6`` always);
- weight decay applies to every parameter unless ``decay_mask_norms``
  masks the 1-D ones (norm scales, biases) off;
- ``sgd``, ``momentum`` and ``adam`` take weight decay as optax's
  ``add_decayed_weights`` before the update: L2 added into the gradient
  (torch ``SGD``'s and ``Adam``'s ``weight_decay``); ``momentum`` is optax's
  ``trace`` (no Nesterov), ``t = g + momentum * t``, update ``-lr * t``;
- ``adam``/``adamw``/``lamb`` are optax's ``scale_by_adam``: the moments as
  ``(1 - b) * g + b * m``, bias corrections ``1 - b ** (count + 1)`` in f32,
  eps outside the square root; ``adamw`` adds ``wd * p`` to that update
  (decoupled, scaled by the lr with it), ``lamb`` adds it and then scales
  each tensor's update by the trust ratio ``|p| / |u|`` (1 where either is
  0);
- ``lion``: ``sign((1 - b1) g + b1 m)`` plus ``wd * p``, then
  ``m = (1 - b2) g + b2 m``;
- ``adafactor``: optax's factored second moments (``min_dim_size_to_factor``
  128 on the two largest dims, ``decay_rate`` 0.8 as ``1 - (count + 1) **
  -0.8``, eps 1e-30), block-RMS clipping at 1, the lr, the parameter's RMS
  (at least 1e-3), then ``wd * p`` (not scaled by the lr);
- ``mu_dtype`` keeps the first moment (momentum's trace) in that dtype
  between steps: as in optax, ``b * m`` is taken in that dtype (``b``
  rounded to it), the rest of the step in f32, and the new moment is
  stored cast.

On sharded parameters (``ShardLayout``: ZeRO's fsdp shards, the expert
axis's slices of the stacked experts, the tensor axis's Megatron slices,
the pipeline's stages) the
elementwise optimizers run on each rank's slice as they are. The three
reductions that span a whole parameter or the whole model take their
partial sums across ranks: the global norm of the clip (over the shard
group and the expert group, each replicated leaf counted once, then over
the other stages), lamb's ``|p|`` and ``|u|`` and adafactor's factored
means and block RMS (over the groups whose split dim they reduce). Without a layout, or where nothing
is split, the update is the one-device update, bit for bit.

Each is written out with ``torch._foreach`` ops (per tensor where a norm
or a factored moment is per tensor), in optax's order of operations, in
place on the moments and on the step's own temporaries: an adam step holds
three parameter-sized temporaries at most (the update, its denominator and
the decay).

The update is safe to capture in a CUDA graph (``train/multistep.py``): the
moments are allocated at construction and only ever written in place, and
what changes from one update to the next (the learning rate, adam's bias
corrections, adafactor's decay rate) is read from a device tensor, never
frozen into the launches as a Python float. The host computes those values
as floats from the update count, as optax does in f32, and writes them
once into a table on the device (:meth:`Optimizer.hyper`); an eager update
reads its row of the table, a captured one the row the caller copies into
place before each replay (:meth:`Optimizer.reading`), so both read the
same f32 values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Iterable

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.config import OptimConfig
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc

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


def _step(init: float, span: int, milestones, gamma: float) -> Schedule:
    # torch StepLR as the JAX package builds it: optax's
    # piecewise_constant_schedule with a gamma at each milestone fraction
    # of the post-warmup span (milestones at one step compound)
    scales: dict[int, float] = {}
    for frac in milestones:
        b = max(int(span * frac), 1)
        scales[b] = scales.get(b, 1.0) * gamma

    def fn(count: int) -> float:
        v = init
        for boundary, scale in sorted(scales.items()):
            if count >= boundary:
                v *= scale
        return v

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
    elif cfg.schedule == "step":
        base = _step(cfg.lr, span, cfg.step_milestones, cfg.step_gamma)
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
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    when the global norm reaches ``max_norm`` every gradient becomes
    ``g / norm * max_norm``; below it nothing changes. ``norm`` is the
    global norm where the caller has taken it across ranks (else it is
    taken over ``grads``). Returns the norm."""
    if norm is None:
        norm = torch.stack([g.float().square().sum()
                            for g in grads]).sum().sqrt()
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    denom = torch.where(keep, one, norm)
    mult = torch.where(keep, one, torch.full_like(one, max_norm))
    for g in grads:
        g.div_(denom).mul_(mult)
    return norm


@dataclasses.dataclass
class ShardLayout:
    """Where the optimizer's tensors lie across ranks. ``dims[i]`` is the
    dim of parameter i split over the ``size`` ranks of ``group`` (None:
    this rank holds it whole, as every rank of the group does), and
    ``shapes[i]`` its whole shape. ``norm_group`` (of ``norm_size``) holds
    the ranks with the OTHER parameters of the model (the pipeline's other
    stages): the global norm sums over it too. ``experts[i]``: parameter i
    is this rank's slice along dim 0 of the stacked experts, the others'
    on the ``expert_size`` ranks of ``expert_group`` (before any fsdp
    split, which takes another dim)."""

    dims: list[int | None]
    shapes: list[tuple[int, ...]]
    group: Any = None
    size: int = 1
    norm_group: Any = None
    norm_size: int = 1
    experts: list[bool] | None = None
    expert_group: Any = None
    expert_size: int = 1
    tensor_dims: list[int | None] | None = None
    tensor_group: Any = None
    tensor_size: int = 1

    def tensor_dim(self, i: int) -> int | None:
        if self.tensor_size > 1 and self.tensor_dims:
            return self.tensor_dims[i]
        return None

    def tensor_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the tensor group, in place."""
        return cc.all_reduce_sum(t, self.tensor_group)

    def split(self, i: int) -> bool:
        return self.size > 1 and self.dims[i] is not None

    def expert_split(self, i: int) -> bool:
        return self.expert_size > 1 and bool(self.experts and self.experts[i])

    def expert_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the expert group, in place."""
        return cc.all_reduce_sum(t, self.expert_group)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the shard group, in place."""
        return cc.all_reduce_sum(t, self.group)


_NAMES = ("sgd", "momentum", "adam", "adamw", "lamb", "lion", "adafactor")
_MU_DTYPES = ("momentum", "adam", "adamw", "lion")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _f32_bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count``, computed in float32."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _factored_zeros(p: torch.Tensor, shape=None) -> tuple:
    """adafactor's zero moments of ``p``: ``(None, v)`` whole, or
    ``((d1, d0), (v_row, v_col))`` factored over the two largest dims of
    ``shape`` (the whole parameter's, where ``p`` is a slice of it)."""
    dims = _factored_dims(p.shape if shape is None else shape)
    if dims is None:
        return None, torch.zeros_like(p)
    d1, d0 = dims
    return dims, (p.new_zeros(np.delete(p.shape, d0).tolist()),
                  p.new_zeros(np.delete(p.shape, d1).tolist()))


def _factored_dims(shape) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: the second-largest and largest dims when
    both are at least 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


# the per-update values of the table: the lr and its negation, adam's
# bias corrections 1 - b1 ** n and 1 - b2 ** n, adafactor's decay rate
# 1 - n ** -0.8 and 1 - rate, for update n = count + 1
_LR, _NEG_LR, _BC1, _BC2, _RATE, _KEEP = range(6)


class Optimizer:
    """optax's ``chain(clip_by_global_norm?, add_decayed_weights?,
    <optimizer> (schedule))`` over ``params``: :meth:`step` applies the
    ``.grad`` of each parameter with the lr of update ``count``, then
    counts one update. The moments (``mu``, ``nu``, ``factored``) exist
    from construction, zeros, as optax's ``init`` makes them."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimConfig, total_steps: int,
                 layout: ShardLayout | None = None) -> None:
        if cfg.name not in _NAMES:
            raise ValueError(f"unknown optimizer {cfg.name!r}; have {_NAMES}")
        if cfg.mu_dtype and cfg.name not in _MU_DTYPES:
            raise ValueError(
                f"mu_dtype is not supported for optimizer {cfg.name!r} "
                "(momentum/adam/adamw/lion only)")
        if cfg.mu_dtype and cfg.mu_dtype not in _DTYPES:
            raise ValueError(f"unknown mu_dtype {cfg.mu_dtype!r}")
        self.cfg = cfg
        self.name = cfg.name
        self.params = [p for p in params if p.requires_grad]
        if layout is not None and len(layout.dims) != len(self.params):
            raise ValueError("the layout does not describe the parameters")
        self.layout = layout
        self.schedule = make_schedule(cfg, total_steps)
        self.total_steps = total_steps
        self.grad_clip_norm = cfg.grad_clip_norm
        self.weight_decay = cfg.weight_decay
        self.momentum = cfg.momentum
        self.mu_dtype = _DTYPES.get(cfg.mu_dtype)
        # the parameters weight decay applies to (optax's mask)
        self.decayed = [p for p in self.params
                        if p.dim() > 1 or not cfg.decay_mask_norms]
        self.mu: list[torch.Tensor] | None = None  # first moment / trace
        self.nu: list[torch.Tensor] | None = None  # adam's second moment
        self.factored: list[tuple] | None = None  # adafactor's moments
        if cfg.name in ("momentum", "adam", "adamw", "lamb", "lion"):
            self.mu = self._zeros(self.mu_dtype)
        if cfg.name in ("adam", "adamw", "lamb"):
            self.nu = self._zeros()
        if cfg.name == "adafactor":
            shapes = (layout.shapes if layout is not None
                      else [p.shape for p in self.params])
            self.factored = [_factored_zeros(p, shape)
                             for p, shape in zip(self.params, shapes)]
        self.count = 0
        self._table: torch.Tensor | None = None  # per-update values
        self._row: torch.Tensor | None = None  # set by reading()
        self._holds: list = []  # events the next update waits for

    def _hyper_row(self, count: int) -> list[float]:
        lr = self.schedule(count)
        n = count + 1
        rate = float(np.float32(1.0) - np.float32(n) ** np.float32(-0.8))
        return [lr, -lr, _f32_bias_correction(self.cfg.b1, n),
                _f32_bias_correction(self.cfg.b2, n), rate, 1.0 - rate]

    def hyper(self, start: int, k: int = 1) -> torch.Tensor:
        """The (k, 6) float32 rows of updates ``start`` ... ``start + k - 1``
        on the parameters' device: a view of the table, which is built (or
        grown) here, with one copy to the device."""
        end = start + k
        if self._table is None or end > self._table.shape[0]:
            have = 0 if self._table is None else self._table.shape[0]
            n = max(end, 2 * have, self.total_steps + 1)
            rows = [self._hyper_row(c) for c in range(n)]
            dev = self.params[0].device if self.params else "cpu"
            self._table = torch.tensor(rows, dtype=torch.float32).to(dev)
        return self._table[start:end]

    @contextlib.contextmanager
    def reading(self, row: torch.Tensor):
        """Updates inside read their per-update values from ``row`` (a (6,)
        float32 device tensor that the caller fills before each replay of a
        captured graph) instead of the table's row of ``count``."""
        prev, self._row = self._row, row
        try:
            yield
        finally:
            self._row = prev

    def hold(self, event) -> None:
        """The next update (or :meth:`release`) makes the current stream
        wait for ``event``: a checkpoint's copy of the state that reads the
        parameters and moments this update writes in place."""
        self._holds.append(event)

    def release(self) -> None:
        for event in self._holds:
            torch.cuda.current_stream(event.device).wait_event(event)
        self._holds = []

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a trainable parameter got no gradient")
        self.release()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(grads, self.grad_clip_norm,
                                 self._global_norm(grads))
        row = self._row if self._row is not None else self.hyper(
            self.count)[0]
        with torch.no_grad():
            getattr(self, f"_{self.name}")(grads, row)
        self.count += 1

    @torch.no_grad()
    def _global_norm(self, grads) -> torch.Tensor | None:
        """The norm over every rank's gradients (None without a layout
        that splits anything: :func:`clip_by_global_norm_` takes it
        locally). Each replicated leaf counts once."""
        lay = self.layout
        if lay is None or (lay.size == 1 and lay.norm_size == 1
                           and lay.expert_size == 1
                           and lay.tensor_size == 1):
            return None
        sq = [g.float().square().sum() for g in grads]
        zero = torch.zeros((), device=grads[0].device)
        if lay.tensor_size > 1:
            return self._split_norm(sq, zero)
        ex = [lay.expert_split(i) for i in range(len(sq))]
        whole = [s for i, s in enumerate(sq)
                 if not lay.split(i) and not ex[i]]
        total = torch.stack(whole).sum() if whole else zero
        parts = [s for i, s in enumerate(sq) if lay.split(i) and not ex[i]]
        if parts:
            total = total + lay.sum_(torch.stack(parts).sum().reshape(1))[0]
        if any(ex):  # the expert slices: over fsdp where split, then expert
            experts = torch.stack([s for i, s in enumerate(sq)
                                   if ex[i] and not lay.split(i)]
                                  or [zero]).sum()
            both = [s for i, s in enumerate(sq) if ex[i] and lay.split(i)]
            if both:
                experts = experts + lay.sum_(
                    torch.stack(both).sum().reshape(1))[0]
            total = total + lay.expert_sum_(experts.reshape(1))[0]
        if lay.norm_size > 1:
            total = cc.all_reduce_sum(total.reshape(1), lay.norm_group)[0]
        return total.sqrt()

    def _split_norm(self, sq: list[torch.Tensor],
                    zero: torch.Tensor) -> torch.Tensor:
        """The global norm from each parameter's squares ``sq`` on a layout
        with a tensor split: the parameters grouped by the axes they are
        split over, each group's sum taken over those axes (fsdp, expert,
        tensor, in that order), then over the other stages. Every rank of
        a group holds the same parameters, so it issues the same sums."""
        lay = self.layout
        keys = [(lay.split(i), lay.expert_split(i),
                 lay.tensor_dim(i) is not None) for i in range(len(sq))]
        total = zero
        for key in sorted(set(keys)):
            part = torch.stack([s for s, k in zip(sq, keys)
                                if k == key]).sum().reshape(1)
            for on, reduce in zip(key, (lay.sum_, lay.expert_sum_,
                                        lay.tensor_sum_)):
                if on:
                    part = reduce(part)
            total = total + part[0]
        if lay.norm_size > 1:
            total = cc.all_reduce_sum(total.reshape(1), lay.norm_group)[0]
        return total.sqrt()

    def _norms(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The L2 norm of each whole parameter from its slices."""
        lay = self.layout
        out = [None if lay is not None and (lay.split(i) or
                                            lay.expert_split(i) or
                                            lay.tensor_dim(i) is not None)
               else torch.linalg.vector_norm(t)
               for i, t in enumerate(tensors)]
        sliced = [i for i, n in enumerate(out) if n is None]
        if not sliced:
            return out
        sq = dict(zip(sliced, [tensors[i].float().square().sum()
                               for i in sliced]))
        split = [i for i in sliced if lay.split(i)]
        if split:
            sq.update(zip(split, lay.sum_(torch.stack(
                [sq[i] for i in split]))))
        ex = [i for i in sliced if lay.expert_split(i)]
        if ex:
            sq.update(zip(ex, lay.expert_sum_(torch.stack(
                [sq[i] for i in ex]))))
        tp = [i for i in sliced if lay.tensor_dim(i) is not None]
        if tp:
            sq.update(zip(tp, lay.tensor_sum_(torch.stack(
                [sq[i] for i in tp]))))
        for i in sliced:
            out[i] = sq[i].sqrt().to(tensors[i].dtype)
        return out

    def _split_dim(self, i: int) -> int | None:
        """The dim of parameter i split across ranks (None: whole here)."""
        lay = self.layout
        return lay.dims[i] if lay is not None and lay.split(i) else None

    def _tensor_dim(self, i: int) -> int | None:
        """The dim of parameter i split over tensor (None: whole there)."""
        return None if self.layout is None else self.layout.tensor_dim(i)

    def _mean(self, t: torch.Tensor, dim: int | None = None,
              keepdim: bool = False, split: int | None = None,
              expert: bool = False,
              tsplit: int | None = None) -> torch.Tensor:
        """``t.mean(dim)`` (all dims when None), where ``t`` is this rank's
        slice along ``split`` (None: ``t`` is whole here), with ``expert``
        along dim 0 over the expert group, and along ``tsplit`` over the
        tensor group: the mean over the whole tensor where the reduction
        crosses a split."""
        fsdp = split is not None and dim in (None, split)
        ex = expert and dim in (None, 0)
        tp = tsplit is not None and dim in (None, tsplit)
        if not (fsdp or ex or tp):
            return t.mean() if dim is None else t.mean(dim, keepdim=keepdim)
        lay = self.layout
        n = ((lay.size if fsdp else 1) * (lay.expert_size if ex else 1)
             * (lay.tensor_size if tp else 1))
        if dim is None:
            s, count = t.sum().reshape(1), t.numel() * n
        else:
            s = t.sum(dim, keepdim=keepdim).contiguous()
            count = t.shape[dim] * n
        if fsdp:
            s = lay.sum_(s)
        if ex:
            s = lay.expert_sum_(s)
        if tp:
            s = lay.tensor_sum_(s)
        return (s[0] if dim is None else s) / count

    def _zeros(self, dtype=None) -> list[torch.Tensor]:
        return [torch.zeros_like(p, dtype=dtype or p.dtype)
                for p in self.params]

    def _decay(self, updates: list[torch.Tensor], *,
               own: bool = False) -> list[torch.Tensor]:
        """add_decayed_weights: ``u + wd * p`` on the decayed parameters,
        in place when ``updates`` are the step's own temporaries (``own``),
        else in a new list (the tensors of the others passed through)."""
        keep = {id(p) for p in self.decayed}
        at = [i for i, p in enumerate(self.params) if id(p) in keep]
        if self.weight_decay <= 0 or not at:
            return updates
        decay = torch._foreach_mul([self.params[i] for i in at],
                                   self.weight_decay)
        picked = [updates[i] for i in at]
        if own:
            torch._foreach_add_(picked, decay)
            return updates
        out = list(updates)
        for i, u in zip(at, torch._foreach_add(picked, decay)):
            out[i] = u
        return out

    def _apply(self, updates: list[torch.Tensor],
               scale: torch.Tensor | float, *, own: bool = False) -> None:
        """``p += scale * u`` (``scale`` a 0-d device tensor, or a constant);
        ``own`` as in :meth:`_decay`."""
        if own:
            torch._foreach_mul_(updates, scale)
        else:
            updates = torch._foreach_mul(updates, scale)
        torch._foreach_add_(self.params, updates)

    def _sgd(self, grads, row: torch.Tensor) -> None:
        self._apply(self._decay(grads), row[_NEG_LR])

    def _momentum(self, grads, row: torch.Tensor) -> None:
        grads = self._decay(grads)
        m = self._mu_scalar(self.momentum)
        if self.mu_dtype is None:
            torch._foreach_mul_(self.mu, m)
            torch._foreach_add_(self.mu, grads)
            trace = self.mu
        else:  # the update is the f32 trace, the stored moment its cast
            trace = torch._foreach_add(grads, torch._foreach_mul(self.mu, m))
            self._store_mu(trace)
        self._apply(trace, row[_NEG_LR])

    def _mu_scalar(self, x: float) -> float:
        """A decay that multiplies the stored first moment: JAX takes a
        Python float times a bf16 array in bf16, the float rounded to it
        (0.9 -> 0.8984375)."""
        if self.mu_dtype is None:
            return x
        return float(torch.tensor(x, dtype=self.mu_dtype))

    def _store_mu(self, mu: list[torch.Tensor]) -> None:
        """The new first moment into the stored one, in place (cast to
        ``mu_dtype``)."""
        if mu is not self.mu:
            torch._foreach_copy_(self.mu, mu)

    def _adam_direction(self, grads, row: torch.Tensor
                        ) -> list[torch.Tensor]:
        """scale_by_adam: mu_hat / (sqrt(nu_hat) + eps)."""
        b1, b2, eps = self.cfg.b1, self.cfg.b2, self.cfg.eps
        step = torch._foreach_mul(grads, 1.0 - b1)
        if self.mu_dtype is None:
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, step)
            mu = self.mu
        else:
            mu = torch._foreach_add(step, torch._foreach_mul(
                self.mu, self._mu_scalar(b1)))
        step = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(step, 1.0 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, step)
        del step
        direction = torch._foreach_div(mu, row[_BC1])
        denom = torch._foreach_div(self.nu, row[_BC2])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(direction, denom)
        self._store_mu(mu)
        return direction

    def _adam(self, grads, row: torch.Tensor) -> None:
        self._apply(self._adam_direction(self._decay(grads), row),
                    row[_NEG_LR], own=True)

    def _adamw(self, grads, row: torch.Tensor) -> None:
        self._apply(self._decay(self._adam_direction(grads, row), own=True),
                    row[_NEG_LR], own=True)

    def _lamb(self, grads, row: torch.Tensor) -> None:
        updates = self._decay(self._adam_direction(grads, row), own=True)
        for u, pn, un in zip(updates, self._norms(self.params),
                             self._norms(updates)):
            u.mul_(torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                               pn / un))
        self._apply(updates, row[_NEG_LR], own=True)

    def _lion(self, grads, row: torch.Tensor) -> None:
        b1, b2 = self.cfg.b1, self.cfg.b2
        b1m, b2m = self._mu_scalar(b1), self._mu_scalar(b2)
        direction = [torch.sign((1.0 - b1) * g + b1m * m)
                     for g, m in zip(grads, self.mu)]
        self._store_mu([(1.0 - b2) * g + b2m * m
                        for g, m in zip(grads, self.mu)])
        self._apply(self._decay(direction, own=True), row[_NEG_LR], own=True)

    def _adafactor(self, grads, row: torch.Tensor) -> None:
        eps = 1e-30
        rate, keep = row[_RATE], row[_KEEP]
        updates = []
        for i, (g, p) in enumerate(zip(grads, self.params)):
            dims, state = self.factored[i]
            g2 = g * g + eps
            ex = self.layout is not None and self.layout.expert_split(i)
            if dims is None:
                v = state.copy_(rate * state + keep * g2)
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                sd, td = self._split_dim(i), self._tensor_dim(i)
                v_row = state[0].copy_(rate * state[0] + keep * self._mean(
                    g2, d0, split=sd, expert=ex, tsplit=td))
                v_col = state[1].copy_(rate * state[1] + keep * self._mean(
                    g2, d1, split=sd, expert=ex, tsplit=td))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                # where v_row (the dims but d0) is split, if anywhere
                row_sd = None if sd in (None, d0) else sd - (sd > d0)
                row_td = None if td in (None, d0) else td - (td > d0)
                row_col_mean = self._mean(v_row, reduced_d1, keepdim=True,
                                          split=row_sd,
                                          expert=ex and d0 != 0,
                                          tsplit=row_td)
                row_factor = (v_row / row_col_mean) ** -0.5
                col_factor = v_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            # clip_by_block_rms(1.0), the lr, scale_by_param_block_rms
            sd, td = self._split_dim(i), self._tensor_dim(i)
            u = u / torch.clamp(self._mean(u.square(), split=sd, expert=ex,
                                           tsplit=td).sqrt(), min=1.0)
            u = u * row[_LR]
            rms = self._mean(p.square(), split=sd, expert=ex,
                             tsplit=td).sqrt()
            updates.append(u * torch.clamp(rms, min=1e-3))
        self._apply(self._decay(updates, own=True), -1.0, own=True)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter],
                   total_steps: int = 10_000,
                   layout: ShardLayout | None = None) -> Optimizer:
    return Optimizer(params, cfg, total_steps, layout=layout)

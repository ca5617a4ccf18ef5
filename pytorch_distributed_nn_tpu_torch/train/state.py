"""TrainState: what a step touches, in one object (the JAX package's
``train/state.py``). PyTorch updates in place, so where the JAX state is an
immutable pytree replaced every step, this one is mutated by
:meth:`TrainState.apply_gradients`. The model state (the BatchNorm running
statistics, flax's ``batch_stats``) lives in the model's buffers, beside
the parameters: :attr:`TrainState.model_state`.

:meth:`TrainState.state_dict` names every tensor a checkpoint must carry
(the JAX ``_array_tree``: step, params, model state, optimizer state, rng),
and :meth:`TrainState.load_state_dict` copies such a dict back in place, so
every tensor keeps its storage (the optimizer and a captured CUDA graph
hold them).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pytorch_distributed_nn_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer  # holds the lr schedule and its update count
    # base generator for per-step stochastic ops (seed + 1, apart from the
    # init's), on the CPU; only its seed is read (dropout_stream's)
    generator: torch.Generator
    step: int = 0
    # the sharded strategies' layout of this rank's part (ZeRO's
    # ``ZeroShards``, the pipeline's ``PipelineStages``; None replicated):
    # its ``owned_params()`` replace the module's tensors in state_dict,
    # and a checkpoint records its ``meta()`` and writes its ``part``
    sharding: Any = None

    @property
    def model_state(self) -> dict[str, torch.Tensor]:
        """The model's floating-point buffers by name (the BatchNorm
        ``mean`` and ``var``; empty for a model without BatchNorm)."""
        return {n: b for n, b in self.model.named_buffers()
                if b.is_floating_point()}

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``, which it
        then clears."""
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Every tensor of the state by name, live (not copies):
        ``model.<name>`` for the parameters and buffers under their flax
        names (``utils/interop.py``'s; a ZeRO-3 rank's slice where it holds
        one), ``opt.<moment>.<param name>`` for
        the optimizer's moments, ``opt.count``, ``generator`` (its
        ``get_state()``) and ``step``."""
        out = {f"model.{k}": v for k, v in self.model.state_dict().items()}
        if self.sharding is not None:
            out.update({f"model.{k}": v for k, v in
                        self.sharding.owned_params().items()})
        for k, v in _optimizer_tensors(self).items():
            out[f"opt.{k}"] = v
        out["opt.count"] = torch.tensor(self.optimizer.count)
        out["generator"] = self.generator.get_state()
        out["step"] = torch.tensor(self.step)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Copy ``state`` (a :meth:`state_dict`, on any device) into this
        state in place. The names must match exactly."""
        want = self.state_dict()
        if set(state) != set(want):
            missing = sorted(set(want) - set(state))
            extra = sorted(set(state) - set(want))
            raise KeyError(f"state names differ: missing {missing[:5]}, "
                           f"unexpected {extra[:5]}")
        for name, t in want.items():
            if name in ("opt.count", "generator", "step"):
                continue
            src = state[name]
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(
                    f"{name}: {tuple(src.shape)} {src.dtype} does not fit "
                    f"{tuple(t.shape)} {t.dtype}")
            t.copy_(src)
        self.optimizer.count = int(state["opt.count"])
        self.generator.set_state(state["generator"].cpu())
        self.step = int(state["step"])


def _optimizer_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """The optimizer's moments by ``<moment>.<param name>``: ``mu``,
    ``nu``, and adafactor's ``v`` or ``v_row``/``v_col``."""
    opt = state.optimizer
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    if len(names) != len(opt.params):
        raise ValueError("the optimizer's parameters are not the model's "
                         "trainable ones")
    out = {}
    for moment in ("mu", "nu"):
        values = getattr(opt, moment)
        if values is not None:
            out.update({f"{moment}.{n}": v for n, v in zip(names, values)})
    for n, (dims, v) in zip(names, opt.factored or ()):
        if dims is None:
            out[f"v.{n}"] = v
        else:
            out[f"v_row.{n}"], out[f"v_col.{n}"] = v
    return out


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

"""TrainState: what a step touches, in one object (the JAX package's
``train/state.py``). PyTorch updates in place, so where the JAX state is an
immutable pytree replaced every step, this one is mutated by
:meth:`TrainState.apply_gradients`.
"""

from __future__ import annotations

import dataclasses

import torch

from pytorch_distributed_nn_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer  # holds the lr schedule and its update count
    # base generator for per-step stochastic ops (seed + 1, apart from the
    # init's); the Llama path draws nothing from it yet
    generator: torch.Generator
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``, which it
        then clears."""
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

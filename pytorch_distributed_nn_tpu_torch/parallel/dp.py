"""Data parallelism at world size 1: the model call and the loss/gradient
computation of the JAX package's ``parallel/dp.py``, shared by every
step. Data parallelism across devices is ROADMAP slice 3.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_distributed_nn_tpu_torch.train.state import TrainState


def forward(state: TrainState, x: torch.Tensor, *,
            apply_kwargs: dict | None = None) -> torch.Tensor:
    """The model on ``x``; ``apply_kwargs`` are passed on (for example
    ``return_hidden=True`` for the chunked loss, which then gets the trunk
    hidden instead of logits)."""
    return state.model(x, **(apply_kwargs or {}))


def _loss_and_grads(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                    loss_fn: Callable) -> torch.Tensor:
    """``loss_fn(out, y)``, backpropagated into the parameters' ``.grad``;
    returns the detached loss. A loss_fn marked by
    ``api.make_chunked_loss`` gets the model output it asks for
    (``loss_fn.apply_kwargs``) and the live parameters by name
    (``loss_fn.needs_params``)."""
    apply_kwargs = getattr(loss_fn, "apply_kwargs", None)
    out = forward(state, x, apply_kwargs=apply_kwargs)
    if getattr(loss_fn, "needs_params", False):
        loss = loss_fn(out, y, dict(state.model.named_parameters()))
    else:
        loss = loss_fn(out, y)
    loss.backward()
    return loss.detach()

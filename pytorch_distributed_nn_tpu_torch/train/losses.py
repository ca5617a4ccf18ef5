"""Losses: the JAX package's ``train/losses.py`` for classification (the
vision datasets) and the causal LM (``lm_synthetic``). f32 logits, mean
over the batch; the chunked LM forms never build the (B, T, V) logits.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

log = logging.getLogger(__name__)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Classification: logits (B, C), labels (B,) int; f32 mean."""
    return F.cross_entropy(logits.float(), labels.long())


def lm_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Causal LM: logits (B, T, V), targets (B, T) int; f32 mean."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V),
                           targets.reshape(-1).long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def _chunk_xent_sum(h: torch.Tensor, kernel: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    # the head in f32: the bf16 hidden and the raw f32 kernel promote, as
    # the JAX einsum with preferred_element_type=f32 does
    logits = h.float() @ kernel.float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           t.reshape(-1).long(), reduction="sum")


def _chunks(hidden, targets, chunk: int):
    """Per-chunk (B, chunk, D) / (B, chunk) views along T, or None when
    T is indivisible (logged: the dense fallback builds the (B, T, V)
    logits the chunked path exists to avoid)."""
    T = targets.shape[1]
    if T % chunk:
        log.warning("chunked LM loss: T=%d %% chunk=%d != 0 -- dense "
                    "fallback, (B, T, V) logits WILL materialize", T, chunk)
        return None
    return zip(hidden.split(chunk, dim=1), targets.split(chunk, dim=1))


def chunked_lm_xent(hidden: torch.Tensor, kernel: torch.Tensor,
                    targets: torch.Tensor, *,
                    chunk: int = 2048) -> torch.Tensor:
    """``lm_xent(hidden @ kernel, targets)`` without the (B, T, V) logits:
    the head projection and cross-entropy run per T-chunk, each chunk
    checkpointed, so forward and backward keep one (B, chunk, V) f32
    logits block live. The chunk sums add up in order, in f32, as the JAX
    scan does. hidden: (B, T, D); kernel: (D, V); targets: (B, T) int."""
    chunks = _chunks(hidden, targets, chunk)
    if chunks is None:
        return lm_xent(hidden.float() @ kernel.float(), targets)
    B, T = targets.shape
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, t in chunks:
        total = total + checkpoint(_chunk_xent_sum, h, kernel, t,
                                   use_reentrant=False)
    return total / (B * T)


@torch.no_grad()
def chunked_lm_eval(hidden: torch.Tensor, kernel: torch.Tensor,
                    targets: torch.Tensor, *, chunk: int = 2048
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval twin of :func:`chunked_lm_xent`: (mean loss, accuracy), per
    T-chunk, never building the full logits."""
    chunks = _chunks(hidden, targets, chunk)
    if chunks is None:
        logits = hidden.float() @ kernel.float()
        return lm_xent(logits, targets), accuracy(logits, targets)
    B, T = targets.shape
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    hits = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for h, t in chunks:
        logits = h.float() @ kernel.float()
        loss = loss + F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                      t.reshape(-1).long(), reduction="sum")
        hits = hits + (logits.argmax(-1) == t).sum()
    return loss / (B * T), hits.float() / (B * T)


_CLASSIFICATION = ("mnist", "cifar10", "imagenet_synthetic")


def get_loss_fn(dataset_name: str):
    if dataset_name == "lm_synthetic":
        return lm_xent
    if dataset_name in _CLASSIFICATION:
        return softmax_xent
    raise NotImplementedError(
        f"loss for dataset {dataset_name!r} is not ported yet (ROADMAP.md: "
        "the masked-LM loss comes with BERT, label smoothing with the "
        "trainer features)")

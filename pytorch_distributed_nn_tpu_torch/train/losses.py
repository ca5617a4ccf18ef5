"""Losses: the JAX package's ``train/losses.py`` for classification (the
vision datasets, synthetic or read from files), the causal LM
(``lm_synthetic``, ``token_file``) and BERT's masked LM
(``mlm_synthetic``). f32 logits, mean over the batch (over the valid
positions for the masked LM); the chunked LM forms never build the
(B, T, V) logits. ``get_loss_fn(label_smoothing=)`` smooths the dense
forms as torch's ``CrossEntropyLoss(label_smoothing=)`` does.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

log = logging.getLogger(__name__)


def valid_mask(labels: torch.Tensor) -> torch.Tensor:
    """The ignore-index convention in one place: targets >= 0 are valid;
    negative targets (-1) count neither in the loss nor in its
    denominator, nor in the accuracy."""
    return labels >= 0


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Classification: logits (B, C), labels (B,) int; f32 mean."""
    return F.cross_entropy(logits.float(), labels.long())


def lm_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Causal LM: logits (B, T, V), targets (B, T) int; f32 mean."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V),
                           targets.reshape(-1).long())


def masked_lm_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                   denom: torch.Tensor | None = None) -> torch.Tensor:
    """BERT MLM: logits (B, T, V), labels (B, T) with -1 = ignore; f32 mean
    over the valid positions (0 when there are none). The denominator is
    the LOCAL valid count, clamped at 1: under ``dp_explicit`` each rank
    divides by its own rows' count before the mean across ranks, torch
    DDP's per-rank behaviour for ignore-index losses, as in the JAX
    package. The ``dp`` step passes ``denom`` (``token_weighted``) to get
    the global token mean the JAX ``dp`` step computes."""
    V = logits.shape[-1]
    valid = valid_mask(labels).reshape(-1)
    per_tok = F.cross_entropy(logits.float().reshape(-1, V),
                              labels.clamp(min=0).reshape(-1).long(),
                              reduction="none")
    per_tok = torch.where(valid, per_tok, torch.zeros_like(per_tok))
    if denom is None:
        denom = valid.sum().clamp(min=1)
    return per_tok.sum() / denom


masked_lm_xent.token_weighted = True


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked accuracy: hits among the valid labels over their count
    (clamped at 1); labels < 0 count neither as hits nor in the
    denominator (the JAX trainer's eval)."""
    valid = valid_mask(labels)
    hits = (logits.argmax(-1) == labels) & valid
    return hits.sum() / valid.sum().clamp(min=1)


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


_CLASSIFICATION = ("mnist", "cifar10", "imagenet_synthetic", "array_file",
                   "mnist_idx", "cifar10_bin", "image_folder")


def _smoothed(base, eps: float):
    """torch ``CrossEntropyLoss(label_smoothing=eps)`` semantics: per
    element ``(1 - eps) * nll + eps * (the uniform cross-entropy over the
    classes)``, f32; the masked LM keeps its ignore mask and denominator
    (``denom``, as :func:`masked_lm_xent`)."""
    masked = base is masked_lm_xent

    def loss_fn(logits: torch.Tensor, labels: torch.Tensor, *,
                denom: torch.Tensor | None = None) -> torch.Tensor:
        logp = F.log_softmax(logits.float(), dim=-1)
        uniform = -logp.mean(-1)
        nll = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
        per = (1.0 - eps) * nll + eps * uniform
        if not masked:
            return per.mean()
        valid = valid_mask(labels)
        per = torch.where(valid, per, torch.zeros_like(per))
        if denom is None:
            denom = valid.sum().clamp(min=1)
        return per.sum() / denom

    if masked:
        loss_fn.token_weighted = True
    return loss_fn


def get_loss_fn(dataset_name: str, *, label_smoothing: float = 0.0):
    """The dataset's loss; with ``label_smoothing`` in (0, 1) its smoothed
    form (:func:`_smoothed`)."""
    if dataset_name in ("lm_synthetic", "token_file"):
        base = lm_xent
    elif dataset_name == "mlm_synthetic":
        base = masked_lm_xent
    elif dataset_name in _CLASSIFICATION:
        base = softmax_xent
    else:
        raise KeyError(f"unknown dataset {dataset_name!r}")
    if label_smoothing == 0.0:
        return base
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1), got {label_smoothing}")
    return _smoothed(base, label_smoothing)

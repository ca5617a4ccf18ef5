"""Analytic FLOP counts (the JAX package's ``utils/flops.py`` closed
form), for MFU reports on the card."""

from __future__ import annotations


def lm_train_flops_per_token(n_params: int, n_layers: int, seq_len: int,
                             d_model: int, *, causal: bool = False) -> float:
    """6N + 12*L*T*d (PaLM appendix B): training FLOPs per token of a dense
    transformer LM with N matmul-participating parameters. The second term
    is attention's two (T, T) products, forward and backward; a causal mask
    halves the work a kernel that skips masked tiles needs, so ``causal``
    counts 6*L*T*d. Recompute (remat) is not counted: this is the model's
    work, the numerator of MFU."""
    attn = 12.0 * n_layers * seq_len * d_model
    return 6.0 * n_params + (attn / 2 if causal else attn)

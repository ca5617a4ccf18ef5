"""Synthetic datasets, deterministic by (seed, step): the port's own copy
of the JAX package's ``data/datasets.py`` for ``lm_synthetic``.

``batch(step)`` depends only on (seed, step, global batch size) and is
byte-equal to the JAX package's batch for the same arguments (numpy makes
both), so the two packages train on the same tokens.
"""

from __future__ import annotations

import numpy as np

# Evaluation batches are requested at step >= this offset (the trainer's
# held-out stream): an infinite synthetic stream never reaches it in
# training.
EVAL_STEP_OFFSET = 1 << 30


class SyntheticDataset:
    """Base: infinite stream of batches, indexed by step."""

    def __init__(self, seed: int, batch_size: int) -> None:
        self.seed = seed
        self.batch_size = batch_size

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class SyntheticLM(SyntheticDataset):
    """Learnable token stream: tokens follow a noised affine recurrence
    t_{i+1} = (a·t_i + c) mod V, with a fraction of uniform-random tokens.
    Targets are inputs shifted by one (causal LM). int32 (B, T) arrays."""

    def __init__(self, seed: int, batch_size: int, *, seq_len: int,
                 vocab_size: int, noise_frac: float = 0.1) -> None:
        super().__init__(seed, batch_size)
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.noise_frac = noise_frac
        self.a = 31337 % vocab_size or 1
        self.c = 7919 % vocab_size

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = self._rng(step)
        V = self.vocab_size
        toks = np.empty((self.batch_size, self.seq_len + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, V, size=self.batch_size)
        for i in range(self.seq_len):
            toks[:, i + 1] = (self.a * toks[:, i] + self.c) % V
        flip = rng.random(toks.shape) < self.noise_frac
        toks[flip] = rng.integers(0, V, size=int(flip.sum()))
        return (toks[:, :-1].astype(np.int32),
                toks[:, 1:].astype(np.int32))


def get_dataset(name: str, *, seed: int, batch_size: int,
                seq_len: int = 512, vocab_size: int = 32000):
    if name == "lm_synthetic":
        return SyntheticLM(seed, batch_size, seq_len=seq_len,
                           vocab_size=vocab_size)
    raise NotImplementedError(
        f"dataset {name!r} is not ported yet (ROADMAP.md: the vision and "
        "file datasets come with slice 3); have 'lm_synthetic'")

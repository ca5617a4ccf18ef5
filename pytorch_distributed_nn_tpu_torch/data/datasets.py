"""Synthetic datasets, deterministic by (seed, step): the port's own copy
of the JAX package's ``data/datasets.py`` for ``lm_synthetic`` and the
vision stand-ins ``mnist``, ``cifar10`` and ``imagenet_synthetic``.

``batch(step)`` depends only on (seed, step, global batch size) and is
byte-equal to the JAX package's batch for the same arguments (numpy makes
both), so the two packages train on the same data, on any number of
ranks (each takes its rows of the global batch, ``data/loader.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Evaluation batches are requested at step >= this offset (the trainer's
# held-out stream): an infinite synthetic stream never reaches it in
# training.
EVAL_STEP_OFFSET = 1 << 30


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    x_shape: tuple[int, ...]  # per-example
    x_dtype: np.dtype
    y_shape: tuple[int, ...]
    y_dtype: np.dtype
    num_classes: int


class SyntheticDataset:
    """Base: infinite stream of batches, indexed by step."""

    spec: BatchSpec

    def __init__(self, seed: int, batch_size: int) -> None:
        self.seed = seed
        self.batch_size = batch_size

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class ClassTemplateImages(SyntheticDataset):
    """Class-conditional template + noise images (NHWC, f32): y ~
    uniform(classes), x = template[y] + a row of a pre-generated N(0,
    noise) pool, both chosen by (seed, step). The finite pool keeps the
    host's work a gather and an add rather than fresh gaussians."""

    def __init__(self, seed: int, batch_size: int, *,
                 shape: tuple[int, ...], num_classes: int,
                 noise: float = 0.35, noise_pool: int = 256) -> None:
        super().__init__(seed, batch_size)
        self.noise = noise
        self.spec = BatchSpec(shape, np.dtype(np.float32), (),
                              np.dtype(np.int32), num_classes)
        tmpl_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xC1A55]))
        self.templates = tmpl_rng.standard_normal(
            (num_classes, *shape), dtype=np.float32)
        pool = tmpl_rng.standard_normal(
            (max(noise_pool, 2), *shape), dtype=np.float32)
        pool *= noise
        self._pool = pool

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = self._rng(step)
        y = rng.integers(0, self.spec.num_classes, size=self.batch_size,
                         dtype=np.int32)
        idx = rng.integers(0, len(self._pool), size=self.batch_size)
        x = self.templates[y] + self._pool[idx]
        return x, y


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
        self.spec = BatchSpec((seq_len,), np.dtype(np.int32), (seq_len,),
                              np.dtype(np.int32), vocab_size)
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


# (example shape, classes) of the vision stand-ins
_IMAGES = {"mnist": ((28, 28), 10), "cifar10": ((32, 32, 3), 10),
           "imagenet_synthetic": ((224, 224, 3), 1000)}
_NOT_PORTED = ("mlm_synthetic", "token_file", "array_file", "mnist_idx",
               "cifar10_bin", "image_folder")


def get_dataset(name: str, *, seed: int, batch_size: int,
                seq_len: int = 512, vocab_size: int = 32000):
    if name in _IMAGES:
        shape, classes = _IMAGES[name]
        return ClassTemplateImages(seed, batch_size, shape=shape,
                                   num_classes=classes)
    if name == "lm_synthetic":
        return SyntheticLM(seed, batch_size, seq_len=seq_len,
                           vocab_size=vocab_size)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md: the file "
            "readers, and BERT's masked-LM stream); have "
            f"{sorted(_IMAGES) + ['lm_synthetic']}")
    raise KeyError(f"unknown dataset {name!r}")

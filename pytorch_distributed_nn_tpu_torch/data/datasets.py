"""Datasets, deterministic by (seed, step): the port's own copy of the JAX
package's ``data/datasets.py``. Synthetic streams: ``lm_synthetic``,
BERT's ``mlm_synthetic`` and the vision stand-ins ``mnist``, ``cifar10``
and ``imagenet_synthetic``. From the user's files: ``token_file``
(:class:`TokenFileDataset`), ``array_file`` (:class:`ArrayFileDataset`)
and the readers of ``data/readers.py`` (``mnist_idx``, ``cifar10_bin``,
``image_folder``), each sampled by :class:`ArraySampler` or, for tokens,
by random windows.

``batch(step)`` depends only on (seed, step, global batch size) and is
byte-equal to the JAX package's batch for the same arguments (numpy makes
both, with the same draws in the same order), so the two packages train
on the same data, on any number of ranks (each takes its rows of the
global batch, ``data/loader.py``). Evaluation asks for steps from
``EVAL_STEP_OFFSET`` on: a file dataset then reads its test split or its
held-out part (``holdout_frac``), or, with neither, its training examples.
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


class SyntheticMLM(SyntheticLM):
    """Masked-LM view of the synthetic token stream (BERT pretraining): 15%
    of positions replaced by the [MASK] token (vocab_size - 1); labels hold
    the original token at masked positions and -1 elsewhere (ignored by
    ``train.losses.masked_lm_xent``)."""

    mask_frac = 0.15

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        tokens, _ = super().batch(step)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xA5C]))
        mask = rng.random(tokens.shape) < self.mask_frac
        labels = np.where(mask, tokens, -1).astype(np.int32)
        inputs = np.where(mask, self.spec.num_classes - 1,
                          tokens).astype(np.int32)
        return inputs, labels


class TokenFileDataset(SyntheticDataset):
    """A causal-LM corpus from a token file the user brings (the flat
    token dumps of nanoGPT and Megatron): a 1-D array, a raw ``.bin`` of
    ``token_dtype`` or an ``.npy``, memory-mapped, never copied whole.
    ``batch(step)`` takes ``batch_size`` windows of ``seq_len + 1`` tokens
    at offsets drawn from (seed, step). ``holdout_frac > 0`` keeps the
    file's tail fraction for evaluation: training windows lie in the head,
    evaluation windows (steps from ``EVAL_STEP_OFFSET`` on) in the tail."""

    def __init__(self, path: str, seed: int, batch_size: int, *,
                 seq_len: int, vocab_size: int,
                 token_dtype: str = "uint16",
                 holdout_frac: float = 0.0) -> None:
        super().__init__(seed, batch_size)
        self.seq_len = seq_len
        self.spec = BatchSpec((seq_len,), np.dtype(np.int32), (seq_len,),
                              np.dtype(np.int32), vocab_size)
        if not 0.0 <= holdout_frac < 1.0:
            raise ValueError(f"holdout_frac must be in [0, 1), got "
                             f"{holdout_frac}")
        if str(path).endswith(".npy"):
            self.tokens = np.load(path, mmap_mode="r")
        else:
            self.tokens = np.memmap(path, dtype=np.dtype(token_dtype),
                                    mode="r")
        if self.tokens.ndim != 1:
            raise ValueError(
                f"token file must be 1-D, got shape {self.tokens.shape}")
        if len(self.tokens) < seq_len + 1:
            raise ValueError(
                f"token file has {len(self.tokens)} tokens; need at least "
                f"seq_len + 1 = {seq_len + 1}")
        n = len(self.tokens)
        self._eval_start = n - int(n * holdout_frac) if holdout_frac else n
        if holdout_frac:
            # each region must hold one whole window
            if self._eval_start < seq_len + 1:
                raise ValueError(
                    f"holdout_frac {holdout_frac} leaves no full training "
                    f"window (train region {self._eval_start} tokens < "
                    "seq_len + 1)")
            if n - self._eval_start < seq_len + 1:
                raise ValueError(
                    f"holdout_frac {holdout_frac} reserves only "
                    f"{n - self._eval_start} tokens, not one full eval "
                    f"window (need seq_len + 1 = {seq_len + 1})")

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = self._rng(step)
        # a window spans seq_len + 1 tokens: the last start is the
        # region's end less seq_len + 1
        if step >= EVAL_STEP_OFFSET and self._eval_start < len(self.tokens):
            lo, hi = self._eval_start, len(self.tokens) - self.seq_len
        else:
            lo, hi = 0, self._eval_start - self.seq_len
        starts = rng.integers(lo, hi, size=self.batch_size)
        rows = np.stack([np.asarray(self.tokens[s:s + self.seq_len + 1])
                         for s in starts]).astype(np.int64)
        if rows.max() >= self.spec.num_classes:
            raise ValueError(
                f"token id {rows.max()} >= vocab_size "
                f"{self.spec.num_classes}: set data.vocab_size to the "
                "tokenizer's size")
        return (rows[:, :-1].astype(np.int32),
                rows[:, 1:].astype(np.int32))


class ArraySampler(SyntheticDataset):
    """Sampling over a finite set of examples, the engine of every finite
    dataset here (``.npz`` arrays, MNIST idx, CIFAR binaries, image
    folders). ``sample="shuffle"`` walks a fresh permutation each epoch
    (every example once an epoch, torch ``DistributedSampler`` with
    ``set_epoch``); ``"replacement"`` draws i.i.d. Both are functions of
    (seed, step).

    Evaluation (steps from ``EVAL_STEP_OFFSET`` on) reads, in order of
    preference: the last ``n_eval_tail`` rows, where a subclass has a real
    test split (MNIST's t10k, CIFAR's test_batch, an image folder's val/);
    else a uniform subset of ``holdout_frac`` of the rows drawn from the
    seed; else the training rows. A subclass that decodes its examples a
    batch at a time overrides :meth:`_gather`."""

    def __init__(self, x, y, seed: int, batch_size: int, *,
                 sample: str = "shuffle", holdout_frac: float = 0.0,
                 n_eval_tail: int = 0) -> None:
        super().__init__(seed, batch_size)
        if sample not in ("shuffle", "replacement"):
            raise ValueError(f"unknown sample mode {sample!r}")
        if not 0.0 <= holdout_frac < 1.0:
            raise ValueError(f"holdout_frac must be in [0, 1), got "
                             f"{holdout_frac}")
        if len(x) != len(y):
            raise ValueError(f"x has {len(x)} rows but y has {len(y)}")
        self.sample = sample
        self.x = x
        self.y = np.asarray(y).astype(np.int32)
        n = len(self.x)
        if n_eval_tail:
            if holdout_frac:
                raise ValueError("holdout_frac is redundant when a real "
                                 "test split exists (n_eval_tail > 0)")
            if not 0 < n_eval_tail < n:
                raise ValueError(
                    f"n_eval_tail {n_eval_tail} out of range for {n} rows")
            self._eval_rows = np.arange(n - n_eval_tail, n)
            self._train_rows = np.arange(n - n_eval_tail)
        else:
            n_eval = int(n * holdout_frac)
            if holdout_frac and (n_eval == 0 or n_eval == n):
                raise ValueError(
                    f"holdout_frac {holdout_frac} of {n} rows leaves an "
                    "empty train or eval split")
            # keyed by the seed alone: one partition for the whole run
            split = np.random.default_rng(
                np.random.SeedSequence([self.seed, 0x401D])).permutation(n)
            self._eval_rows = np.sort(split[:n_eval])
            self._train_rows = np.sort(split[n_eval:])
        self._perm_cache: dict[str, tuple[int, np.ndarray]] = {}

    def _gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.x[idx].astype(np.float32, copy=False), self.y[idx]

    def _perm(self, which: str, rows: np.ndarray,
              epoch: int) -> np.ndarray:
        """The epoch's order of ``rows``, a function of (seed, epoch),
        kept for the epoch so that a step costs O(batch)."""
        cached = self._perm_cache.get(which)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 0x5EAF]))
        perm = rows[rng.permutation(len(rows))]
        self._perm_cache[which] = (epoch, perm)
        return perm

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        if step >= EVAL_STEP_OFFSET and len(self._eval_rows):
            which, rows = "eval", self._eval_rows
            step = step - EVAL_STEP_OFFSET
        else:
            which, rows = "train", self._train_rows
        if self.sample == "replacement":
            rng = self._rng(step)
            idx = rows[rng.integers(0, len(rows), size=self.batch_size)]
        else:
            n = len(rows)
            pos = step * self.batch_size
            parts, remaining = [], self.batch_size
            while remaining:  # a batch may straddle two epochs
                epoch, within = divmod(pos, n)
                take = min(remaining, n - within)
                parts.append(
                    self._perm(which, rows, epoch)[within:within + take])
                pos += take
                remaining -= take
            idx = np.concatenate(parts)
        return self._gather(idx)


class ArrayFileDataset(ArraySampler):
    """Classification from a ``.npz`` the user brings, with arrays ``x``
    (N, ...) and integer ``y`` (N,); sampled by :class:`ArraySampler`."""

    def __init__(self, path: str, seed: int, batch_size: int, *,
                 sample: str = "shuffle",
                 holdout_frac: float = 0.0) -> None:
        data = np.load(path)
        try:
            x, y = data["x"], data["y"]
        except KeyError as e:
            raise ValueError(
                f"{path} must contain arrays 'x' and 'y'") from e
        super().__init__(x, y, seed, batch_size, sample=sample,
                         holdout_frac=holdout_frac)
        self.spec = BatchSpec(tuple(self.x.shape[1:]), np.dtype(np.float32),
                              (), np.dtype(np.int32), int(self.y.max()) + 1)


# (example shape, classes) of the vision stand-ins
_IMAGES = {"mnist": ((28, 28), 10), "cifar10": ((32, 32, 3), 10),
           "imagenet_synthetic": ((224, 224, 3), 1000)}
FILE_DATASETS = ("token_file", "array_file", "mnist_idx", "cifar10_bin",
                 "image_folder")


def get_dataset(name: str, *, seed: int, batch_size: int,
                seq_len: int = 512, vocab_size: int = 32000,
                path: str = "", token_dtype: str = "uint16",
                sample: str = "shuffle", holdout_frac: float = 0.0,
                image_size: int = 224, num_workers: int = 0):
    if name in FILE_DATASETS and not path:
        raise ValueError(f"dataset {name!r} needs data.path")
    if name in ("mnist_idx", "cifar10_bin", "image_folder"):
        from pytorch_distributed_nn_tpu_torch.data import readers

        if name == "mnist_idx":
            return readers.MnistIdxDataset(
                path, seed, batch_size, sample=sample,
                holdout_frac=holdout_frac)
        if name == "cifar10_bin":
            return readers.Cifar10BinDataset(
                path, seed, batch_size, sample=sample,
                holdout_frac=holdout_frac)
        return readers.ImageFolderDataset(
            path, seed, batch_size, sample=sample,
            holdout_frac=holdout_frac, image_size=image_size,
            num_workers=num_workers)
    if name == "token_file":
        return TokenFileDataset(path, seed, batch_size, seq_len=seq_len,
                                vocab_size=vocab_size,
                                token_dtype=token_dtype,
                                holdout_frac=holdout_frac)
    if name == "array_file":
        return ArrayFileDataset(path, seed, batch_size, sample=sample,
                                holdout_frac=holdout_frac)
    if name in _IMAGES:
        shape, classes = _IMAGES[name]
        return ClassTemplateImages(seed, batch_size, shape=shape,
                                   num_classes=classes)
    if name == "lm_synthetic":
        return SyntheticLM(seed, batch_size, seq_len=seq_len,
                           vocab_size=vocab_size)
    if name == "mlm_synthetic":
        return SyntheticMLM(seed, batch_size, seq_len=seq_len,
                            vocab_size=vocab_size)
    raise KeyError(f"unknown dataset {name!r}")

"""Readers of the standard on-disk dataset formats (the JAX package's
``data/readers.py``, which stands for the reference's
``torchvision.datasets``): MNIST idx files, CIFAR-10 binary batches and
class-per-directory image folders. They read files the user already has;
nothing downloads.

Each feeds :class:`~pytorch_distributed_nn_tpu_torch.data.datasets.ArraySampler`,
so it samples by (seed, step) like every finite dataset, and a real test
split on disk (the ``t10k-*`` pair, ``test_batch.bin``, a ``val/``
directory) becomes the evaluation stream. Pixels are scaled as
``torchvision.transforms.ToTensor`` scales them: uint8 to f32 in [0, 1].
PIL is imported only where an image is decoded.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from pytorch_distributed_nn_tpu_torch.data.datasets import (
    ArraySampler,
    BatchSpec,
)

_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
               0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}


def _parse_idx_header(f, path) -> tuple[np.dtype, tuple[int, ...]]:
    """The idx header of an open stream: [0, 0, dtype, ndim], then ndim
    big-endian uint32 dims. Leaves ``f`` at the data."""
    zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
    if zero != 0 or dtype_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: not an idx file (magic "
                         f"{zero:#06x}/{dtype_code:#04x})")
    dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
    return np.dtype(_IDX_DTYPES[dtype_code]), tuple(int(d) for d in dims)


def _idx_opener(path):
    return gzip.open if str(path).endswith(".gz") else open


def read_idx_header(path: str | Path) -> tuple[np.dtype, tuple[int, ...]]:
    """(dtype, dims) from the header alone: a few bytes, for shape probes
    that must not load a corpus."""
    with _idx_opener(path)(path, "rb") as f:
        return _parse_idx_header(f, path)


def read_idx(path: str | Path) -> np.ndarray:
    """One idx file (optionally ``.gz``), LeCun's MNIST container: the
    header, then the array with multibyte types big-endian."""
    with _idx_opener(path)(path, "rb") as f:
        native_dtype, dims = _parse_idx_header(f, path)
        # read the bytes as big-endian: converting after a native read
        # would keep the swapped values
        dtype = native_dtype.newbyteorder(">")
        data = np.frombuffer(f.read(), dtype=dtype)
    expected = int(np.prod(dims))
    if data.size != expected:
        raise ValueError(f"{path}: header promises {dims} = {expected} "
                         f"values, file holds {data.size}")
    return data.astype(dtype.newbyteorder("=")).reshape(dims)


def find_one(root: Path, stem: str) -> Path | None:
    """``root/stem`` or ``root/stem.gz``, whichever exists first."""
    for name in (stem, stem + ".gz"):
        p = root / name
        if p.exists():
            return p
    return None


class _Uint8Pixels(ArraySampler):
    """Keeps the corpus as uint8 (a quarter of f32's memory) and scales a
    batch to [0, 1] when it is gathered."""

    def _gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.x[idx].astype(np.float32) / 255.0, self.y[idx]


class MnistIdxDataset(_Uint8Pixels):
    """MNIST from its idx files: ``path`` is the directory holding
    ``train-images-idx3-ubyte[.gz]`` and ``train-labels-idx1-ubyte[.gz]``;
    a ``t10k-*`` pair there is the evaluation split (the real test set),
    and half a pair is refused."""

    def __init__(self, path: str, seed: int, batch_size: int, *,
                 sample: str = "shuffle",
                 holdout_frac: float = 0.0) -> None:
        root = Path(path)
        imgs = find_one(root, "train-images-idx3-ubyte")
        lbls = find_one(root, "train-labels-idx1-ubyte")
        if imgs is None or lbls is None:
            raise ValueError(f"{root}: need train-images-idx3-ubyte[.gz] + "
                             "train-labels-idx1-ubyte[.gz]")
        x = read_idx(imgs)
        y = read_idx(lbls)
        t_imgs = find_one(root, "t10k-images-idx3-ubyte")
        t_lbls = find_one(root, "t10k-labels-idx1-ubyte")
        if (t_imgs is None) != (t_lbls is None):
            # half a test pair would quietly make the evaluation in-sample
            raise ValueError(
                f"{root}: t10k pair incomplete (found "
                f"{'images' if t_imgs else 'labels'} without its mate)")
        n_eval = 0
        if t_imgs is not None:
            x = np.concatenate([x, read_idx(t_imgs)])
            ty = read_idx(t_lbls)
            y = np.concatenate([y, ty])
            n_eval = len(ty)
            holdout_frac = 0.0  # the real test set wins
        super().__init__(x, y, seed, batch_size, sample=sample,
                         holdout_frac=holdout_frac, n_eval_tail=n_eval)
        self.spec = BatchSpec(tuple(x.shape[1:]), np.dtype(np.float32), (),
                              np.dtype(np.int32), int(self.y.max()) + 1)


class Cifar10BinDataset(_Uint8Pixels):
    """CIFAR-10 from its binary batches, each record one label byte and
    3072 CHW pixel bytes: ``path`` is the directory holding
    ``data_batch_*.bin`` and, for the evaluation split, ``test_batch.bin``.
    Images come out HWC."""

    RECORD = 1 + 3 * 32 * 32

    @classmethod
    def _read_bin(cls, path: Path) -> tuple[np.ndarray, np.ndarray]:
        raw = np.frombuffer(path.read_bytes(), np.uint8)
        if raw.size % cls.RECORD:
            raise ValueError(f"{path}: size {raw.size} is not a multiple of "
                             f"the {cls.RECORD}-byte CIFAR record")
        rec = raw.reshape(-1, cls.RECORD)
        x = np.ascontiguousarray(
            rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        return x, rec[:, 0]

    def __init__(self, path: str, seed: int, batch_size: int, *,
                 sample: str = "shuffle",
                 holdout_frac: float = 0.0) -> None:
        root = Path(path)
        train_files = sorted(root.glob("data_batch_*.bin"))
        if not train_files:
            raise ValueError(f"{root}: no data_batch_*.bin files")
        parts = [self._read_bin(p) for p in train_files]
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        test = root / "test_batch.bin"
        n_eval = 0
        if test.exists():
            tx, ty = self._read_bin(test)
            x = np.concatenate([x, tx])
            y = np.concatenate([y, ty])
            n_eval = len(ty)
            holdout_frac = 0.0
        super().__init__(x, y, seed, batch_size, sample=sample,
                         holdout_frac=holdout_frac, n_eval_tail=n_eval)
        self.spec = BatchSpec((32, 32, 3), np.dtype(np.float32), (),
                              np.dtype(np.int32), int(self.y.max()) + 1)


class ImageFolderDataset(ArraySampler):
    """torchvision's ``ImageFolder`` layout, ``root/<class>/<image>``, the
    class index the sorted directory order. Images are decoded a batch at a
    time (:meth:`_decode`: the short side scaled to ``image_size`` with
    PIL's bilinear filter, then a center crop), by ``num_workers`` threads
    (0 inline, -1 one a core up to 16; PIL releases the GIL while it
    decodes and resizes). ``root/train`` and ``root/val``, with the same
    classes, are taken as the split; otherwise ``holdout_frac`` applies.
    :meth:`close` stops the threads."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")

    @classmethod
    def _scan(cls, root: Path) -> tuple[list[Path], list[int], list[str]]:
        classes = sorted(d.name for d in root.iterdir() if d.is_dir())
        if not classes:
            raise ValueError(f"{root}: no class directories")
        paths, labels = [], []
        for ci, cname in enumerate(classes):
            files = sorted(p for p in (root / cname).rglob("*")
                           if p.suffix.lower() in cls.EXTS)
            paths.extend(files)
            labels.extend([ci] * len(files))
        if not paths:
            raise ValueError(f"{root}: no image files under the class "
                             "directories")
        return paths, labels, classes

    def __init__(self, path: str, seed: int, batch_size: int, *,
                 sample: str = "shuffle", holdout_frac: float = 0.0,
                 image_size: int = 224, num_workers: int = 0) -> None:
        root = Path(path)
        self.image_size = image_size
        if num_workers < 0:
            num_workers = min(os.cpu_count() or 1, 16)
        self.num_workers = num_workers
        # made here, not on first use: the loader's prefetch thread and the
        # evaluation both gather
        self._pool = None
        if num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=num_workers,
                                            thread_name_prefix="img-decode")
        n_eval = 0
        if (root / "train").is_dir():
            paths, labels, classes = self._scan(root / "train")
            if (root / "val").is_dir():
                vp, vl, vclasses = self._scan(root / "val")
                if vclasses != classes:
                    raise ValueError(
                        f"{root}: train/ and val/ class sets differ")
                paths, labels = paths + vp, labels + vl
                n_eval = len(vl)
                holdout_frac = 0.0
        else:
            paths, labels, classes = self._scan(root)
        super().__init__(np.array([str(p) for p in paths]),
                         np.array(labels), seed, batch_size, sample=sample,
                         holdout_frac=holdout_frac, n_eval_tail=n_eval)
        self.classes = classes
        self.spec = BatchSpec((image_size, image_size, 3),
                              np.dtype(np.float32), (), np.dtype(np.int32),
                              len(classes))

    def _decode(self, path: str) -> np.ndarray:
        from PIL import Image

        s = self.image_size
        with Image.open(path) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = s / min(w, h)
            im = im.resize((max(s, round(w * scale)),
                            max(s, round(h * scale))), Image.BILINEAR)
            w, h = im.size
            left, top = (w - s) // 2, (h - s) // 2
            im = im.crop((left, top, left + s, top + s))
            return np.asarray(im, np.float32) / 255.0

    def _gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        paths = self.x[idx]
        if self._pool is not None:
            x = np.stack(list(self._pool.map(self._decode, paths)))
        else:
            x = np.stack([self._decode(p) for p in paths])
        return x, self.y[idx]

    def close(self) -> None:
        """Stop the decode threads (idle ones would live as long as the
        process)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

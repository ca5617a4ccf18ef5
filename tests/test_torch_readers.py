"""Port parity of the on-disk readers (``data/readers.py``: MNIST idx,
CIFAR-10 binary batches, image folders) against the JAX package, on files
the tests write in the upstream formats.

- ``read_idx``: uint8 plain and gzipped, and the multibyte types (int16,
  int32, float32, float64) big-endian, against the values written and the
  JAX reader; a truncated file and a foreign magic number are refused.
- Each reader's train and eval batches, for the same seed and steps,
  equal the JAX reader's bit for bit: under both ``sample`` modes, with
  the real test split (t10k, ``test_batch.bin``, ``val/``) and without it
  at ``holdout_frac`` 0 and > 0. The image folder decodes PNGs through
  PIL's bilinear resize and center crop as the JAX reader does.
- The JAX package's ``ValueError``s: half a t10k pair, no train files,
  a CIFAR file of a foreign size, ``train/`` and ``val/`` with other
  classes, no class directories.
- The decode pool equals the serial decode, batch for batch, and the
  Trainer stops it when it closes.
- The port's Trainer against the JAX Trainer from the same weights:
  ``mlp`` from ``mnist_idx`` and ``lenet`` from ``cifar10_bin``, 3 steps,
  f32 losses within 1e-6 relative and the evaluation on the real test
  split; ResNet-50 from an image folder is in
  ``test_torch_readers_resnet.py``, with the writers and runners here.
"""

import dataclasses
import gzip
import struct

import jax
import numpy as np
import pytest

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.data import datasets as jdata
from pytorch_distributed_nn_tpu.data import readers as jreaders
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.data import datasets as tdata
from pytorch_distributed_nn_tpu_torch.data import readers as treaders
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    vision_params_from_jax,
)

OFF = tdata.EVAL_STEP_OFFSET
_IDX_CODES = {np.dtype(np.uint8): 0x08, np.dtype(np.int8): 0x09,
              np.dtype(np.int16): 0x0B, np.dtype(np.int32): 0x0C,
              np.dtype(np.float32): 0x0D, np.dtype(np.float64): 0x0E}


def write_idx(path, arr, *, compress=False):
    """``arr`` as an idx file (big-endian payload), optionally gzipped;
    returns the path written."""
    head = struct.pack(">HBB", 0, _IDX_CODES[arr.dtype], arr.ndim)
    head += struct.pack(f">{arr.ndim}I", *arr.shape)
    payload = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    path = str(path) + (".gz" if compress else "")
    with (gzip.open if compress else open)(path, "wb") as f:
        f.write(payload)
    return path


def _stripes(rng, n, shape, axis_rows):
    """uint8 images with a saturated stripe at rows 2y..2y+3 (learnable)."""
    y = (np.arange(n) % 10).astype(np.uint8)
    x = rng.integers(0, 256, (n, *shape)).astype(np.uint8)
    for i, yi in enumerate(y):
        idx = [i] + [slice(None)] * len(shape)
        idx[axis_rows] = slice(2 * yi, 2 * yi + 3)
        x[tuple(idx)] = 255
    return x, y


def mnist_dir(root, *, n_train=96, n_test=32, compress=False, test=True):
    rng = np.random.default_rng(0)
    x, y = _stripes(rng, n_train, (28, 28), 1)
    write_idx(root / "train-images-idx3-ubyte", x, compress=compress)
    write_idx(root / "train-labels-idx1-ubyte", y, compress=compress)
    if test:
        tx, ty = _stripes(rng, n_test, (28, 28), 1)
        write_idx(root / "t10k-images-idx3-ubyte", tx, compress=compress)
        write_idx(root / "t10k-labels-idx1-ubyte", ty, compress=compress)
    return root


def cifar_dir(root, *, n_per_batch=48, n_batches=2, n_test=24, test=True):
    rng = np.random.default_rng(1)

    def records(n):
        x, y = _stripes(rng, n, (3, 32, 32), 2)  # CHW, stripe over rows
        return np.concatenate([y[:, None], x.reshape(n, -1)], 1)

    for b in range(n_batches):
        (root / f"data_batch_{b + 1}.bin").write_bytes(
            records(n_per_batch).tobytes())
    if test:
        (root / "test_batch.bin").write_bytes(records(n_test).tobytes())
    return root


def image_folder(root, *, n_per_class=6, classes=("cat", "dog", "emu"),
                 seed=2):
    """PNGs of varied sizes (some not square, some smaller than the target
    size), a class stripe each."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for ci, cname in enumerate(sorted(classes)):
        d = root / cname
        d.mkdir(parents=True)
        for i in range(n_per_class):
            h, w = int(rng.integers(24, 56)), int(rng.integers(24, 56))
            arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            arr[:, ci * 6:ci * 6 + 5] = 255
            Image.fromarray(arr).save(d / f"img_{i:03d}.png")
    return root


def _same(port, ref, steps):
    for step in steps:
        got, want = port.batch(step), ref.batch(step)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, step
            assert a.tobytes() == b.tobytes(), step


def _both(name, **kw):
    return (tdata.get_dataset(name, **kw), jdata.get_dataset(name, **kw))


# --------------------------------------------------------------------------
# the idx container
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "int32",
                                   "float32", "float64"])
@pytest.mark.parametrize("compress", [False, True])
def test_read_idx_is_big_endian_and_matches_jax(tmp_path, dtype, compress):
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((5, 3, 4)) * 1000).astype(dtype)
    path = write_idx(tmp_path / "vals-idx3", arr, compress=compress)
    got = treaders.read_idx(path)
    assert got.dtype == np.dtype(dtype) and got.dtype.isnative
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, jreaders.read_idx(path))
    assert treaders.read_idx_header(path) == (np.dtype(dtype), (5, 3, 4))


def test_read_idx_refuses_foreign_and_truncated_files(tmp_path):
    junk = tmp_path / "junk"
    junk.write_bytes(b"junkjunk")
    with pytest.raises(ValueError, match="not an idx file"):
        treaders.read_idx(junk)
    path = write_idx(tmp_path / "short", np.arange(10, dtype=np.int32))
    with open(path, "r+b") as f:
        f.truncate(8 + 4 * 9)
    with pytest.raises(ValueError, match="header promises"):
        treaders.read_idx(path)


# --------------------------------------------------------------------------
# the readers' batches against the JAX readers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sample", ["shuffle", "replacement"])
@pytest.mark.parametrize("split", ["t10k", "holdout", "none"])
@pytest.mark.parametrize("compress", [False, True])
def test_mnist_idx_batches_are_the_jax_batches(tmp_path, compress, split,
                                               sample):
    mnist_dir(tmp_path, compress=compress, test=split == "t10k")
    kw = dict(seed=5, batch_size=20, path=str(tmp_path), sample=sample,
              holdout_frac=0.2 if split == "holdout" else 0.0)
    port, ref = _both("mnist_idx", **kw)
    _same(port, ref, list(range(7)) + [OFF, OFF + 1, OFF + 2])
    assert dataclasses.astuple(port.spec) == dataclasses.astuple(ref.spec)
    assert port.spec.x_shape == (28, 28) and port.spec.num_classes == 10
    x, _ = port.batch(0)
    assert x.dtype == np.float32 and 0.0 <= x.min() and x.max() <= 1.0
    n_eval = {"t10k": 32, "holdout": int(96 * 0.2), "none": 0}[split]
    assert len(port._eval_rows) == n_eval
    if split == "t10k":  # the test set is the tail, never trained on
        assert port._eval_rows.min() == 96 and port._train_rows.max() == 95


@pytest.mark.parametrize("sample", ["shuffle", "replacement"])
@pytest.mark.parametrize("split", ["test_batch", "holdout", "none"])
def test_cifar10_bin_batches_are_the_jax_batches(tmp_path, split, sample):
    cifar_dir(tmp_path, test=split == "test_batch")
    kw = dict(seed=6, batch_size=16, path=str(tmp_path), sample=sample,
              holdout_frac=0.25 if split == "holdout" else 0.0)
    port, ref = _both("cifar10_bin", **kw)
    _same(port, ref, list(range(8)) + [OFF, OFF + 1])
    assert port.spec.x_shape == (32, 32, 3)
    assert len(port._train_rows) == (96 if split != "holdout" else 72)
    # CHW records come out HWC: the stripe at rows 2y..2y+3 of every
    # channel is 1.0 across the row
    x, y = port.batch(3)
    for xi, yi in zip(x, y):
        np.testing.assert_array_equal(xi[2 * yi:2 * yi + 3], 1.0)


@pytest.mark.parametrize("sample", ["shuffle", "replacement"])
@pytest.mark.parametrize("split", ["val", "holdout", "none"])
def test_image_folder_batches_are_the_jax_batches(tmp_path, split, sample):
    if split == "val":
        image_folder(tmp_path / "train")
        image_folder(tmp_path / "val", n_per_class=2, seed=9)
    else:
        image_folder(tmp_path)
    kw = dict(seed=7, batch_size=4, path=str(tmp_path), sample=sample,
              holdout_frac=0.25 if split == "holdout" else 0.0,
              image_size=32, num_workers=0)
    port, ref = _both("image_folder", **kw)
    assert port.classes == ref.classes == ["cat", "dog", "emu"]
    assert [str(p) for p in port.x] == [str(p) for p in ref.x]
    _same(port, ref, [0, 1, 4, 5, OFF, OFF + 1])
    x, y = port.batch(0)
    assert x.shape == (4, 32, 32, 3) and x.dtype == np.float32
    n_eval = {"val": 6, "holdout": int(18 * 0.25), "none": 0}[split]
    assert len(port._eval_rows) == n_eval


def test_image_folder_decodes_as_the_jax_reader(tmp_path):
    """Non-square images smaller and larger than the target: the short
    side scaled with PIL's bilinear filter, then the center crop."""
    image_folder(tmp_path, n_per_class=4)
    for size in (24, 33):
        port, ref = _both("image_folder", seed=0, batch_size=1,
                          path=str(tmp_path), image_size=size,
                          num_workers=0)
        for p in port.x:
            got, want = port._decode(p), ref._decode(p)
            assert got.shape == (size, size, 3)
            assert got.tobytes() == want.tobytes()


def test_image_folder_pool_matches_serial_decode(tmp_path):
    image_folder(tmp_path)
    kw = dict(seed=0, batch_size=5, path=str(tmp_path), image_size=32)
    serial = tdata.get_dataset("image_folder", num_workers=0, **kw)
    pooled = tdata.get_dataset("image_folder", num_workers=4, **kw)
    assert serial._pool is None and pooled._pool is not None
    try:
        _same(pooled, serial, [0, 1, 2, 3, 4])
    finally:
        pooled.close()
    assert pooled._pool is None
    # -1: one thread a core, at most 16
    auto = tdata.get_dataset("image_folder", num_workers=-1, **kw)
    assert 1 <= auto.num_workers <= 16
    auto.close()


@pytest.mark.parametrize("make,name,match", [
    (lambda d: (mnist_dir(d, test=True),
                (d / "t10k-labels-idx1-ubyte").unlink()),
     "mnist_idx", "t10k pair incomplete"),
    (lambda d: (d / "train-images-idx3-ubyte").write_bytes(b"junkjunk"),
     "mnist_idx", "need train-images"),
    (lambda d: None, "cifar10_bin", "no data_batch"),
    (lambda d: (d / "data_batch_1.bin").write_bytes(b"\0" * 3000),
     "cifar10_bin", "not a multiple"),
    (lambda d: (image_folder(d / "train"),
                image_folder(d / "val", classes=("cat", "dog"))),
     "image_folder", "class sets differ"),
    (lambda d: None, "image_folder", "no class directories"),
    (lambda d: (d / "empty_class").mkdir(), "image_folder", "no image"),
])
def test_readers_refuse_what_the_jax_readers_refuse(tmp_path, make, name,
                                                    match):
    make(tmp_path)
    for pkg in (tdata, jdata):
        with pytest.raises(ValueError, match=match):
            pkg.get_dataset(name, seed=0, batch_size=4, path=str(tmp_path))


def test_mnist_idx_reads_other_image_dims(tmp_path):
    """idx holds any dims: the spec and ``flops.input_spec`` read them."""
    from pytorch_distributed_nn_tpu_torch.utils.flops import input_spec

    rng = np.random.default_rng(4)
    write_idx(tmp_path / "train-images-idx3-ubyte",
              rng.integers(0, 256, (12, 20, 24)).astype(np.uint8))
    write_idx(tmp_path / "train-labels-idx1-ubyte",
              (np.arange(12) % 3).astype(np.uint8))
    ds = tdata.get_dataset("mnist_idx", seed=0, batch_size=4,
                           path=str(tmp_path))
    assert ds.spec.x_shape == (20, 24) and ds.spec.num_classes == 3
    cfg = tconfig.get_config("mlp_mnist", **{"data.dataset": "mnist_idx",
                                             "data.path": str(tmp_path)})
    assert input_spec(cfg) == ((20, 24), np.dtype(np.float32))


# --------------------------------------------------------------------------
# the port's Trainer from the readers, against the JAX Trainer
# --------------------------------------------------------------------------

def _overrides(dataset, path, model, **more):
    return {"data.dataset": dataset, "data.path": str(path),
            "model.name": model, "data.batch_size": "16",
            "data.prefetch": "0", "model.compute_dtype": "float32",
            "parallel.strategy": "single", "steps": "3", "log_every": "1",
            "optim.lr": "0.05", **more}


def _jax_run(ov, evaluate=True):
    cfg = jconfig.get_config("mlp_mnist", **ov)
    jt = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=1),
                                      devices=jax.devices()[:1]))
    init = jax.device_get((jt.state.params,
                           jt.state.model_state.get("batch_stats")))
    jt.train()
    ev = jt.evaluate(num_batches=2) if evaluate else None
    jt.close()
    return init, jt.losses(), ev


@pytest.mark.parametrize("dataset,model,make", [
    ("mnist_idx", "mlp", mnist_dir),
    ("cifar10_bin", "lenet", cifar_dir),
])
def test_trainer_from_the_reader_matches_the_jax_trainer(tmp_path, dataset,
                                                         model, make):
    make(tmp_path)
    ov = _overrides(dataset, tmp_path, model)
    (params, stats), j_losses, j_eval = _jax_run(ov)
    with Trainer(tconfig.get_config("mlp_mnist", **ov), device="cpu",
                 params=vision_params_from_jax(params, stats)) as t:
        t.train()
        ev = t.evaluate(num_batches=2)  # the real test split
    assert len(t.losses()) == 3
    np.testing.assert_allclose(t.losses(), j_losses, rtol=1e-6)
    np.testing.assert_allclose(ev.loss, j_eval.loss, rtol=1e-6)
    assert ev.accuracy == pytest.approx(j_eval.accuracy, abs=1e-6)

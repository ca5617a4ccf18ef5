"""Port parity of the file-backed datasets (``data/datasets.py``:
``token_file``, ``array_file`` and the ``ArraySampler`` under every
reader), against the JAX package on the files the tests write.

- A token corpus as a raw ``.bin`` (uint16, and uint32 through
  ``token_dtype``) and as an ``.npy``; an ``.npz`` of (x, y). For the same
  seed and steps the port's train and eval batches equal the JAX
  package's bit for bit, under both ``sample`` modes and ``holdout_frac``
  0 and > 0, epochs straddled included.
- The JAX package's ``ValueError``s: no path, a short corpus, a split
  that leaves no whole window or no row, ids past the vocabulary, a
  ``.npz`` without ``x``/``y``.
- The config takes the six DataConfig fields with the JAX defaults; the
  loss of each file dataset is the JAX one; ``token_file`` is a token
  dataset for ``xent_chunk`` and ``mesh.seq``; ``utils.flops.input_spec``
  gives the datasets' example shapes.
- config 4's transformer LM (tiny dims, f32) trained 3 steps from a
  ``token_file`` with a held-out tail and evaluated on it, by the port's
  Trainer and the JAX Trainer from the same weights: losses within 1e-6
  relative, the evaluation within 1e-6. A pipeline run (every stage in
  this process) trained on a token file resumes from its checkpoint bit
  for bit.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.data import datasets as jdata
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train import losses as jlosses
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.data import datasets as tdata
from pytorch_distributed_nn_tpu_torch.train import losses as tlosses
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils import flops as tflops
from pytorch_distributed_nn_tpu_torch.utils.interop import params_from_jax

OFF = tdata.EVAL_STEP_OFFSET
V = 97


def _corpus(n=6000, v=V, seed=0):
    """A learnable affine token stream with some noise, numpy-seeded."""
    rng = np.random.default_rng(seed)
    toks = np.empty(n, dtype=np.int64)
    toks[0] = 1
    for i in range(1, n):
        toks[i] = (31 * toks[i - 1] + 17) % v
    flip = rng.random(n) < 0.1
    toks[flip] = rng.integers(0, v, int(flip.sum()))
    return toks


@pytest.fixture()
def token_files(tmp_path):
    toks = _corpus()
    paths = {"bin": tmp_path / "corpus.bin", "npy": tmp_path / "corpus.npy",
             "u32": tmp_path / "corpus32.bin"}
    toks.astype(np.uint16).tofile(paths["bin"])
    np.save(paths["npy"], toks.astype(np.uint16))
    toks.astype(np.uint32).tofile(paths["u32"])
    return {k: str(v) for k, v in paths.items()}


@pytest.fixture()
def npz(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "arrays.npz"
    np.savez(path, x=rng.standard_normal((37, 6, 5)).astype(np.float32),
             y=rng.integers(0, 4, 37))
    return str(path)


def _same(port, ref, steps):
    for step in steps:
        got, want = port.batch(step), ref.batch(step)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, step
            assert a.tobytes() == b.tobytes(), step


@pytest.mark.parametrize("holdout", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["bin", "npy", "u32"])
def test_token_file_batches_are_the_jax_batches(token_files, kind, holdout):
    kw = dict(seed=3, batch_size=5, seq_len=24, vocab_size=V,
              path=token_files[kind], holdout_frac=holdout,
              token_dtype="uint32" if kind == "u32" else "uint16")
    port = tdata.get_dataset("token_file", **kw)
    _same(port, jdata.get_dataset("token_file", **kw),
          [0, 1, 7, OFF, OFF + 1])
    x, y = port.batch(2)
    assert x.shape == y.shape == (5, 24)
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    if holdout:
        # evaluation windows lie in the tail, training windows before it
        windows = np.lib.stride_tricks.sliding_window_view(_corpus(), 25)
        tail = 6000 - int(6000 * holdout)
        for step, in_tail in ((0, False), (1, False), (OFF, True)):
            x, y = port.batch(step)
            rows = np.concatenate([x, y[:, -1:]], axis=1)
            for row in rows:
                starts = np.flatnonzero((windows == row).all(axis=1))
                assert len(starts), step
                assert ((starts >= tail) == in_tail).all(), step


@pytest.mark.parametrize("holdout", [0.0, 0.25])
@pytest.mark.parametrize("sample", ["shuffle", "replacement"])
def test_array_file_batches_are_the_jax_batches(npz, sample, holdout):
    kw = dict(seed=4, batch_size=8, path=npz, sample=sample,
              holdout_frac=holdout)
    port = tdata.get_dataset("array_file", **kw)
    ref = jdata.get_dataset("array_file", **kw)
    # 37 rows (or the 28 left of a 0.25 holdout) in batches of 8: the
    # shuffle straddles epochs
    _same(port, ref, list(range(12)) + [OFF + i for i in range(6)])
    assert dataclasses.astuple(port.spec) == dataclasses.astuple(ref.spec)
    np.testing.assert_array_equal(port._eval_rows, ref._eval_rows)
    np.testing.assert_array_equal(port._train_rows, ref._train_rows)
    if holdout:
        assert not set(port._eval_rows) & set(port._train_rows)
    if sample == "shuffle" and not holdout:
        # one epoch (37 rows) visits each row once: the rows of steps 0-3
        # and the first 5 of step 4
        seen = np.concatenate([port.batch(s)[0] for s in range(4)]
                              + [port.batch(4)[0][:5]])
        assert len({r.tobytes() for r in seen}) == 37


@pytest.mark.parametrize("name", tdata.FILE_DATASETS)
def test_file_datasets_need_a_path(name):
    with pytest.raises(ValueError, match="needs data.path"):
        tdata.get_dataset(name, seed=0, batch_size=1)
    with pytest.raises(ValueError, match="needs data.path"):
        jdata.get_dataset(name, seed=0, batch_size=1)


@pytest.mark.parametrize("kwargs,match", [
    (dict(seq_len=6000), "need at least"),
    (dict(seq_len=16, holdout_frac=0.999), "no full training window"),
    (dict(seq_len=16, holdout_frac=0.001), "not one full eval window"),
    (dict(seq_len=16, holdout_frac=1.0), r"in \[0, 1\)"),
])
def test_token_file_refuses_what_the_jax_package_refuses(token_files,
                                                        kwargs, match):
    kw = dict(seed=0, batch_size=2, vocab_size=V, path=token_files["bin"],
              **kwargs)
    for pkg in (tdata, jdata):
        with pytest.raises(ValueError, match=match):
            pkg.get_dataset("token_file", **kw)


def test_token_file_refuses_ids_past_the_vocabulary(token_files, tmp_path):
    for pkg in (tdata, jdata):
        ds = pkg.get_dataset("token_file", seed=0, batch_size=4, seq_len=16,
                             vocab_size=5, path=token_files["npy"])
        with pytest.raises(ValueError, match="vocab_size"):
            ds.batch(0)
    two_d = tmp_path / "two_d.npy"
    np.save(two_d, np.zeros((4, 40), np.uint16))
    with pytest.raises(ValueError, match="1-D"):
        tdata.get_dataset("token_file", seed=0, batch_size=1, seq_len=8,
                          path=str(two_d))


@pytest.mark.parametrize("kwargs,match", [
    (dict(holdout_frac=0.01), "empty train or eval split"),
    (dict(sample="sequential"), "unknown sample mode"),
])
def test_array_file_refuses_what_the_jax_package_refuses(npz, kwargs,
                                                         match, tmp_path):
    for pkg in (tdata, jdata):
        with pytest.raises(ValueError, match=match):
            pkg.get_dataset("array_file", seed=0, batch_size=2, path=npz,
                            **kwargs)
    bad = tmp_path / "bad.npz"
    np.savez(bad, inputs=np.zeros((3, 2)), y=np.zeros(3))
    with pytest.raises(ValueError, match="'x' and 'y'"):
        tdata.get_dataset("array_file", seed=0, batch_size=1, path=str(bad))


def test_data_config_takes_the_jax_fields():
    got, want = tconfig.DataConfig(), jconfig.DataConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ov = {"data.path": "/data/x", "data.image_size": "64",
          "data.token_dtype": "uint32", "data.sample": "replacement",
          "data.holdout_frac": "0.05", "data.num_workers": "3"}
    g = tconfig.get_config("mlp_mnist", **ov).data
    w = jconfig.get_config("mlp_mnist", **ov).data
    assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert (g.path, g.image_size, g.holdout_frac) == ("/data/x", 64, 0.05)


@pytest.mark.parametrize("name", ["token_file", "array_file", "mnist_idx",
                                  "cifar10_bin", "image_folder"])
def test_file_dataset_losses_are_the_jax_losses(name):
    rng = np.random.default_rng(2)
    if name == "token_file":
        logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
        y = rng.integers(0, 11, (2, 5)).astype(np.int32)
        assert tlosses.get_loss_fn(name) is tlosses.lm_xent
    else:
        logits = rng.standard_normal((6, 10)).astype(np.float32)
        y = rng.integers(0, 10, 6).astype(np.int32)
        assert tlosses.get_loss_fn(name) is tlosses.softmax_xent
    for eps in (0.0, 0.1):
        got = tlosses.get_loss_fn(name, label_smoothing=eps)(
            torch.from_numpy(logits), torch.from_numpy(y))
        want = jlosses.get_loss_fn(name, label_smoothing=eps)(logits, y)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_token_file_is_a_token_dataset_for_the_step_checks():
    from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step

    cfg = tconfig.get_config("llama3_longcontext", **{
        "data.dataset": "token_file", "xent_chunk": "4096",
        "data.seq_len": "8192"})
    step, _ = make_train_step(cfg, tlosses.lm_xent)  # the chunked loss
    assert callable(step)
    cfg.mesh.seq = 2
    with pytest.raises(ValueError, match="attn_impl"):
        make_train_step(cfg, tlosses.lm_xent)  # past the dataset check
    cfg.data.dataset = "array_file"
    with pytest.raises(ValueError, match="no sequence dim"):
        make_train_step(cfg, tlosses.lm_xent)


def test_input_spec_is_the_dataset_spec(token_files, npz, tmp_path):
    cases = {"token_file": token_files["bin"], "array_file": npz,
             "mnist": "", "cifar10": "", "lm_synthetic": ""}
    for name, path in cases.items():
        cfg = tconfig.get_config("mlp_mnist", **{
            "data.dataset": name, "data.path": path,
            "data.seq_len": "16", "data.vocab_size": str(V)})
        d = cfg.data
        spec = tdata.get_dataset(name, seed=0, batch_size=1,
                                 seq_len=d.seq_len,
                                 vocab_size=d.vocab_size, path=d.path).spec
        assert tflops.input_spec(cfg) == (spec.x_shape, spec.x_dtype), name
    cfg = tconfig.get_config("mlp_mnist", **{
        "data.dataset": "image_folder", "data.image_size": "40"})
    assert tflops.input_spec(cfg)[0] == (40, 40, 3)
    cfg.data.dataset = "cifar10_bin"
    assert tflops.input_spec(cfg)[0] == (32, 32, 3)


# --------------------------------------------------------------------------
# the transformer LM trained from a token file, against the JAX Trainer
# --------------------------------------------------------------------------

TINY_LM = {"num_layers": 2, "d_model": 32, "num_heads": 4, "mlp_dim": 64,
           "vocab_size": V, "max_len": 64}


def _lm_overrides(path, **more):
    return {"mesh.pipe": "1", "parallel.strategy": "single",
            "data.dataset": "token_file", "data.path": path,
            "data.holdout_frac": "0.1", "data.batch_size": "8",
            "data.seq_len": "16", "data.vocab_size": str(V),
            "data.prefetch": "0", "model.extra": json.dumps(TINY_LM),
            "model.compute_dtype": "float32", "model.remat": "false",
            "optim.warmup_steps": "1", "steps": "3", "log_every": "1",
            "eval_batches": "2", **more}


def test_lm_from_a_token_file_matches_the_jax_trainer(token_files):
    ov = _lm_overrides(token_files["bin"])
    cfg = jconfig.get_config("transformer_lm_pp", **ov)
    jt = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=1),
                                      devices=jax.devices()[:1]))
    init = jax.device_get(jt.state.params)
    jt.train()
    j_eval = jt.evaluate(num_batches=2)
    jt.close()
    with Trainer(tconfig.get_config("transformer_lm_pp", **ov),
                 device="cpu", params=params_from_jax(init)) as t:
        assert isinstance(t.dataset, tdata.TokenFileDataset)
        t.train()
        ev = t.evaluate(num_batches=2)
    np.testing.assert_allclose(t.losses(), jt.losses(), rtol=1e-6)
    np.testing.assert_allclose(ev.loss, j_eval.loss, rtol=1e-6)
    assert ev.accuracy == pytest.approx(j_eval.accuracy, abs=1e-6)
    assert ev.loss != pytest.approx(t.losses()[-1], rel=1e-3)


def test_pipeline_on_a_token_file_resumes_bit_for_bit(token_files,
                                                      tmp_path):
    from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
        read_full_params,
    )

    ov = _lm_overrides(token_files["bin"], **{
        "mesh.pipe": "2", "parallel.strategy": "pipeline",
        "parallel.microbatches": "2", "parallel.pipeline_schedule": "1f1b",
        "steps": "4"})
    straight = Trainer(tconfig.get_config("transformer_lm_pp", **ov),
                       device="cpu")
    init = {k: v.clone() for k, v in straight.model.state_dict().items()}
    straight.train()
    ck = dict(ov, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every="2")
    with Trainer(tconfig.get_config("transformer_lm_pp", **ck),
                 device="cpu", params=init) as a:
        a.train(steps=2)
    with Trainer(tconfig.get_config("transformer_lm_pp", **ck),
                 device="cpu", params=init) as b:
        assert b.data_step == 2 and b.state.sharding.part_name == "local"
        b.train()
    assert b.losses() == straight.losses()[2:]
    want = straight.model.state_dict()
    for k, v in b.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    full = read_full_params(tmp_path / "ck")
    assert sorted(full) == sorted(want)

"""Port parity for BERT pretraining (``bert_base_buckets``, config 3): the
model, its masked-LM stream, loss and accuracy, the flax layers it is built
of, and three steps of the preset against the JAX package's ``Trainer``.

Tiny dims: 2 layers, d 32, 4 heads, MLP 64, vocab 97, T = 16. Weights are
the JAX init, carried by ``utils.interop.params_from_jax``.

Tolerances. Logits: f32 max|err| <= 1e-5 max|ref| (the two sum in another
order); bf16 <= 2e-2 max|ref| (each rounds to bf16 at other places). Three
training steps (AdamW, dp_explicit with the 100 MB bucket reduce, world 1):
f32 losses to 1e-5 relative and each parameter to 1e-4 of its largest
|value| (the attention key biases, whose gradient is zero in exact
arithmetic, to the lr's scale: ``assert_params_close``); bf16 losses to
1e-3. The loss, accuracy and data units are exact or to f32 rounding
(1e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.data import datasets as jdata
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train import losses as jlosses
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.data import datasets as tdata
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.nn import layers
from pytorch_distributed_nn_tpu_torch.train import losses as tlosses
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    params_from_jax,
    params_to_jax,
)

TINY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "mlp_dim": 64,
        "vocab_size": 97, "max_len": 32}
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _overrides(dtype, **extra):
    return {"model.extra": json.dumps({**TINY, **extra}),
            "model.compute_dtype": dtype, "data.vocab_size": "97",
            "data.seq_len": "16", "data.batch_size": "4", "steps": "3",
            "log_every": "1", "optim.warmup_steps": "1"}


def _models(dtype, **extra):
    ov = _overrides(dtype, **extra)
    jm = jget_model(jconfig.get_config("bert_base_buckets", **ov).model)
    tm = get_model(tconfig.get_config("bert_base_buckets", **ov).model,
                   device="cpu")
    return jm, tm


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_logits_match_jax(dtype):
    jm, tm = _models(dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 97, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), bool)
    mask[1, 11:] = False  # the second row is padded after 11 tokens
    params = jm.init(jax.random.key(0), jnp.asarray(toks))["params"]
    sd = params_from_jax(jax.device_get(params))
    assert sorted(sd) == sorted(tm.state_dict())  # no type_embed here
    tm.load_state_dict(sd)
    for kw_j, kw_t in (({}, {}),
                       ({"attention_mask": jnp.asarray(mask)},
                        {"attention_mask": torch.from_numpy(mask)})):
        ref = jm.apply({"params": params}, jnp.asarray(toks), **kw_j)
        got = tm(torch.from_numpy(toks), **kw_t)
        assert got.dtype == torch.float32  # the f32 mlm_decoder
        _close(got, ref, LOGIT_TOL[dtype])


def test_bert_token_types_and_max_len():
    jm, tm = _models("float32", token_types=True)
    toks = np.zeros((1, 8), np.int32)
    types = np.ones((1, 8), np.int32)
    params = jm.init(jax.random.key(1), jnp.asarray(toks),
                     token_types=jnp.asarray(types))["params"]
    sd = params_from_jax(jax.device_get(params))
    assert "type_embed.embedding" in sd
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    _close(tm(torch.from_numpy(toks), token_types=torch.from_numpy(types)),
           jm.apply({"params": params}, jnp.asarray(toks),
                    token_types=jnp.asarray(types)), 1e-5)
    _, plain = _models("float32")
    with pytest.raises(ValueError, match="token_types"):
        plain(torch.zeros((1, 4), dtype=torch.int32),
              token_types=torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="exceeds max_len"):
        plain(torch.zeros((1, 33), dtype=torch.int32))


def test_interop_round_trip_is_the_jax_tree():
    jm, _ = _models("float32")
    params = jax.device_get(
        jm.init(jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    back = params_to_jax(params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_mlm_batches_are_byte_equal():
    kw = dict(seed=5, batch_size=3, seq_len=24, vocab_size=97)
    j = jdata.get_dataset("mlm_synthetic", **kw)
    t = tdata.get_dataset("mlm_synthetic", **kw)
    for step in (0, 1, 7, tdata.EVAL_STEP_OFFSET):
        for a, b in zip(t.batch(step), j.batch(step)):
            assert a.dtype == b.dtype == np.int32
            assert a.tobytes() == b.tobytes()
    x, y = t.batch(0)
    assert (y >= 0).any() and (y < 0).any()
    assert (x[y >= 0] == 96).all()  # masked inputs are [MASK] = V - 1


def test_masked_lm_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 8, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 8)).astype(np.int32)
    labels[rng.random((2, 8)) < 0.6] = -1
    labels[0, 0] = int(logits[0, 0].argmax())  # at least one hit
    ignored = np.full((2, 8), -1, np.int32)
    for y in (labels, ignored):
        want = float(jlosses.masked_lm_xent(jnp.asarray(logits),
                                            jnp.asarray(y)))
        got = tlosses.masked_lm_xent(torch.from_numpy(logits),
                                     torch.from_numpy(y)).item()
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
        valid = y >= 0  # the JAX trainer's eval accuracy
        hit = np.logical_and(logits.argmax(-1) == y, valid)
        acc = tlosses.accuracy(torch.from_numpy(logits),
                               torch.from_numpy(y)).item()
        assert acc == pytest.approx(hit.sum() / max(valid.sum(), 1),
                                    abs=1e-7)
    assert tlosses.masked_lm_xent(torch.from_numpy(logits),
                                  torch.from_numpy(ignored)).item() == 0.0
    assert tlosses.get_loss_fn("mlm_synthetic") is tlosses.masked_lm_xent


def test_layernorm_and_gelu_match_flax():
    from flax import linen as nn

    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 16)) * 3 + 2).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-12)
    p = ln.init(jax.random.key(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(
        np.float32), p)
    t = layers.LayerNorm(16, eps=1e-12, dtype=torch.float32)
    t.load_state_dict(params_from_jax(jax.device_get(p["params"])))
    _close(t(torch.from_numpy(x)), ln.apply(p, jnp.asarray(x)), 1e-6)
    _close(layers.gelu(torch.from_numpy(x)), nn.gelu(jnp.asarray(x)), 1e-6)


def test_dropout_keeps_its_rate_and_is_off_at_eval():
    drop = layers.Dropout(0.25, salt=3)
    x = torch.ones((200, 500))
    with layers.dropout_stream(1, 7):
        a = drop(x)
        b = drop(x)
    with layers.dropout_stream(1, 8):
        c = drop(x)
    keep = (a != 0).float().mean().item()
    assert abs(keep - 0.75) < 0.01  # 1e5 draws: sigma 1.4e-3
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert torch.equal(a, b) and not torch.equal(a, c)  # keyed by the step
    drop.eval()
    assert drop(x) is x  # eval: the identity, no stream needed
    drop.train()
    with pytest.raises(RuntimeError, match="dropout_stream"):
        drop(x)


def test_dropout_masks_survive_remat():
    """A block recomputed in the backward (remat) redraws the same mask:
    the gradients equal those of the same step without remat."""
    ov = {"model.extra": json.dumps({**TINY, "dropout": 0.3}),
          "model.compute_dtype": "float32", "data.vocab_size": "97",
          "data.seq_len": "16", "data.batch_size": "2"}
    grads = {}
    for remat in (False, True):
        cfg = tconfig.get_config("transformer_lm_pp", **{
            **ov, "mesh.pipe": "1", "parallel.strategy": "dp",
            "model.remat": str(remat)})
        t = Trainer(cfg, device="cpu")
        x, y = t.loader.batch_at(0)
        from pytorch_distributed_nn_tpu_torch.parallel import dp

        dp._loss_and_grads(t.state, x, y, t.loss_fn)
        grads[remat] = {n: p.grad.clone()
                        for n, p in t.model.named_parameters()}
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=1e-5, atol=1e-6)


def assert_params_close(state_dict, j_final, j_init, *, peak_lr):
    """Every parameter to 1e-4 of its largest |value|, and at least one
    moved. The attention key biases are the exception: softmax is
    invariant to a shift of a row's logits, so their gradient is zero in
    exact arithmetic and AdamW turns each framework's rounding noise into
    steps of up to ~lr of either sign; they are held to that scale."""
    want = params_from_jax(j_final)
    start = params_from_jax(j_init)
    assert sorted(want) == sorted(state_dict)
    moved = 0.0
    for name, b in want.items():
        a = state_dict[name].detach().float().numpy()
        b = b.float().numpy()
        if name.endswith("attn.key.bias"):
            assert np.abs(a).max() <= 3 * peak_lr, name
            assert np.abs(b).max() <= 3 * peak_lr, name
            continue
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)
        moved = max(moved, float(np.abs(b - start[name].numpy()).max()))
    assert moved > 1e-5


def _jax_run(dtype):
    cfg = jconfig.get_config("bert_base_buckets", **_overrides(dtype))
    trainer = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=1),
                                           devices=jax.devices()[:1]))
    init = jax.device_get(trainer.state.params)
    trainer.train()
    final = jax.device_get(trainer.state.params)
    ev = trainer.evaluate(num_batches=2)
    trainer.close()
    return init, trainer.losses(), final, ev


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_jax_trainer(dtype):
    init, j_losses, j_final, j_eval = _jax_run(dtype)
    cfg = tconfig.get_config("bert_base_buckets", **_overrides(dtype))
    assert (cfg.parallel.strategy, cfg.parallel.bucket_mb,
            cfg.parallel.overlap) == ("dp_explicit", 100.0, True)
    trainer = Trainer(cfg, device="cpu", params=params_from_jax(init))
    trainer.train()
    losses = trainer.losses()
    assert len(losses) == len(j_losses) == 3
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, j_losses,
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    if dtype == "float32":
        final = params_to_jax(trainer.model.state_dict())
        assert jax.tree.structure(final) == jax.tree.structure(j_final)
        assert_params_close(trainer.model.state_dict(), j_final, init,
                            peak_lr=cfg.optim.lr)
        got = trainer.evaluate(num_batches=2)  # the masked accuracy
        np.testing.assert_allclose(got.loss, j_eval.loss, rtol=1e-5)
        assert got.accuracy == pytest.approx(j_eval.accuracy, abs=1e-6)


def test_train_entry_prints_the_final_line(capsys):
    from pytorch_distributed_nn_tpu_torch.train.__main__ import main

    argv = ["--preset", "bert_base_buckets", "--device", "cpu", "--steps",
            "2"]
    for k, v in _overrides("float32").items():
        if k != "steps":
            argv += [f"--{k}", v]
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("final: step=1 loss=")
    assert np.isfinite(float(out[-1].split("loss=")[1]))


@pytest.mark.parametrize("shape", [(32, 32, 3), (28, 28)])
def test_vit_logits_match_jax(shape):
    """ViT (no preset uses it) at f32: the patch convolution's kernel goes
    HWIO -> OIHW in ``params_from_jax``; grayscale (B, H, W) batches get a
    channel. Tolerance 1e-5 max|ref|, as BERT's."""
    extra = {"num_layers": 2, "d_model": 32, "num_heads": 4, "mlp_dim": 64,
             "patch_size": 4, "num_classes": 10}
    mcfg = {"name": "vit", "compute_dtype": "float32", "extra": extra}
    jm = jget_model(jconfig.ModelConfig(**mcfg))
    tm = get_model(tconfig.ModelConfig(**mcfg), device="cpu",
                   input_shape=shape)
    x = np.random.default_rng(6).standard_normal((3, *shape)).astype(
        np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    sd = params_from_jax(jax.device_get(params))
    assert sd["patch_embed.kernel"].shape == (32, 1 if len(shape) == 2
                                              else 3, 4, 4)
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    _close(tm(torch.from_numpy(x)), jm.apply({"params": params},
                                              jnp.asarray(x)), 1e-5)
    back = params_to_jax(tm.state_dict())
    np.testing.assert_array_equal(back["patch_embed"]["kernel"],
                                  np.asarray(params["patch_embed"]["kernel"]))
    tm.init_params(seed=1)  # the port's own seeded init runs too
    assert float(tm.pos_embed.detach().std()) < 0.05 and not tm.cls.any()

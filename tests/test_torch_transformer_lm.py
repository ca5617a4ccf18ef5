"""Port parity for config 4's model, the transformer LM
(``transformer_lm_pp`` with ``--mesh.pipe 1 --parallel.strategy dp``: the
pipeline schedule is not ported yet).

- Logits against the JAX module from the same weights, with
  ``attn_impl="flash"`` at head_dim 64 (d 128, 2 heads): the port's flash
  wrappers run their plain versions on the CPU; the JAX side runs its
  Pallas kernels in interpret mode (``_interpret_flash``, as
  ``tests/test_torch_flash.py`` runs them), which off the TPU it otherwise
  replaces by its jnp reference.
- Three steps of the preset (adam, remat, dense loss) against the JAX
  ``Trainer`` at tiny dims (2 layers, d 32, 4 heads, vocab 97, T = 16).

Tolerances: logits f32 max|err| <= 1e-5 max|ref|, bf16 <= 2e-2 max|ref|;
training f32 losses to 1e-5 relative and each parameter to 1e-4 of its
largest |value| (the attention key biases, whose gradient is zero in exact
arithmetic, to the lr's scale), bf16 losses to 1e-3.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.ops.pallas import flash_attention as jflash
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import params_from_jax
from test_torch_bert import assert_params_close

TINY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "mlp_dim": 64,
        "vocab_size": 97, "max_len": 32}
D64 = {"num_layers": 2, "d_model": 128, "num_heads": 2, "mlp_dim": 256,
       "vocab_size": 97, "max_len": 64, "attn_impl": "flash"}
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ONE_CARD = {"mesh.pipe": "1", "parallel.strategy": "dp"}


def _overrides(dtype, extra=TINY):
    return {"model.extra": json.dumps(extra), "model.compute_dtype": dtype,
            "data.vocab_size": "97", "data.seq_len": "16",
            "data.batch_size": "4", "steps": "3", "log_every": "1",
            "optim.warmup_steps": "1", **ONE_CARD}


class _TpuBackend:
    """``jax`` as the JAX flash module sees it, reporting a TPU backend so
    that ``flash_attention`` takes its Pallas path."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture()
def _interpret_flash(monkeypatch):
    monkeypatch.setattr(jflash, "jax", _TpuBackend())
    monkeypatch.setattr(jflash, "_flash_bhtd",
                        functools.partial(jflash._flash_bhtd, interpret=True))
    monkeypatch.setattr(jflash, "_flash_bwd_pallas", functools.partial(
        jflash._flash_bwd_pallas, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax_with_flash_at_head_dim_64(dtype, _interpret_flash):
    ov = _overrides(dtype, D64)
    jm = jget_model(jconfig.get_config("transformer_lm_pp", **ov).model)
    tm = get_model(tconfig.get_config("transformer_lm_pp", **ov).model,
                   device="cpu")
    assert tm.head_dim == 64
    toks = np.random.default_rng(1).integers(0, 97, (2, 32)).astype(np.int32)
    params = jm.init(jax.random.key(0), jnp.asarray(toks))["params"]
    sd = params_from_jax(jax.device_get(params))
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    calls = []
    orig = jflash._flash_bhtd
    jflash._flash_bhtd = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)),
                         np.float32)
    finally:
        jflash._flash_bhtd = orig
    assert len(calls) == 2  # the Pallas kernel, once a layer
    got = tm(torch.from_numpy(toks)).detach().float().numpy()
    err = np.abs(got - ref).max()
    assert err <= LOGIT_TOL[dtype] * np.abs(ref).max(), err
    # the hidden path the chunked loss reads: ln_f'd, before the head
    hidden = tm(torch.from_numpy(toks), return_hidden=True)
    torch.testing.assert_close(hidden.float() @ tm.lm_head.kernel,
                               torch.from_numpy(got), rtol=1e-5, atol=1e-5)


def test_preset_and_its_limits():
    cfg = tconfig.get_config("transformer_lm_pp")
    want = jconfig.get_config("transformer_lm_pp")
    for section in ("optim", "data", "parallel", "mesh"):
        g = vars(getattr(cfg, section))
        w = vars(getattr(want, section))
        assert g == {k: w[k] for k in g}, section
    assert vars(cfg.model) == vars(want.model)
    assert (cfg.parallel.microbatches, cfg.parallel.pipeline_schedule,
            cfg.mesh.pipe) == (8, "gpipe", 4)
    # the preset's pipeline over mesh.pipe = 4 builds (every stage in this
    # one process); a tensor axis of 2 cannot span one process
    pp = {k: v for k, v in _overrides(
        "float32", dict(TINY, num_layers=4)).items() if k not in ONE_CARD}
    pp["data.batch_size"] = "8"
    t = Trainer(tconfig.get_config("transformer_lm_pp", **pp), device="cpu")
    assert t.state.sharding.S == 4 and t.mesh.pipe_local
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        Trainer(tconfig.get_config("transformer_lm_pp", **pp,
                                   **{"mesh.tensor": "2"}), device="cpu")
    tm = get_model(tconfig.get_config("transformer_lm_pp", **_overrides(
        "float32")).model, device="cpu").init_params(seed=0)
    # the decode cache: a prefill through it gives the full forward's
    # logits (tests/test_torch_kv_cache.py holds it against the JAX LM)
    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )

    toks = torch.arange(1, 5, dtype=torch.int32)[None]
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(toks, cache=init_cache(tm, 1, 4)).numpy(), tm(toks).numpy(),
            rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tm(torch.zeros((1, 33), dtype=torch.int32))


def _jax_run(dtype):
    cfg = jconfig.get_config("transformer_lm_pp", **_overrides(dtype))
    trainer = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=1),
                                           devices=jax.devices()[:1]))
    init = jax.device_get(trainer.state.params)
    trainer.train()
    final = jax.device_get(trainer.state.params)
    trainer.close()
    return init, trainer.losses(), final


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_jax_trainer(dtype):
    init, j_losses, j_final = _jax_run(dtype)
    cfg = tconfig.get_config("transformer_lm_pp", **_overrides(dtype))
    assert cfg.model.remat and cfg.optim.name == "adam"
    trainer = Trainer(cfg, device="cpu", params=params_from_jax(init))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches)
    trainer.train()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches) == before
    losses = trainer.losses()
    assert len(losses) == len(j_losses) == 3
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, j_losses,
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    if dtype == "float32":
        assert_params_close(trainer.model.state_dict(), j_final, init,
                            peak_lr=cfg.optim.lr)


def test_chunked_loss_equals_the_dense_loss():
    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )

    cfg = tconfig.get_config("transformer_lm_pp", **_overrides("float32"))
    t = Trainer(cfg, device="cpu")
    x, y = t.loader.batch_at(0)
    out = {}
    for name, fn in (("dense", t.loss_fn), ("chunked", make_chunked_loss(4))):
        loss = dp._loss_and_grads(t.state, x, y, fn)
        out[name] = (loss, {n: p.grad.clone()
                            for n, p in t.model.named_parameters()})
        t.state.optimizer.zero_grad()
    torch.testing.assert_close(out["chunked"][0], out["dense"][0],
                               rtol=1e-6, atol=0)
    for n, g in out["dense"][1].items():
        torch.testing.assert_close(out["chunked"][1][n], g, rtol=1e-5,
                                   atol=1e-6)


def test_train_entry_prints_the_final_line(capsys):
    from pytorch_distributed_nn_tpu_torch.train.__main__ import main

    argv = ["--preset", "transformer_lm_pp", "--device", "cpu", "--steps",
            "2"]
    for k, v in _overrides("float32").items():
        if k != "steps":
            argv += [f"--{k}", v]
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("final: step=1 loss=")
    assert np.isfinite(float(out[-1].split("loss=")[1]))

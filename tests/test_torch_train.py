"""Port parity for the slice as a whole: ``llama3_longcontext`` trained for
3 steps by the JAX package's ``Trainer`` and by the port's ``Trainer`` from
the same initial weights (the JAX init, carried by ``utils.interop``) on
the same batches.

Tiny dims: 2 layers, d 64, 4/2 heads, MLP 128, vocab 512, T = 256 with
``xent_chunk`` 64 (so the chunked loss runs), flash attention, remat on.
Off the TPU the JAX flash path is its plain reference; the port's is its
plain versions (the CPU tensors select them).

Tolerances. f32 compute: the two sum in another order, so per-step losses
agree to 1e-5 relative and the parameters after 3 AdamW steps to 1e-4.
bf16 compute: each framework rounds to bf16 at other places, 2e-2 on the
losses.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
    llama_params_to_jax,
)

EXTRA = ('{"num_layers": 2, "d_model": 64, "num_heads": 4, '
         '"num_kv_heads": 2, "mlp_dim": 128, "vocab_size": 512, '
         '"attn_impl": "flash"}')


def _overrides(dtype):
    return {"model.extra": EXTRA, "model.compute_dtype": dtype,
            "data.vocab_size": "512", "data.seq_len": "256",
            "xent_chunk": "64", "steps": "3", "log_every": "1"}


def _jax_run(dtype):
    cfg = jconfig.get_config("llama3_longcontext", **_overrides(dtype))
    trainer = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=1),
                                           devices=jax.devices()[:1]))
    init = jax.device_get(trainer.state.params)  # before donation
    trainer.train()
    final = jax.device_get(trainer.state.params)
    trainer.close()
    return init, trainer.losses(), final


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_jax_trainer(dtype):
    init, j_losses, j_final = _jax_run(dtype)
    cfg = tconfig.get_config("llama3_longcontext", **_overrides(dtype))
    assert cfg.model.remat and cfg.xent_chunk < cfg.data.seq_len
    trainer = Trainer(cfg, device="cpu", params=llama_params_from_jax(init))
    trainer.train()
    losses = trainer.losses()
    assert len(losses) == len(j_losses) == 3
    assert np.all(np.isfinite(losses))
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(losses, j_losses, rtol=rtol)
    if dtype == "float32":
        final = llama_params_to_jax(trainer.model.state_dict())
        assert (jax.tree.structure(final) == jax.tree.structure(j_final))
        for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(j_final)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        # the weights moved: the comparison is not of two initial trees
        moved = [np.abs(a - b).max() for a, b in
                 zip(jax.tree.leaves(final), jax.tree.leaves(init))]
        assert max(moved) > 1e-5


def test_evaluate_matches_the_jax_trainer():
    ov = _overrides("float32")
    jcfg = jconfig.get_config("llama3_longcontext", **ov)
    jt = JTrainer(jcfg, mesh=make_mesh(JMeshSpec(data=1),
                                       devices=jax.devices()[:1]))
    init = jax.device_get(jt.state.params)
    want = jt.evaluate(num_batches=2)
    jt.close()
    t = Trainer(tconfig.get_config("llama3_longcontext", **ov), device="cpu",
                params=llama_params_from_jax(init))
    got = t.evaluate(num_batches=2)
    assert got.step == want.step == -1
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
    assert got.accuracy == pytest.approx(want.accuracy, abs=1e-6)


def test_train_entry_prints_the_final_line(capsys):
    from pytorch_distributed_nn_tpu_torch.train.__main__ import main

    argv = ["--preset", "llama3_longcontext", "--device", "cpu",
            "--steps", "2"]
    for k, v in _overrides("float32").items():
        if k != "steps":
            argv += [f"--{k}", v]
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("final: step=1 loss=")
    assert np.isfinite(float(out[-1].split("loss=")[1]))


def test_trainer_runs_on_cpu_without_flash_launches():
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    cfg = tconfig.get_config("llama3_longcontext", **_overrides("float32"))
    t = Trainer(cfg, device="cpu")
    t.train(steps=1)
    assert t.data_step == 1 and t.state.step == 1
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before
    assert all(p.grad is None for p in t.model.parameters())
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in t.model.parameters())

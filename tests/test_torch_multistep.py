"""The multistep loop in the port (``train/multistep.py``, the
``Trainer``'s ``multistep_k``/``multistep_pool``): the cases of the JAX
package's ``tests/test_multistep.py``. On the CPU the k steps are a loop;
on the card one CUDA graph (``tests/test_torch_cuda.py`` holds that one
bit for bit against eager steps).

``mlp_mnist`` at a tiny width (features (64, 10), batch 32). Within the
port every comparison is bit for bit: the same steps on the same batches.
Against the JAX ``Trainer``'s multistep run (a ``lax.scan``) from the same
initial weights: f32 losses to 1e-5 relative
(``tests/test_torch_train.py``'s tolerance).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.train.multistep import make_multistep
from pytorch_distributed_nn_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    vision_params_from_jax,
)

OV = {"data.prefetch": "0", "data.batch_size": "32",
      "model.extra": '{"features": [64, 10]}',
      "optim.warmup_steps": "3", "optim.schedule": "cosine"}


def _trainer(**ov):
    return Trainer(tconfig.get_config("mlp_mnist", **{**OV, **ov}),
                   device="cpu")


def _equal_params(a, b):
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_multistep_matches_sequential():
    t = _trainer(steps="4")
    batches = [t.loader.batch_at(i) for i in range(4)]
    state = t.state
    for x, y in batches:
        state, metrics = t.step_fn(state, x, y)
    t2 = _trainer(steps="4")
    xs = torch.stack([b[0] for b in batches])
    ys = torch.stack([b[1] for b in batches])
    _, metrics2 = make_multistep(t2.step_fn, 4)(t2.state, xs, ys)
    assert torch.equal(metrics2["loss"], metrics["loss"])
    assert metrics2["all"]["loss"].shape == (4,)
    _equal_params(t, t2)
    assert t2.state.step == 4 and t2.state.optimizer.count == 4


def test_multistep_cycles_a_small_pool():
    t = _trainer(steps="4")
    batches = [t.loader.batch_at(i) for i in range(2)]
    state = t.state
    for i in range(4):
        state, metrics = t.step_fn(state, *batches[i % 2])
    t2 = _trainer(steps="4")
    xs = torch.stack([b[0] for b in batches])
    ys = torch.stack([b[1] for b in batches])
    _, metrics2 = make_multistep(t2.step_fn, 4)(t2.state, xs, ys)
    assert torch.equal(metrics2["loss"], metrics["loss"])
    _equal_params(t, t2)


def test_multistep_rejects_a_bad_k_and_an_oversize_pool():
    with pytest.raises(ValueError):
        make_multistep(lambda s, x, y: (s, {}), 0)
    with pytest.raises(ValueError, match="pool"):
        make_multistep(lambda s, x, y: (s, {"loss": torch.zeros(())}), 2)(
            None, torch.zeros(4, 2), torch.zeros(4, 2))


def test_the_trainer_multistep_matches_the_per_step_loop_and_jax():
    base = {"steps": "12", "log_every": "3"}
    jt = JTrainer(jconfig.get_config("mlp_mnist", **OV, **base,
                                     multistep_k=5),
                  mesh=make_mesh(MeshSpec(data=1), devices=jax.devices()[:1]))
    init = vision_params_from_jax(jax.device_get(jt.state.params), None)
    j_hist = jt.train()  # dispatches of 5, 5, 2
    jt.close()
    cfg = tconfig.get_config("mlp_mnist", **OV, **base)
    ref = Trainer(cfg, device="cpu", params=init)
    ref_hist = ref.train()
    fused = Trainer(cfg.override(multistep_k="5"), device="cpu", params=init)
    fused_hist = fused.train()
    assert sorted(fused._multisteps) == [2, 5]
    _equal_params(ref, fused)
    assert [r.step for r in fused_hist] == [r.step for r in ref_hist] \
        == [r.step for r in j_hist] == [0, 3, 6, 9, 11]
    assert [r.loss for r in fused_hist] == [r.loss for r in ref_hist]
    np.testing.assert_allclose([r.loss for r in fused_hist],
                               [r.loss for r in j_hist], rtol=1e-5)


def test_checkpoint_and_eval_cadences_round_up_to_the_dispatch(tmp_path):
    cfg = tconfig.get_config("mlp_mnist", **OV, steps="10", log_every="0",
                             multistep_k="4", checkpoint_dir=str(tmp_path),
                             checkpoint_every="5", eval_every="5",
                             eval_batches="1")
    with Trainer(cfg, device="cpu") as t:
        t.train()  # windows end at 4, 8, 10: every=5 fires at 8 and 10
    assert t.ckpt.all_steps() == [8, 10]
    assert [r.step for r in t.eval_history] == [7, 9]
    with Trainer(cfg, device="cpu") as restored:  # resume=True
        assert restored.data_step == 10
        restored.train()  # the budget is spent
        assert restored.data_step == 10 and not restored.history


def test_pool_mode_repeats_the_pool():
    t = _trainer(steps="9", log_every="0", multistep_k="3",
                 multistep_pool="2")
    generated = []
    orig = t.dataset.batch
    t.dataset.batch = lambda s: (generated.append(s), orig(s))[1]
    t.train()
    assert t.data_step == 9 and t.state.step == 9
    assert float(t.last_metrics["loss"]) > 0
    assert generated == [0, 1]  # pool-many batches, made once


def test_the_update_reads_the_row_it_is_given():
    """What a captured update reads (``Optimizer.reading``) is the table's
    row: the same update bit for bit."""
    cfg = tconfig.get_config("llama3_longcontext").optim  # adamw, cosine
    torch.manual_seed(0)
    p0 = [torch.randn(5, 4), torch.randn(3)]
    grads = [torch.randn(5, 4), torch.randn(3)]
    runs = []
    for captured in (False, True):
        params = [torch.nn.Parameter(p.clone()) for p in p0]
        opt = make_optimizer(cfg, params, total_steps=4)
        rows = opt.hyper(0, 6).clone()  # beyond total_steps: grown
        assert rows.shape == (6, 6) and rows.dtype == torch.float32
        for i in range(6):
            for p, g in zip(params, grads):
                p.grad = g.clone()
            if captured:
                with opt.reading(rows[i]):
                    opt.step()
            else:
                opt.step()
        runs.append(params)
    for a, b in zip(*runs):
        assert torch.equal(a, b)

"""Port parity for the data-parallel vision slice, against the JAX package
on the same numpy inputs and the same initial weights (the JAX init,
carried by ``utils.interop``):

- the class-template image datasets, byte for byte, and each rank's rows;
- the MLP, LeNet (NHWC flatten) and ResNet (both stems, train and eval
  BatchNorm) forwards: f32 logits to 1e-5 of the largest (the same f32
  products summed in another order by two convolution libraries), 1e-4
  with batch statistics over 3 examples;
- the space-to-depth stem and its kernel rewrite, exactly;
- ``softmax_xent``, and the sgd / momentum / weight-decay / step-schedule
  optimizers against optax (1e-6);
- the three ``Trainer`` steps against the JAX ``Trainer`` are in
  ``test_torch_vision_trainer.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.data import datasets as jdata
from pytorch_distributed_nn_tpu.models import lenet as jlenet
from pytorch_distributed_nn_tpu.models import mlp as jmlp
from pytorch_distributed_nn_tpu.models import resnet as jresnet
from pytorch_distributed_nn_tpu.train import losses as jlosses
from pytorch_distributed_nn_tpu.train import optim as joptim
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.data import datasets as tdata
from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
from pytorch_distributed_nn_tpu_torch.models import lenet as tlenet
from pytorch_distributed_nn_tpu_torch.models import mlp as tmlp
from pytorch_distributed_nn_tpu_torch.models import resnet as tresnet
from pytorch_distributed_nn_tpu_torch.train import losses as tlosses
from pytorch_distributed_nn_tpu_torch.train import optim as toptim
from pytorch_distributed_nn_tpu_torch.utils import flops as tflops
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    vision_params_from_jax,
    vision_params_to_jax,
)

TINY = {"stage_sizes": [1, 1, 1, 1], "width": 8, "num_classes": 10}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", ["mnist", "cifar10", "imagenet_synthetic"])
def test_image_batches_are_byte_equal(name):
    kw = dict(seed=5, batch_size=3)
    j = jdata.get_dataset(name, **kw)
    t = tdata.get_dataset(name, **kw)
    assert t.spec.x_shape == j.spec.x_shape
    assert t.spec.num_classes == j.spec.num_classes
    for step in (0, 1, tdata.EVAL_STEP_OFFSET):
        for a, b in zip(t.batch(step), j.batch(step)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_loader_gives_each_rank_its_rows():
    ds = tdata.get_dataset("cifar10", seed=1, batch_size=8)
    x, y = ds.batch(3)
    for rank in range(4):
        loader = DataLoader(ds, torch.device("cpu"), data_index=rank,
                            data_degree=4, prefetch=0)
        xr, yr = loader.batch_at(3)
        np.testing.assert_array_equal(xr.numpy(), x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(yr.numpy(), y[2 * rank:2 * rank + 2])


def _jax_init(model, x, **kw):
    variables = model.init(jax.random.key(1), jnp.asarray(x[:1]),
                           train=False, **kw)
    return jax.device_get(variables)


def _port(model, variables):
    model.load_state_dict(vision_params_from_jax(
        variables["params"], variables.get("batch_stats")))
    return model


def test_mlp_forward_matches_jax():
    x = np.random.RandomState(0).randn(5, 28, 28).astype(np.float32)
    jm = jmlp.MLP(features=(32, 10))
    v = _jax_init(jm, x)
    tm = _port(tmlp.MLP(784, (32, 10), device="cpu"), v)
    _close(tm(torch.from_numpy(x)).detach(), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(28, 28), (32, 32, 3)])
def test_lenet_flattens_in_nhwc_order(shape):
    x = np.random.RandomState(1).randn(4, *shape).astype(np.float32)
    jm = jlenet.LeNet()
    v = _jax_init(jm, x)
    tm = _port(tlenet.LeNet(shape, device="cpu"), v)
    assert tm.Conv_0.kernel.shape == (6, shape[-1] if len(shape) == 3 else 1,
                                      5, 5)
    got = tm(torch.from_numpy(x)).detach()
    _close(got, jm.apply(v, jnp.asarray(x)))
    # the same dense kernel read in NCHW flatten order gives other logits:
    # the order is what the test holds
    k = tm.Dense_0.kernel.detach()
    c, hw = 16, k.shape[0] // 16
    with torch.no_grad():
        tm.Dense_0.kernel.copy_(k.reshape(hw, c, -1).transpose(0, 1)
                                .reshape(k.shape))
    assert not np.allclose(tm(torch.from_numpy(x)).detach(), got, atol=1e-3)


@functools.lru_cache(maxsize=None)
def _resnet_pair(stem):
    x = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    jm = jresnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                        stem=stem)
    v = _jax_init(jm, x)
    return x, jm, v


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("bn_impl", ["flax", "pallas"])
def test_resnet_forward_matches_jax(stem, bn_impl):
    x, jm, v = _resnet_pair(stem)
    tm = _port(tresnet.ResNet((1, 1, 1, 1), width=8, num_classes=10,
                              stem=stem, bn_impl=bn_impl,
                              dtype=torch.float32, device="cpu"), v)
    tm.eval()  # running statistics (the init's 0 and 1)
    _close(tm(torch.from_numpy(x)).detach(), jm.apply(v, jnp.asarray(x)))
    tm.train()  # batch statistics; the running ones move as flax's do
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    # 1e-4: the last stage normalises 3 values a channel (a 1x1 map), and
    # flax's (x - mean) * rsig rounds otherwise than x * a + b
    _close(tm(torch.from_numpy(x)).detach(), want, 1e-4)
    _, stats = vision_params_to_jax(tm.state_dict())
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(upd["batch_stats"])):
        _close(a, b)


def test_space_to_depth_stem_matches_jax_exactly():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tresnet.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jresnet.space_to_depth(jnp.asarray(x))))
    k7 = rng.randn(7, 7, 3, 5).astype(np.float32)
    k4 = tresnet.conv7_to_s2d_kernel(torch.from_numpy(k7))
    np.testing.assert_array_equal(
        k4.numpy(), np.asarray(jresnet.conv7_to_s2d_kernel(jnp.asarray(k7))))
    np.testing.assert_array_equal(tresnet.s2d_kernel_to_conv7(k4).numpy(),
                                  k7)
    # the rewritten stem computes the 7x7 stem's map
    _, _, v = _resnet_pair("conv7")
    x, _, _ = _resnet_pair("s2d")
    params = jax.tree.map(np.asarray, v["params"])
    k = params.pop("conv_init")["kernel"]
    params["conv_init_s2d"] = {"kernel": np.asarray(
        jresnet.conv7_to_s2d_kernel(jnp.asarray(k)))}
    models = {}
    for stem, p in (("conv7", v["params"]), ("s2d", params)):
        models[stem] = _port(tresnet.ResNet(
            (1, 1, 1, 1), width=8, num_classes=10, stem=stem,
            dtype=torch.float32, device="cpu").eval(),
            {"params": p, "batch_stats": v["batch_stats"]})
    _close(models["s2d"](torch.from_numpy(x)).detach(),
           models["conv7"](torch.from_numpy(x)).detach(), 1e-4)


def test_interop_round_trips_params_and_batch_stats():
    _, _, v = _resnet_pair("conv7")
    params, stats = vision_params_to_jax(vision_params_from_jax(
        v["params"], v["batch_stats"]))
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_softmax_xent_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 10).astype(np.float32) * 3
    y = rng.randint(0, 10, size=6).astype(np.int32)
    got = tlosses.softmax_xent(torch.from_numpy(logits), torch.from_numpy(y))
    _close(got.item(), jlosses.softmax_xent(jnp.asarray(logits),
                                            jnp.asarray(y)), 1e-6)
    assert tlosses.get_loss_fn("imagenet_synthetic") is tlosses.softmax_xent


@pytest.mark.parametrize("kw", [
    dict(name="sgd", lr=0.1),
    dict(name="momentum", lr=0.05, momentum=0.9, weight_decay=1e-2),
    dict(name="momentum", lr=0.1, momentum=0.8, warmup_steps=1,
         schedule="step", step_milestones=(0.25, 0.5), step_gamma=0.5),
])
def test_sgd_and_momentum_match_optax(kw):
    total = 6
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    tx = joptim.make_optimizer(jconfig.OptimConfig(**kw), total)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = toptim.make_optimizer(tconfig.OptimConfig(**kw), tp.values(),
                                total)
    for i in range(total):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        opt.zero_grad()
        for k, p in tp.items():
            _close(p.detach().numpy(), jp[k], 1e-6)


def test_step_schedule_matches_optax():
    kw = dict(name="momentum", lr=0.4, warmup_steps=2, schedule="step",
              step_milestones=(0.5, 0.5, 0.75), step_gamma=0.1)
    for total in (3, 10, 17):
        j = joptim.make_schedule(jconfig.OptimConfig(**kw), total)
        t = toptim.make_schedule(tconfig.OptimConfig(**kw), total)
        for count in range(total + 2):
            assert t(count) == pytest.approx(float(j(count)), rel=1e-6)


def test_resnet_flops_are_the_published_resnet50_count():
    # torchvision's ResNet-50: 4.09 GMACs forward at 224x224
    assert tflops.resnet_forward_flops() == pytest.approx(2 * 4.089e9,
                                                          rel=1e-3)
    assert tflops.resnet_train_flops_per_example() == \
        3 * tflops.resnet_forward_flops()
    s2d = tflops.resnet_forward_flops(stem="s2d")
    assert s2d - tflops.resnet_forward_flops() == \
        2 * 112 * 112 * 64 * 3 * (64 - 49)  # the s2d stem's zero taps


def test_vision_presets_match_jax():
    for preset in ("mlp_mnist", "lenet_cifar10", "resnet50_dp"):
        got, want = tconfig.get_config(preset), jconfig.get_config(preset)
        for section in ("optim", "data", "model", "parallel"):
            g = vars(getattr(got, section))
            w = vars(getattr(want, section))
            assert g == {k: w[k] for k in g}, (preset, section)
        assert got.steps == want.steps

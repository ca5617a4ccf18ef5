"""Port parity for BatchNorm: the ``bn_stats`` reductions and
``batch_norm_train`` / ``TpuBatchNorm`` against the JAX package's, on the
same numpy inputs.

Off the TPU the JAX ``sum_and_sumsq`` / ``sum_and_dot`` run their jnp path,
which the JAX package's own tests use; the port's CPU tensors select its
plain versions. Tolerances: f32 sums agree to 1e-6 relative (the same f32
terms summed in another order); the f32 BatchNorm forward, its three
gradients and the running statistics to 1e-5; in bf16 the output is
rounded to bf16 once on both sides (one bf16 step, 2^-7 relative, of the
largest element) and the f32 gradients of scale and bias agree to 1e-4
relative (their sums read the same bf16 inputs in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.nn import batchnorm as jbn
from pytorch_distributed_nn_tpu.ops.pallas import bn_stats as jstats
from pytorch_distributed_nn_tpu_torch.nn import batchnorm as tbn
from pytorch_distributed_nn_tpu_torch.ops import bn_stats as tstats

# (..., C) shapes: C < 128 (the TPU kernel's lane fold), C not a multiple of
# anything, M ragged and M smaller than the TPU's fold
SHAPES = [(2, 5, 5, 8), (37, 64), (3, 7, 96), (4, 3, 3, 200), (3, 1, 1, 64),
          (13, 3)]


def _rand(shape, seed, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + shift).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_sum_and_sumsq_matches_jax(shape):
    x = _rand(shape, 0, shift=0.3)
    s1, s2 = tstats.sum_and_sumsq(torch.from_numpy(x))
    j1, j2 = jstats.sum_and_sumsq(jnp.asarray(x))
    assert s1.dtype == s2.dtype == torch.float32
    assert s1.shape == (shape[-1],)
    np.testing.assert_allclose(s1.numpy(), np.asarray(j1), rtol=1e-6,
                               atol=1e-6 * np.abs(x).sum(
                                   tuple(range(x.ndim - 1))).max())
    np.testing.assert_allclose(s2.numpy(), np.asarray(j2), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_sum_and_dot_matches_jax(shape):
    a, b = _rand(shape, 1), _rand(shape, 2, shift=-0.2)
    s1, s2 = tstats.sum_and_dot(torch.from_numpy(a), torch.from_numpy(b))
    j1, j2 = jstats.sum_and_dot(jnp.asarray(a), jnp.asarray(b))
    axes = tuple(range(a.ndim - 1))
    np.testing.assert_allclose(s1.numpy(), np.asarray(j1), rtol=1e-6,
                               atol=1e-6 * np.abs(a).sum(axes).max())
    np.testing.assert_allclose(s2.numpy(), np.asarray(j2), rtol=1e-6,
                               atol=1e-6 * np.abs(a * b).sum(axes).max())


def test_bn_stats_channel_axis_and_errors():
    x = torch.from_numpy(_rand((4, 6, 3, 5), 3))  # NCHW, C = 6
    nhwc = x.permute(0, 2, 3, 1)
    for got, want in zip(tstats.sum_and_sumsq(x, dim=1),
                         tstats.sum_and_sumsq(nhwc)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for got, want in zip(tstats.sum_and_dot(x, 2 * x, dim=1),
                         tstats.sum_and_dot(nhwc, 2 * nhwc)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="shape mismatch"):
        tstats.sum_and_dot(x, x[:2], dim=1)
    # the CPU path launches nothing
    n = (tstats.sum_and_sumsq.launches, tstats.sum_and_dot.launches)
    tstats.sum_and_sumsq(x.to(torch.bfloat16), dim=1)
    assert (tstats.sum_and_sumsq.launches, tstats.sum_and_dot.launches) == n


@pytest.mark.parametrize("m,c", [(3211264, 64), (12544, 2048), (7, 64),
                                 (12345, 96)])
def test_launch_plan_covers_every_row_once(m, c):
    stripes, rows = tstats.launch_plan(m, c)
    assert 1 <= stripes <= 65535
    assert (stripes - 1) * rows < m <= stripes * rows


def _jax_bn(x, scale, bias, dy, impl):
    def f(x, s, b):
        return jbn.batch_norm_train(x, s, b, impl=impl)

    (y, mean, var), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias))
    dx, ds, db = vjp((jnp.asarray(dy).astype(y.dtype), jnp.zeros_like(mean),
                      jnp.zeros_like(var)))
    return [np.asarray(t.astype(jnp.float32)) for t in
            (y, mean, var, dx, ds, db)]


def _torch_bn(x, scale, bias, dy, impl, dim=-1):
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y, mean, var = tbn.batch_norm_train(xt, st, bt, impl=impl, dim=dim)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    return [t.detach().float().numpy() for t in
            (y, mean, var, xt.grad, st.grad, bt.grad)]


@pytest.mark.parametrize("impl", ["pallas", "unfused", "flax"])
@pytest.mark.parametrize("shape", [(4, 5, 5, 8), (6, 3, 3, 200)])
def test_batch_norm_train_matches_jax_f32(shape, impl):
    c = shape[-1]
    x, dy = _rand(shape, 4, shift=0.7), _rand(shape, 5)
    scale, bias = _rand((c,), 6, shift=1.0), _rand((c,), 7)
    got = _torch_bn(x, scale, bias, dy, impl)
    want = _jax_bn(x, scale, bias, dy, "unfused" if impl == "flax" else impl)
    for name, g, w in zip(("y", "mean", "var", "dx", "dscale", "dbias"),
                          got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_batch_norm_train_matches_jax_bf16():
    shape = (4, 6, 6, 64)
    x, dy = _rand(shape, 8, shift=0.5), _rand(shape, 9)
    scale, bias = _rand((64,), 10, shift=1.0), _rand((64,), 11)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    dyb = np.array(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))

    def run_torch():
        xt = torch.from_numpy(xb).to(torch.bfloat16).requires_grad_()
        st = torch.from_numpy(scale).requires_grad_()
        bt = torch.from_numpy(bias).requires_grad_()
        y, mean, var = tbn.batch_norm_train(xt, st, bt, impl="pallas")
        y.backward(torch.from_numpy(dyb).to(torch.bfloat16))
        assert y.dtype == xt.grad.dtype == torch.bfloat16
        return [t.detach().float().numpy() for t in
                (y, mean, var, xt.grad, st.grad, bt.grad)]

    def f(x, s, b):
        return jbn.batch_norm_train(x, s, b, impl="pallas")

    (y, mean, var), vjp = jax.vjp(f, jnp.asarray(xb, jnp.bfloat16),
                                  jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp((jnp.asarray(dyb, jnp.bfloat16), jnp.zeros_like(mean),
                      jnp.zeros_like(var)))
    want = [np.asarray(t.astype(jnp.float32))
            for t in (y, mean, var, dx, ds, db)]
    got = run_torch()
    for name, g, w in zip(("y", "dx"), (got[0], got[3]), (want[0], want[3])):
        np.testing.assert_allclose(g, w, atol=2 ** -7 * np.abs(w).max(),
                                   err_msg=name)
    for name, g, w in zip(("mean", "var", "dscale", "dbias"),
                          got[1:3] + got[4:], want[1:3] + want[4:]):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_channels_first_matches_channels_last():
    x, dy = _rand((3, 4, 5, 16), 12, shift=0.2), _rand((3, 4, 5, 16), 13)
    scale, bias = _rand((16,), 14), _rand((16,), 15)
    last = _torch_bn(x, scale, bias, dy, "pallas")
    # the same numbers as NCHW, channel axis 1
    nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    dy_nchw = np.ascontiguousarray(dy.transpose(0, 3, 1, 2))
    first = _torch_bn(nchw, scale, bias, dy_nchw, "pallas", dim=1)
    for i in (0, 3):
        first[i] = first[i].transpose(0, 2, 3, 1)
    for g, w in zip(first, last):  # sums in another order
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("impl", ["pallas", "unfused"])
def test_tpu_batch_norm_module_matches_flax(impl):
    c = 24
    x1, x2 = _rand((8, 3, 3, c), 16, shift=2.0), _rand((8, 3, 3, c), 17)
    jm = jbn.TpuBatchNorm(stats_impl=impl, momentum=0.9)
    variables = jm.init(jax.random.key(0), jnp.asarray(x1),
                        use_running_average=False)
    tm = tbn.TpuBatchNorm(c, stats_impl=impl, momentum=0.9, dim=-1)
    assert dict(tm.named_buffers()).keys() == {"mean", "var"}
    assert not any(b.requires_grad for b in tm.buffers())
    for x in (x1, x2):  # two training steps: the running averages move
        y_j, upd = jm.apply(variables, jnp.asarray(x),
                            use_running_average=False,
                            mutable=["batch_stats"])
        variables = {**variables, **upd}
        y_t = tm(torch.from_numpy(x))
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                                   rtol=1e-5, atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(tm, k).numpy(),
                np.asarray(variables["batch_stats"][k]), rtol=1e-5,
                atol=1e-6)
    tm.eval()
    y_j = jm.apply(variables, jnp.asarray(x1), use_running_average=True)
    np.testing.assert_allclose(tm(torch.from_numpy(x1)).detach().numpy(),
                               np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="stats_impl"):
        tbn.TpuBatchNorm(8, stats_impl="cudnn")
    with pytest.raises(ValueError, match="stats_impl"):
        tbn.batch_norm_train(torch.zeros(2, 3), torch.ones(3),
                             torch.zeros(3), impl="cudnn")

"""Port parity: the W8A16 int8 matmul and the quantized modules.

The port (pytorch_distributed_nn_tpu_torch) against the JAX package on the
same numpy-made inputs. On the CPU the port's ``int8_matmul`` runs its
plain PyTorch version and the JAX one its jnp fallback; both round x to
bf16, take exact int8 weights and sum f32 products, so they differ only
in summation order: tolerances are a few f32 ulps of the row's magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.nn import quantized as jq
from pytorch_distributed_nn_tpu.ops.pallas import int8_matmul as jmm
from pytorch_distributed_nn_tpu_torch.nn import quantized as tq
from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
)

# f32 sums of up to ~2k products in another order: relative error well
# under 1e-5 of the largest output; bf16 outputs may then round to the
# neighbouring bf16 value (2^-8 relative)
F32_TOL = 1e-5
BF16_TOL = 2 ** -7


def _max_rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


@pytest.mark.parametrize("k,n", [(4096, 14336), (4096, 128256), (48, 40),
                                 (14336, 4096), (100, 3000), (2049, 1)])
def test_padded_kn_matches_jax(k, n):
    assert tmm.padded_kn(k, n) == jmm.padded_kn(k, n)


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 200)).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero channel takes scale 1
    jq_, js = jmm.quantize_weight(jnp.asarray(w))
    tq_, ts = tmm.quantize_weight(torch.from_numpy(w))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 96), (5, 64, 96), (8, 200, 300),
                                   (33, 96, 1000)])
def test_int8_matmul_matches_jax(m, k, n, out_dtype):
    rng = np.random.default_rng(m * 1000 + k)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q, s = jmm.quantize_weight(jnp.asarray(w))
    ref = jmm.int8_matmul(jnp.asarray(x), q, s,
                          out_dtype=getattr(jnp, out_dtype))
    before = tmm.int8_matmul.launches
    got = tmm.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                          torch.from_numpy(np.array(s)),
                          out_dtype=getattr(torch, out_dtype))
    # the CPU path is the plain version: no kernel launch is counted
    assert tmm.int8_matmul.launches == before
    assert got.dtype == getattr(torch, out_dtype)
    assert tuple(got.shape) == tuple(ref.shape)
    tol = F32_TOL if out_dtype == "float32" else BF16_TOL
    assert _max_rel(got.float().numpy(), np.asarray(ref, np.float32)) <= tol


def test_int8_matmul_reference_is_the_cpu_path():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    q, s = tmm.quantize_weight(torch.from_numpy(
        rng.standard_normal((64, 128)).astype(np.float32)))
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(tmm.int8_matmul(x, q, s, out_dtype=dt),
                           tmm.int8_matmul_reference(x, q, s, out_dtype=dt))


def test_int8_matmul_rejects_other_devices():
    x = torch.zeros((2, 32), device="meta")
    q = torch.zeros((32, 128), dtype=torch.int8, device="meta")
    s = torch.zeros((1, 128), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmm.int8_matmul(x, q, s)


@pytest.mark.parametrize("m,kp,np_", [(1, 4096, 6144), (8, 4096, 4096),
                                      (8, 14336, 4096), (3, 4096, 28672),
                                      (128, 4096, 129024), (256, 4096, 4096),
                                      (2, 128, 128)])
def test_launch_plan_covers_k_exactly_once(m, kp, np_):
    plan = tmm.launch_plan(m, kp, np_)
    mt, kc, splits = plan.mt, plan.kc, plan.splits
    assert mt in (8, 16, 32, 64, 128) and (mt >= m or mt == 128)
    assert kc % 64 == 0 and kc >= 64
    # every K row belongs to exactly one split, and no split is empty
    assert (splits - 1) * kc < kp <= splits * kc
    if np_ // 128 < 132 and kp >= 256:
        assert splits > 1  # narrow layers are split over K
    # the K split ignores M: a row sums in the same order in any batch
    one = tmm.launch_plan(1, kp, np_)
    assert (one.kc, one.splits) == (kc, splits)


# the (K, N) of every int8 matmul on the fused Llama-3-8B path
_PATH_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                (4096, 128256)]


@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("k,n", _PATH_SHAPES)
def test_launch_plan_fills_the_card_on_the_8b_path(k, n, m):
    kp, np_ = tmm.padded_kn(k, n)
    plan = tmm.launch_plan(m, kp, np_)
    tiles = -(-m // plan.mt) * (np_ // 128)
    assert plan.blocks == tiles * plan.splits >= 132
    # the workspace holds every split's f32 partial sums, or none
    assert plan.workspace == (plan.splits * m * np_ if plan.splits > 1
                              else 0)


def _jax_apply(mod, params, x):
    return np.asarray(mod.apply({"params": params}, x), np.float32)


def _load(module, jparams):
    module.load_state_dict(llama_params_from_jax(jax.device_get(jparams)))
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 40)).astype(np.float32)
    jmod = jq.Int8Dense(72, dtype=getattr(jnp, dtype))
    params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    ref = _jax_apply(jmod, params, jnp.asarray(x).astype(jmod.dtype))
    tmod = _load(tq.Int8Dense(40, 72, dtype=getattr(torch, dtype)), params)
    got = tmod(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tuple(got.shape) == ref.shape == (3, 7, 72)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _max_rel(got.float().numpy(), ref) <= tol


@pytest.mark.parametrize("in_shape,features,axis", [
    ((32,), (48,), -1),          # plain
    ((32,), (4, 12), -1),        # q/k/v: tuple features
    ((4, 8), (32,), (-2, -1)),   # out projection: two contraction axes
])
def test_int8_densegeneral_matches_jax(in_shape, features, axis):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, *in_shape)).astype(np.float32)
    jmod = jq.Int8DenseGeneral(features, axis=axis, dtype=jnp.float32)
    params = jmod.init(jax.random.key(1), jnp.asarray(x))["params"]
    ref = _jax_apply(jmod, params, jnp.asarray(x))
    tmod = _load(tq.Int8DenseGeneral(in_shape, features,
                                     dtype=torch.float32), params)
    got = tmod(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    assert _max_rel(got.numpy(), ref) <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_embed_matches_jax_exactly(dtype):
    tokens = np.random.default_rng(9).integers(0, 97, size=(3, 11))
    jmod = jq.Int8Embed(97, 24, dtype=getattr(jnp, dtype))
    params = jmod.init(jax.random.key(2), jnp.asarray(tokens))["params"]
    ref = _jax_apply(jmod, params, jnp.asarray(tokens))
    tmod = _load(tq.Int8Embed(97, 24, dtype=getattr(torch, dtype)), params)
    got = tmod(torch.from_numpy(tokens))
    # one multiply per element in the same dtype: bit-identical
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_quantize_model_params_matches_jax():
    """The float -> int8 converter, including the fused qkv / gate_up
    merge, gives the JAX converter's int8 tree."""
    rng = np.random.default_rng(11)
    fl = {
        "attn": {n: {"kernel": rng.standard_normal((16, h, 8)).astype(
            np.float32)} for n, h in (("query", 4), ("key", 2),
                                      ("value", 2))},
        "mlp": {n: {"kernel": rng.standard_normal((16, 40)).astype(
            np.float32)} for n in ("gate_proj", "up_proj")},
        "tok_embed": {"embedding": rng.standard_normal((30, 16)).astype(
            np.float32)},
        "norm": {"scale": np.ones((16,), np.float32)},
    }
    shapes = {"attn": {"qkv": {"kernel_q": (32, 128), "scale": (1, 128)}},
              "mlp": {"gate_up": {"kernel_q": (32, 128),
                                  "scale": (1, 128)}},
              "tok_embed": {"embedding_q": (30, 16), "scale": (30, 1)},
              "norm": {"scale": (16,)}}
    jshapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                           shapes, is_leaf=lambda s: isinstance(s, tuple))
    ref = jax.device_get(jq.quantize_model_params(
        jax.tree.map(jnp.asarray, fl), jshapes))
    got = tq.quantize_model_params(
        jax.tree.map(torch.from_numpy, fl), shapes)
    want = llama_params_from_jax(ref)
    have = llama_params_from_jax(jax.tree.map(lambda t: t.numpy(), got))
    assert sorted(have) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(have[key].numpy(), want[key].numpy(),
                                      err_msg=key)


def test_synthetic_int8_params_seeded_and_in_range():
    from pytorch_distributed_nn_tpu_torch.config import ModelConfig
    from pytorch_distributed_nn_tpu_torch.models import get_model

    cfg = ModelConfig(name="llama3_8b", extra=dict(
        num_layers=1, d_model=64, num_heads=4, num_kv_heads=2, mlp_dim=96,
        vocab_size=50, quantized=True, fused_proj=True))
    a = tq.synthetic_int8_params(get_model(cfg, device="cpu"), seed=3)
    b = tq.synthetic_int8_params(get_model(cfg, device="cpu"), seed=3)
    for (name, p), (_, p2) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert torch.equal(p, p2), name
        if p.dtype == torch.int8:
            assert int(p.min()) >= -64 and int(p.max()) < 64
            assert int(p.abs().sum()) > 0

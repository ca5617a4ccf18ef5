"""Port parity: rotary embeddings, per-row cache writes, decode attention.

The port's ``nn/attention.py`` against the JAX package's on numpy-made
inputs. Tolerances: f32 paths differ by summation order and by the ulp
or two that two libraries' f32 pow/cos/sin may differ by (relative 1e-5
of the largest output); bf16 outputs may then round to the neighbouring
bf16 value (2^-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.nn import attention as ja
from pytorch_distributed_nn_tpu_torch.nn import attention as ta
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
)

F32_TOL = 1e-5
BF16_TOL = 2 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _close(got, ref, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-30))
    assert err <= tol, err


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("per_row", [False, True])
def test_rotary_matches_jax(dtype, per_row):
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    pos = None
    if per_row:
        pos = (rng.integers(0, 200, size=(3, 1)) + np.arange(5)).astype(
            np.int32)
    jq_, jk = ja.rotary_embedding(
        jnp.asarray(q, jd), jnp.asarray(k, jd), theta=500000.0,
        positions=None if pos is None else jnp.asarray(pos))
    tq_, tk = ta.rotary_embedding(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        theta=500000.0,
        positions=None if pos is None else torch.from_numpy(pos))
    # the tables are weakly typed in JAX: a bf16 input rotates in bf16
    assert tq_.dtype == td and str(jq_.dtype) == dtype
    _close(tq_, jq_, tol)
    _close(tk, jk, tol)


def test_rotary_rejects_odd_head_dim():
    x = torch.zeros((1, 2, 1, 5))
    with pytest.raises(ValueError, match="even head_dim"):
        ta.rotary_embedding(x, x)


@pytest.mark.parametrize("starts", [[0, 3, 9], [10, 12, 11], [7, 0, 20]])
def test_row_update_matches_jax_including_clamp(starts):
    """Starts past S - T are clamped to S - T, as dynamic_update_slice
    clamps (the engine feeds inactive rows at their frozen depth)."""
    rng = np.random.default_rng(1)
    buf = rng.standard_normal((3, 12, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    st = np.asarray(starts, np.int32)
    ref = np.asarray(ja._row_update(jnp.asarray(buf), jnp.asarray(new),
                                    jnp.asarray(st)))
    got = torch.from_numpy(buf.copy())
    ta._row_update(got, torch.from_numpy(new), torch.from_numpy(st))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [1, 6])
def test_cache_attention_matches_jax(dtype, T):
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(2 + T)
    B, S, H, Hkv, D = 3, 16, 8, 2, 16
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    depth = np.asarray([0, 5, 9], np.int32)
    pos = depth[:, None] + np.arange(T)[None]
    mask = np.arange(S)[None, None, :] <= pos[:, :, None]
    ref = ja._cache_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), jnp.asarray(mask), jd)
    got = ta._cache_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(mask), td)
    assert got.dtype == td
    _close(got, ref, tol)


@pytest.mark.parametrize("causal", [True, False])
def test_dot_product_attention_matches_jax(causal):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 7, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    ref = ja.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    got = ta.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    _close(got, ref, F32_TOL)


def test_unported_impls_name_the_roadmap():
    x = torch.zeros((1, 2, 2, 4))
    # ring and ulysses are ported as MultiHeadAttention's sequence-parallel
    # impls; as a plain attention impl they are unknown, as in the JAX
    # package, and the error says where they live
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="parallel/sequence.py"):
            ta.dot_product_attention(x, x, x, causal=True, impl=impl)
    # flash is ported: on the CPU it runs its plain versions
    torch.testing.assert_close(
        ta.dot_product_attention(x, x, x, causal=True, impl="flash"),
        ta.dot_product_attention(x, x, x, causal=True, impl="xla"))
    # the int8 KV cache is ported (tests/test_torch_kv_cache.py holds it
    # against the JAX package); an unknown cache dtype raises, as there
    cache = ta.MultiHeadAttention(8, 2, 4, cache_dtype="int8").init_cache(
        1, 4)
    assert cache["cached_key"].dtype == torch.int8
    with pytest.raises(ValueError, match="cache_dtype"):
        ta.MultiHeadAttention(8, 2, 4, cache_dtype="fp4")


D_MODEL, H, HKV, HD = 32, 4, 2, 8


def _mha_pair(quantized, fused, dtype):
    jd, td, _ = DTYPES[dtype]
    jmod = ja.MultiHeadAttention(
        num_heads=H, head_dim=HD, num_kv_heads=HKV, causal=True,
        rotary=True, rope_theta=500000.0, use_bias=False, dtype=jd,
        quantized=quantized, fused_qkv=fused)
    tmod = ta.MultiHeadAttention(
        D_MODEL, H, HD, num_kv_heads=HKV, rope_theta=500000.0, dtype=td,
        quantized=quantized, fused_qkv=fused)
    return jmod, tmod


@pytest.mark.parametrize("quantized,fused", [(True, True), (True, False),
                                             (False, False)])
@pytest.mark.parametrize("per_row", [False, True])
def test_mha_decode_matches_jax(quantized, fused, per_row):
    """Prefill 5 tokens, then 3 one-token decode steps, through the shared
    cache_index or per-row cache_positions; outputs and caches agree."""
    B, S = 2, 12
    rng = np.random.default_rng(6)
    jmod, tmod = _mha_pair(quantized, fused, "float32")
    variables = jmod.init(jax.random.key(0),
                          jnp.zeros((B, S, D_MODEL), jnp.float32),
                          decode=True)
    params, jcache = variables["params"], variables["cache"]
    tmod.load_state_dict(llama_params_from_jax(jax.device_get(params)))
    tcache = {"cached_key": torch.zeros((B, S, HKV, HD)),
              "cached_value": torch.zeros((B, S, HKV, HD)),
              "cache_index": torch.zeros((), dtype=torch.int32)}
    depth = np.zeros((B,), np.int32)
    for T in (5, 1, 1, 1):
        x = rng.standard_normal((B, T, D_MODEL)).astype(np.float32)
        kw_j, kw_t = {}, {}
        if per_row:
            kw_j["cache_positions"] = jnp.asarray(depth)
            kw_t["cache_positions"] = torch.from_numpy(depth)
        ref, mut = jmod.apply({"params": params, "cache": jcache},
                              jnp.asarray(x), decode=True,
                              mutable=["cache"], **kw_j)
        jcache = mut["cache"]
        with torch.inference_mode():
            got = tmod(torch.from_numpy(x), cache=tcache, **kw_t)
        _close(got, ref, F32_TOL)
        depth = depth + T
    _close(tcache["cached_key"], jcache["cached_key"], F32_TOL)
    _close(tcache["cached_value"], jcache["cached_value"], F32_TOL)
    assert int(tcache["cache_index"]) == int(jcache["cache_index"])

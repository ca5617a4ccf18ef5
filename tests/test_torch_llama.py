"""Port parity: the quantized (and float) Llama forward, config and weights.

The port's ``Llama`` against the JAX package's on the same weights, carried
by ``llama_params_from_jax``, and the same numpy-made tokens: a ragged
prefill then teacher-forced decode steps against the KV cache.

Tolerance, relative to the largest logit. In f32 compute the two differ
by summation order (about 1e-6 measured), but each int8 matmul rounds its
input to bf16, and an f32 difference of one ulp upstream can move one
input element to the neighbouring bf16 value (2^-8) in one package and
not the other: 1e-4 leaves room for that. In bf16 compute every op rounds
to bf16, at different places in the two frameworks (about 1e-2 measured):
3e-2. Greedy tokens must agree wherever the JAX top-1/top-2 margin
exceeds twice the absolute tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.inference.generate import (
    init_cache as j_init_cache,
)
from pytorch_distributed_nn_tpu.models import get_model as j_get_model
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.inference.generate import (
    init_cache as t_init_cache,
)
from pytorch_distributed_nn_tpu_torch.models import get_model as t_get_model
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
EXTRA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             mlp_dim=128, vocab_size=257, attn_impl="xla")


def _pair(dtype, **extra):
    ex = dict(EXTRA, **extra)
    jm = j_get_model(JModelConfig(name="llama3_8b", compute_dtype=dtype,
                                  extra=ex))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    tm = t_get_model(tconfig.ModelConfig(name="llama3_8b",
                                         compute_dtype=dtype, extra=ex),
                     device="cpu")
    if not ex.get("quantized", False):
        # flax's default init gives norm scales of one: perturb them so the
        # float check also covers the norm weights
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: x * 1.5 if "scale" in str(p[-1]) else x, params)
    tm.load_state_dict(llama_params_from_jax(jax.device_get(params)))
    return jm, params, tm


def _check(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * scale, (err, scale)
    # greedy tokens agree wherever the reference margin is decisive
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * tol * scale
    np.testing.assert_array_equal(got.argmax(-1)[decisive],
                                  ref.argmax(-1)[decisive])
    return int(decisive.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized,fused", [(True, True), (True, False),
                                             (False, False)])
def test_llama_prefill_and_decode_match_jax(dtype, quantized, fused):
    jm, params, tm = _pair(dtype, quantized=quantized, fused_proj=fused)
    B, P, S, steps = 3, 9, 16, 4
    rng = np.random.default_rng(21)
    toks = rng.integers(0, 257, size=(B, P + steps)).astype(np.int32)
    zeros = np.zeros((B,), np.int32)
    jcache = j_init_cache(jm, B, S)
    ref, mut = jm.apply({"params": params, "cache": jcache},
                        jnp.asarray(toks[:, :P]), decode=True,
                        mutable=["cache"], cache_positions=jnp.asarray(zeros))
    jcache = mut["cache"]
    tcache = t_init_cache(tm, B, S)
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks[:, :P]), cache=tcache,
                 cache_positions=torch.from_numpy(zeros))
    assert got.dtype == torch.float32  # lm_head outputs f32
    decisive = _check(got, ref, TOL[dtype])
    for i in range(steps):
        pos = np.full((B,), P + i, np.int32)
        feed = toks[:, P + i:P + i + 1]
        ref, mut = jm.apply({"params": params, "cache": jcache},
                            jnp.asarray(feed), decode=True,
                            last_only=True, mutable=["cache"],
                            cache_positions=jnp.asarray(pos))
        jcache = mut["cache"]
        with torch.inference_mode():
            got = tm(torch.from_numpy(feed), cache=tcache,
                     cache_positions=torch.from_numpy(pos), last_only=True)
        decisive += _check(got, ref, TOL[dtype])
    assert decisive >= 3  # the token check did compare tokens


def test_llama_shared_index_decode_matches_jax():
    """The shared cache_index path (uniform batches in ``generate``)."""
    jm, params, tm = _pair("float32", quantized=True, fused_proj=True)
    B, P, S = 2, 6, 12
    toks = np.random.default_rng(22).integers(0, 257, size=(B, P + 3))
    jcache = j_init_cache(jm, B, S)
    tcache = t_init_cache(tm, B, S)
    for lo, hi in ((0, P), (P, P + 1), (P + 1, P + 2), (P + 2, P + 3)):
        feed = toks[:, lo:hi].astype(np.int32)
        ref, mut = jm.apply({"params": params, "cache": jcache},
                            jnp.asarray(feed), decode=True, last_only=True,
                            mutable=["cache"])
        jcache = mut["cache"]
        with torch.inference_mode():
            got = tm(torch.from_numpy(feed), cache=tcache, last_only=True)
        _check(got, ref, TOL["float32"])
    assert int(tcache["layer0"]["cache_index"]) == P + 3


def test_llama_full_forward_without_cache_matches_jax():
    jm, params, tm = _pair("float32", quantized=True, fused_proj=True)
    toks = np.random.default_rng(23).integers(0, 257, size=(2, 11))
    ref = jm.apply({"params": params}, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks))
    _check(got, ref, TOL["float32"])


@pytest.mark.parametrize("quantized,fused", [(True, True), (True, False),
                                             (False, False)])
def test_state_dict_keys_are_the_flax_paths(quantized, fused):
    jm, params, tm = _pair("float32", quantized=quantized, fused_proj=fused)
    sd = llama_params_from_jax(jax.device_get(params))
    got = tm.state_dict()
    assert sorted(got) == sorted(sd)
    for key, value in sd.items():
        assert got[key].dtype == value.dtype, key
        assert tuple(got[key].shape) == tuple(value.shape), key
        assert torch.equal(got[key], value), key


def test_full_width_8b_shapes_without_allocating():
    """The llama3_8b builder at its real dims, on the meta device: the
    int8 storage shapes the kernel sees on the main path."""
    cfg = tconfig.get_config(
        "llama3_8b_zero",
        **{"model.extra": '{"quantized": true, "fused_proj": true}'})
    m = t_get_model(cfg.model, device="meta")
    sd = m.state_dict()
    assert tuple(sd["layer0.attn.qkv.kernel_q"].shape) == (4096, 6144)
    assert tuple(sd["layer0.attn.out.kernel_q"].shape) == (4096, 4096)
    assert tuple(sd["layer0.gate_up.kernel_q"].shape) == (4096, 28672)
    assert tuple(sd["layer31.down_proj.kernel_q"].shape) == (14336, 4096)
    assert tuple(sd["lm_head.kernel_q"].shape) == (4096, 129024)
    assert tuple(sd["tok_embed.embedding_q"].shape) == (128256, 4096)
    n_int8 = sum(t.numel() for t in sd.values() if t.dtype == torch.int8)
    # 7.5 GB of projection weights + the 0.5 GB embedding
    assert 8.0e9 < n_int8 < 8.1e9


def test_config_overrides_match_jax():
    from pytorch_distributed_nn_tpu import config as jconfig

    argv = ["--model.extra", '{"quantized": true, "num_layers": 2}',
            "--model.compute_dtype=float32", "--seed", "4"]
    assert tconfig.parse_overrides(argv) == jconfig.parse_overrides(argv)
    for preset in ("llama3_8b_zero", "llama3_longcontext"):
        ov = tconfig.parse_overrides(argv)
        got = tconfig.get_config(preset, **ov)
        ref = jconfig.get_config(preset, **ov)
        assert got.seed == ref.seed == 4
        assert vars(got.model) == vars(ref.model)
    with pytest.raises(AttributeError, match="unknown config field"):
        tconfig.get_config("llama3_8b_zero", **{"parallel.overlap": "1"})
    with pytest.raises(ValueError):
        tconfig.parse_overrides(["positional"])


def test_interop_carries_bf16_and_int8_leaves():
    import ml_dtypes

    tree = {"a": {"b": np.asarray([1.5, -2.0], ml_dtypes.bfloat16),
                  "q": np.asarray([[3, -127]], np.int8)}}
    sd = llama_params_from_jax(tree)
    assert sorted(sd) == ["a.b", "a.q"]
    assert sd["a.b"].dtype == torch.bfloat16
    assert sd["a.b"].tolist() == [1.5, -2.0]
    assert sd["a.q"].dtype == torch.int8 and sd["a.q"].tolist() == [[3, -127]]

"""Port parity of the decode caches: the int8 KV cache
(``nn/attention.py`` ``cache_dtype="int8"``), the transformer LM's decode
cache and ``generate()``'s sampling, ``eos_token`` and ``prefill_chunk``,
each held against the JAX package on the same inputs and weights (the JAX
init carried by ``utils.interop``), on the CPU at tiny dims.

- ``_quantize_kv``: int8 values and scales bit for bit the JAX function's;
  the round trip within half a scale; zero rows exact with scale 1.
- The folded scales: int8-cache attention against the port's float
  attention over the dequantized cache (rtol 2e-5, atol 2e-6, as the JAX
  test) and against JAX's ``_cache_attention`` on the same int8 inputs
  (f32, 1e-5 of the largest element).
- A decode step's attention (``_decode_attention``): a row's bits the
  same alone and in a batch of 8 with a longer cache (f32 and bf16, both
  caches), JAX's ``_cache_attention`` in f32 to 1e-5 of the largest
  element, and the same bits reduced in chunks of keys.
- The cache's leaves: the JAX cache's shapes and dtypes, about half the
  bytes under int8; an unknown ``cache_dtype`` raises in both packages.
- int8 decode: greedy tokens equal the float cache's and the JAX int8
  run's; decode logits within the JAX test's tolerance of the
  full-context forward.
- The transformer LM (config 4 at 2 layers, d 64): prefill plus 8 decode
  steps on ragged rows (per-row ``cache_positions``) and on the shared
  counter against the JAX LM's ``decode=True``: logits to 1e-5 of the
  largest, greedy tokens exact. The MoE LM refuses a decode cache in both.
- ``generate()`` with temperature, top_k, top_p, ``eos_token`` and
  ``prefill_chunk`` against JAX ``generate()`` from the same key: tokens
  exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.nn import attention as jattn
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.inference.generate import (
    cache_bytes,
    generate,
    init_cache,
)
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.nn import attention as tattn
from pytorch_distributed_nn_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_nn_tpu_torch.utils import threefry
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
    params_from_jax,
)

# the module (the package's ``inference`` exports its function by name)
jgen = importlib.import_module("pytorch_distributed_nn_tpu.inference.generate")
VOCAB = 97
TOL = 1e-5


def _llama_extra(cache_dtype="compute", vocab=VOCAB):
    return dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                mlp_dim=128, vocab_size=vocab, cache_dtype=cache_dtype)


LM_EXTRA = dict(num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
                vocab_size=VOCAB, max_len=32)


def _pair(name, extra, init_key, dtype="float32"):
    """(JAX model, its params, port model with the same weights)."""
    jm = jget_model(JModelConfig(name=name, compute_dtype=dtype,
                                 dtype="float32", extra=extra))
    params = jm.init(jax.random.key(init_key), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    tm = get_model(ModelConfig(name=name, compute_dtype=dtype,
                               dtype="float32", extra=extra), device="cpu")
    convert = llama_params_from_jax if name == "llama3_8b" else \
        params_from_jax
    tm.load_state_dict(convert(jax.device_get(params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def llama_pair():
    return _pair("llama3_8b", _llama_extra(), 0)


@pytest.fixture(scope="module")
def lm_pair():
    return _pair("transformer_lm", LM_EXTRA, 2)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


# --------------------------------------------------------------------------
# the int8 cache
# --------------------------------------------------------------------------

def test_quantize_kv_roundtrip_and_bits_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 8).astype(np.float32) * 3.0
    x[0, 1, 2] = 0.0  # a dead head's row
    q, s = tattn._quantize_kv(torch.from_numpy(x))
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == (2, 5, 3)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = q.float() * s[..., None]
    # symmetric per-row absmax: error bounded by scale/2 per element
    assert ((deq - torch.from_numpy(x)).abs()
            <= s[..., None] * 0.5 + 1e-7).all()
    assert s[0, 1, 2] == 1.0 and (q[0, 1, 2] == 0).all()


@pytest.mark.parametrize("gqa", [1, 2])
def test_folded_scales_equal_the_dequantized_cache(gqa):
    """int8-cache attention equals float attention over the dequantized
    cache (the same quantization error on both sides isolates the
    scale-folding algebra), and JAX's on the same int8 inputs."""
    rng = np.random.RandomState(1)
    B, T, S, Hkv, D = 2, 3, 16, 2, 16
    H = Hkv * gqa
    q = torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S, Hkv, D).astype(np.float32)) * 2
    v = torch.from_numpy(rng.randn(B, S, Hkv, D).astype(np.float32))
    kq, ks = tattn._quantize_kv(k)
    vq, vs = tattn._quantize_kv(v)
    pos = torch.arange(T)[None] + (S - T)
    pos_mask = torch.arange(S)[None, None, :] <= pos[:, :, None]
    got = tattn._cache_attention(q, kq, vq, pos_mask, torch.float32,
                                 kscale=ks, vscale=vs)
    want = tattn.dot_product_attention(
        q, kq.float() * ks[..., None], vq.float() * vs[..., None],
        causal=False, impl="xla", mask=pos_mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-6)
    jgot = jattn._cache_attention(
        jnp.asarray(q.numpy()), jnp.asarray(kq.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(pos_mask.numpy()),
        jnp.float32, kscale=jnp.asarray(ks.numpy()),
        vscale=jnp.asarray(vs.numpy()))
    _close(got.numpy(), jgot)


def _decode_case(rng, B, S, Hkv=2, G=2, D=16):
    H = Hkv * G
    return (torch.from_numpy(rng.randn(B, 1, H, D).astype(np.float32)),
            torch.from_numpy(rng.randn(B, S, Hkv, D).astype(np.float32)) * 2,
            torch.from_numpy(rng.randn(B, S, Hkv, D).astype(np.float32)))


def _decode(q, k, v, pos, dtype, cache_dtype):
    """One decode step's attention over a cache of len(k[0]) keys, each row
    at its position ``pos``; int8 caches quantized as the layer stores
    them."""
    q, k, v = (x.to(dtype) for x in (q, k, v))
    scales = {}
    if cache_dtype == "int8":
        (k, ks), (v, vs) = tattn._quantize_kv(k), tattn._quantize_kv(v)
        scales = dict(kscale=ks, vscale=vs)
    pos_mask = torch.arange(k.shape[1])[None, None, :] <= pos[:, None, None]
    return tattn._decode_attention(q, k, v, pos_mask, dtype, **scales)


@pytest.mark.parametrize("cache_dtype", ["compute", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_row_ignores_its_batch_and_cache_length(
        dtype, cache_dtype):
    """A decode step gives a row the same bits alone (B 1, a cache of its
    own length) as in row 3 of 8 with a cache 2.4 times as long, whose
    other rows and later keys hold other values: what lets the engine's
    greedy rows equal a solo ``generate()``. In f32 it also equals JAX's
    ``_cache_attention`` to 1e-5 of the largest element."""
    rng = np.random.RandomState(2)
    dt = getattr(torch, dtype)
    S1, S2, row = 13, 31, 3
    q1, k1, v1 = _decode_case(rng, 1, S1)
    alone = _decode(q1, k1, v1, torch.tensor([S1 - 1]), dt, cache_dtype)
    q, k, v = _decode_case(rng, 8, S2)
    q[row], k[row, :S1], v[row, :S1] = q1[0], k1[0], v1[0]
    pos = torch.from_numpy(rng.randint(0, S2, size=8))
    pos[row] = S1 - 1
    batched = _decode(q, k, v, pos, dt, cache_dtype)
    assert torch.equal(batched[row], alone[0])
    if dtype == "float32" and cache_dtype == "compute":
        pos_mask = (torch.arange(S2)[None, None, :]
                    <= pos[:, None, None]).numpy()
        want = jattn._cache_attention(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)),
            jnp.asarray(pos_mask), jnp.float32)
        _close(batched.numpy(), want)


def test_decode_attention_chunks_keep_its_bits(monkeypatch):
    """Caches reduced in chunks of keys (any power of two, the last one
    short) give the bits of the whole cache in one product."""
    rng = np.random.RandomState(3)
    q, k, v = _decode_case(rng, 3, 37)
    pos = torch.tensor([36, 10, 0])
    monkeypatch.setattr(tattn, "DECODE_CHUNK_BYTES", 1 << 40)
    whole = _decode(q, k, v, pos, torch.float32, "int8")
    per_key = 3 * 4 * 16 * 4  # B * H * D * 4 bytes: one key's product
    for keys in (1, 4, 8, 13, 64):
        monkeypatch.setattr(tattn, "DECODE_CHUNK_BYTES", keys * per_key)
        got = _decode(q, k, v, pos, torch.float32, "int8")
        assert torch.equal(got, whole), keys


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_cache_structure_and_size_match_jax():
    B, L = 2, 32
    caches = {}
    for dtype in ("compute", "int8"):
        extra = _llama_extra(dtype)
        tm = get_model(ModelConfig(name="llama3_8b", extra=extra),
                       device="cpu")
        jm = jget_model(JModelConfig(name="llama3_8b", extra=extra))
        got = _leaves(init_cache(tm, B, L))
        want = {k.replace(".attn", ""): v for k, v in _leaves(
            jgen.init_cache(jm, B, L)).items()}
        assert set(got) == set(want)
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype)
        caches[dtype] = got
    int8 = caches["int8"]
    assert all(t.dtype == torch.int8 for n, t in int8.items()
               if n.endswith(("cached_key", "cached_value")))
    assert all(t.dtype == torch.float32 for n, t in int8.items()
               if n.endswith("scale"))
    assert cache_bytes(int8) < 0.75 * cache_bytes(caches["compute"])


def test_unknown_cache_dtype_raises_in_both():
    extra = _llama_extra("fp4")
    with pytest.raises(ValueError, match="cache_dtype"):
        get_model(ModelConfig(name="llama3_8b", extra=extra), device="cpu")
    jm = jget_model(JModelConfig(name="llama3_8b", extra=extra))
    with pytest.raises(ValueError, match="cache_dtype"):
        jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                train=False, decode=True)


def test_int8_decode_tokens_match_the_float_cache_and_jax():
    """Greedy generation with the int8 cache agrees with the float cache
    token for token, and with the JAX int8 run (bf16 compute, the
    preset's, as the JAX test runs it: its margins are decisive)."""
    jf, params, tf_ = _pair("llama3_8b", _llama_extra("compute"), 0,
                            dtype="bfloat16")
    jq, _, tq = _pair("llama3_8b", _llama_extra("int8"), 0,
                      dtype="bfloat16")
    prompt = np.asarray(jax.random.randint(jax.random.key(3), (2, 12), 0,
                                           VOCAB, jnp.int32))
    out_f = generate(tf_, prompt, 24).numpy()
    out_q = generate(tq, prompt, 24).numpy()
    np.testing.assert_array_equal(out_q, out_f)
    np.testing.assert_array_equal(
        out_q, np.asarray(jgen.generate(jq, params, prompt, 24)))


def test_int8_decode_logits_near_the_full_context_forward():
    jm, params, tm = _pair("llama3_8b", _llama_extra("int8"), 0)
    toks = torch.tensor(np.asarray(jax.random.randint(
        jax.random.key(5), (2, 10), 0, VOCAB, jnp.int32)))
    with torch.no_grad():
        full = tm(toks)
        logits = tm(toks, cache=init_cache(tm, 2, 10))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=0.1,
                               atol=0.05)
    jcache = jgen.init_cache(jm, 2, 10)
    jlogits, _ = jm.apply({"params": params, "cache": jcache},
                          jnp.asarray(toks.numpy()), train=False,
                          decode=True, mutable=["cache"])
    _close(logits.numpy(), jlogits)


# --------------------------------------------------------------------------
# the transformer LM's decode cache
# --------------------------------------------------------------------------

def _jax_lm_steps(jm, params, prompt, n, positions=None):
    """JAX LM decode: the prefill's logits, then n greedy steps' logits
    and tokens (per-row ``cache_positions`` when ``positions`` given)."""
    B, P = prompt.shape
    cache = jgen.init_cache(jm, B, P + n + 1)
    kw = {} if positions is None else dict(
        cache_positions=jnp.zeros((B,), jnp.int32))
    logits, mut = jm.apply({"params": params, "cache": cache},
                           jnp.asarray(prompt), train=False, decode=True,
                           mutable=["cache"], **kw)
    cache = mut["cache"]
    if positions is None:
        last = logits[:, -1]
    else:
        last = logits[jnp.arange(B), jnp.asarray(positions) - 1]
    out_logits, toks = [last], []
    pos = None if positions is None else jnp.asarray(positions, jnp.int32)
    for _ in range(n):
        tok = jnp.argmax(last, -1).astype(jnp.int32)
        toks.append(tok)
        kw = {} if pos is None else dict(cache_positions=pos)
        logits, mut = jm.apply({"params": params, "cache": cache},
                               tok[:, None], train=False, decode=True,
                               mutable=["cache"], **kw)
        cache = mut["cache"]
        last = logits[:, -1]
        out_logits.append(last)
        if pos is not None:
            pos = pos + 1
    return np.stack([np.asarray(x) for x in out_logits]), \
        np.stack([np.asarray(t) for t in toks])


def _port_lm_steps(tm, prompt, n, positions=None):
    B, P = prompt.shape
    cache = init_cache(tm, B, P + n + 1)
    with torch.no_grad():
        if positions is None:
            last = tm(torch.from_numpy(prompt), cache=cache)[:, -1]
        else:
            logits = tm(torch.from_numpy(prompt), cache=cache,
                        cache_positions=torch.zeros(B, dtype=torch.int32))
            last = logits[torch.arange(B),
                          torch.as_tensor(positions) - 1]
        out_logits, toks = [last], []
        pos = None if positions is None else torch.as_tensor(
            positions, dtype=torch.int32)
        for _ in range(n):
            tok = torch.argmax(last, -1).to(torch.int32)
            toks.append(tok)
            if pos is None:
                last = tm(tok[:, None], cache=cache)[:, -1]
            else:
                last = tm(tok[:, None], cache=cache,
                          cache_positions=pos)[:, -1]
                pos = pos + 1
            out_logits.append(last)
    return torch.stack(out_logits).numpy(), torch.stack(toks).numpy()


@pytest.mark.parametrize("ragged", [False, True])
def test_transformer_lm_decode_matches_jax(lm_pair, ragged):
    jm, params, tm = lm_pair
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, VOCAB, size=(3, 7)).astype(np.int32)
    positions = [7, 3, 5] if ragged else None  # left-aligned rows
    jl, jt = _jax_lm_steps(jm, params, prompt, 8, positions)
    tl, tt = _port_lm_steps(tm, prompt, 8, positions)
    _close(tl, jl)
    np.testing.assert_array_equal(tt, jt)


def test_transformer_lm_generate_ragged_matches_jax(lm_pair):
    jm, params, tm = lm_pair
    rng = np.random.default_rng(5)
    lengths = [5, 1, 8, 3]
    batch = np.zeros((4, 8), np.int32)
    for i, n in enumerate(lengths):
        batch[i, 8 - n:] = rng.integers(1, VOCAB, size=(n,))
    got = generate(tm, batch, 6, prompt_lengths=lengths).numpy()
    want = np.asarray(jgen.generate(jm, params, batch, 6,
                                    prompt_lengths=np.asarray(lengths)))
    np.testing.assert_array_equal(got, want)


def test_decode_refusals_match_jax(lm_pair):
    _, _, tm = lm_pair
    with pytest.raises(ValueError, match="positions"):
        tm(torch.zeros((1, 2), dtype=torch.int32), cache=init_cache(tm, 1, 4),
           positions=torch.zeros((1, 2), dtype=torch.int64))
    extra = dict(LM_EXTRA, num_experts=2)
    moe = get_model(ModelConfig(name="moe_lm", extra=extra), device="cpu")
    with pytest.raises(ValueError, match="decode"):
        init_cache(moe, 1, 8)
    with pytest.raises(ValueError, match="decode"):
        jgen.init_cache(jget_model(JModelConfig(name="moe_lm",
                                                extra=extra)), 1, 8)


# --------------------------------------------------------------------------
# generate(): sampling, eos and chunked prefill against JAX
# --------------------------------------------------------------------------

SAMPLING = {
    "temperature": dict(temperature=0.9),
    "top_k": dict(temperature=1.1, top_k=7),
    "top_p": dict(temperature=0.8, top_p=0.9),
    "top_k_top_p": dict(temperature=1.3, top_k=20, top_p=0.7),
    "greedy_prefill_chunk": dict(prefill_chunk=3),
    "sampled_prefill_chunk": dict(temperature=1.0, prefill_chunk=4),
}


@pytest.mark.parametrize("case", list(SAMPLING))
@pytest.mark.parametrize("model", ["llama", "lm"])
def test_generate_matches_jax_from_the_same_key(llama_pair, lm_pair, case,
                                                model):
    jm, params, tm = llama_pair if model == "llama" else lm_pair
    kw = SAMPLING[case]
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, VOCAB, size=(3, 9)).astype(np.int32)
    seed = 11
    jkw = dict(kw, rng=jax.random.PRNGKey(seed)) if "temperature" in kw \
        else kw
    want = np.asarray(jgen.generate(jm, params, prompt, 10, **jkw))
    tkw = dict(kw, rng=threefry.prng_key(seed)) if "temperature" in kw \
        else kw
    got = generate(tm, prompt, 10, **tkw).numpy()
    np.testing.assert_array_equal(got, want)


def test_eos_padding_matches_jax(llama_pair):
    jm, params, tm = llama_pair
    prompt = np.asarray([[1, 2], [5, 9]], np.int32)
    first = int(generate(tm, prompt[:1], 1)[0, -1])
    greedy = generate(tm, prompt, 6, eos_token=first).numpy()
    assert (greedy[0, 2:] == first).all()  # eos fires at once, then pads
    np.testing.assert_array_equal(
        greedy, np.asarray(jgen.generate(jm, params, prompt, 6,
                                         eos_token=first)))
    got = generate(tm, prompt, 6, eos_token=first, temperature=1.0,
                   rng=3).numpy()
    want = np.asarray(jgen.generate(jm, params, prompt, 6, eos_token=first,
                                    temperature=1.0,
                                    rng=jax.random.PRNGKey(3)))
    np.testing.assert_array_equal(got, want)


def test_generate_validation():
    tm = get_model(ModelConfig(name="llama3_8b", extra=_llama_extra()),
                   device="cpu")
    with pytest.raises(ValueError, match="rng"):
        generate(tm, np.zeros((1, 2), np.int32), 2, temperature=1.0)
    # generate(mesh=) decodes tensor-parallel (tests/test_torch_tensor_pipe
    # .py); ragged prompts with a mesh raise, as in the JAX package
    with pytest.raises(ValueError, match="mesh"):
        generate(tm, np.zeros((2, 2), np.int32), 2, prompt_lengths=[1, 2],
                 mesh=MeshSpec(tensor=2, data=-1))
    with pytest.raises(ValueError, match="mutually exclusive"):
        generate(tm, np.zeros((1, 2), np.int32), 2, prefill_chunk=1,
                 prompt_lengths=[1])


@pytest.mark.parametrize("rows", [1, 3, 8, 9])
def test_norm_statistics_of_a_decode_step_are_row_blocks(rows):
    """ROADMAP §3 item 5's repair: a decode step's norm statistics
    (``nn.layers.row_mean``: (B, 1, K) rows in fixed blocks of 8, the last
    padded) are each row's own mean, as a prefill's plain mean gives it;
    RMSNorm and LayerNorm on each row alone equal the rows together. (On
    the card the blocks fix the reduction's shape; the CPU's reduction
    already gives each row the same bits whatever the rows.)"""
    from pytorch_distributed_nn_tpu_torch.models.llama import RMSNorm
    from pytorch_distributed_nn_tpu_torch.nn.layers import LayerNorm, row_mean

    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, 1, 4096)).astype(np.float32)) * 3.0
    torch.testing.assert_close(row_mean(x), x.mean(-1, keepdim=True),
                               rtol=1e-6, atol=0)
    for norm in (RMSNorm(4096, dtype=torch.bfloat16),
                 LayerNorm(4096, eps=1e-6, dtype=torch.bfloat16)):
        together = norm(x)
        alone = torch.cat([norm(x[i:i + 1]) for i in range(rows)])
        assert together.shape == (rows, 1, 4096)
        assert torch.equal(together, alone)

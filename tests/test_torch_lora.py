"""Port parity of per-request LoRA adapters (``nn/lora.py``, the Llama's
``lora_bank``/``adapter_ids``, the attention's q/v deltas, the engine's
per-slot adapters and the prefix cache's adapter namespaces), held against
the JAX package on the CPU at the tiny llama's shape
(``tests/conftest.py``'s ``tiny_llama``: 2 layers, d 64, 4/2 heads, vocab
97, f32). Banks and weights cross with ``utils.interop``.

The engine cases mirror the JAX test's oracle at scale 0.3. At the JAX
default 0.02 the deltas change no greedy token of this model in 6 new
tokens (the JAX package's own ``test_engine_lora_adapters_match_merged_
weights`` fails at its last check for that reason, ROADMAP.md §3); at 0.3
adapters 1 and 2 diverge from the base:

- adapters 1 and 2 give the JAX engine's tokens and those of the port's
  ``generate()`` on ``merge_lora``; adapter 0 gives the base model's and
  the no-bank engine's; at least one adapter diverges;
- one prompt on three adapters is three prefix misses, a repeat on one
  adapter a hit, and two adapters never share a block;
- rows on different adapters in one batch give what each gives alone;
- an adapter out of range raises the JAX ``ValueError``.

``lora_delta`` and ``merge_lora`` against the JAX functions: f32 to
1e-6 of the largest element (the products' order differs); a bf16 input
to one bf16 step (2^-7) of the largest. The model's forward with a bank,
float and quantized fused-qkv, against the JAX forward: 1e-4 of the
largest logit (the port's forward tolerance in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.nn import lora as jlora
from pytorch_distributed_nn_tpu.serve import ServingEngine as JEngine
from pytorch_distributed_nn_tpu.serve import decoding as jdec
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.inference.generate import generate
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.nn import lora
from pytorch_distributed_nn_tpu_torch.serve import DecodeSpec, ServingEngine
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
    lora_bank_from_jax,
)

VOCAB = 97
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            mlp_dim=128, vocab_size=VOCAB)
SCALE = 0.3  # at 0.02 no greedy token of this model moves (see above)
ENGINE = dict(max_slots=2, max_seq_len=64, block_size=8)
N_NEW = 6
PROMPT = (np.arange(1, 13) % (VOCAB - 1) + 1).astype(np.int32)


def _port(params, **extra):
    tm = get_model(ModelConfig(name="llama3_8b", compute_dtype="float32",
                               dtype="float32", extra=dict(TINY, **extra)),
                   device="cpu")
    tm.load_state_dict(llama_params_from_jax(jax.device_get(params)))
    return tm.eval()


@pytest.fixture(scope="module")
def setup(tiny_llama):
    """(JAX model, params, JAX bank, port model, port bank): the JAX
    test's bank (3 adapters of rank 2 from PRNGKey(7)) at SCALE."""
    jm, params = tiny_llama
    jbank = jlora.init_lora_bank(jm, num_adapters=3, rank=2,
                                 rng=jax.random.PRNGKey(7), scale=SCALE)
    return jm, params, jbank, _port(params), lora_bank_from_jax(jbank)


def _solo(model, prompt, n_new=N_NEW):
    return generate(model, prompt[None], n_new).numpy()[0, len(prompt):]


def _merged(tm, bank, adapter):
    m = get_model(ModelConfig(name="llama3_8b", compute_dtype="float32",
                              dtype="float32", extra=TINY), device="cpu")
    m.load_state_dict(lora.merge_lora(tm.state_dict(), bank, adapter))
    return m.eval()


# --------------------------------------------------------------------------
# the functions against the JAX module
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    a = (0.3 * rng.standard_normal((3, 64, 4))).astype(np.float32)
    b = (0.3 * rng.standard_normal((3, 4, 4, 16))).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jlora.lora_delta(jx, jnp.asarray(a), jnp.asarray(b)),
                      np.float32)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = lora.lora_delta(tx, torch.tensor(a), torch.tensor(b))
    assert got.dtype == tx.dtype and got.shape == (3, 5, 4, 16)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_merge_lora_matches_jax(setup):
    jm, params, jbank, tm, bank = setup
    for adapter in (0, 1, 2):
        want = llama_params_from_jax(jax.device_get(
            jlora.merge_lora(params, jbank, adapter)))
        got = lora.merge_lora(tm.state_dict(), bank, adapter)
        assert got.keys() == want.keys()
        for k in want:
            w = want[k].numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)
            if adapter == 0 or "query" not in k and "value" not in k:
                assert torch.equal(got[k], tm.state_dict()[k])
    with pytest.raises(ValueError):
        lora.merge_lora(tm.state_dict(), bank, 3)


def test_bank_layout_and_init(setup):
    jm, params, jbank, tm, bank = setup
    for k in lora.BANK_KEYS:
        np.testing.assert_array_equal(bank[k].numpy(), np.asarray(jbank[k]))
    assert lora.num_adapters(bank) == jlora.num_adapters(jbank) == 3
    assert lora.num_adapters(None) == 0
    for i in (0, 1):
        for got, want in zip(lora.layer_slice(bank, i),
                             jlora.layer_slice(jbank, i)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mine = lora.init_lora_bank(tm, num_adapters=4, rank=3, scale=0.5,
                               generator=torch.Generator().manual_seed(1))
    again = lora.init_lora_bank(tm, num_adapters=4, rank=3, scale=0.5,
                                generator=torch.Generator().manual_seed(1))
    shapes = dict(a_q=(4, 2, 64, 3), b_q=(4, 2, 3, 4, 16),
                  a_v=(4, 2, 64, 3), b_v=(4, 2, 3, 2, 16))
    for k in lora.BANK_KEYS:
        assert mine[k].shape == shapes[k] and mine[k].dtype == torch.float32
        assert torch.equal(mine[k], again[k])
    assert not mine["b_q"][0].any() and not mine["b_v"][0].any()
    assert mine["b_q"][1:].std() == pytest.approx(0.5, rel=0.1)
    with pytest.raises(ValueError):
        lora.init_lora_bank(tm, num_adapters=0, rank=2,
                            generator=torch.Generator())
    with pytest.raises(ValueError):
        lora.init_lora_bank(tm, num_adapters=2, rank=0,
                            generator=torch.Generator())


@pytest.mark.parametrize("quantized", [False, True])
def test_forward_with_a_bank_matches_jax(setup, quantized):
    """Rows on adapters (2, 0, 1) through one forward, float and int8
    fused-qkv: the JAX logits; adapter 0's row the base model's bits."""
    jm, params, jbank, tm, bank = setup
    if quantized:
        extra = dict(TINY, quantized=True, fused_proj=True)
        jm = jget_model(JModelConfig(name="llama3_8b", dtype="float32",
                                     compute_dtype="float32", extra=extra))
        params = jm.init(jax.random.key(3), jnp.zeros((1, 8), jnp.int32),
                         train=False)["params"]
        tm = _port(params, quantized=True, fused_proj=True)
    tokens = np.random.default_rng(2).integers(1, VOCAB, size=(3, 9))
    ids = np.asarray([2, 0, 1], np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens),
                               train=False, lora_bank=jbank,
                               adapter_ids=jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.tensor(tokens), lora_bank=bank,
                 adapter_ids=torch.tensor(ids, dtype=torch.int64)).numpy()
        base = tm(torch.tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # adapter 0's row is the base model's, bit for bit
    np.testing.assert_array_equal(got[1], base[1])
    assert np.abs(got[0] - base[0]).max() > 1e-3 * np.abs(base).max()


# --------------------------------------------------------------------------
# the engine: the JAX test's oracle at scale 0.3
# --------------------------------------------------------------------------

def test_engine_adapters_match_jax_and_merged_weights(setup):
    jm, params, jbank, tm, bank = setup
    eng = ServingEngine(tm, lora_bank=bank, **ENGINE)
    jeng = JEngine(jm, params, lora_bank=jbank, **ENGINE)
    outs, jouts = {}, {}
    for adapter in (0, 1, 2):
        for e, out in ((eng, outs), (jeng, jouts)):
            r = e.submit(PROMPT, N_NEW, adapter=adapter)
            e.run_until_idle()
            assert r.state == "done", (r.state, r.reject_reason)
            out[adapter] = np.asarray(r.tokens)
        np.testing.assert_array_equal(outs[adapter], jouts[adapter])
    np.testing.assert_array_equal(outs[0], _solo(tm, PROMPT))
    for adapter in (1, 2):
        np.testing.assert_array_equal(
            outs[adapter], _solo(_merged(tm, bank, adapter), PROMPT))
    assert any(not np.array_equal(outs[a], outs[0]) for a in (1, 2))
    stats = eng.prefix_cache.stats()
    assert stats["prefix_misses"] >= 3
    assert stats == jeng.prefix_cache.stats()
    # a repeat on one adapter restores that adapter's rows
    r = eng.submit(PROMPT, N_NEW, adapter=2)
    eng.run_until_idle()
    assert eng.prefix_cache.stats()["prefix_hits"] == stats[
        "prefix_hits"] + 1
    np.testing.assert_array_equal(r.tokens, outs[2])
    assert eng.completed[-1]["adapter"] == 2
    # 8 rows of a whole block and 3 of the next (copy-on-write)
    assert eng.completed[-1]["cached_tokens"] == 11
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(PROMPT, 2, adapter=9)
    with pytest.raises(ValueError, match="no\\s+LoRA bank"):
        ServingEngine(tm, **ENGINE).submit(PROMPT, 2, adapter=1)


def test_adapter_zero_is_the_engine_without_a_bank(setup):
    tm, bank = setup[3], setup[4]
    prompts = [np.random.default_rng(s).integers(1, VOCAB, size=n)
               .astype(np.int32) for s, n in ((1, 9), (2, 17), (3, 4))]
    got = []
    for b in (bank, None):
        eng = ServingEngine(tm, lora_bank=b, **ENGINE)
        reqs = [eng.submit(p, N_NEW) for p in prompts]
        eng.run_until_idle()
        got.append([r.tokens for r in reqs])
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


def test_mixed_adapter_batch_rows_equal_each_adapter_alone(setup):
    """Rows on adapters 1, 0, 2 and 1 (one sampled) share one 3-slot
    batch; each gives what that adapter gives served alone."""
    tm, bank = setup[3], setup[4]
    rng = np.random.default_rng(4)
    rows = [(1, rng.integers(1, VOCAB, size=10), None),
            (0, rng.integers(1, VOCAB, size=14), None),
            (2, rng.integers(1, VOCAB, size=7),
             dict(temperature=0.8, top_k=20, seed=9)),
            (1, rng.integers(1, VOCAB, size=12), None)]

    def serve(batch):
        eng = ServingEngine(tm, lora_bank=bank, max_slots=3,
                            max_seq_len=64, block_size=8)
        reqs = [eng.submit(p.astype(np.int32), N_NEW, adapter=a,
                           decode=None if kw is None else DecodeSpec(**kw))
                for a, p, kw in batch]
        eng.run_until_idle()
        return [r.tokens for r in reqs]

    mixed = serve(rows)
    for row, got in zip(rows, mixed):
        np.testing.assert_array_equal(got, serve([row])[0])


def test_adapters_never_share_prefix_blocks(setup):
    tm, bank = setup[3], setup[4]
    eng = ServingEngine(tm, lora_bank=bank, **ENGINE)
    pool = eng.scheduler.pool
    prompt = np.random.default_rng(5).integers(1, VOCAB, size=30).astype(
        np.int32)
    tables = {}
    for adapter in (1, 2, 1):
        r = eng.submit(prompt, 2, adapter=adapter)
        eng.step()  # admitted and prefilled: its table is live
        tables.setdefault(adapter, set()).update(
            pool.block_table(r.request_id))
        eng.run_until_idle()
    assert not tables[1] & tables[2]
    st = eng.prefix_cache.stats()
    assert (st["prefix_misses"], st["prefix_hits"]) == (2, 1)
    assert eng.prefix_cache.peek(prompt, adapter=0) == 0


def test_jax_engine_sampled_adapter_rows_match(setup):
    """A sampled request on each adapter, the same seed, through both
    engines: identical streams (the sampling and the deltas together)."""
    jm, params, jbank, tm, bank = setup
    kw = dict(temperature=0.9, top_k=30, top_p=0.95, seed=13)
    got, want = [], []
    for e, spec, out in ((ServingEngine(tm, lora_bank=bank, **ENGINE),
                          DecodeSpec, got),
                         (JEngine(jm, params, lora_bank=jbank, **ENGINE),
                          jdec.DecodeSpec, want)):
        reqs = [e.submit(PROMPT[:9], N_NEW, adapter=a, decode=spec(**kw))
                for a in (0, 1, 2)]
        e.run_until_idle()
        out += [r.tokens for r in reqs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

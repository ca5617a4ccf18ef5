"""Port parity of the prefix cache's engine half (the pool, the index and
the JAX unit cases are ``test_torch_prefix_cache.py``, whose model
fixture and constants this file uses): waves of requests with shared
prefixes, a copy-on-write tail, cold prompts that evict, an n-best
request and sampled rows go through the JAX ``ServingEngine`` and the
port's, on the compute and the int8 KV cache: tokens, n-best rankings and
prefix ``stats()`` equal. The port with the cache on gives the tokens of
the cache off and of a solo ``generate()``; so does the transformer LM's
decode cache. A short suffix's hit is the whole prefill bit for bit; an
n-best on a hit keeps the index whole; a fork reclaims cached blocks
before backpressure; the block store covers every cache tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_prefix_cache import (  # noqa: F401 (models: a fixture)
    ENGINE,
    LM_EXTRA,
    N_NEW,
    VOCAB,
    models,
)

from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.serve import ServingEngine as JEngine
from pytorch_distributed_nn_tpu.serve import decoding as jdec
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.inference.generate import generate
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.serve import (
    DecodeSpec,
    KVPool,
    PrefixCache,
    Scheduler,
    ServingEngine,
)
from pytorch_distributed_nn_tpu_torch.serve.scheduler import branch_seq_ids
from pytorch_distributed_nn_tpu_torch.utils.interop import params_from_jax


def _waves(seed=3):
    """Four waves through a 3-slot engine of 24 blocks of 8 rows: (1) a
    24-token prefix A with a suffix; (2) A with other suffixes (greedy,
    sampled), a prompt ending inside wave 1's fourth block (a
    copy-on-write tail) and an n-best of 2 on a prompt of its own (on a
    hit the JAX engine leaves its index stale, ROADMAP.md §3; the port's
    case is :func:`test_nbest_on_a_hit_keeps_the_index_whole`); (3) three
    cold 40-token prompts, whose reservations evict; (4) A again and a
    cold prompt's head again. Each entry: (prompt, decode kwargs or
    None)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(1, VOCAB, size=24).astype(np.int32)

    def tok(n):
        return rng.integers(1, VOCAB, size=n).astype(np.int32)

    first = np.concatenate([A, tok(5)])
    cold = [tok(40) for _ in range(3)]
    return [
        [(first, None)],
        [(np.concatenate([A, tok(3)]), None),
         (np.concatenate([A, tok(7)]),
          dict(temperature=0.8, top_k=20, top_p=0.9, seed=11)),
         (np.concatenate([first[:27], [95]]).astype(np.int32), None),
         (tok(20), dict(temperature=0.7, n=2, best_of=2, seed=5))],
        [(c, None) for c in cold],
        [(np.concatenate([A, tok(6)]), None),
         (np.concatenate([cold[0][:32], tok(2)]), None)],
    ]


def _serve_waves(engine, spec_cls, waves):
    out = []
    for wave in waves:
        reqs = [engine.submit(p, N_NEW, decode=None if kw is None
                              else spec_cls(**kw)) for p, kw in wave]
        engine.run_until_idle()
        for r in reqs:
            assert r.state == "done", (r.state, r.reject_reason)
        out += reqs
    return out


@pytest.mark.parametrize("cache_dtype", ["compute", "int8"])
def test_engine_prefix_cache_matches_the_jax_engine(models, cache_dtype):
    """Tokens, n-best rankings and prefix stats of the same waves through
    the JAX engine and the port's, both with the prefix cache on."""
    jm, params, tm = models[cache_dtype]
    waves = _waves()
    got_eng = ServingEngine(tm, **ENGINE)
    got = _serve_waves(got_eng, DecodeSpec, waves)
    want_eng = JEngine(jm, params, **ENGINE)
    want = _serve_waves(want_eng, jdec.DecodeSpec, waves)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=str(i))
        if w.n_best is not None:
            assert [b["tokens"] for b in g.n_best] == \
                [b["tokens"] for b in w.n_best]
    gs, ws = got_eng.prefix_cache.stats(), want_eng.prefix_cache.stats()
    assert gs == ws
    assert gs["prefix_hits"] >= 4 and gs["prefix_evictions"] > 0
    cached = [c["cached_tokens"] for c in got_eng.completed]
    assert cached == [c["cached_tokens"] for c in want_eng.completed]
    assert 27 in cached  # the copy-on-write tail's rows
    assert got_eng.scheduler.pool.live_sequences == 0
    assert got_eng.summary()["prefix_hits"] == gs["prefix_hits"]


def _solo(model, prompt, n_new=N_NEW):
    return generate(model, prompt[None], n_new).numpy()[0, len(prompt):]


@pytest.mark.parametrize("cache_dtype", ["compute", "int8"])
def test_engine_prefix_on_equals_off_equals_generate(models, cache_dtype):
    tm = models[cache_dtype][2]
    waves = [[(p, None) for p, _ in w] for w in _waves(seed=8)]
    on_eng = ServingEngine(tm, **ENGINE)
    on = _serve_waves(on_eng, DecodeSpec, waves)
    off_eng = ServingEngine(tm, prefix_cache=False, **ENGINE)
    off = _serve_waves(off_eng, DecodeSpec, waves)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, _solo(tm, a.prompt))
    assert on_eng.prefix_cache.stats()["prefix_hits"] >= 4
    assert off_eng.prefix_cache is None and off_eng._store is None
    assert "prefix_hits" not in off_eng.summary()


def _hit_prefill(model, donor, prompt, on, device="cpu"):
    """``donor`` served and retired, then ``prompt`` admitted (with the
    prefix cache ``on`` or off) in a 2-slot engine at blocks of 16: the
    engine, the request and its slot's K/V rows after the admission's
    round, then the request served to its end."""
    eng = ServingEngine(model, max_slots=2, max_seq_len=64, block_size=16,
                        prefix_cache=on)
    eng.submit(donor, N_NEW)
    eng.run_until_idle()
    req = eng.submit(prompt, N_NEW)
    eng.step()  # the prefill into slot 0 and one decode round
    kv = {(n, k): v[0, :len(prompt)].clone()
          for n, layer in eng._cache.items() for k, v in layer.items()
          if v.dim() >= 2}
    eng.run_until_idle()
    return eng, req, kv


@pytest.mark.parametrize("cache_dtype", ["compute", "int8"])
@pytest.mark.parametrize("suffix", [1, 2])
def test_short_suffix_hit_is_the_whole_prefill(models, cache_dtype, suffix):
    """A prompt of 16k + 1 and 16k + 2 rows served as a hit of 16k rows: a
    one-row forward would take the decode step's attention, so the engine
    starts the prefill at ``suffix_prefill_start``; the slot's K/V rows and
    the tokens are the cache-off engine's bit for bit."""
    from pytorch_distributed_nn_tpu_torch.nn.attention import (
        suffix_prefill_start,
    )

    tm = models[cache_dtype][2]
    rng = np.random.default_rng(21)
    donor = rng.integers(1, VOCAB, size=40).astype(np.int32)
    # the rows after the 32 shared ones differ from the donor's
    prompt = np.concatenate([donor[:32], donor[32:32 + suffix]
                             % (VOCAB - 1) + 1]).astype(np.int32)
    assert suffix_prefill_start(32, len(prompt)) == len(prompt) - 2
    on, req_on, kv_on = _hit_prefill(tm, donor, prompt, True)
    off, req_off, kv_off = _hit_prefill(tm, donor, prompt, False)
    assert on.prefix_cache.stats()["prefix_hits"] == 1
    assert on.completed[-1]["cached_tokens"] == 32
    np.testing.assert_array_equal(req_on.tokens, req_off.tokens)
    assert kv_on.keys() == kv_off.keys()
    for key, want in kv_off.items():
        assert torch.equal(kv_on[key], want), key


def test_transformer_lm_decode_cache_serves_with_the_prefix_cache():
    """The transformer LM's cache (K/V per block and the model's 0-d
    ``pos_index``) through the block store: the JAX engine's tokens and
    stats, and the port's with the cache off."""
    jm = jget_model(JModelConfig(name="transformer_lm",
                                 compute_dtype="float32", dtype="float32",
                                 extra=LM_EXTRA))
    params = jm.init(jax.random.key(2), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    tm = get_model(ModelConfig(name="transformer_lm",
                               compute_dtype="float32", dtype="float32",
                               extra=LM_EXTRA), device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    tm.eval()
    waves = [[(p, None) for p, _ in w] for w in _waves(seed=5)[:2]]
    eng = ServingEngine(tm, **ENGINE)
    got = _serve_waves(eng, DecodeSpec, waves)
    jeng = JEngine(jm, params, **ENGINE)
    want = _serve_waves(jeng, jdec.DecodeSpec, waves)
    off = _serve_waves(ServingEngine(tm, prefix_cache=False, **ENGINE),
                       DecodeSpec, waves)
    for g, w, o in zip(got, want, off):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.tokens, o.tokens)
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert eng.prefix_cache.stats()["prefix_hits"] >= 3
    assert "pos_index" not in eng._store


def _stale(pc):
    """Index nodes whose block is neither cached nor in a live table."""
    pool = pc.pool
    live = {b for t in pool._tables.values() for b in t}
    return [n.phys for n in pc._nodes.values()
            if n.phys not in pool._cached and n.phys not in live]


def test_nbest_on_a_hit_keeps_the_index_whole(models):
    """An n-best request admitted on a prefix hit: the branches hold the
    matched blocks by reference; retiring them donates nothing new, the
    matched chain stays cached whichever branch retires last, and a later
    request on the prefix restores it and gives the tokens of the cache
    off. The JAX engine frees the chain's blocks with its last branch and
    keeps them in its index (the fault this checks the port against)."""
    tm = models["compute"][2]
    eng = ServingEngine(tm, **ENGINE)
    pool = eng.scheduler.pool
    rng = np.random.default_rng(1)
    A = rng.integers(1, VOCAB, size=16).astype(np.int32)
    eng.submit(np.concatenate([A, [5, 6]]).astype(np.int32), 2)
    eng.run_until_idle()
    nodes = eng.prefix_cache.nodes
    req = eng.submit(np.concatenate([A, [7, 8, 9]]).astype(np.int32), 4,
                     decode=DecodeSpec(temperature=0.9, n=2, best_of=3,
                                       seed=2))
    eng.step()
    tables = [pool.block_table(s) for s in branch_seq_ids(req)]
    assert all(t[:2] == tables[0][:2] for t in tables)
    assert all(pool.refcount(b) == 3 for b in tables[0][:2])
    eng.run_until_idle()
    assert req.ok and eng.prefix_cache.nodes == nodes
    assert pool.live_sequences == 0 and not _stale(eng.prefix_cache)
    assert pool.free_blocks + pool.cached_blocks == pool.num_blocks
    assert eng.prefix_cache.stats()["prefix_hits"] == 1
    cold = eng.submit(rng.integers(1, VOCAB, size=40).astype(np.int32), 2)
    again = np.concatenate([A, [3, 4]]).astype(np.int32)
    r = eng.submit(again, N_NEW)
    eng.run_until_idle()
    assert cold.ok and eng.prefix_cache.stats()["prefix_hits"] == 2
    np.testing.assert_array_equal(r.tokens, _solo(tm, again))

    jm, params = models["compute"][:2]
    jeng = JEngine(jm, params, **ENGINE)
    jeng.submit(np.concatenate([A, [5, 6]]).astype(np.int32), 2)
    jeng.run_until_idle()
    jeng.submit(np.concatenate([A, [7, 8, 9]]).astype(np.int32), 4,
                decode=jdec.DecodeSpec(temperature=0.9, n=2, best_of=3,
                                       seed=2))
    jeng.run_until_idle()
    assert _stale(jeng.prefix_cache)


def test_fork_reclaims_cached_blocks_before_backpressure():
    """A branched head whose tails find the free list parked in the cached
    ring sheds cached blocks (``make_room``) instead of waiting for blocks
    that nothing running will ever free."""
    pool = KVPool(num_blocks=8, block_size=4)
    pc = PrefixCache(pool)
    s = Scheduler(pool, prefix_cache=pc)
    for i in range(3):
        p = np.arange(1 + 8 * i, 9 + 8 * i, dtype=np.int32)
        pc.admit(f"d{i}", p, 8)
        pc.release(f"d{i}", p)
    assert pool.cached_blocks == 6 and pool.free_blocks == 2
    req = s.submit(np.arange(50, 54), 4,
                   decode=DecodeSpec(temperature=1.0, n=2, best_of=3))
    assert s.next_admissions(free_slots=3) == [req]
    assert pc.stats()["prefix_evictions"] == 2  # one block a tail
    for sid in branch_seq_ids(req):
        s.release_branch(req, sid)
    assert pool.live_sequences == 0


def test_engine_block_store_covers_every_cache_tensor(models):
    eng = ServingEngine(models["int8"][2], **ENGINE)
    nb = eng.scheduler.pool.num_blocks
    for name, layer in eng._cache.items():
        leaves = {k for k, v in layer.items() if v.dim() >= 2}
        assert set(eng._store[name]) == leaves
        assert {"cached_key_scale", "cached_value_scale"} <= leaves
        for k in leaves:
            assert eng._store[name][k].shape == (nb, 8) + \
                layer[k].shape[2:]
            assert eng._store[name][k].dtype == layer[k].dtype

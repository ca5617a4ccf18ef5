"""Port parity of the decoding policy (``serve/decoding.py``), JAX's
threefry (``utils/threefry.py``) and the engine's sampled, n-best and
streamed paths, held against the JAX package on the CPU. The model is a
tiny Llama (2 layers, d 64, 4/2 heads, vocab 512, f32), the JAX init
carried by ``utils.interop``.

- threefry: ``PRNGKey``, ``fold_in``, ``split``, the random bits and the
  uniforms bit for bit ``jax.random``'s over a spread of seeds, branches,
  steps and shapes; Gumbel noise within 1e-6 relative (the float32 log of
  two libraries); ``categorical`` draws identical.
- ``row_keys`` bit for bit; ``sample_rows`` tokens identical to JAX's,
  with per-row k = 0, k >= V, p = 0, p = 1 and ties at the k-th value;
  ``_mask_one``'s kept set identical except where a token's mass before it
  is within 1e-6 of p (the cumulative sums of two libraries round apart
  there; such tokens carry under 1e-6 of the mass); ``token_logprobs`` to
  1e-5 relative.
- The engine's sampled and n-best streams against the JAX
  ``ServingEngine`` on the same weights: tokens identical, n-best
  log-probabilities to 1e-5 relative.
- The intent of the JAX package's ``tests/test_decoding.py``: inert
  defaults, mixed batches keeping greedy rows bit for bit, the same seed
  twice, independence from batch composition, n-best sharing prompt
  blocks, fork backpressure all or nothing with no leak, streaming chunks,
  branches retiring at their own eos. (The fleet, process and disagg cases
  belong to ROADMAP.md slice 6.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.serve import ServingEngine as JEngine
from pytorch_distributed_nn_tpu.serve import decoding as jdec
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.inference.generate import generate
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.serve import (
    DecodeSpec,
    InferenceServer,
    KVPool,
    Scheduler,
    ServingEngine,
    TokenStream,
)
from pytorch_distributed_nn_tpu_torch.serve import decoding as tdec
from pytorch_distributed_nn_tpu_torch.serve.scheduler import branch_seq_ids
from pytorch_distributed_nn_tpu_torch.utils import threefry
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
)

VOCAB = 512
EXTRA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             mlp_dim=128, vocab_size=VOCAB)
LOGPROB_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, port model) with the same weights, f32."""
    kw = dict(name="llama3_8b", compute_dtype="float32", dtype="float32",
              extra=EXTRA)
    jm = jget_model(JModelConfig(**kw))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    tm = get_model(ModelConfig(**kw), device="cpu")
    tm.load_state_dict(llama_params_from_jax(jax.device_get(params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def model(pair):
    return pair[2]


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


def _engine(model, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_queue", 16)
    return ServingEngine(model, **kw)


def _run_one(model, prompt, n_new, **kw):
    eng = _engine(model)
    req = eng.submit(prompt, n_new, **kw)
    eng.run_until_idle()
    assert req.state == "done", (req.state, req.reject_reason)
    return req, eng


# --------------------------------------------------------------------------
# threefry against jax.random
# --------------------------------------------------------------------------

SEEDS = [0, 1, 7, 4242, 2 ** 31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for data in (0, 1, 3, 1000, 2 ** 31 + 5):
        np.testing.assert_array_equal(threefry.fold_in(tk, data).numpy(),
                                      np.asarray(jax.random.fold_in(jk,
                                                                    data)))
    np.testing.assert_array_equal(threefry.split(tk, 5).numpy(),
                                  np.asarray(jax.random.split(jk, 5)))
    for shape in ((1,), (7,), (3, 5), (2, 3, 4), (VOCAB,)):
        np.testing.assert_array_equal(
            threefry.random_bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            threefry.uniform(tk, shape).numpy(),
            np.asarray(jax.random.uniform(jk, shape)))
        want = np.asarray(jax.random.gumbel(jk, shape))
        np.testing.assert_allclose(threefry.gumbel(tk, shape).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_categorical_draws_match_jax(seed):
    rng = np.random.default_rng(seed)
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for shape in ((VOCAB,), (4, VOCAB), (3, 97)):
        logits = (rng.standard_normal(shape) * 2).astype(np.float32)
        np.testing.assert_array_equal(
            threefry.categorical(tk, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(jk, jnp.asarray(logits))))
    # a batch of keys, one a row, as under vmap
    logits = (rng.standard_normal((6, VOCAB)) * 2).astype(np.float32)
    seeds = jnp.arange(6) + seed % 1000
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(s),
                                                  3))(seeds)
    tkeys = threefry.fold_in(threefry.prng_key(torch.tensor(
        np.asarray(seeds))), 3)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(
        threefry.categorical(tkeys, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.vmap(jax.random.categorical)(jkeys,
                                                    jnp.asarray(logits))))


# --------------------------------------------------------------------------
# the sampling math against the JAX functions
# --------------------------------------------------------------------------

# per row: (top_k, top_p, temperature); k = 0 and p = 0 switch each off
ROWS = [(0, 0.0, 1.0), (1, 0.0, 0.8), (5, 0.0, 1.2), (VOCAB, 0.0, 1.0),
        (VOCAB + 9, 0.0, 0.7), (0, 1.0, 1.0), (0, 0.9, 0.9), (50, 0.95, 0.8),
        (3, 0.5, 1.5), (0, 0.3, 2.0), (20, 1.0, 0.6), (7, 0.0, 0.0),
        (0, 0.999, 1.0), (4, 0.0, 1.0)]


def _batch(seed):
    rng = np.random.default_rng(seed)
    B = len(ROWS)
    logits = (rng.standard_normal((B, VOCAB))
              * rng.uniform(0.5, 4.0, (B, 1))).astype(np.float32)
    logits[12, :40] = logits[12].max()  # ties at the top
    logits[13] = np.round(logits[13])  # ties at the k-th value
    ks = np.array([r[0] for r in ROWS], np.int32)
    ps = np.array([r[1] for r in ROWS], np.float32)
    ts = np.array([r[2] for r in ROWS], np.float32)
    return logits, ks, ps, ts


def _mass_before(logits, k):
    """Each token's f64 mass before it in the sorted top-k-masked
    distribution (inf for tokens the top-k mask drops)."""
    desc = np.sort(logits)[::-1].astype(np.float64)
    if k > 0:
        kth = desc[min(k, len(desc)) - 1]
        desc = np.where(desc >= kth, desc, -np.inf)
    pr = np.exp(desc - desc[0])
    pr /= pr.sum()
    before = np.cumsum(pr) - pr
    order = np.argsort(-logits, kind="stable")
    out = np.empty(len(logits))
    out[order] = before
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mask_and_sample_rows_match_jax(seed):
    logits, ks, ps, ts = _batch(seed)
    got = tdec._mask_one(torch.from_numpy(logits), torch.from_numpy(ks),
                         torch.from_numpy(ps)).numpy()
    want = np.asarray(jax.vmap(jdec._mask_one)(
        jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(ps)))
    for i in range(len(ROWS)):
        differ = np.isinf(got[i]) != np.isinf(want[i])
        if differ.any():
            near = np.abs(_mass_before(logits[i], ks[i]) - ps[i])
            assert (near[differ] <= 1e-6).all(), (i, ROWS[i])
        kept = ~np.isinf(want[i]) & ~np.isinf(got[i])
        np.testing.assert_array_equal(got[i][kept], want[i][kept])
    seeds = np.arange(len(ROWS), dtype=np.int32) + 100 * seed
    branches = np.arange(len(ROWS), dtype=np.int32) % 3
    steps = np.full(len(ROWS), seed, np.int32)
    jkeys = jdec.row_keys(jnp.asarray(seeds), jnp.asarray(branches),
                          jnp.asarray(steps))
    tkeys = tdec.row_keys(torch.from_numpy(seeds),
                          torch.from_numpy(branches),
                          torch.from_numpy(steps))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    toks = tdec.sample_rows(torch.from_numpy(logits), torch.from_numpy(ts),
                            torch.from_numpy(ks), torch.from_numpy(ps),
                            tkeys)
    jtoks = jdec.sample_rows(jnp.asarray(logits), jnp.asarray(ts),
                             jnp.asarray(ks), jnp.asarray(ps), jkeys)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    # a temperature-0 row takes its argmax, whatever its masks say
    assert toks[11] == int(np.argmax(logits[11]))
    np.testing.assert_allclose(
        tdec.token_logprobs(torch.from_numpy(logits), toks).numpy(),
        np.asarray(jdec.token_logprobs(jnp.asarray(logits), jtoks)),
        rtol=LOGPROB_TOL)


# --------------------------------------------------------------------------
# DecodeSpec and TokenStream
# --------------------------------------------------------------------------

BAD_SPECS = [dict(temperature=-0.1), dict(temperature=float("nan")),
             dict(top_k=-1), dict(top_p=1.5), dict(top_p=-0.1), dict(n=0),
             dict(best_of=-1), dict(best_of=2, n=3), dict(seed=-1),
             dict(seed=2 ** 31)]


def test_spec_defaults_properties_and_validation_match_jax():
    d = DecodeSpec()
    assert not d.sampled and d.branches == 1
    for kw in (dict(temperature=0.5), dict(best_of=3), dict(n=2),
               dict(best_of=4, n=2), dict(top_k=5, top_p=0.9)):
        got, want = DecodeSpec(**kw), jdec.DecodeSpec(**kw)
        assert (got.sampled, got.branches) == (want.sampled, want.branches)
    for bad in BAD_SPECS:
        with pytest.raises(ValueError):
            DecodeSpec(**bad)
        with pytest.raises(ValueError):
            jdec.DecodeSpec(**bad)


def test_spec_wire_roundtrip_key_absent_and_loud():
    assert DecodeSpec().to_wire() == {}
    kw = dict(temperature=0.8, top_p=0.9, best_of=3, seed=7)
    spec = DecodeSpec(**kw)
    assert spec.to_wire() == jdec.DecodeSpec(**kw).to_wire()
    assert "top_k" not in spec.to_wire() and "n" not in spec.to_wire()
    assert DecodeSpec.from_wire(spec.to_wire()) == spec
    with pytest.raises(ValueError, match="unknown"):
        DecodeSpec.from_wire({"temperature": 0.5, "beams": 4})


def test_token_stream_close_idempotent_and_one_shot():
    ts = TokenStream("r1")
    ts._feed([1, 2])
    ts._feed([3])
    ts.close()
    ts.close()  # idempotent: no second sentinel
    assert ts.chunks == 2
    np.testing.assert_array_equal(ts.tokens(), [1, 2, 3])


# --------------------------------------------------------------------------
# the engine against the JAX engine
# --------------------------------------------------------------------------

MIX = [("greedy", 7, None),
       ("sampled", 9, dict(temperature=0.8, top_k=50, top_p=0.95, seed=3)),
       ("hot", 5, dict(temperature=1.3, seed=11)),
       ("nbest", 11, dict(temperature=1.0, best_of=3, n=2, seed=17)),
       ("nucleus", 6, dict(temperature=0.9, top_p=0.5, seed=29))]


def _serve_mix(engine, spec_cls, n_new=8):
    reqs = {}
    for (name, length, kw), p in zip(MIX, _prompts([m[1] for m in MIX],
                                                   seed=3)):
        spec = None if kw is None else spec_cls(**kw)
        reqs[name] = engine.submit(p, n_new, decode=spec)
    engine.run_until_idle()
    for name, r in reqs.items():
        assert r.state == "done", (name, r.state)
    return reqs


def test_engine_streams_match_the_jax_engine(pair):
    """The same mix of greedy, sampled and n-best requests through 6 slots
    of each engine: every request's tokens identical, the n-best ranking
    identical, its log-probabilities to 1e-5 relative."""
    jm, params, tm = pair
    kw = dict(max_slots=6, max_seq_len=64, block_size=8, max_queue=16)
    got = _serve_mix(ServingEngine(tm, **kw), DecodeSpec)
    want = _serve_mix(JEngine(jm, params, prefix_cache=False, **kw),
                      jdec.DecodeSpec)
    for name in got:
        np.testing.assert_array_equal(got[name].tokens, want[name].tokens,
                                      err_msg=name)
    g, w = got["nbest"].n_best, want["nbest"].n_best
    assert [b["branch"] for b in g] == [b["branch"] for b in w]
    assert [b["tokens"] for b in g] == [b["tokens"] for b in w]
    np.testing.assert_allclose([b["logprob"] for b in g],
                               [b["logprob"] for b in w], rtol=LOGPROB_TOL)


# --------------------------------------------------------------------------
# inert defaults, seeded determinism
# --------------------------------------------------------------------------

def test_default_spec_requests_are_bit_identical_to_unset(model):
    """decode=DecodeSpec(), an explicitly greedy spec and stream=True give
    the tokens of a plain submit, with no decoding keys in the record
    (streaming adds only stream_chunks), and generate()'s tokens."""
    (p,) = _prompts([9], seed=2)
    runs = {}
    for name, kw in [("unset", {}), ("default", dict(decode=DecodeSpec())),
                     ("explicit", dict(decode=DecodeSpec(
                         temperature=0.0, top_k=0, top_p=0.0, n=1))),
                     ("streamed", dict(stream=True))]:
        req, eng = _run_one(model, p, 6, **kw)
        runs[name] = (np.asarray(req.tokens), eng.completed[-1])
        if kw.get("stream"):
            np.testing.assert_array_equal(req.stream.tokens(), req.tokens)
    base, base_rec = runs["unset"]
    assert not {"decode", "branches", "stream_chunks"} & set(base_rec)
    for name in ("default", "explicit", "streamed"):
        toks, rec = runs[name]
        np.testing.assert_array_equal(toks, base)
        extra = set(rec) - set(base_rec)
        assert extra == ({"stream_chunks"} if name == "streamed"
                         else set()), (name, extra)
    ref = generate(model, p[None], 6).numpy()
    np.testing.assert_array_equal(base, ref[0, len(p):])


def test_mixed_batch_keeps_greedy_rows_bit_identical(model):
    pg, ps1, ps2 = _prompts([7, 5, 11], seed=4)
    eng = _engine(model)
    rg = eng.submit(pg, 6)
    rs1 = eng.submit(ps1, 6, decode=DecodeSpec(temperature=1.0, seed=1))
    rs2 = eng.submit(ps2, 6, decode=DecodeSpec(temperature=0.9, top_p=0.8,
                                               seed=2))
    eng.run_until_idle()
    assert rg.state == rs1.state == rs2.state == "done"
    ref = generate(model, pg[None], 6).numpy()
    np.testing.assert_array_equal(rg.tokens, ref[0, len(pg):])
    assert (np.asarray(rs1.tokens) < VOCAB).all()
    assert (np.asarray(rs2.tokens) < VOCAB).all()


def test_same_seed_twice_is_bit_identical(model):
    (p,) = _prompts([8], seed=5)
    spec = DecodeSpec(temperature=0.9, top_k=20, top_p=0.95, seed=11)
    r1, _ = _run_one(model, p, 8, decode=spec)
    r2, _ = _run_one(model, p, 8, decode=spec)
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    r3, _ = _run_one(model, p, 8, decode=DecodeSpec(
        temperature=0.9, top_k=20, top_p=0.95, seed=12))
    assert not np.array_equal(r1.tokens, r3.tokens)


def test_sampling_independent_of_batch_composition(model):
    p, q1, q2, q3 = _prompts([8, 5, 13, 6], seed=6)
    spec = DecodeSpec(temperature=1.1, top_p=0.9, seed=21)
    solo, _ = _run_one(model, p, 8, decode=spec)
    eng = _engine(model)
    for q in (q1, q2):
        eng.submit(q, 5)
    crowd = eng.submit(p, 8, decode=spec)  # another slot, other rounds
    eng.submit(q3, 7, decode=DecodeSpec(temperature=0.7, seed=4))
    eng.run_until_idle()
    assert crowd.state == "done"
    np.testing.assert_array_equal(crowd.tokens, solo.tokens)


# --------------------------------------------------------------------------
# n-best branches
# --------------------------------------------------------------------------

def test_n_best_branches_share_prompt_blocks(model):
    """Live branches hold ONE refcounted set of full prompt blocks plus
    private tails; retirement returns every block."""
    prompt = np.arange(1, 17, dtype=np.int32)  # 2 full 8-token blocks
    eng = _engine(model)
    pool = eng.scheduler.pool
    free0 = pool.free_blocks
    spec = DecodeSpec(temperature=0.8, best_of=3, n=2, seed=9)
    req = eng.submit(prompt, 8, request_id="cow", decode=spec)
    eng.step()  # admit, prefill and fork: the branches are live
    sids = branch_seq_ids(req)
    assert sids == ["cow", "cow#b1", "cow#b2"]
    tables = [pool.block_table(s) for s in sids]
    held = {b for t in tables for b in t}
    prompt_blocks = set(tables[0][:2])
    for t in tables[1:]:
        assert set(t[:2]) == prompt_blocks
        assert not (set(t[2:]) & set(tables[0][2:]))
    assert len(held) == 2 + sum(len(t) - 2 for t in tables)
    assert len(held) < sum(len(t) for t in tables)
    assert all(pool.refcount(b) == 3 for b in prompt_blocks)
    eng.run_until_idle()
    assert req.state == "done" and len(req.n_best) == 2
    lps = [b["logprob"] for b in req.n_best]
    assert lps == sorted(lps, reverse=True)
    np.testing.assert_array_equal(req.tokens, req.n_best[0]["tokens"])
    assert req.logprob == pytest.approx(lps[0])
    rec = eng.completed[-1]
    assert rec["branches"] == 3 and rec["decode"]["best_of"] == 3
    assert pool.free_blocks == free0 and pool.live_sequences == 0


def test_n_best_deterministic_and_winner_beats_losers(model):
    (p,) = _prompts([10], seed=8)
    spec = DecodeSpec(temperature=1.0, best_of=3, n=3, seed=17)
    r1, _ = _run_one(model, p, 6, decode=spec)
    r2, _ = _run_one(model, p, 6, decode=spec)
    assert [b["tokens"] for b in r1.n_best] == \
        [b["tokens"] for b in r2.n_best]
    assert [b["branch"] for b in r1.n_best] == \
        [b["branch"] for b in r2.n_best]
    assert r1.n_best[0]["logprob"] >= r1.n_best[-1]["logprob"]


def test_fork_backpressure_is_all_or_nothing_no_leak():
    sched = Scheduler(KVPool(num_blocks=4, block_size=4), max_queue=8)
    filler = sched.submit([1, 2], 2)  # 1 block
    assert sched.next_admissions(4) == [filler]
    assert sched.pool.free_blocks == 3
    spec = DecodeSpec(temperature=1.0, best_of=2, seed=3)
    b = sched.submit(np.arange(1, 9, dtype=np.int32), 4, decode=spec)
    # the primary's 3 blocks fit, the tail's 1 more does not: roll back
    assert sched.next_admissions(4) == []
    assert b.state == "queued"
    assert sched.pool.free_blocks == 3 and sched.pool.live_sequences == 1
    sched.retire(filler, np.asarray([5, 6], np.int32))
    assert sched.next_admissions(4) == [b]
    # 3 primary blocks + 1 forked tail, the 2 prompt blocks shared
    assert sched.pool.free_blocks == 0
    t0 = sched.pool.block_table(b.request_id)
    t1 = sched.pool.block_table(branch_seq_ids(b)[1])
    assert t1[:2] == t0[:2] and t1[2] != t0[2]
    # and a branched head needs one free slot a branch
    c = sched.submit([1], 2, decode=DecodeSpec(best_of=3, temperature=1.0))
    sched.fail(b, "test")
    assert sched.next_admissions(2) == [] and c.state == "queued"
    assert sched.next_admissions(3) == [c]


def test_branch_count_validated_against_slots(model):
    eng = _engine(model, max_slots=2)
    with pytest.raises(ValueError, match="branches"):
        eng.submit([1, 2, 3], 4, decode=DecodeSpec(best_of=3))
    with pytest.raises(ValueError, match="DecodeSpec"):
        eng.submit([1, 2, 3], 4, decode={"temperature": 1.0})


def test_branches_retire_independently_on_eos(model):
    """With an eos token, each branch retires at its OWN eos or budget and
    frees its tail; the ranking still covers every branch."""
    (p,) = _prompts([8], seed=15)
    budget = 10
    # eos: a token the model likes here (its third greedy token), so that
    # top-2 sampled branches meet it at different steps
    eos = int(generate(model, p[None], 3)[0, -1])
    for seed in range(40):
        eng = _engine(model, eos_token=eos)
        req = eng.submit(p, budget, decode=DecodeSpec(
            temperature=1.0, top_k=2, best_of=3, n=3, seed=seed))
        eng.run_until_idle()
        assert req.state == "done"
        assert eng.scheduler.pool.live_sequences == 0  # no leak, ever
        lens = [len(b["tokens"]) for b in req.n_best]
        for b in req.n_best:
            assert len(b["tokens"]) == budget or b["tokens"][-1] == eos
        if min(lens) < max(lens):
            return
    pytest.fail("no seed produced ragged branch retirement")


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------

def test_streaming_chunks_concatenate_and_chunking_is_presentation(model):
    (p,) = _prompts([9], seed=12)
    plain, _ = _run_one(model, p, 6)
    eng1 = _engine(model)  # stream_chunk_tokens=1: every token a chunk
    r1 = eng1.submit(p, 6, stream=True)
    eng1.run_until_idle()
    chunks1 = list(r1.stream)
    assert len(chunks1) == 6 and len(chunks1[0]) == 1  # TTFT chunk first
    eng3 = _engine(model, stream_chunk_tokens=3)
    r3 = eng3.submit(p, 6, stream=True)
    eng3.run_until_idle()
    chunks3 = list(r3.stream)
    assert [len(c) for c in chunks3] == [1, 3, 2]  # prefill, 3, flush
    for r, chunks in ((r1, chunks1), (r3, chunks3)):
        np.testing.assert_array_equal(np.concatenate(chunks), plain.tokens)
        np.testing.assert_array_equal(r.tokens, plain.tokens)
    assert eng1.completed[-1]["stream_chunks"] == 6
    assert eng3.completed[-1]["stream_chunks"] == 3


def test_stream_of_sampled_request_and_rejection_closes(model):
    (p,) = _prompts([7], seed=13)
    spec = DecodeSpec(temperature=0.9, seed=31)
    ref, _ = _run_one(model, p, 6, decode=spec)
    eng = _engine(model)
    r = eng.submit(p, 6, decode=spec, stream=True)
    eng.run_until_idle()
    np.testing.assert_array_equal(r.stream.tokens(), ref.tokens)
    eng2 = _engine(model, max_queue=1)
    eng2.scheduler.drain()
    r2 = eng2.submit(p, 4, stream=True)
    assert r2.state == "rejected" and r2.stream.tokens().size == 0
    with pytest.raises(ValueError, match="stream"):
        eng.submit([1, 2, 3], 4, stream=True,
                   decode=DecodeSpec(temperature=1.0, best_of=2))


def test_server_stream_front_end(model):
    (p,) = _prompts([8], seed=14)
    srv = InferenceServer(_engine(model)).start()
    try:
        stream = srv.stream(p, 5, decode=DecodeSpec(temperature=0.7,
                                                    seed=5))
        got = list(stream)
        r = srv.submit(p, 5, decode=DecodeSpec(temperature=0.7, seed=5))
        assert r.done.wait(120)
    finally:
        srv.stop()
    assert stream.request.state == "done"
    np.testing.assert_array_equal(np.concatenate(got), stream.request.tokens)
    np.testing.assert_array_equal(r.tokens, stream.request.tokens)

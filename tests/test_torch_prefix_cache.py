"""Port parity of the prefix cache (``serve/kv_pool.py``'s cached ring,
``serve/prefix_cache.py``, the scheduler's prefix admission and the
engine's block store, restore and suffix prefill), held against the JAX
package on the CPU at the tiny llama's shape (``tests/conftest.py``'s
``tiny_llama``: 2 layers, d 64, 4/2 heads, vocab 97, f32; its weights
carried by ``utils.interop``).

- The pool: one seeded script of reserve (shared, cached), fork, extend,
  free with retain, touch, pin, unpin and release_cached drives the JAX
  ``KVPool`` and the port's; the free list, the cached ring's LRU order,
  refcounts, tables and pins are equal after every op.
- The index: one seeded script of admit (shared heads, copy-on-write
  tails, two adapters, a pool small enough to evict and to defer),
  finish_restore, release, abandon, make_room and peek drives the JAX
  ``PrefixCache`` and the port's; every match, the digests (byte for byte,
  adapter roots included), the nodes' links, the pool and ``stats()`` are
  equal after every op.
- The JAX package's own unit cases of the pool and the index, on the port.
- The engine against the JAX engine is ``test_torch_prefix_engine.py``,
  with this file's ``models`` fixture.
"""

import jax
import numpy as np
import pytest

from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.serve import KVPool as JKVPool
from pytorch_distributed_nn_tpu.serve import PrefixCache as JPrefixCache
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.serve import (
    KVPool,
    PrefixCache,
    Scheduler,
)
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
)

VOCAB = 97
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            mlp_dim=128, vocab_size=VOCAB)
LM_EXTRA = dict(num_layers=2, d_model=32, num_heads=4, mlp_dim=64,
                vocab_size=VOCAB, max_len=64)
ENGINE = dict(max_slots=3, max_seq_len=64, block_size=8, max_queue=32)
N_NEW = 6


def _port_llama(params, cache_dtype="compute"):
    tm = get_model(ModelConfig(name="llama3_8b", compute_dtype="float32",
                               dtype="float32",
                               extra=dict(TINY, cache_dtype=cache_dtype)),
                   device="cpu")
    tm.load_state_dict(llama_params_from_jax(jax.device_get(params)))
    return tm.eval()


@pytest.fixture(scope="module")
def models(tiny_llama):
    """{cache dtype: (JAX model, params, port model)}, the same weights."""
    jm, params = tiny_llama
    jm8 = jget_model(JModelConfig(name="llama3_8b", compute_dtype="float32",
                                  dtype="float32",
                                  extra=dict(TINY, cache_dtype="int8")))
    return {"compute": (jm, params, _port_llama(params)),
            "int8": (jm8, params, _port_llama(params, "int8"))}


# --------------------------------------------------------------------------
# the pool's cached ring against the JAX pool, op for op
# --------------------------------------------------------------------------

def _pool_state(p):
    return dict(free=list(p._free), cached=list(p._cached),
                ref=dict(p._ref), tables={k: list(v)
                                          for k, v in p._tables.items()},
                pinned=set(p._pinned), free_blocks=p.free_blocks,
                cached_blocks=p.cached_blocks,
                utilization=p.utilization())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_cached_ring_matches_jax_op_for_op(seed):
    """120 seeded ops, each valid against the JAX pool's state (which must
    equal the port's), applied to both pools."""
    j, t = JKVPool(num_blocks=20, block_size=4), KVPool(num_blocks=20,
                                                        block_size=4)
    rng = np.random.default_rng(seed)
    live: list[str] = []
    n = 0
    for _ in range(120):
        op = rng.choice(["reserve", "fork", "extend", "free", "touch",
                         "pin", "unpin", "release"])
        cached = list(j._cached)
        if op == "reserve":
            k = int(rng.integers(0, len(cached) + 1))
            shared = [int(b) for b in rng.permutation(cached)[:k]]
            if live and rng.random() < 0.3:
                shared += list(j.block_table(live[0])[:1])
            tokens = 4 * len(shared) + int(rng.integers(0, 13))
            sid = f"s{n}"
            n += 1
            got = [p.reserve(sid, tokens, shared=shared) for p in (j, t)]
            assert got[0] == got[1]
            if got[0]:
                live.append(sid)
        elif op == "fork" and live:
            parent = live[int(rng.integers(0, len(live)))]
            tokens = 4 * len(j.block_table(parent))
            sid = f"s{n}"
            n += 1
            shared_tokens = int(rng.integers(0, tokens + 1))
            got = [p.fork(parent, sid, tokens, shared_tokens=shared_tokens)
                   for p in (j, t)]
            assert got[0] == got[1]
            if got[0]:
                live.append(sid)
        elif op == "extend" and live:
            sid = live[int(rng.integers(0, len(live)))]
            tokens = int(rng.integers(0, 4 * len(j.block_table(sid)) + 1))
            for p in (j, t):
                p.extend(sid, tokens)
        elif op == "free" and live:
            sid = live.pop(int(rng.integers(0, len(live))))
            table = j.block_table(sid)
            retain = frozenset(int(b) for b in table
                               if rng.random() < 0.6)
            assert j.free(sid, retain=retain) == t.free(sid, retain=retain)
        elif op in ("touch", "pin", "unpin", "release") and cached:
            b = int(rng.choice(cached))
            if op == "release":
                assert j.release_cached(b) == t.release_cached(b)
            else:
                name = {"touch": "touch_cached"}.get(op, op)
                for p in (j, t):
                    getattr(p, name)(b)
        assert _pool_state(j) == _pool_state(t), (seed, op)
        for b in range(20):
            assert j.refcount(b) == t.refcount(b)
            assert j.is_cached(b) == t.is_cached(b)
    assert n > 10


# --------------------------------------------------------------------------
# the index against the JAX PrefixCache, op for op
# --------------------------------------------------------------------------

def _index_state(pc):
    nodes = {d: (n.parent, n.tokens.tolist(), n.phys, sorted(n.children))
             for d, n in pc._nodes.items()}
    return dict(nodes=nodes, by_phys=dict(pc._by_phys), stats=pc.stats(),
                pool=_pool_state(pc.pool))


def _match(m):
    return None if m is None else (m.blocks, m.tail, m.tokens,
                                   m.restore_blocks)


# scripts on which the JAX module never evicts its own match (see below);
# between them they take copy-on-write tails and deferrals
INDEX_CASES = [(0, 12), (0, 16), (0, 24), (1, 24), (2, 24), (2, 40),
               (3, 16), (5, 40)]


@pytest.mark.parametrize("seed,num_blocks", INDEX_CASES)
def test_prefix_index_matches_jax_op_for_op(seed, num_blocks):
    """150 seeded ops (admit, finish_restore, release, abandon, make_room,
    peek; 20% of the prompts end inside another live request's rows) on
    a pool of ``num_blocks`` blocks of 4, each compared after the op."""
    _index_script(seed, num_blocks)


def test_index_scripts_cover_tails_and_deferrals():
    kinds = set()
    for seed, num_blocks in INDEX_CASES[:4]:
        kinds |= _index_script(seed, num_blocks)
    assert {"hit", "miss", "cow", "defer"} <= kinds


def test_admission_never_evicts_its_own_match():
    """Two cached chains, the matched one least recently parked: the JAX
    module's admission sheds the matched chain's leaf to make room, and
    its reservation raises on that block (a fault of the JAX package,
    ROADMAP.md §3); the port's sheds the other chain and admits the hit."""
    bs = 4
    a = np.arange(1, 9, dtype=np.int32)  # 2 blocks
    c = np.arange(40, 44, dtype=np.int32)  # 1 block
    prompt = np.concatenate([a, [77]]).astype(np.int32)
    out = []
    for pool_cls, pc_cls in ((JKVPool, JPrefixCache), (KVPool, PrefixCache)):
        pc = pc_cls(pool_cls(5, bs))
        for sid, p in (("a", a), ("c", c)):
            pc.admit(sid, p, len(p))
            pc.release(sid, p)
        assert pc.pool.cached_lru() == [0, 1, 2]
        try:
            out.append(pc.admit("x", prompt, 20))
        except ValueError as e:
            out.append(str(e))
    assert "stale" in out[0]
    assert out[1].tokens == 8 and out[1].blocks == (0, 1)
    assert pc.stats()["prefix_evictions"] == 1 and pc.peek(c) == 0


def _index_script(seed, num_blocks):
    bs = 4
    jp = JPrefixCache(JKVPool(num_blocks, bs), max_rows=48)
    tp = PrefixCache(KVPool(num_blocks, bs), max_rows=48)
    rng = np.random.default_rng(seed)
    bases = [rng.integers(1, VOCAB, size=20).astype(np.int32)
             for _ in range(3)]
    restoring: dict[str, tuple] = {}  # seq -> (JAX match, port match)
    live: dict[str, tuple] = {}  # seq -> (prompt, adapter)
    kinds = set()
    for i in range(150):
        op = rng.choice(["admit", "admit", "finish", "release", "release",
                         "abandon", "make_room", "peek"])
        if op in ("admit", "peek"):
            adapter = int(rng.integers(0, 2))
            head = bases[int(rng.integers(0, 3))][:int(rng.integers(3, 21))]
            if live and rng.random() < 0.3:
                # a prompt ending inside another request's written rows:
                # a copy-on-write tail when it is resident
                p, a = live[list(live)[int(rng.integers(0, len(live)))]]
                head, adapter = p[:int(rng.integers(2, len(p) + 1))], a
            suffix = rng.integers(1, VOCAB, size=int(rng.integers(0, 6)))
            prompt = np.concatenate([head, suffix]).astype(np.int32)
            if op == "peek":
                assert jp.peek(prompt, adapter) == tp.peek(prompt, adapter)
                assert _match(jp.resident_chain(prompt, adapter)) == \
                    _match(tp.resident_chain(prompt, adapter))
                continue
            sid = f"s{i}"
            total = len(prompt) + int(rng.integers(1, 8))
            got = [pc.admit(sid, prompt, total, adapter=adapter)
                   for pc in (jp, tp)]
            assert _match(got[0]) == _match(got[1]), i
            if got[0] is not None:
                kinds.add("hit" if got[0].tokens else "miss")
                if got[0].tail is not None:
                    kinds.add("cow")
                if rng.random() < 0.6:  # restored at once
                    for pc, m in zip((jp, tp), got):
                        pc.finish_restore(m)
                else:  # pinned across later ops
                    restoring[sid] = tuple(got)
                written = rng.integers(1, VOCAB, size=total - len(prompt))
                live[sid] = (np.concatenate([prompt, written[:-1]]),
                             adapter)
            else:
                kinds.add("defer")
        elif op == "finish" and restoring:
            sid = list(restoring)[int(rng.integers(0, len(restoring)))]
            for pc, m in zip((jp, tp), restoring.pop(sid)):
                pc.finish_restore(m)
        elif op in ("release", "abandon"):
            done = [s for s in live if s not in restoring]
            if not done:
                continue
            sid = done[int(rng.integers(0, len(done)))]
            covered, adapter = live.pop(sid)
            if op == "release":
                got = [pc.release(sid, covered, adapter=adapter)
                       for pc in (jp, tp)]
            else:
                got = [pc.abandon(sid) for pc in (jp, tp)]
            assert got[0] == got[1]
        elif op == "make_room":
            k = int(rng.integers(1, 6))
            assert jp.make_room(k) == tp.make_room(k)
        assert _index_state(jp) == _index_state(tp), (i, op)
    assert jp.stats() == tp.stats()
    assert {"hit", "miss"} <= kinds and tp.stats()["prefix_evictions"] > 0
    return kinds


def test_digests_are_the_jax_digests_byte_for_byte():
    from pytorch_distributed_nn_tpu.serve import prefix_cache as jpc
    from pytorch_distributed_nn_tpu_torch.serve import prefix_cache as tpc

    toks = np.arange(7, 23, dtype=np.int32)
    for adapter in (0, 1, 13):
        assert tpc._root(adapter) == jpc._root(adapter)
        d_j = d_t = jpc._root(adapter)
        for j in range(4):
            d_j = jpc._digest(d_j, toks[4 * j:4 * j + 4])
            d_t = tpc._digest(d_t, toks[4 * j:4 * j + 4])
            assert d_j == d_t and len(d_t) == 20


# --------------------------------------------------------------------------
# the JAX package's unit cases of the pool and the index, on the port
# --------------------------------------------------------------------------

def test_pool_shared_blocks_refcount_and_cached_parking():
    pool = KVPool(num_blocks=8, block_size=4)
    assert pool.reserve("a", 12)
    table = pool.block_table("a")
    pool.free("a", retain=frozenset(table[:2]))
    assert pool.cached_blocks == 2 and pool.free_blocks == 6
    assert pool.is_cached(table[0]) and not pool.is_cached(table[2])
    assert pool.reserve("b", 12, shared=table[:2])
    assert pool.cached_blocks == 0 and pool.refcount(table[0]) == 1
    assert pool.block_table("b")[:2] == table[:2]
    assert pool.reserve("c", 12, shared=table[:2])
    assert pool.refcount(table[0]) == 2
    pool.free("b")
    assert pool.refcount(table[0]) == 1 and not pool.is_cached(table[0])
    pool.free("c", retain=frozenset(table[:2]))
    assert pool.cached_blocks == 2 and pool.live_sequences == 0
    assert pool.utilization() == 0.0  # cached blocks are headroom
    with pytest.raises(ValueError, match="stale"):
        pool.reserve("d", 4, shared=[table[2]])


def test_pool_pin_blocks_eviction_and_lru_order():
    pool = KVPool(num_blocks=4, block_size=4)
    assert pool.reserve("a", 16)
    t = pool.block_table("a")
    pool.free("a", retain=frozenset(t))
    assert pool.cached_lru() == list(t)
    pool.touch_cached(t[0])
    assert pool.cached_lru() == list(t[1:]) + [t[0]]
    pool.pin(t[1])
    assert not pool.release_cached(t[1])
    pool.unpin(t[1])
    assert pool.release_cached(t[1])
    assert not pool.release_cached(t[1])
    assert pool.free_blocks == 1


def test_prefix_match_donate_hit_and_last_token_cap():
    pc = PrefixCache(KVPool(num_blocks=16, block_size=4), max_rows=64)
    prompt = np.arange(1, 13, dtype=np.int32)
    m = pc.admit("a", prompt, 16)
    assert m is not None and m.tokens == 0
    pc.release("a", prompt)
    m2 = pc.admit("b", prompt, 16)
    assert m2.tokens == 11 and len(m2.blocks) == 2 and m2.tail is not None
    pc.finish_restore(m2)
    st = pc.stats()
    assert (st["prefix_hits"], st["prefix_misses"],
            st["prefix_tokens_saved"]) == (1, 1, 11)


def test_prefix_cow_divergence_mid_block():
    pool = KVPool(num_blocks=16, block_size=4)
    pc = PrefixCache(pool, max_rows=64)
    p1 = np.arange(1, 13, dtype=np.int32)
    pc.admit("a", p1, 16)
    pc.release("a", p1)
    p2 = np.concatenate([p1[:10], np.asarray([99], np.int32)])
    m = pc.admit("b", p2, 16)
    assert m.tokens == 10 and len(m.blocks) == 2 and m.tail is not None
    assert not pool.release_cached(m.tail)  # pinned until restored
    pc.finish_restore(m)
    assert pool.block_table("b")[2] != m.tail
    p3 = np.concatenate([p1[:10], np.asarray([90, 91], np.int32)])
    m3 = pc.admit("c", p3, 16)
    assert m3.tokens == 8 and m3.tail is None


def test_prefix_eviction_under_pressure_then_re_prefill():
    pool = KVPool(num_blocks=4, block_size=4)
    pc = PrefixCache(pool, max_rows=16)
    p1 = np.arange(1, 9, dtype=np.int32)
    pc.admit("a", p1, 8)
    pc.release("a", p1)
    assert pool.cached_blocks == 2
    p2 = np.arange(50, 58, dtype=np.int32)
    m = pc.admit("b", p2, 16)
    assert m.tokens == 0 and pc.stats()["prefix_evictions"] == 2
    pc.release("b", p2)
    assert pc.admit("c", p1, 8).tokens == 0
    assert pc.stats()["prefix_misses"] == 3


def test_prefix_adapter_namespaces_do_not_cross_match():
    pc = PrefixCache(KVPool(num_blocks=16, block_size=4), max_rows=64)
    prompt = np.arange(1, 13, dtype=np.int32)
    pc.admit("a", prompt, 16, adapter=0)
    pc.release("a", prompt, adapter=0)
    assert pc.peek(prompt, adapter=0) == 11
    assert pc.peek(prompt, adapter=1) == 0
    assert pc.admit("b", prompt, 16, adapter=1).tokens == 0


def test_prefix_abandon_keeps_pool_consistent():
    pool = KVPool(num_blocks=8, block_size=4)
    pc = PrefixCache(pool, max_rows=32)
    prompt = np.arange(1, 9, dtype=np.int32)
    pc.admit("a", prompt, 8)
    pc.abandon("a")
    assert pool.live_sequences == 0 and pc.peek(prompt) == 0
    assert pool.free_blocks == 8


def test_prefix_defer_leaves_no_pin_and_no_reservation():
    pool = KVPool(num_blocks=6, block_size=4)
    pc = PrefixCache(pool, max_rows=24)
    p1 = np.arange(1, 13, dtype=np.int32)
    pc.admit("a", p1, 12)
    pc.release("a", p1)
    assert pc.admit("x", np.arange(60, 64, dtype=np.int32), 8) is not None
    # a tail match that cannot reserve: deferred, tail unpinned
    m = pc.admit("b", np.concatenate([p1[:10], [5]]).astype(np.int32), 24)
    assert m is None and pool.block_table("b") == ()
    assert not pool._pinned
    assert pc.stats()["prefix_hits"] == 0


def test_scheduler_retire_donates_and_fail_abandons():
    pool = KVPool(num_blocks=16, block_size=4)
    pc = PrefixCache(pool)
    s = Scheduler(pool, prefix_cache=pc)
    a = s.submit(np.arange(1, 10), 4, adapter=2)
    assert a.adapter == 2
    (adm,) = s.next_admissions(free_slots=2)
    assert adm.prefix_match.tokens == 0
    s.retire(adm, np.asarray([11, 12, 13, 14], np.int32))
    # 9 prompt + 3 written tokens: 3 full blocks indexed under adapter 2
    assert pc.nodes == 3 and pool.cached_blocks == 3
    assert pc.peek(np.arange(1, 10), adapter=2) == 8
    b = s.submit(np.arange(1, 10), 4, adapter=2)
    (adm,) = s.next_admissions(free_slots=2)
    assert adm is b and b.prefix_match.tokens == 8
    pc.finish_restore(b.prefix_match)
    s.fail(b, "engine_error")
    assert b.state == "failed" and pool.live_sequences == 0
    assert pc.nodes == 3 and pool.cached_blocks == 3

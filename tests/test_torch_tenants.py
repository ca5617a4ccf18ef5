"""Port parity of tenant quotas and the deficit round-robin across tenants
(``serve/scheduler.py``, the engine's ``tenant_quotas``), held against the
JAX package on the CPU, and the engine's greedy contract under them.

- One seeded script of submits across four tenants (two with quotas,
  oversize prompts, expired deadlines, best-of-2 requests), admissions at
  varied free slots, retirements and a drain drives the JAX ``Scheduler``
  and the port's: every request's state and reject reason, the admission
  order, the per-tenant counts by state (the JAX
  ``serve_tenant_requests_total{tenant,state}`` counter against the port's
  ``stats()``), the queue depth, the tenants' live residency and the pool
  are equal after every op.
- The JAX package's three tenant cases (``tests/test_prefix_cache.py``)
  on the port's scheduler and engine.
- A flood tenant and two light tenants through the JAX engine and the
  port's on the same weights: rejects, admission rounds and tokens equal.
- Greedy rows through an engine of 3 and 8 slots under the rotation give,
  for every request, the next-token logits of a solo ``generate()`` bit
  for bit (the decode step's dense products run on fixed row blocks,
  ``nn.layers.dense_product``), for a Llama and the transformer LM (f32
  here, whose products the CPU library also orders by M; bf16 on the
  card, ``test_torch_cuda.py``).
"""

import time

import jax
import numpy as np
import pytest
import torch

from chip_smoke import f1_engine_logits, f1_solo_logits
from pytorch_distributed_nn_tpu import obs
from pytorch_distributed_nn_tpu.runtime import chaos
from pytorch_distributed_nn_tpu.serve import KVPool as JKVPool
from pytorch_distributed_nn_tpu.serve import Scheduler as JScheduler
from pytorch_distributed_nn_tpu.serve import ServingEngine as JEngine
from pytorch_distributed_nn_tpu.serve import decoding as jdec
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.serve import (
    DecodeSpec,
    KVPool,
    Scheduler,
    ServingEngine,
)
from pytorch_distributed_nn_tpu_torch.serve.scheduler import branch_seq_ids
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
)

VOCAB = 97
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            mlp_dim=128, vocab_size=VOCAB)
STATES = ("queued", "running", "done", "rejected", "failed")
TENANTS = ("a", "b", "c", "default")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Disarmed chaos and a fresh JAX metric registry per test."""
    monkeypatch.delenv(chaos.ENV_CHAOS, raising=False)
    chaos.reset()
    obs.reset_registry()
    yield
    chaos.reset()


def _jax_counts(tenants):
    c = obs.get_registry().counter("serve_tenant_requests_total")
    out = {}
    for tenant in tenants:
        row = {s: int(c.value(tenant=tenant, state=s)) for s in STATES}
        row = {s: n for s, n in row.items() if n}
        if row:
            out[tenant] = row
    return out


def _port_counts(sched):
    return sched.stats()["serve_tenant_requests_total"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_tenants_match_jax_op_for_op(seed):
    """160 seeded ops on both schedulers; everything observable equal after
    each."""
    kw = dict(max_queue=6, max_seq_len=40, max_prefills_per_round=2,
              tenant_quotas={"a": 2, "b": 3})
    j = JScheduler(JKVPool(24, 4), **kw)
    t = Scheduler(KVPool(24, 4), **kw)
    rng = np.random.default_rng(seed)
    reqs: list[tuple] = []
    running: list[tuple] = []
    n = 0
    for i in range(160):
        op = rng.choice(["submit", "submit", "submit", "admit", "retire"])
        if i == 150:
            op = "drain"
        if op == "submit":
            tenant = str(rng.choice(TENANTS))
            prompt = rng.integers(1, VOCAB, size=int(rng.integers(1, 13)))
            new = int(rng.integers(1, 41))
            deadline = (time.monotonic() - 1.0 if rng.random() < 0.1
                        else None)
            nbest = rng.random() < 0.15
            specs = ((jdec.DecodeSpec(temperature=0.8, best_of=2, seed=3),
                      DecodeSpec(temperature=0.8, best_of=2, seed=3))
                     if nbest else (None, None))
            rid = f"r{n}"
            n += 1
            pair = tuple(s.submit(prompt, new, request_id=rid,
                                  tenant=tenant, deadline_s=deadline,
                                  decode=d)
                         for s, d in zip((j, t), specs))
            reqs.append(pair)
        elif op == "admit":
            free = int(rng.integers(0, 5))
            got = [s.next_admissions(free) for s in (j, t)]
            assert [r.request_id for r in got[0]] == \
                [r.request_id for r in got[1]]
            running += list(zip(*got))
        elif op == "retire" and running:
            jr, tr = running.pop(int(rng.integers(0, len(running))))
            toks = rng.integers(1, VOCAB, size=int(rng.integers(1, 5)))
            if jr.branches > 1:
                for s, r in ((j, jr), (t, tr)):
                    for sid in branch_seq_ids(r):
                        s.release_branch(r, sid)
                    s.finish_branches(r, toks, [], 0.0)
            else:
                j.retire(jr, toks)
                t.retire(tr, toks)
        elif op == "drain":
            assert j.drain() == t.drain()
        for jr, tr in reqs:
            assert (jr.state, jr.reject_reason, jr.round_admitted) == \
                (tr.state, tr.reject_reason, tr.round_admitted)
        assert _jax_counts(TENANTS) == _port_counts(t)
        assert j.queue_depth == t.queue_depth
        assert {k: v for k, v in j._live.items() if v} == \
            {k: v for k, v in t._live.items() if v}
        assert j.pool.free_blocks == t.pool.free_blocks
        j.round += 1
        t.round += 1
    reasons = {r.reject_reason for _, r in reqs}
    assert {"tenant_quota", "too_large", "backpressure", "deadline",
            "draining"} <= reasons


def test_quota_counts_queued_and_running_and_one_per_nbest():
    """A quota of 2 holds while the two requests run, frees as they retire,
    and a best-of-3 request holds one residency, not three."""
    s = Scheduler(KVPool(32, 4), tenant_quotas={"a": 2})
    first = [s.submit([1, 2], 2, tenant="a") for _ in range(2)]
    assert s.submit([1], 2, tenant="a").reject_reason == "tenant_quota"
    assert len(s.next_admissions(4)) == 2
    assert s.submit([1], 2, tenant="a").reject_reason == "tenant_quota"
    s.retire(first[0], np.asarray([5]))
    nb = s.submit([1, 2], 2, tenant="a",
                  decode=DecodeSpec(temperature=0.5, best_of=3))
    assert nb.state == "queued"
    assert s.submit([1], 2, tenant="a").reject_reason == "tenant_quota"
    assert _port_counts(s)["a"] == dict(queued=3, running=2, done=1,
                                        rejected=3)


def test_quota_must_be_positive():
    with pytest.raises(ValueError, match="quota must be >= 1"):
        Scheduler(KVPool(8, 4), tenant_quotas={"a": 0})


# -- the JAX package's tenant cases (tests/test_prefix_cache.py) on the port


def test_tenant_quota_rejects_flood_not_neighbors():
    s = Scheduler(KVPool(16, 4), max_queue=64, tenant_quotas={"flood": 2})
    flood = [s.submit([1, 2], 2, tenant="flood") for _ in range(5)]
    light = s.submit([3, 4], 2, tenant="light")
    assert [r.state for r in flood[:2]] == ["queued", "queued"]
    assert all(r.state == "rejected"
               and r.reject_reason == "tenant_quota"
               for r in flood[2:])
    assert light.state == "queued"  # unquoted neighbor: untouched
    c = _port_counts(s)
    assert c["flood"]["rejected"] == 3
    assert c["flood"]["queued"] == 2
    assert c["light"]["queued"] == 1


def test_drr_rotation_prevents_tenant_starvation():
    s = Scheduler(KVPool(64, 4), max_prefills_per_round=2)
    flood = [s.submit([1, 2], 2, tenant="flood") for _ in range(6)]
    light = s.submit([9, 8], 2, tenant="light")
    first = s.next_admissions(free_slots=2)
    second = s.next_admissions(free_slots=2)
    admitted = [r.request_id for r in first + second]
    assert light.request_id in admitted, \
        "light tenant starved behind the flood"
    assert any(r.request_id in admitted for r in flood)


def _port_llama(params, compute_dtype="float32"):
    tm = get_model(ModelConfig(name="llama3_8b", compute_dtype=compute_dtype,
                               dtype="float32", extra=dict(TINY)),
                   device="cpu")
    tm.load_state_dict(llama_params_from_jax(jax.device_get(params)))
    return tm.eval()


def test_engine_flood_cannot_starve_light_tenant(tiny_llama):
    _, params = tiny_llama
    eng = ServingEngine(_port_llama(params), max_slots=2, max_seq_len=32,
                        block_size=8, max_queue=64,
                        tenant_quotas={"flood": 2})
    flood, rejected = [], 0
    for i in range(10):
        r = eng.submit(np.asarray([10 + i], np.int32), 2, tenant="flood")
        rejected += r.state == "rejected"
        flood.append(r)
    light = [eng.submit(np.asarray([40 + i, 41], np.int32), 2,
                        tenant="light") for i in range(3)]
    eng.run_until_idle()
    assert all(r.state == "done" for r in light)
    c = eng.summary()["serve_tenant_requests_total"]
    assert c["light"]["done"] == 3
    assert c["flood"]["rejected"] == rejected > 0
    assert c["flood"]["done"] >= 2
    assert {rec["tenant"] for rec in eng.completed} == {"flood", "light"}


def test_engine_tenants_match_jax_engine(tiny_llama):
    """A flood of 8 (quota 2) and two light tenants of 3, all submitted
    before the first round, through both engines: rejects, admission
    rounds, tokens and the records' tenants equal."""
    jm, params = tiny_llama
    rng = np.random.default_rng(5)
    stream = [("flood", rng.integers(1, VOCAB, size=int(n)))
              for n in rng.integers(3, 20, size=8)]
    for tenant in ("light1", "light2"):
        stream += [(tenant, rng.integers(1, VOCAB, size=int(n)))
                   for n in rng.integers(3, 20, size=3)]
    kw = dict(max_slots=3, max_seq_len=64, block_size=8, max_queue=32,
              tenant_quotas={"flood": 2})
    out = []
    for eng in (JEngine(jm, params, **kw),
                ServingEngine(_port_llama(params), **kw)):
        order = _admission_order(eng)
        reqs = [eng.submit(p.astype(np.int32), 5, tenant=tn,
                           request_id=f"q{i}")
                for i, (tn, p) in enumerate(stream)]
        eng.run_until_idle()
        out.append((reqs, order, sorted((r["request_id"], r["tenant"])
                                        for r in eng.completed)))
    (jr, jorder, jrec), (tr, torder, trec) = out
    assert (jorder, jrec) == (torder, trec)
    for a, b in zip(jr, tr):
        assert (a.state, a.reject_reason, a.round_admitted) == \
            (b.state, b.reject_reason, b.round_admitted)
        if a.ok:
            np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
    assert sum(r.reject_reason == "tenant_quota" for r in tr) == 6
    # each light head waits for at most one admission of each other tenant
    assert max(_waits(torder).values()) <= 2


def _admission_order(eng):
    """Record the (tenant, request id) of every admission, in order."""
    order = []
    admit = eng.scheduler.next_admissions

    def recorded(free_slots):
        got = admit(free_slots)
        order.extend((r.tenant, r.request_id) for r in got)
        return got

    eng.scheduler.next_admissions = recorded
    return order


def _waits(order):
    """For each admitted request of a tenant with requests queued from the
    start: the admissions of other tenants since its tenant's previous
    admission (or the first)."""
    waits, last = {}, {}
    for i, (tenant, rid) in enumerate(order):
        waits[rid] = i - last.get(tenant, -1) - 1
        last[tenant] = i
    return waits


# -- the greedy contract under the rotation: logits bit for bit ----------


@pytest.mark.parametrize("name", ["llama3_8b", "transformer_lm"])
def test_engine_rows_are_solo_generate_logits_bit_for_bit(name):
    extra = dict(TINY) if name == "llama3_8b" else dict(
        num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
        vocab_size=VOCAB, max_len=128)
    model = get_model(ModelConfig(name=name, compute_dtype="float32",
                                  extra=extra), device="cpu")
    model.init_params(seed=16)
    model.eval()
    rng = np.random.default_rng(16)
    for slots in (3, 8):
        tenants = [("flood", "light")[i % 3 == 2] for i in range(slots)]
        prompts = [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
                   for n in rng.integers(4, 40, size=slots)]
        served = f1_engine_logits(model, prompts, slots, n_new=6,
                                  tenants=tenants)
        for t, p, (logits, toks) in zip(tenants, prompts, served):
            ref, ref_toks = f1_solo_logits(model, p, n_new=6)
            np.testing.assert_array_equal(toks, ref_toks)
            assert len(logits) == len(ref) == 6
            for step, (a, b) in enumerate(zip(logits, ref)):
                assert torch.equal(a, b), (slots, t, step)

"""The port's rendezvous store (``runtime/native.py``, c10d's
``TCPStore``) against the JAX package's C++ store: one script of
operations runs on each, and the results must be equal — set/get and
overwrite, ``add`` counters, check/delete, a timed-out ``get``, a blocking
``get`` woken by a ``set``, a reusable barrier across processes, an 8 MB
value, and a stopped server (every operation raises ``OSError``, a
blocked ``get`` too)."""

import concurrent.futures
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from pytorch_distributed_nn_tpu.runtime import native as jnative
from pytorch_distributed_nn_tpu_torch.runtime import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARRIER_PROCS = 1  # and the test process: 2 at the barrier
BARRIER_ROUNDS = 2

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's store not built")


def _outcome(fn, *args, **kw):
    """A call's value, or the kind of error it raised."""
    try:
        return ("ok", fn(*args, **kw))
    except TimeoutError:
        return ("raised", "TimeoutError")
    except OSError:
        return ("raised", "OSError")


# a barrier participant in a process of its own that imports only the
# store's module (not this file, which imports both packages)
BARRIER_WORKER = """
import importlib, json, sys
native = importlib.import_module(sys.argv[1])
port, rank, procs, rounds = map(int, sys.argv[2:])
seen = []
with native.StoreClient(port=port) as c:
    for rnd in range(rounds):
        c.set(f"round{rnd}/rank{rank}", b"1")
        c.barrier("loop", procs + 1, timeout_ms=60_000)
        seen.append(all(c.check(f"round{rnd}/rank{r}")
                        for r in range(procs + 1)))
print(json.dumps([rank, seen]))
"""


def _script(native):
    """The operation script; returns every result in order."""
    out = []
    srv = native.StoreServer()
    c = native.StoreClient(port=srv.port)
    # set/get and overwrite
    c.set("alpha", b"hello")
    out.append(_outcome(c.get, "alpha"))
    c.set("alpha", b"again")
    out.append(_outcome(c.get, "alpha"))
    c.set("empty", b"")
    out.append(_outcome(c.get, "empty"))
    # add counters (read back through add(key, 0))
    out += [_outcome(c.add, "n", d) for d in (1, 5, -2, 0)]
    out.append(_outcome(c.add, "fresh", 0))
    # check/delete
    out += [_outcome(c.check, k) for k in ("alpha", "n", "missing")]
    c.delete("alpha")
    c.delete("missing")  # deleting what is not there is no error
    out.append(_outcome(c.check, "alpha"))
    out.append(_outcome(c.add, "n2", 3))
    c.delete("n2")
    out.append(_outcome(c.add, "n2", 1))  # a deleted counter starts over
    # a get that times out
    t0 = time.perf_counter()
    out.append(_outcome(c.get, "never", timeout_ms=200))
    out.append(("waited", time.perf_counter() - t0 >= 0.15))
    # a blocking get woken by a set
    got = {}

    def waiter():
        with native.StoreClient(port=srv.port) as w:
            got["value"] = _outcome(w.get, "later", timeout_ms=10_000)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    c.set("later", b"woken")
    t.join(timeout=15)
    out.append(got.get("value"))
    # an 8 MB value
    big = bytes(range(256)) * (8 << 12)
    c.set("big", big)
    value = c.get("big", timeout_ms=10_000)
    out.append(("big", len(value), value == big))
    # a reusable barrier across processes (two rounds under one name)
    procs = [subprocess.Popen(
        [sys.executable, "-c", BARRIER_WORKER, native.__name__,
         str(srv.port), str(r), str(BARRIER_PROCS), str(BARRIER_ROUNDS)],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
        for r in range(1, BARRIER_PROCS + 1)]
    seen = []
    for rnd in range(BARRIER_ROUNDS):
        c.set(f"round{rnd}/rank0", b"1")
        c.barrier("loop", BARRIER_PROCS + 1, timeout_ms=60_000)
        seen.append(all(c.check(f"round{rnd}/rank{r}")
                        for r in range(BARRIER_PROCS + 1)))
    results = []
    for p in procs:
        stdout, _ = p.communicate(timeout=60)
        results.append(json.loads(stdout.splitlines()[-1]))
    out.append(("barrier", seen, sorted(results),
                [p.returncode for p in procs]))
    # a stopped server: a blocked get and every later operation raise
    blocked = {}
    w = native.StoreClient(port=srv.port)

    def blocked_get():
        # an OSError: the JAX server answers its waiters "not there" as it
        # stops (TimeoutError, a subclass), c10d's drops the connection
        try:
            w.get("nothing")
            blocked["value"] = "returned"
        except OSError:
            blocked["value"] = ("raised", "OSError")

    t = threading.Thread(target=blocked_get)
    t.start()
    time.sleep(0.1)
    srv.stop()
    t.join(timeout=10)
    out.append(("blocked", blocked.get("value"), t.is_alive()))
    out.append(_outcome(c.set, "k", b"v"))
    out.append(_outcome(c.get, "k", timeout_ms=500))
    out.append(_outcome(c.add, "n", 1))
    out.append(_outcome(c.check, "n"))
    out.append(_outcome(c.delete, "n"))
    c.close()
    w.close()
    return out


def test_store_script_gives_the_jax_stores_results():
    # the two stores are independent: their scripts run side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        got, want = pool.map(_script, (tnative, jnative))
    assert got == want
    # the script checks what it should: the values it read
    assert got[0] == ("ok", b"hello") and got[1] == ("ok", b"again")
    assert got[3:7] == [("ok", 1), ("ok", 6), ("ok", 4), ("ok", 4)]
    assert ("raised", "TimeoutError") in got
    assert got[-6] == ("blocked", ("raised", "OSError"), False)
    assert got[-5:] == [("raised", "OSError")] * 5


def test_store_binds_a_free_port_and_refuses_a_dead_one():
    with tnative.StoreServer() as srv:
        assert srv.port > 0
        with tnative.StoreServer() as other:
            assert other.port != srv.port
        port = srv.port
    with pytest.raises(ConnectionError):
        tnative.StoreClient(port=port, connect_timeout_ms=300)


def test_add_counter_reads_back_as_decimal_text():
    """The one documented difference: c10d keeps a counter as its decimal
    text, which ``get`` returns; the JAX store returns its eight bytes.
    Both stores read a counter the same through ``add(key, 0)``."""
    with tnative.StoreServer() as srv, \
            tnative.StoreClient(port=srv.port) as c:
        c.add("n", 6)
        assert c.get("n") == b"6" and c.add("n", 0) == 6

"""The port's failure detector and heartbeat reporter
(``runtime/failure.py``) against the JAX package's: the cases of the JAX
package's ``tests/test_failure.py`` (the flight recorder's left out), each
run on both modules over a dict-backed store, then the port's over its
real store (c10d's ``TCPStore``), the counted retry helper, the
environment contract and the preemption handler under the agent."""

import os
import subprocess
import sys
import time

import pytest

from pytorch_distributed_nn_tpu.runtime import failure as jfailure
from pytorch_distributed_nn_tpu_torch.runtime import failure as tfailure
from pytorch_distributed_nn_tpu_torch.runtime import native as tnative

IMPLS = {"port": tfailure, "jax": jfailure}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeStoreClient:
    """dict-backed stand-in for a store client (check/get/set); ``down``
    makes every operation fail as a store outage does."""

    def __init__(self):
        self.d: dict[str, bytes] = {}
        self.down = False

    def _up(self):
        if self.down:
            raise OSError("store unreachable")

    def set(self, key, value):
        self._up()
        self.d[key] = value

    def get(self, key, timeout_ms=-1, **_):
        self._up()
        if key not in self.d:
            raise TimeoutError(key)
        return self.d[key]

    def check(self, key):
        self._up()
        return key in self.d

    def close(self):
        pass


def _beat(client, rank, incarnation=0, at=None):
    client.set(f"hb/{incarnation}/{rank}",
               repr(at if at is not None else time.time()).encode())


def test_env_contract_is_the_jax_packages():
    for name in ("ENV_STORE_PORT", "ENV_STORE_HOST", "ENV_RESTART",
                 "ENV_HB_INTERVAL", "ENV_PROGRESS_WINDOW", "ENV_PREEMPT",
                 "GRACEFUL_EXIT_CODE"):
        assert getattr(tfailure, name) == getattr(jfailure, name), name


# ---------------------------------------------------------------------------
# FailureDetector, on both modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_never_beaten_rank_gets_startup_grace(impl):
    client = FakeStoreClient()
    det = IMPLS[impl].FailureDetector(client, ranks=[0, 1], incarnation=0,
                                      timeout_s=0.15)
    _beat(client, 0)
    # rank 1 never beat: inside the grace window it is not stale ...
    assert det.stale_ranks() == []
    assert det.missed_counts == {0: 0, 1: 0}
    # ... but once it has been up longer than the timeout it is
    time.sleep(0.2)
    _beat(client, 0)
    assert det.stale_ranks() == [1]
    assert det.missed_counts == {0: 0, 1: 1}


@pytest.mark.parametrize("impl", IMPLS)
def test_rank_removed_from_alive_is_not_reported(impl):
    """A rank whose process exited is the exit-code watcher's business."""
    client = FakeStoreClient()
    det = IMPLS[impl].FailureDetector(client, ranks=[0, 1], incarnation=0,
                                      timeout_s=0.05)
    _beat(client, 0, at=time.time() - 10.0)
    _beat(client, 1, at=time.time() - 10.0)
    assert set(det.stale_ranks()) == {0, 1}
    assert det.stale_ranks(alive={1}) == [1]
    assert det.stale_ranks(alive=set()) == []
    assert det.missed_counts == {0: 1, 1: 2}


@pytest.mark.parametrize("impl", IMPLS)
def test_last_beat_ages_none_for_silent_rank(impl):
    client = FakeStoreClient()
    det = IMPLS[impl].FailureDetector(client, ranks=[0, 1], incarnation=0,
                                      timeout_s=1.0)
    _beat(client, 0, at=time.time() - 2.5)
    ages = det.last_beat_ages()
    assert ages[0] == pytest.approx(2.5, abs=0.5)
    assert ages[1] is None
    assert det.any_beats()
    client.down = True
    assert not det.any_beats()  # a dead store reads as no beat


@pytest.mark.parametrize("impl", IMPLS)
def test_incarnation_isolates_heartbeats(impl):
    """Beats of an earlier incarnation do not vouch for the new gang."""
    client = FakeStoreClient()
    _beat(client, 0, incarnation=0)
    det = IMPLS[impl].FailureDetector(client, ranks=[0], incarnation=1,
                                      timeout_s=0.05)
    assert det.stale_ranks() == []  # startup grace arms here
    time.sleep(0.1)
    assert det.stale_ranks() == [0]


# ---------------------------------------------------------------------------
# HeartbeatReporter: watchdog arm/disarm, on both modules
# ---------------------------------------------------------------------------

def _reporter(impl, client, **kw):
    kw.setdefault("rank", 0)
    kw.setdefault("interval_s", 0.03)
    return IMPLS[impl].HeartbeatReporter(client, **kw)


@pytest.mark.parametrize("impl", IMPLS)
def test_disarmed_reporter_keeps_beating_and_age_stays_fresh(impl):
    client = FakeStoreClient()
    rep = _reporter(impl, client, progress_window_s=0.05)
    try:
        rep.notify_progress()
        time.sleep(0.25)  # progress stalls: the beats are withheld
        assert rep.stats()["suppressed"] > 0
        stale_age = rep.stats()["age_s"]
        assert stale_age > 0.1
        rep.disarm()
        time.sleep(0.15)  # liveness only again: beats resume
        assert rep.stats()["age_s"] < stale_age
        assert rep.stats()["age_s"] < 0.15
    finally:
        rep.stop()


@pytest.mark.parametrize("impl", IMPLS)
def test_watchdog_not_armed_before_first_progress(impl):
    client = FakeStoreClient()
    rep = _reporter(impl, client, progress_window_s=0.05)
    try:
        time.sleep(0.2)
        assert rep.stats()["suppressed"] == 0
        assert rep.stats()["beats"] >= 2
    finally:
        rep.stop()


def test_beat_thread_survives_store_outage_and_counts_errors():
    client = FakeStoreClient()
    before = tfailure.store_errors_total().get("beat", 0)
    rep = tfailure.HeartbeatReporter(client, rank=0, interval_s=0.01)
    try:
        client.down = True
        time.sleep(0.15)  # every beat in this window fails
        assert rep._thread.is_alive()
        assert rep.store_errors > 0
        assert tfailure.store_errors_total()["beat"] - before \
            == rep.store_errors
        client.down = False
        first = float(client.d["hb/0/0"])
        deadline = time.time() + 2.0
        while time.time() < deadline \
                and float(client.d["hb/0/0"]) <= first:
            time.sleep(0.03)
        assert float(client.d["hb/0/0"]) > first, "beats did not resume"
    finally:
        rep.stop()


# ---------------------------------------------------------------------------
# over the port's real store
# ---------------------------------------------------------------------------

def test_reporter_and_detector_over_the_port_store():
    with tnative.StoreServer() as srv:
        monitor = tnative.StoreClient(port=srv.port)
        det = tfailure.FailureDetector(monitor, ranks=[3], incarnation=2,
                                       timeout_s=0.3)
        rep = tfailure.HeartbeatReporter(
            tnative.StoreClient(port=srv.port), rank=3, incarnation=2,
            interval_s=0.05, progress_window_s=0.2)
        try:
            assert monitor.check("hb/2/3")  # the synchronous first beat
            rep.notify_progress()
            time.sleep(0.2)
            assert det.stale_ranks() == []  # beating while it progresses
            time.sleep(0.6)  # no progress: silent past the timeout
            assert det.stale_ranks() == [3]
            rep.disarm()
            time.sleep(0.2)
            assert det.stale_ranks() == []
            assert det.last_beat_ages()[3] < 0.3
        finally:
            rep.stop()
            monitor.close()


def test_maybe_start_heartbeat_follows_the_agent_environment(monkeypatch):
    monkeypatch.delenv(tfailure.ENV_STORE_PORT, raising=False)
    monkeypatch.setattr(tfailure, "_reporter", None)
    assert tfailure.maybe_start_heartbeat(rank=0) is None
    assert tfailure.heartbeat_stats() is None
    tfailure.notify_progress()  # no-ops outside the agent
    tfailure.notify_done()
    with tnative.StoreServer() as srv:
        monkeypatch.setenv(tfailure.ENV_STORE_PORT, str(srv.port))
        monkeypatch.setenv(tfailure.ENV_RESTART, "4")
        monkeypatch.setenv(tfailure.ENV_HB_INTERVAL, "0.05")
        monkeypatch.setenv(tfailure.ENV_PROGRESS_WINDOW, "7.5")
        rep = tfailure.maybe_start_heartbeat(rank=1)
        try:
            assert rep is tfailure.maybe_start_heartbeat(rank=1)
            assert rep is tfailure.reporter()
            assert (rep.incarnation, rep._interval, rep._window) == \
                (4, 0.05, 7.5)
            with tnative.StoreClient(port=srv.port) as c:
                assert c.check("hb/4/1")
            stats = tfailure.heartbeat_stats()
            assert stats["beats"] >= 1 and "store_errors_total" in stats
        finally:
            rep.stop()


# a worker under the agent that beats every 0.5 ms and exits: without the
# reporter stopped at exit, most such exits aborted with "terminate called
# without an active exception" (the beat thread leaving a store call while
# the interpreter finalizes)
EXIT_WORKER = """
import time
from pytorch_distributed_nn_tpu_torch.runtime import failure
assert failure.maybe_start_heartbeat(rank=0) is not None
time.sleep(0.3)
"""


def test_a_beating_worker_exits_cleanly():
    with tnative.StoreServer() as srv:
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        env.update({tfailure.ENV_STORE_PORT: str(srv.port),
                    tfailure.ENV_RESTART: "0",
                    tfailure.ENV_HB_INTERVAL: "0.0005"})
        procs = [subprocess.Popen([sys.executable, "-c", EXIT_WORKER],
                                  env=env, stderr=subprocess.PIPE,
                                  text=True) for _ in range(4)]
        outs = [(p.wait(timeout=120), p.stderr.read()[-500:])
                for p in procs]
    assert all(rc == 0 for rc, _ in outs), outs


def test_preemption_handler_installs_under_the_agent(monkeypatch):
    monkeypatch.delenv(tfailure.ENV_PREEMPT, raising=False)
    monkeypatch.delenv(tfailure.ENV_STORE_PORT, raising=False)
    assert not tfailure.install_preemption_handler()
    monkeypatch.setenv(tfailure.ENV_STORE_PORT, "1")
    try:
        assert tfailure.install_preemption_handler()
        assert not tfailure.preempt_requested()
        tfailure.request_preemption()
        assert tfailure.preempt_requested()
    finally:
        tfailure.uninstall_preemption_handler()
    assert not tfailure.preempt_requested()


# ---------------------------------------------------------------------------
# store_call: the counted retry helper
# ---------------------------------------------------------------------------

def test_store_call_outage_survive_resume():
    calls = {"n": 0, "retries": 0}
    before = tfailure.store_errors_total().get("drill", 0)

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 3:
            raise OSError("partition window")
        return b"healed"

    out = tfailure.store_call(
        flaky, op="drill", deadline_s=5.0, base_s=0.001, max_s=0.002,
        on_retry=lambda: calls.__setitem__(
            "retries", calls["retries"] + 1))
    assert out == b"healed"
    assert calls["n"] == 4 and calls["retries"] == 3
    assert tfailure.store_errors_total()["drill"] - before == 3


def test_store_call_deadline_fallback_and_reraise():
    def dead():
        raise TimeoutError("store gone")

    t0 = time.monotonic()
    out = tfailure.store_call(dead, op="drill_dead", deadline_s=0.15,
                              base_s=0.001, max_s=0.01, fallback=None)
    assert out is None
    assert time.monotonic() - t0 < 2.0
    with pytest.raises(TimeoutError):
        tfailure.store_call(dead, op="drill_dead", deadline_s=0.1,
                            base_s=0.001, max_s=0.01)


def test_store_call_only_absorbs_transient_errors():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("not a transient")

    with pytest.raises(ValueError):
        tfailure.store_call(broken, op="drill_bug", deadline_s=5.0)
    assert calls["n"] == 1


def test_store_call_retries_on_the_jax_schedule(monkeypatch):
    """The same seeded backoff as the JAX helper: the sleeps of each, with
    their clocks frozen, are equal."""
    sleeps = {}
    for name, mod in IMPLS.items():
        got = sleeps[name] = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        monkeypatch.setattr(mod.time, "monotonic", lambda: 100.0)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 6:
                raise OSError("down")
            return calls["n"]

        assert mod.store_call(flaky, op="sched", seed=3, base_s=0.01,
                              max_s=0.05, deadline_s=1.0) == 7
        monkeypatch.undo()
    assert len(sleeps["port"]) == 6
    assert sleeps["port"] == sleeps["jax"]


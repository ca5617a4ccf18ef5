"""The port's elastic agent (``launch.py``) against the JAX package's:

- :class:`RestartPolicy`'s decisions and delays bit for bit the JAX
  policy's, same seed, fake clock, over the sequences of the JAX
  package's ``tests/test_restart_policy.py``;
- :func:`worker_env` key for key the JAX function's;
- the agent driving real gangs (numpy-only workers, as the JAX package's
  ``tests/test_launch.py``): the environment contract, a crash restarted
  and resumed, the budget exhausted, fail-fast, a free preemption
  restart, signals propagated to the gang, a hang found by the heartbeat,
  the progress watchdog and the long first step it must tolerate, a
  staggered clean finish, the CLI; and a 2-rank gloo gang of the port's
  Trainer sent SIGTERM after step 2, resumed, its losses bit for bit a
  straight run's.

The gangs run side by side in one module fixture (:func:`runs`), in
chains started a few seconds apart: the heartbeat cases wait out their
timeouts together while the Trainer gangs, then the agents started as
processes, run one at a time. Only three of the heartbeat cases' workers
import torch (the port's heartbeat is c10d's store); the other gangs'
workers are numpy-only, but the Trainer's.
"""

import concurrent.futures
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from pytorch_distributed_nn_tpu import launch as jlaunch
from pytorch_distributed_nn_tpu_torch import launch as tlaunch
from pytorch_distributed_nn_tpu_torch.launch import LaunchConfig, launch
from pytorch_distributed_nn_tpu_torch.runtime import failure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
# heartbeat cases: the timeout leaves a worker room to import torch and
# beat under a loaded test run (the whole suite on 6 workers took 10 s
# and more); each case's sleep outlasts it
HB_TIMEOUT = 20.0
HB_SLEEP = 24.0


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# RestartPolicy, bit for bit the JAX policy
# ---------------------------------------------------------------------------

def _crash(code=1, duration=60.0, beat_seen=True):
    return ("crash", code, duration, beat_seen)


# (policy overrides, events): the sequences of the JAX policy's tests; an
# event is (reason, code, duration_s, beat_seen) or ("advance", seconds)
POLICY_SEQUENCES = {
    "ok_stops": ({}, [("ok", 0, 10.0, None)]),
    "backoff_jitter": ({"max_restarts": 10}, [_crash()] * 5),
    "seed3": ({"max_restarts": 10, "seed": 3}, [_crash()] * 4),
    "seed4": ({"max_restarts": 10, "seed": 4}, [_crash()] * 4),
    "lifetime_budget": ({"max_restarts": 2, "window_s": None},
                        [_crash()] * 3),
    "window_slides": ({"max_restarts": 2, "window_s": 100.0}, [
        _crash(), ("advance", 30.0), _crash(), ("advance", 30.0), _crash(),
        ("advance", 45.0), _crash(), ("advance", 200.0), _crash()]),
    "failfast_same_code": ({"max_restarts": 10},
                           [_crash(2, beat_seen=False)] * 2),
    "failfast_needs_same_code": ({"max_restarts": 10}, [
        _crash(2, beat_seen=False), _crash(3, beat_seen=False),
        _crash(3, beat_seen=False)]),
    "heartbeat_resets_streak": ({"max_restarts": 10}, [
        _crash(2, beat_seen=False), _crash(2, beat_seen=True),
        _crash(2, beat_seen=False), _crash(2, beat_seen=False)]),
    "duration_heuristic_short": ({"max_restarts": 10}, [
        _crash(9, 1.0, None)] * 2),
    "duration_heuristic_long": ({"max_restarts": 10}, [
        _crash(9, 60.0, None)] * 4),
    "hang_never_failfasts": ({"max_restarts": 10}, [
        ("hang", 1, 1.0, False)] * 4),
    "preempt_free": ({"max_restarts": 1}, [
        ("preempt", 83, 30.0, None)] * 5 + [_crash()]),
    "preempt_resets": ({"max_restarts": 10}, [
        _crash(2, beat_seen=False), ("preempt", 83, 1.0, None),
        _crash(2, beat_seen=False)]),
    "backoff_total": ({"max_restarts": 10}, [_crash()] * 3),
}


def _policy_trace(module, overrides, events):
    clock = FakeClock()
    kw = dict(max_restarts=3, backoff_base_s=1.0, backoff_max_s=30.0,
              backoff_factor=2.0, jitter_frac=0.1, failfast_repeats=2,
              failfast_startup_s=5.0, seed=7, clock=clock)
    kw.update(overrides)
    policy = module.RestartPolicy(**kw)
    trace = []
    for ev in events:
        if ev[0] == "advance":
            clock.t += ev[1]
            continue
        reason, code, duration, beat_seen = ev
        d = policy.on_exit(reason=reason, code=code, duration_s=duration,
                           beat_seen=beat_seen)
        trace.append((d.action, d.delay_s, d.why))
    trace.append(("counts", policy.budget_restarts, policy.preempt_restarts,
                  policy.backoff_total_s,
                  [policy.backoff_bounds(n) for n in range(1, 8)]))
    return trace


@pytest.mark.parametrize("name", POLICY_SEQUENCES)
def test_restart_policy_is_the_jax_policy_bit_for_bit(name):
    overrides, events = POLICY_SEQUENCES[name]
    got = _policy_trace(tlaunch, overrides, events)
    assert got == _policy_trace(jlaunch, overrides, events)
    if name == "window_slides":
        assert [a for a, _, _ in got[:-1]] == [
            "restart", "restart", "stop", "restart", "restart"]
    if name == "preempt_free":
        assert got[-1][1:3] == (1, 5)


@pytest.mark.parametrize("kw", [
    dict(max_restarts=-1), dict(max_restarts=1, jitter_frac=1.0)])
def test_restart_policy_refuses_what_the_jax_policy_refuses(kw):
    with pytest.raises(ValueError):
        jlaunch.RestartPolicy(**kw)
    with pytest.raises(ValueError):
        tlaunch.RestartPolicy(**kw)


@pytest.mark.parametrize("kw", [
    dict(rank=0),
    dict(rank=3, local_rank=1, world_size=4, master_addr="10.0.0.2",
         master_port=1234, incarnation=2, heartbeat_interval_s=0.5,
         progress_timeout_s=3.0, store_host="10.0.0.3", store_port=999,
         extra={"TPUNN_X": "1", "RANK": "overridden"}),
    dict(rank=1, world_size=2, incarnation=5, store_port=4321),
])
def test_worker_env_is_the_jax_contract(kw):
    assert tlaunch.worker_env(**kw) == jlaunch.worker_env(**kw)


def test_agent_refuses_bad_configs():
    for cfg in (LaunchConfig(nprocs=0),
                LaunchConfig(nprocs=1, progress_timeout_s=1.0),
                LaunchConfig(nprocs=1, heartbeat_timeout_s=1.0,
                             heartbeat_interval_s=1.0)):
        with pytest.raises(ValueError):
            tlaunch.ElasticAgent(["x.py"], cfg)
    with pytest.raises(ValueError):
        tlaunch.ElasticAgent([], LaunchConfig(nprocs=1))


def test_heartbeat_watch_raises_when_the_store_does_not_start(monkeypatch):
    """No fallback to a watch of exit codes alone."""
    def refuse(*a, **k):
        raise OSError("no port")

    monkeypatch.setattr(tlaunch.native, "StoreServer", refuse)
    agent = tlaunch.ElasticAgent(
        ["never_spawned.py"], LaunchConfig(nprocs=1,
                                           heartbeat_timeout_s=5.0))
    with pytest.raises(RuntimeError, match="failed to start"):
        agent.run()


# ---------------------------------------------------------------------------
# the gangs
# ---------------------------------------------------------------------------

def _write(d, name, body):
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write(textwrap.dedent(body))
    return path


def _env_contract(d):
    script = _write(d, "worker.py", """
        import os, sys
        out = sys.argv[1]
        rank = os.environ["RANK"]
        assert os.environ["PROCESS_ID"] == rank
        assert os.environ["WORLD_SIZE"] == os.environ["NUM_PROCESSES"] == "2"
        addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        assert os.environ["COORDINATOR_ADDRESS"] == f"{addr}:{port}"
        assert os.environ["TPUNN_RESTART"] == "0"
        assert "TPUNN_STORE_PORT" not in os.environ
        with open(f"{out}/rank{rank}.txt", "w") as f:
            f.write(port)
    """)
    return launch([script, d], LaunchConfig(nprocs=2))


def _crash_resume(d):
    script = _write(d, "worker.py", """
        import os, sys, time
        import numpy as np
        ckpt = sys.argv[1] + "/state.npy"
        rank = int(os.environ["RANK"])
        incarnation = int(os.environ["TPUNN_RESTART"])
        try:
            step = int(np.load(ckpt)) if os.path.exists(ckpt) else 0
        except Exception:
            step = 0
        first_step = step
        if rank == 1 and incarnation == 0:
            while not os.path.exists(ckpt):
                time.sleep(0.02)
            os._exit(17)
        while step < 10:
            step += 1
            if rank == 0:
                np.save(ckpt + ".tmp.npy", np.int64(step))
                os.replace(ckpt + ".tmp.npy", ckpt)
        with open(f"{sys.argv[1]}/done{rank}_{incarnation}", "w") as f:
            f.write(str(first_step))
    """)
    return launch([script, d], LaunchConfig(nprocs=2, max_restarts=2,
                                            backoff_base_s=0.05))


def _budget(d):
    script = _write(d, "worker.py", "import os; os._exit(3)")
    return launch([script], LaunchConfig(nprocs=2, max_restarts=1,
                                         backoff_base_s=0.05))


def _failfast(d):
    script = _write(d, "worker.py", "import os; os._exit(7)")
    return launch([script], LaunchConfig(nprocs=2, max_restarts=10,
                                         backoff_base_s=0.05))


def _preempt_free(d):
    script = _write(d, "worker.py", f"""
        import os, sys
        incarnation = int(os.environ["TPUNN_RESTART"])
        rank = os.environ["RANK"]
        with open(f"{{sys.argv[1]}}/ran{{rank}}_{{incarnation}}", "w"):
            pass
        if incarnation == 0:
            sys.exit({failure.GRACEFUL_EXIT_CODE})
    """)
    return launch([script, d], LaunchConfig(nprocs=2, max_restarts=0))


def _signal(d, signum):
    worker = _write(d, "worker.py", """
        import os, sys, time
        with open(f"{sys.argv[1]}/pid{os.environ['RANK']}", "w") as f:
            f.write(str(os.getpid()))
        time.sleep(600)
    """)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch.launch",
         "--nprocs", "2", "--", worker, d],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if all(os.path.exists(f"{d}/pid{r}") for r in range(2)):
                break
            time.sleep(0.05)
        pids = [int(open(f"{d}/pid{r}").read()) for r in range(2)]
        proc.send_signal(signum)
        rc = proc.wait(timeout=30)
        deadline = time.time() + 15
        alive = pids
        while alive and time.time() < deadline:
            time.sleep(0.1)
            alive = [p for p in pids if _alive(p)]
        return rc, alive
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def _hang(d):
    # numpy-only: the hung rank never connects nor beats; the other exits
    # at once (an exited rank is the exit-code watcher's, not the
    # detector's), and the restarted gang finishes
    script = _write(d, "worker.py", """
        import os, sys, time
        rank = int(os.environ["RANK"])
        incarnation = int(os.environ["TPUNN_RESTART"])
        assert "TPUNN_STORE_PORT" in os.environ
        if rank == 1 and incarnation == 0:
            time.sleep(600)  # hung: never connects, never beats
        with open(f"{sys.argv[1]}/done{rank}_{incarnation}", "w") as f:
            f.write("ok")
    """)
    return launch([script, d], LaunchConfig(
        nprocs=2, max_restarts=1, heartbeat_timeout_s=HB_TIMEOUT,
        heartbeat_interval_s=0.2, backoff_base_s=0.05, env=ENV))


def _watchdog(d):
    # one process beats: rank 1 of the first incarnation arms the
    # watchdog, then stalls while its beat thread lives on; every other
    # worker is numpy-only and exits at once
    script = _write(d, "worker.py", """
        import os, sys, time
        rank = int(os.environ["RANK"])
        incarnation = int(os.environ["TPUNN_RESTART"])
        if rank == 1 and incarnation == 0:
            from pytorch_distributed_nn_tpu_torch.runtime import failure
            hb = failure.maybe_start_heartbeat()
            assert hb is not None and hb._window == 1.0
            failure.notify_progress()  # arm the watchdog (step 1 done)
            time.sleep(600)  # "deadlock": the thread beats, no progress
        with open(f"{sys.argv[1]}/done{rank}_{incarnation}", "w") as f:
            f.write("ok")
    """)
    return launch([script, d], LaunchConfig(
        nprocs=2, max_restarts=1, heartbeat_timeout_s=HB_TIMEOUT,
        heartbeat_interval_s=0.2, progress_timeout_s=1.0,
        backoff_base_s=0.05, env=ENV))


def _first_step_staggered(d):
    # one gang for two cases: rank 1's first step outlasts the progress
    # window and the heartbeat timeout with the watchdog not yet armed;
    # rank 0 beats and finishes at once, and rank 1 runs on well past the
    # timeout after it (a clean early finish is not a hang)
    script = _write(d, "worker.py", f"""
        import os, sys, time
        from pytorch_distributed_nn_tpu_torch.runtime import failure
        rank = int(os.environ["RANK"])
        hb = failure.maybe_start_heartbeat()
        assert hb is not None and hb._window == 1.0
        if rank == 1:
            time.sleep({HB_SLEEP})  # "first step": no progress yet
            failure.notify_progress()
        with open(f"{{sys.argv[1]}}/done{{rank}}", "w") as f:
            f.write("ok")
        hb.stop()
    """)
    return launch([script, d], LaunchConfig(
        nprocs=2, max_restarts=1, heartbeat_timeout_s=HB_TIMEOUT,
        heartbeat_interval_s=0.2, progress_timeout_s=1.0, env=ENV))


def _cli(d):
    script = _write(d, "worker.py", """
        import os, sys
        open(sys.argv[1] + "/r" + os.environ["RANK"], "w").close()
    """)
    return subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch.launch",
         "--nprocs", "2", "--", script, d],
        cwd=REPO, capture_output=True, text=True, timeout=120)


# the port's Trainer under the agent: a runner around the train entry
# point that records each incarnation's losses and, in the faulted run,
# sends itself SIGTERM once step 2 is done (every rank, as a preemption
# of the whole job does); each rank's output, a native abort's included,
# goes to its own log, which a failed check shows
TRAINER_RUNNER = """
import json, os, signal, sys
out, fault, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
rank, inc = os.environ["RANK"], int(os.environ["TPUNN_RESTART"])
log = os.open(f"{out}/rank{rank}_inc{inc}.log",
              os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
os.dup2(log, 1)
os.dup2(log, 2)
from pytorch_distributed_nn_tpu_torch.runtime import failure
from pytorch_distributed_nn_tpu_torch.train import __main__ as entry
from pytorch_distributed_nn_tpu_torch.train import trainer

steps = []
progress = failure.notify_progress


def notify_progress():
    progress()
    steps.append(1)
    if fault == "preempt" and inc == 0 and len(steps) == 2:
        os.kill(os.getpid(), signal.SIGTERM)


failure.notify_progress = notify_progress
train = trainer.Trainer.train


def recorded(self, steps=None):
    start = self.data_step
    try:
        return train(self, steps)
    finally:
        with open(f"{out}/rank{rank}_inc{inc}.json", "w") as f:
            json.dump({"start": start, "losses": self.losses()}, f)


trainer.Trainer.train = recorded
sys.exit(entry.main(argv))
"""
TRAINER_ARGV = ["--preset", "mlp_mnist", "--device", "cpu", "--steps", "4",
                "--log_every", "1", "--checkpoint_every", "1",
                "--data.batch_size", "16", "--model.extra",
                json.dumps({"features": [16, 10]})]


def _trainer(d, fault):
    runner = _write(d, "runner.py", TRAINER_RUNNER)
    argv = [runner, d, fault, *TRAINER_ARGV, "--checkpoint_dir",
            os.path.join(d, "ckpt")]
    return launch(argv, LaunchConfig(
        nprocs=2, max_restarts=0, heartbeat_timeout_s=60.0,
        heartbeat_interval_s=0.5, progress_timeout_s=30.0, env=ENV))


# the gangs run in chains, each chain on a thread of its own, its gangs
# one after another, started a few seconds apart, so that few processes
# import torch at once (a worker's startup grace is what a loaded machine
# threatens, this file's and the JAX package's launch tests'): first the
# heartbeat cases and the numpy-only gangs (three workers import torch),
# then the two Trainer gangs in turn, then the agents started as
# processes (the signals and the CLI) in turn
CHAINS = (
    (0.0, {"hang": _hang}), (0.0, {"watchdog": _watchdog}),
    (0.0, {"first_step": _first_step_staggered}),
    (0.0, {"env": _env_contract}), (0.0, {"crash": _crash_resume}),
    (0.0, {"budget": _budget}), (0.0, {"failfast": _failfast}),
    (0.0, {"preempt": _preempt_free}),
    (4.0, {"trainer_preempt": lambda d: _trainer(d, "preempt"),
           "trainer_straight": lambda d: _trainer(d, "none")}),
    (8.0, {"sigint": lambda d: _signal(d, signal.SIGINT),
           "sighup": lambda d: _signal(d, signal.SIGHUP), "cli": _cli}),
)


def _chain(delay, gangs, dirs):
    time.sleep(delay)
    return {name: fn(dirs[name]) for name, fn in gangs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every gang of the file: name -> (result, its directory)."""
    dirs = {name: str(tmp_path_factory.mktemp(name))
            for _, gangs in CHAINS for name in gangs}
    results = {}
    with concurrent.futures.ThreadPoolExecutor(len(CHAINS)) as pool:
        for done in [pool.submit(_chain, delay, gangs, dirs)
                     for delay, gangs in CHAINS]:
            results.update(done.result())
    return {name: (results[name], dirs[name]) for name in dirs}


def test_gang_env_contract(runs):
    result, d = runs["env"]
    assert result.exit_code == 0 and result.restarts == 0
    ports = {open(f"{d}/rank{r}.txt").read() for r in range(2)}
    assert len(ports) == 1  # the whole gang agreed on the port


def test_crash_restart_resumes_from_checkpoint(runs):
    result, d = runs["crash"]
    assert result.exit_code == 0
    assert result.restarts == 1
    assert [r.reason for r in result.incarnations] == ["crash", "ok"]
    assert result.incarnations[0].code == 17
    assert int(np.load(f"{d}/state.npy")) == 10
    resumed_at = int(open(f"{d}/done0_1").read())
    assert 1 <= resumed_at <= 10


def test_restart_budget_exhausted(runs):
    result, _ = runs["budget"]
    assert result.exit_code == 3
    assert result.restarts == 1
    assert [r.reason for r in result.incarnations] == ["crash", "crash"]
    assert [r.code for r in result.incarnations] == [3, 3]
    assert all(r.duration_s > 0 for r in result.incarnations)


def test_failfast_on_repeated_startup_crash(runs):
    result, _ = runs["failfast"]
    assert result.exit_code == 7
    assert result.restarts == 1
    assert "failfast" in result.stop_reason
    assert len(result.incarnations) == 2


def test_graceful_preempt_exit_restart_is_free(runs):
    result, d = runs["preempt"]
    assert result.exit_code == 0
    assert result.restarts == 1
    assert result.incarnations[0].reason == "preempt"
    assert result.incarnations[0].code == failure.GRACEFUL_EXIT_CODE
    assert result.incarnations[1].reason == "ok"
    assert os.path.exists(f"{d}/ran0_1")


@pytest.mark.parametrize("name,signum", [("sigint", signal.SIGINT),
                                         ("sighup", signal.SIGHUP)])
def test_agent_signal_propagates_to_gang(runs, name, signum):
    (rc, alive), _ = runs[name]
    assert rc == -signum, rc  # the agent re-raised it after the kill
    assert not alive, f"workers {alive} orphaned after {name}"


def test_hang_detected_by_heartbeat(runs):
    result, d = runs["hang"]
    assert result.exit_code == 0
    assert result.restarts == 1
    assert result.incarnations[0].reason == "hang"
    assert os.path.exists(f"{d}/done0_1") and os.path.exists(f"{d}/done1_1")


def test_progress_watchdog_catches_live_but_stuck_worker(runs):
    result, d = runs["watchdog"]
    assert result.exit_code == 0
    assert result.restarts == 1
    assert result.incarnations[0].reason == "hang"
    assert os.path.exists(f"{d}/done0_1") and os.path.exists(f"{d}/done1_1")


def test_unarmed_watchdog_tolerates_long_first_step(runs):
    result, d = runs["first_step"]
    assert result.exit_code == 0
    assert result.restarts == 0
    assert os.path.exists(f"{d}/done0") and os.path.exists(f"{d}/done1")


def test_staggered_clean_finish_is_not_a_hang(runs):
    result, d = runs["first_step"]
    assert result.exit_code == 0
    assert result.restarts == 0
    assert os.path.exists(f"{d}/done0") and os.path.exists(f"{d}/done1")


def test_cli_entrypoint(runs):
    proc, d = runs["cli"]
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(f"{d}/r0") and os.path.exists(f"{d}/r1")


def _losses(d, rank, inc, why=""):
    path = os.path.join(d, f"rank{rank}_inc{inc}.json")
    assert os.path.exists(path), why
    with open(path) as f:
        return json.load(f)


def _gang_report(result, d):
    """The agent's result and the tail of every rank's log under ``d``."""
    lines = [repr(result)]
    for name in sorted(os.listdir(d)):
        if name.endswith(".log"):
            with open(os.path.join(d, name), errors="replace") as f:
                lines += [f"--- {name}", *f.read().splitlines()[-30:]]
    return "\n".join(lines)


def test_trainer_gang_preempted_resumes_to_the_straight_losses(runs):
    """SIGTERM after step 2 on both ranks: exit 83 after a synchronous
    save, a restart charged to no budget (max_restarts 0), a resume at
    step 2, and the four losses bit for bit the straight run's."""
    straight, ds = runs["trainer_straight"]
    result, d = runs["trainer_preempt"]
    why_straight, why = _gang_report(straight, ds), _gang_report(result, d)
    assert straight.exit_code == 0 and straight.restarts == 0, why_straight
    assert result.exit_code == 0, why
    assert [r.reason for r in result.incarnations] == ["preempt", "ok"], why
    assert result.incarnations[0].code == failure.GRACEFUL_EXIT_CODE, why
    want = _losses(ds, 0, 0, why_straight)
    assert want["start"] == 0 and len(want["losses"]) == 4, why_straight
    for rank in range(2):
        first, second = _losses(d, rank, 0, why), _losses(d, rank, 1, why)
        assert first["start"] == 0 and second["start"] == 2, why
        assert first["losses"] + second["losses"] == want["losses"], why
        assert _losses(ds, rank, 0, why_straight) == want, why_straight

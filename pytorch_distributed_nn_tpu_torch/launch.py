"""The elastic agent: the JAX package's ``launch.py`` (``torchrun``'s part
in the reference), over the port's store.

- spawns N local worker processes with both the torch-style
  (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``) and the
  JAX-style (``PROCESS_ID``/``NUM_PROCESSES``/``COORDINATOR_ADDRESS``)
  environment (:func:`worker_env`); ``runtime/bootstrap.py`` reads both;
- watches them two ways: exit codes (a crash) and, with
  ``--heartbeat-timeout``, heartbeats into a node-local store it hosts
  (``runtime/native.StoreServer``, c10d's ``TCPStore``): a hang, which
  exit codes never show; each node's agent watches only the ranks it
  spawned;
- on a failure kills the whole gang and relaunches it with the next
  ``TPUNN_RESTART`` incarnation, governed by :class:`RestartPolicy`: a
  restart budget per window, exponential backoff with jitter, fail-fast on
  repeated identical crashes before any heartbeat, and free restarts for
  graceful preemption exits (``failure.GRACEFUL_EXIT_CODE``). The
  workers recover their progress themselves: the Trainer resumes from its
  newest checkpoint.

CLI::

    python -m pytorch_distributed_nn_tpu_torch.launch \\
        --nprocs 2 --max-restarts 2 --heartbeat-timeout 30 \\
        -- -m pytorch_distributed_nn_tpu_torch.train --preset mlp_mnist

Not ported (slice 6, ROADMAP.md §1 item 5): the watchtower's straggler
feed, the aggregate snapshots, the runtime gauges and the flight
recorder's directory and dump request (``--flight-dir``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import random
import signal
import socket
import subprocess
import sys
import time

from pytorch_distributed_nn_tpu_torch.runtime import failure, native

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LaunchConfig:
    nprocs: int
    max_restarts: int = 0
    heartbeat_timeout_s: float | None = None  # None -> exit-code-only watch
    heartbeat_interval_s: float = 1.0
    progress_timeout_s: float | None = None  # step-progress watchdog window
    poll_interval_s: float = 0.2
    kill_grace_s: float = 5.0
    # restart policy (RestartPolicy): max_restarts per restart_window_s
    # seconds (None -> per job lifetime), exponential backoff with
    # jitter between incarnations, fail-fast on repeated identical
    # pre-heartbeat crashes
    restart_window_s: float | None = None
    backoff_base_s: float = 1.0
    backoff_max_s: float = 30.0
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.1
    failfast_repeats: int = 2
    failfast_startup_s: float = 5.0
    restart_seed: int = 0
    nnodes: int = 1
    node_rank: int = 0
    master_addr: str = "127.0.0.1"
    master_port: int | None = None  # None -> a free port per incarnation
    env: dict[str, str] = dataclasses.field(default_factory=dict)


def worker_env(*, rank: int, local_rank: int | None = None,
               world_size: int = 1, master_addr: str = "127.0.0.1",
               master_port: int | None = None, incarnation: int = 0,
               heartbeat_interval_s: float | None = None,
               progress_timeout_s: float | None = None,
               store_host: str = "127.0.0.1",
               store_port: int | None = None,
               extra: dict[str, str] | None = None) -> dict[str, str]:
    """The agent-to-worker environment contract, in one place: the
    torch-style and JAX-style rank variables and the ``TPUNN_*``
    heartbeat and restart contract (:mod:`runtime.failure`)."""
    env = dict(os.environ)
    if extra:
        env.update(extra)
    env.update(
        RANK=str(rank),
        LOCAL_RANK=str(rank if local_rank is None else local_rank),
        WORLD_SIZE=str(world_size),
        PROCESS_ID=str(rank),
        NUM_PROCESSES=str(world_size),
    )
    if master_port is not None:
        env.update(
            MASTER_ADDR=master_addr,
            MASTER_PORT=str(master_port),
            COORDINATOR_ADDRESS=f"{master_addr}:{master_port}",
        )
    env[failure.ENV_RESTART] = str(incarnation)
    if heartbeat_interval_s is not None:
        env[failure.ENV_HB_INTERVAL] = str(heartbeat_interval_s)
    if progress_timeout_s is not None:
        env[failure.ENV_PROGRESS_WINDOW] = str(progress_timeout_s)
    if store_port is not None:
        env[failure.ENV_STORE_PORT] = str(store_port)
        env[failure.ENV_STORE_HOST] = store_host
    return env


@dataclasses.dataclass
class IncarnationRecord:
    """One gang incarnation's outcome (``LaunchResult.incarnations``)."""

    reason: str  # "ok" | "crash" | "hang" | "preempt"
    code: int
    duration_s: float


@dataclasses.dataclass
class LaunchResult:
    exit_code: int
    restarts: int  # incarnations consumed (0 = a clean first run)
    reason: str = "ok"  # "ok" | "crash" | "hang" | "preempt"
    stop_reason: str = ""  # why the agent stopped restarting
    incarnations: list[IncarnationRecord] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Decision:
    """The :class:`RestartPolicy` verdict after one failed incarnation."""

    action: str  # "restart" | "stop"
    delay_s: float = 0.0
    why: str = ""


class RestartPolicy:
    """Restart governor for the elastic agent:

    - **budget window**: at most ``max_restarts`` budget-charged restarts
      per ``window_s`` seconds (sliding; ``None`` = per job lifetime);
    - **exponential backoff with jitter**: ``base * factor**(n-1)`` capped
      at ``max_s``, +-``jitter`` fraction from a seeded RNG;
    - **fail-fast**: the same exit code ``failfast_repeats`` times in a
      row before any heartbeat is a deterministic startup crash; with no
      heartbeat monitor, "before any heartbeat" is ``duration <
      failfast_startup_s``;
    - **graceful preemption** (exit ``failure.GRACEFUL_EXIT_CODE``):
      restarts at once and charges nothing.

    ``clock`` is injectable for fake-clock tests.
    """

    def __init__(self, *, max_restarts: int,
                 window_s: float | None = None,
                 backoff_base_s: float = 1.0,
                 backoff_max_s: float = 30.0,
                 backoff_factor: float = 2.0,
                 jitter_frac: float = 0.1,
                 failfast_repeats: int = 2,
                 failfast_startup_s: float = 5.0,
                 seed: int = 0,
                 clock=time.monotonic) -> None:
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        if not 0.0 <= jitter_frac < 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1), got "
                             f"{jitter_frac}")
        self.max_restarts = max_restarts
        self.window_s = window_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backoff_factor = backoff_factor
        self.jitter_frac = jitter_frac
        self.failfast_repeats = failfast_repeats
        self.failfast_startup_s = failfast_startup_s
        self._clock = clock
        self._rng = random.Random(seed)
        self._grants: list[float] = []  # budget-charged restart times
        self._failures = 0  # consecutive failed incarnations (backoff)
        self._startup_streak = 0  # consecutive same-code startup crashes
        self._startup_code: int | None = None
        self.preempt_restarts = 0
        self.backoff_total_s = 0.0

    def backoff_bounds(self, failures: int) -> tuple[float, float]:
        """[lo, hi] delay for the n-th consecutive failure: the jitter
        envelope."""
        raw = min(self.backoff_base_s
                  * self.backoff_factor ** max(failures - 1, 0),
                  self.backoff_max_s)
        return raw * (1.0 - self.jitter_frac), raw * (1.0 + self.jitter_frac)

    def on_exit(self, *, reason: str, code: int, duration_s: float,
                beat_seen: bool | None = None) -> Decision:
        """Classify one finished incarnation; call once per exit."""
        if reason == "ok":
            return Decision("stop", why="ok")
        if reason == "preempt":
            # a graceful exit is no failure: no budget charge, no backoff
            # growth, restart at once
            self._failures = 0
            self._startup_streak = 0
            self.preempt_restarts += 1
            return Decision("restart", 0.0, "graceful preemption exit")
        pre_beat = ((not beat_seen) if beat_seen is not None
                    else duration_s < self.failfast_startup_s)
        if reason == "crash" and pre_beat:
            if self._startup_streak and code == self._startup_code:
                self._startup_streak += 1
            else:
                self._startup_streak = 1
                self._startup_code = code
            if self._startup_streak >= self.failfast_repeats:
                return Decision(
                    "stop",
                    why=(f"failfast: exit code {code} x"
                         f"{self._startup_streak} before first "
                         f"heartbeat (deterministic startup crash)"),
                )
        else:
            self._startup_streak = 0
        now = self._clock()
        if self.window_s is not None:
            self._grants = [t for t in self._grants
                            if now - t < self.window_s]
        if len(self._grants) >= self.max_restarts:
            scope = (f"{self.max_restarts} per {self.window_s}s"
                     if self.window_s is not None
                     else f"{self.max_restarts} per job")
            return Decision("stop",
                            why=f"restart budget exhausted ({scope})")
        self._grants.append(now)
        self._failures += 1
        lo, hi = self.backoff_bounds(self._failures)
        delay = lo + (hi - lo) * self._rng.random()
        self.backoff_total_s += delay
        return Decision("restart", delay,
                        f"backoff {delay:.2f}s (consecutive failure "
                        f"{self._failures})")

    @property
    def budget_restarts(self) -> int:
        return len(self._grants)


def _clamp_code(code: int) -> int:
    """Exit codes a shell can see: signal-killed workers (poll() < 0) map
    to the 128+N convention."""
    if code < 0:
        return 128 - code
    return code if 0 < code < 256 else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ElasticAgent:
    """One incarnation loop: spawn the gang, watch it, maybe restart."""

    def __init__(self, argv: list[str], cfg: LaunchConfig) -> None:
        if not argv:
            raise ValueError("no worker command given")
        if cfg.nprocs < 1:
            # an empty gang would vacuously succeed in _watch
            raise ValueError(f"nprocs must be >= 1, got {cfg.nprocs}")
        if (cfg.progress_timeout_s is not None
                and cfg.heartbeat_timeout_s is None):
            raise ValueError(
                "progress_timeout_s needs heartbeat_timeout_s: the "
                "watchdog signals a hang by going silent, and only the "
                "heartbeat monitor listens for silence"
            )
        if (cfg.heartbeat_timeout_s is not None
                and cfg.heartbeat_timeout_s < 2 * cfg.heartbeat_interval_s):
            # a timeout inside the beat period would condemn healthy
            # workers between beats
            raise ValueError(
                f"heartbeat_timeout_s ({cfg.heartbeat_timeout_s}) must be "
                f">= 2x heartbeat_interval_s ({cfg.heartbeat_interval_s})"
            )
        self.argv = argv
        self.cfg = cfg
        self._procs: list[subprocess.Popen] = []

    # -- gang lifecycle ----------------------------------------------------

    def _spawn(self, incarnation: int, store_port: int | None) -> None:
        cfg = self.cfg
        if cfg.master_port is None and cfg.nnodes > 1:
            # each node runs its own agent; a port per agent would hand
            # every node another rendezvous address
            raise ValueError("--master-port is required when nnodes > 1")
        port = cfg.master_port or _free_port()
        world = cfg.nprocs * cfg.nnodes
        base = cfg.nprocs * cfg.node_rank
        for local_rank in range(cfg.nprocs):
            rank = base + local_rank
            env = worker_env(
                rank=rank, local_rank=local_rank, world_size=world,
                master_addr=cfg.master_addr, master_port=port,
                incarnation=incarnation,
                heartbeat_interval_s=cfg.heartbeat_interval_s,
                progress_timeout_s=cfg.progress_timeout_s,
                # workers heartbeat into the store of the agent that
                # spawned them (this host): node-local liveness
                store_port=store_port,
                extra=cfg.env,
            )
            self._procs.append(subprocess.Popen(
                [sys.executable, *self.argv], env=env
            ))

    def _kill_gang(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + self.cfg.kill_grace_s
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.05, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        self._procs.clear()

    # -- one incarnation ---------------------------------------------------

    def _watch(self, detector: failure.FailureDetector | None
               ) -> tuple[str, int]:
        """Poll until the gang succeeds, a worker fails, or a worker
        hangs. Success requires every worker to exit 0. Returns (reason,
        exit_code), reason in {"ok", "crash", "hang", "preempt"}."""
        cfg = self.cfg
        base = cfg.nprocs * cfg.node_rank
        while True:
            codes = [p.poll() for p in self._procs]
            bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                rank, code = bad[0]
                if code == failure.GRACEFUL_EXIT_CODE:
                    # a graceful preemption exit (SIGTERM -> final save ->
                    # this code): not charged to the restart budget
                    log.warning("worker local_rank=%d exited gracefully "
                                "on preemption", rank)
                    return "preempt", _clamp_code(code)
                log.warning("worker local_rank=%d exited %d", rank, code)
                return "crash", _clamp_code(code)
            if all(c == 0 for c in codes):
                return "ok", 0
            if detector is not None:
                alive = {base + i for i, c in enumerate(codes) if c is None}
                stale = detector.stale_ranks(alive)
                if stale:
                    log.warning("heartbeat lost from ranks %s", stale)
                    return "hang", 1
            time.sleep(cfg.poll_interval_s)

    def _policy(self) -> RestartPolicy:
        cfg = self.cfg
        return RestartPolicy(
            max_restarts=cfg.max_restarts,
            window_s=cfg.restart_window_s,
            backoff_base_s=cfg.backoff_base_s,
            backoff_max_s=cfg.backoff_max_s,
            backoff_factor=cfg.backoff_factor,
            jitter_frac=cfg.backoff_jitter,
            failfast_repeats=cfg.failfast_repeats,
            failfast_startup_s=cfg.failfast_startup_s,
            seed=cfg.restart_seed,
        )

    def run(self) -> LaunchResult:
        cfg = self.cfg
        policy = self._policy()
        history: list[IncarnationRecord] = []
        incarnation = 0
        while True:
            server = None
            monitor = None
            detector = None
            beat_seen: bool | None = None
            t0 = time.monotonic()
            try:
                if cfg.heartbeat_timeout_s is not None:
                    # the store (and the workers' heartbeat threads) exist
                    # only when something will read the beats; a store
                    # that does not start raises: nothing falls back to a
                    # watch of exit codes alone
                    try:
                        server = native.StoreServer()
                    except OSError as e:
                        raise RuntimeError(
                            "heartbeat monitoring requires the store, "
                            f"which failed to start: {e}") from e
                    monitor = native.StoreClient("127.0.0.1", server.port)
                    base = cfg.nprocs * cfg.node_rank
                    detector = failure.FailureDetector(
                        monitor,
                        ranks=list(range(base, base + cfg.nprocs)),
                        incarnation=incarnation,
                        timeout_s=cfg.heartbeat_timeout_s,
                    )
                self._spawn(incarnation,
                            server.port if server is not None else None)
                reason, code = self._watch(detector)
                if detector is not None:
                    # the fail-fast discriminator, read before the store
                    # goes down with the gang
                    beat_seen = detector.any_beats()
            finally:
                self._kill_gang()
                if monitor is not None:
                    monitor.close()
                if server is not None:
                    server.stop()
            history.append(IncarnationRecord(
                reason=reason, code=code,
                duration_s=time.monotonic() - t0))
            decision = (Decision("stop", why="ok") if reason == "ok"
                        else policy.on_exit(
                            reason=reason, code=code,
                            duration_s=history[-1].duration_s,
                            beat_seen=beat_seen))
            if reason == "ok":
                return LaunchResult(exit_code=0, restarts=incarnation,
                                    reason="ok", stop_reason="ok",
                                    incarnations=history)
            if decision.action == "stop":
                log.warning("not restarting: %s", decision.why)
                return LaunchResult(exit_code=code, restarts=incarnation,
                                    reason=reason,
                                    stop_reason=decision.why,
                                    incarnations=history)
            log.warning("restarting gang (incarnation %d -> %d): %s",
                        incarnation, incarnation + 1, decision.why)
            if decision.delay_s > 0:
                time.sleep(decision.delay_s)
            incarnation += 1


# signals that must tear the gang down with the agent: SIGTERM (a cluster
# kill or preemption), SIGINT (Ctrl-C), SIGHUP (a lost terminal); any of
# them hitting only the agent would orphan the workers
_PROPAGATED_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)


def launch(argv: list[str], cfg: LaunchConfig) -> LaunchResult:
    """Run ``argv`` (a python script or ``-m module``, with its arguments)
    as an ``nprocs`` gang."""
    agent = ElasticAgent(argv, cfg)

    def _propagate(signum, frame):  # an agent kill takes the gang down
        agent._kill_gang()
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    old: dict[int, object] = {}
    for signum in _PROPAGATED_SIGNALS:
        try:
            old[signum] = signal.signal(signum, _propagate)
        except (ValueError, OSError):  # not the main thread
            pass
    try:
        return agent.run()
    finally:
        for signum, prev in old.items():
            signal.signal(signum, prev)


def main(args: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_nn_tpu_torch.launch",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument("--nprocs", type=int, required=True,
                    help="worker processes on this host "
                         "(torchrun --nproc-per-node)")
    ap.add_argument("--max-restarts", type=int, default=0)
    ap.add_argument("--restart-window", type=float, default=None,
                    help="budget window in seconds: at most "
                         "--max-restarts budget-charged restarts per "
                         "this many seconds (default: per job lifetime)")
    ap.add_argument("--backoff-base", type=float, default=1.0,
                    help="first-restart backoff seconds (doubles per "
                         "consecutive failure, jittered)")
    ap.add_argument("--backoff-max", type=float, default=30.0,
                    help="backoff ceiling in seconds")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="seconds without a heartbeat before a worker "
                         "counts as hung (default: exit-code watch only)")
    ap.add_argument("--progress-timeout", type=float, default=None,
                    help="seconds without a completed training step "
                         "before a worker stops heartbeating (catches "
                         "deadlocked collectives; needs "
                         "--heartbeat-timeout)")
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--node-rank", type=int, default=0)
    ap.add_argument("--master-addr", default="127.0.0.1")
    ap.add_argument("--master-port", type=int, default=None)
    ap.add_argument("script", nargs=argparse.REMAINDER,
                    help="worker script (or -m module) and its args "
                         "(prefix with --)")
    ns = ap.parse_args(args)
    script = ns.script[1:] if ns.script[:1] == ["--"] else ns.script
    if not script:
        ap.error("missing worker script")
    if ns.progress_timeout is not None and ns.heartbeat_timeout is None:
        ap.error("--progress-timeout requires --heartbeat-timeout")
    logging.basicConfig(level=logging.INFO,
                        format="[launch] %(levelname)s %(message)s")
    result = launch(script, LaunchConfig(
        nprocs=ns.nprocs,
        max_restarts=ns.max_restarts,
        restart_window_s=ns.restart_window,
        backoff_base_s=ns.backoff_base,
        backoff_max_s=ns.backoff_max,
        heartbeat_timeout_s=ns.heartbeat_timeout,
        progress_timeout_s=ns.progress_timeout,
        nnodes=ns.nnodes,
        node_rank=ns.node_rank,
        master_addr=ns.master_addr,
        master_port=ns.master_port,
    ))
    if result.restarts:
        log.info("job finished after %d restart(s): %s", result.restarts,
                 "; ".join(f"[{i}] {r.reason} code={r.code} "
                           f"{r.duration_s:.1f}s"
                           for i, r in enumerate(result.incarnations)))
    if result.stop_reason and result.stop_reason != "ok":
        log.warning("agent stopped: %s", result.stop_reason)
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())

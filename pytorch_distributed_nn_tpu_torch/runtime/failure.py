"""Failure detection and the preemption notice: the JAX package's
``runtime/failure.py``, over the port's store (``runtime/native.py``,
c10d's ``TCPStore``).

- **Worker side** (:class:`HeartbeatReporter`): a daemon thread that
  writes ``hb/<incarnation>/<rank> -> wall time`` into the job's store
  every ``interval`` seconds. :func:`maybe_start_heartbeat` is called from
  :func:`runtime.bootstrap.initialize`, so any worker launched by the
  elastic agent (``launch.py``) heartbeats, and outside the agent it does
  nothing. With ``progress_window_s`` (the agent's
  ``--progress-timeout``) the thread goes silent once application code
  has not called :func:`notify_progress` within the window; it arms at
  the first call, so a long first step is not taken for a hang. The
  Trainer calls it once a step, so a worker whose main thread is stuck in
  a hung collective stops beating although the thread itself is fine.
- **Supervisor side** (:class:`FailureDetector`): reads those keys and
  reports still-running ranks whose last beat is older than ``timeout``:
  the hang that exit codes alone never show.
- **Preemption**: SIGTERM becomes a request to stop at the next step
  boundary after a synchronous checkpoint save, with
  :data:`GRACEFUL_EXIT_CODE`, which the agent restarts without charging
  its budget.
- :func:`store_call`: one store operation retried through an outage, each
  failed attempt counted by operation (:func:`store_errors_total`; slice
  6's registry will hold the counter).

Not ported (slice 6, ROADMAP.md §1 item 5): the flight recorder's dump
request over the store and its hooks (the crash hooks and watchdog that
:func:`maybe_start_heartbeat` installs, the dump on a watchdog trip, on a
supervisor's request and on SIGTERM).
"""

from __future__ import annotations

import atexit
import collections
import logging
import os
import random
import signal
import threading
import time

from pytorch_distributed_nn_tpu_torch.runtime import native

log = logging.getLogger(__name__)

# transient store failures absorbed as counted retries, by operation
_store_errors: collections.Counter = collections.Counter()
_store_errors_lock = threading.Lock()


def count_store_error(op: str) -> None:
    """One transient store-op failure absorbed as a counted retry
    (``store_errors_total{op}``) instead of a dead daemon thread or a
    silent drop. ``op`` names the caller's operation (``beat``,
    ``publish``), not the wire verb."""
    with _store_errors_lock:
        _store_errors[op] += 1


def store_errors_total() -> dict[str, int]:
    """The counts of :func:`count_store_error`, by operation."""
    with _store_errors_lock:
        return dict(_store_errors)


_RAISE = object()  # store_call sentinel: re-raise on deadline


def store_call(fn, *, op: str, deadline_s: float = 5.0,
               base_s: float = 0.01, max_s: float = 0.25,
               seed: int = 0, on_retry=None, fallback=_RAISE):
    """Call ``fn()`` (one store operation) until it returns, retrying
    ``OSError``/``TimeoutError`` with exponential backoff and seeded
    jitter, each failure counted under ``op``
    (:func:`count_store_error`) and passed to ``on_retry()`` when given.

    The backoff is ``min(base_s * 2**attempt, max_s)`` scaled by a factor
    in ``[0.5, 1.5)`` from a ``random.Random`` seeded by ``(seed, op)``,
    so a rerun retries on the same schedule. ``deadline_s`` bounds the
    whole call: once it has passed the last error re-raises, or
    ``fallback`` is returned when given. Any other exception propagates at
    its first attempt.
    """
    rng = random.Random((int(seed) << 16) ^ (hash(op) & 0xFFFF))
    deadline = time.monotonic() + float(deadline_s)
    attempt = 0
    while True:
        try:
            return fn()
        except (OSError, TimeoutError):
            count_store_error(op)
            if on_retry is not None:
                on_retry()
            now = time.monotonic()
            if now >= deadline:
                if fallback is not _RAISE:
                    return fallback
                raise
            delay = min(base_s * (2.0 ** attempt), max_s)
            delay *= 0.5 + rng.random()
            time.sleep(min(delay, max(deadline - now, 0.0)))
            attempt += 1


# Environment contract between the elastic agent and its workers.
ENV_STORE_PORT = "TPUNN_STORE_PORT"
ENV_STORE_HOST = "TPUNN_STORE_HOST"
ENV_RESTART = "TPUNN_RESTART"          # incarnation index (0 on first launch)
ENV_HB_INTERVAL = "TPUNN_HEARTBEAT_INTERVAL"
ENV_PROGRESS_WINDOW = "TPUNN_PROGRESS_WINDOW"
ENV_PREEMPT = "TPUNN_PREEMPT"  # "1" forces preemption handling on

# Worker exit code for a graceful preemption exit (SIGTERM -> finish the
# step in flight -> synchronous checkpoint save -> exit): the elastic
# agent restarts on it without charging its restart budget. Outside the
# 128+N signal-kill convention.
GRACEFUL_EXIT_CODE = 83


def _hb_key(incarnation: int, rank: int) -> str:
    return f"hb/{incarnation}/{rank}"


class HeartbeatReporter:
    """Worker-side daemon thread: periodic ``set(hb/<inc>/<rank>, now)``.

    With ``progress_window_s`` set, beats are suppressed once
    :meth:`notify_progress` has not been called for that long (the
    progress watchdog; see the module's docstring).
    """

    def __init__(self, client: native.StoreClient, *, rank: int,
                 incarnation: int = 0, interval_s: float = 1.0,
                 progress_window_s: float | None = None) -> None:
        self._client = client
        self.rank = rank
        self.incarnation = incarnation
        self._key = _hb_key(incarnation, rank)
        self._interval = interval_s
        self._window = progress_window_s
        # beats written, beats withheld by the watchdog, last beat time
        self._beats = 0
        self._suppressed = 0
        self.store_errors = 0  # beats absorbed as counted retries
        self._last_beat: float | None = None
        # None until the first notify_progress: the watchdog arms only
        # once a step has completed, so a long first step cannot read as
        # a hang (until then the beats are the process's liveness alone)
        self._last_progress: float | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"heartbeat-r{rank}", daemon=True
        )
        self.beat()  # one synchronous beat so the detector sees us at once
        self._thread.start()

    def beat(self) -> None:
        now = time.time()
        self._client.set(self._key, repr(now).encode())
        self._beats += 1
        self._last_beat = now

    def stats(self) -> dict:
        """Liveness counters: seconds since the last beat, beats written,
        beats the watchdog withheld, failed beats."""
        now = time.time()
        return {
            "age_s": (now - self._last_beat
                      if self._last_beat is not None else -1.0),
            "beats": self._beats,
            "suppressed": self._suppressed,
            "store_errors": self.store_errors,
        }

    def notify_progress(self) -> None:
        """Application-level liveness: the step loop moved forward."""
        self._last_progress = time.time()

    def disarm(self) -> None:
        """Back to liveness only (the training loop exited): work after
        the loop (checkpoint drains, eval) must not read as a hang."""
        self._last_progress = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            if (self._window is not None
                    and self._last_progress is not None
                    and time.time() - self._last_progress > self._window):
                self._suppressed += 1
                continue  # main thread looks stuck: go silent, get flagged
            try:
                self.beat()
            except (OSError, TimeoutError):
                # a missed beat (a partition, a supervisor mid-teardown) is
                # a counted retry, never a dead thread: a beat thread that
                # died in a short outage would leave a healthy worker
                # reading as hung for good
                self.store_errors += 1
                count_store_error("beat")

    def stop(self, timeout_s: float | None = None) -> None:
        """End the beat thread, waiting ``timeout_s`` (two intervals by
        default) for a beat in flight."""
        self._stop.set()
        self._thread.join(timeout=2 * self._interval if timeout_s is None
                          else timeout_s)
        if self._thread.is_alive():
            # the beat thread is inside a store call: leave its connection
            # to it (the process is exiting anyway)
            return
        self._client.close()


_reporter: HeartbeatReporter | None = None
# how long a process's exit waits for a beat in flight
EXIT_JOIN_S = 5.0


def maybe_start_heartbeat(rank: int | None = None) -> HeartbeatReporter | None:
    """Start heartbeating iff launched under the elastic agent.

    Reads the agent's environment contract; a plain launch has no
    ``TPUNN_STORE_PORT`` and this is a no-op. Idempotent.
    """
    global _reporter
    if _reporter is not None:
        return _reporter
    port = os.environ.get(ENV_STORE_PORT)
    if not port:
        return None
    if rank is None:
        rank = int(os.environ.get("PROCESS_ID", os.environ.get("RANK", "0")))
    window = os.environ.get(ENV_PROGRESS_WINDOW)
    try:
        client = native.StoreClient(
            os.environ.get(ENV_STORE_HOST, "127.0.0.1"), int(port)
        )
        # OSError can come from the constructor's first beat when the
        # agent is tearing the store down at this moment; a dying job must
        # not gain a worker traceback on top
        _reporter = HeartbeatReporter(
            client,
            rank=rank,
            incarnation=int(os.environ.get(ENV_RESTART, "0")),
            interval_s=float(os.environ.get(ENV_HB_INTERVAL, "1.0")),
            progress_window_s=float(window) if window else None,
        )
    except (ConnectionError, OSError) as e:
        log.warning("heartbeat disabled: %s", e)
        return None
    # the beat thread must not be inside a store call when the interpreter
    # finalizes: a daemon thread returning from the C++ client then exits
    # by a forced unwind that aborts the process ("terminate called without
    # an active exception"), turning a clean exit into a crash
    atexit.register(_reporter.stop, timeout_s=EXIT_JOIN_S)
    return _reporter


def reporter() -> HeartbeatReporter | None:
    """The live worker-side reporter, if the agent started one."""
    return _reporter


def heartbeat_stats() -> dict | None:
    """This worker's liveness counters and the store errors counted by
    operation (``store_errors_total``); None outside the agent."""
    if _reporter is None:
        return None
    return {**_reporter.stats(), "store_errors_total": store_errors_total()}


def notify_progress() -> None:
    """Per-step hook for training loops; no-op outside the agent."""
    if _reporter is not None:
        _reporter.notify_progress()


def notify_done() -> None:
    """Loop-exit hook: disarm the progress watchdog; no-op outside the
    agent."""
    if _reporter is not None:
        _reporter.disarm()


# ---------------------------------------------------------------------------
# Worker-side preemption handling (SIGTERM -> cooperative graceful exit)
# ---------------------------------------------------------------------------

_preempt_flag = threading.Event()
_preempt_prev_handler = None
_preempt_installed = False


def install_preemption_handler(force: bool = False) -> bool:
    """SIGTERM only sets a flag that the training loop reads at the next
    step boundary (:func:`preempt_requested`), where it saves a checkpoint
    synchronously and exits ``GRACEFUL_EXIT_CODE``.

    Installed only where it can matter: under the elastic agent
    (``TPUNN_STORE_PORT`` set: the agent classifies the graceful code),
    or when ``TPUNN_PREEMPT=1`` or ``force`` asks for it. Main thread
    only; idempotent. Returns whether the handler is active."""
    global _preempt_installed, _preempt_prev_handler
    if _preempt_installed:
        return True
    if not force and not os.environ.get(ENV_STORE_PORT) \
            and os.environ.get(ENV_PREEMPT, "0") != "1":
        return False

    def _handler(signum, frame):
        _preempt_flag.set()

    try:
        _preempt_prev_handler = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread
        return False
    _preempt_installed = True
    return True


def uninstall_preemption_handler() -> None:
    """Restore the previous SIGTERM disposition (``Trainer.close``)."""
    global _preempt_installed, _preempt_prev_handler
    if not _preempt_installed:
        return
    try:
        signal.signal(signal.SIGTERM, _preempt_prev_handler)
    except (ValueError, TypeError):
        pass
    _preempt_installed = False
    _preempt_prev_handler = None
    _preempt_flag.clear()


def preempt_requested() -> bool:
    """True once a preemption notice (SIGTERM) has arrived."""
    return _preempt_flag.is_set()


def request_preemption() -> None:
    """Programmatic preemption notice (tests, or cluster integrations that
    learn of a preemption other than by SIGTERM)."""
    _preempt_flag.set()


class FailureDetector:
    """Supervisor-side staleness check over the workers' heartbeat keys.

    Node-local by design: each elastic agent hosts its own store and
    watches only the ranks it spawned.
    """

    def __init__(self, client: native.StoreClient, *, ranks: list[int],
                 incarnation: int, timeout_s: float) -> None:
        self._client = client
        self._ranks = list(ranks)
        self._incarnation = incarnation
        self._timeout = timeout_s
        self._first_seen: dict[int, float] = {}
        # rank -> times it has been reported stale
        self.missed_counts: dict[int, int] = {r: 0 for r in self._ranks}

    def any_beats(self) -> bool:
        """Whether any watched rank has beaten this incarnation: the
        restart policy's fail-fast discriminator (a gang that died before
        its first beat is a startup crash, not a fault in training)."""
        try:
            return any(a is not None
                       for a in self.last_beat_ages().values())
        except OSError:
            return False

    def last_beat_ages(self) -> dict[int, float | None]:
        """Per-rank seconds since the last beat (None = never beaten): the
        staleness behind :meth:`stale_ranks`."""
        now = time.time()
        ages: dict[int, float | None] = {}
        for rank in self._ranks:
            key = _hb_key(self._incarnation, rank)
            if self._client.check(key):
                ages[rank] = now - float(
                    self._client.get(key, timeout_ms=1000))
            else:
                ages[rank] = None
        return ages

    def stale_ranks(self, alive: set[int] | None = None) -> list[int]:
        """Ranks whose heartbeat is older than the timeout.

        ``alive`` — ranks whose process is still running; ranks not in it
        have exited and are the exit-code watcher's business (a worker
        that finished cleanly stops beating and must not read as hung). A
        rank that has never beaten is stale only once it has been up
        longer than the timeout (startup grace).
        """
        now = time.time()
        stale = []
        for rank in self._ranks:
            if alive is not None and rank not in alive:
                continue
            key = _hb_key(self._incarnation, rank)
            if self._client.check(key):
                last = float(self._client.get(key, timeout_ms=1000))
                if now - last > self._timeout:
                    stale.append(rank)
            else:
                first = self._first_seen.setdefault(rank, now)
                if now - first > self._timeout:
                    stale.append(rank)
        for rank in stale:
            self.missed_counts[rank] = self.missed_counts.get(rank, 0) + 1
        return stale

"""Thread-based loopback inference server + synthetic load clients.

Counterpart of the JAX package's ``serve/server.py`` without its
preemption, flight-recorder and watchtower hooks. One daemon thread drives
:class:`serve.engine.ServingEngine` rounds; client threads submit through
the scheduler's thread-safe admission path and block on each request's
``done`` event. The loop thread selects the engine's CUDA device before
its first round, so kernels launch on that device's current stream.

Load shapes: :func:`open_loop_client` (arrivals on their own schedule,
fixed or seeded Poisson, whatever the completions) and
:func:`closed_loop_client` (N users, each submit -> wait -> repeat).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.serve.engine import ServingEngine
from pytorch_distributed_nn_tpu_torch.serve.scheduler import Request


class InferenceServer:
    """Single-threaded engine loop with a thread-safe submit path."""

    def __init__(self, engine: ServingEngine, *,
                 idle_wait_s: float = 0.002) -> None:
        self.engine = engine
        self.idle_wait_s = idle_wait_s
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # an exception that ended the loop thread, re-raised by stop()
        self.error: Optional[BaseException] = None

    def start(self) -> "InferenceServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-loop", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            while not self._stop.is_set():
                if self.engine.has_work:
                    self.engine.step()
                else:
                    # park until a submit wakes us (bounded so stop polls
                    # stay live with no traffic)
                    self._wake.wait(self.idle_wait_s)
                    self._wake.clear()
            self.engine.drain()
        except Exception as e:  # the loop thread's boundary: report it
            self.error = e
            # fail every admitted request and reject the queue, so no
            # client blocks forever on a dead loop
            for s in self.engine._slots:
                if s is not None:
                    self.engine.scheduler.fail(s.req, "engine_error")
            self.engine.scheduler.drain()
            raise

    def stop(self, timeout: float = 60.0) -> None:
        """Graceful stop: drain and join the loop thread. Re-raises an
        exception that ended the loop."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("serve loop did not drain in time")
        if self.error is not None:
            raise RuntimeError("serve loop failed") from self.error

    def submit(self, prompt, max_new_tokens: int, **kw) -> Request:
        """Submit a request (``decode=`` a
        :class:`~serve.decoding.DecodeSpec`, ``stream=True`` for a
        :class:`~serve.decoding.TokenStream` on ``req.stream``,
        ``adapter=`` a LoRA adapter of the engine's bank)."""
        req = self.engine.submit(prompt, max_new_tokens, **kw)
        self._wake.set()
        return req

    def stream(self, prompt, max_new_tokens: int, **kw):
        """Submit with streaming and return the request's
        :class:`~serve.decoding.TokenStream`: the first chunk is the
        prefill's token, and iteration ends when the request retires, is
        rejected or fails (a terminal transition closes the stream). The
        Request rides on ``stream.request``."""
        req = self.submit(prompt, max_new_tokens, stream=True, **kw)
        req.stream.request = req
        return req.stream

    def generate(self, prompt, max_new_tokens: int,
                 timeout: float = 120.0, **kw) -> Request:
        """Blocking convenience: submit + wait for the terminal state."""
        req = self.submit(prompt, max_new_tokens, **kw)
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {req.request_id} did not "
                               f"finish in {timeout}s")
        return req


def ragged_prompt_sampler(vocab_size: int, *, min_len: int = 4,
                          max_len: int = 48, seed: int = 0
                          ) -> Callable[[], np.ndarray]:
    """Deterministic ragged-length prompt stream."""
    rng = np.random.default_rng(seed)

    def sample() -> np.ndarray:
        n = int(rng.integers(min_len, max_len + 1))
        return rng.integers(0, vocab_size, size=(n,)).astype(np.int32)

    return sample


def arrival_offsets(num_requests: int, rate_hz: float, *,
                    arrival: str = "fixed",
                    seed: int = 0) -> list[float]:
    """The open-loop submit schedule as offsets from t0: ``fixed`` is a
    metronome at 1/rate_hz, ``poisson`` seeded exponential gaps."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    if arrival not in ("fixed", "poisson"):
        raise ValueError(f"arrival must be 'fixed' or 'poisson', "
                         f"got {arrival!r}")
    if arrival == "fixed":
        return [i / rate_hz for i in range(num_requests)]
    rng = random.Random(seed)
    offsets, t = [], 0.0
    for _ in range(num_requests):
        offsets.append(t)
        t += rng.expovariate(rate_hz)
    return offsets


def open_loop_client(server: InferenceServer, *, num_requests: int,
                     rate_hz: float, max_new_tokens: int,
                     prompt_sampler: Callable[[], np.ndarray],
                     deadline_s: Optional[float] = None,
                     arrival: str = "fixed",
                     seed: int = 0) -> list[Request]:
    """Submit ``num_requests`` on an open loop; returns every Request
    (rejected ones included) once all are terminal."""
    offsets = arrival_offsets(num_requests, rate_hz,
                              arrival=arrival, seed=seed)
    reqs: list[Request] = []
    t0 = time.monotonic()
    for off in offsets:
        wait = t0 + off - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        dl = (time.monotonic() + deadline_s
              ) if deadline_s is not None else None
        reqs.append(server.submit(prompt_sampler(), max_new_tokens,
                                  deadline_s=dl))
    for r in reqs:
        r.done.wait()
    return reqs


def closed_loop_client(server: InferenceServer, *, num_users: int,
                       requests_per_user: int, max_new_tokens: int,
                       prompt_sampler: Callable[[], np.ndarray]
                       ) -> list[Request]:
    """``num_users`` synthetic users, each submit -> wait -> repeat."""
    out_lock = threading.Lock()
    reqs: list[Request] = []

    def user() -> None:
        for _ in range(requests_per_user):
            with out_lock:
                prompt = prompt_sampler()
            r = server.submit(prompt, max_new_tokens)
            with out_lock:
                reqs.append(r)
            r.done.wait()

    threads = [threading.Thread(target=user, daemon=True)
               for _ in range(num_users)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return reqs


def wait_all(reqs: Sequence[Request], timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    for r in reqs:
        if not r.done.wait(max(deadline - time.monotonic(), 0.0)):
            raise TimeoutError(f"request {r.request_id} still "
                               f"{r.state} at timeout")

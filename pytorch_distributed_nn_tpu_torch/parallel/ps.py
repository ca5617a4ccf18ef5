"""Asynchronous parameter-server data parallelism: the JAX package's
``parallel/ps.py``.

The reference's asynchronous strategy: one server holds the parameters;
workers send it gradients and receive fresh parameters back, with no step
synchronisation (async SGD with stale gradients). It is a process-level
program, not a step of the Trainer (``parallel/api.py`` refuses
``strategy: ps``), and its transport is the rendezvous store
(``runtime/native.py``, c10d's ``TCPStore``), with the JAX package's keys:

- server (:class:`ParameterServer`): gradients arrive as a totally
  ordered ticket queue (the store's ``add`` gives the ticket, a blocking
  ``get`` drains it); each is applied at once with the port's optimizer
  (``train/optim.py``, optax's order) and ``ps/params/v{N}`` is
  republished. Its parameters and the optimizer's state live on the
  caller's device, the card unless the CPU is asked for;
- workers (:class:`PSWorker`): pull the newest parameters (cached by
  version), compute a gradient on their own batch with their own copy of
  the model (:func:`model_grad_fn`), push it with their ticket; a
  stale-synchronous gate (``max_staleness``) bounds how far a worker runs
  ahead of the server.

Parameters and gradients cross the store as ``np.savez`` of the tensors in
sorted-name order (:func:`tree_to_bytes`); bf16 tensors travel as their
16-bit patterns.
"""

from __future__ import annotations

import copy
import io
import logging
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.runtime.native import (
    StoreClient,
    StoreServer,
)
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_PARAMS_VERSION = "ps/params/version"
_PARAMS_KEY = "ps/params/v{v}"
_GRAD_TICKET = "ps/grads/ticket"
_GRAD_KEY = "ps/grads/{t}"
_STOP_KEY = "ps/stop"


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: its bit patterns
        t = t.view(torch.int16)
    return t.cpu().numpy()


def tree_to_bytes(tree: Mapping[str, torch.Tensor]) -> bytes:
    """The tensors of ``tree`` (a name -> tensor mapping, a
    ``state_dict``), in sorted-name order, as one ``np.savez`` archive;
    the names and dtypes travel with the template on the other side."""
    buf = io.BytesIO()
    np.savez(buf, *[_numpy(tree[k]) for k in sorted(tree)])
    return buf.getvalue()


def tree_from_bytes(data: bytes, template: Mapping[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`tree_to_bytes`: fresh tensors, named, shaped
    and placed as ``template``'s (in its order)."""
    names = sorted(template)
    with np.load(io.BytesIO(data)) as z:
        loaded = {k: torch.from_numpy(z[f"arr_{i}"])
                  for i, k in enumerate(names)}
    out = {}
    for k, ref in template.items():
        t = loaded[k]
        if ref.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"{k}: got {t.dtype}{tuple(t.shape)}, the "
                             f"template holds {ref.dtype}{tuple(ref.shape)}")
        out[k] = t.to(ref.device)
    return out


class ParameterServer:
    """The server of the reference's PS strategy: owns the parameters and
    the optimizer, applies each incoming (stale) gradient, republishes the
    parameters.

    ``params`` is a name -> tensor mapping (a model's named parameters);
    the server keeps its own copy on ``device``. ``tx`` builds the
    optimizer over that copy's list of ``nn.Parameter`` leaves, e.g.
    ``functools.partial(train.optim.make_optimizer, cfg.optim,
    total_steps=n)``."""

    def __init__(self, store: StoreClient, params: Mapping[str, Any], tx,
                 *, device: str | torch.device = "cuda") -> None:
        dev = resolve_device(device)
        self.store = store
        self._leaves = {k: torch.nn.Parameter(
            torch.as_tensor(v).detach().to(dev, copy=True))
            for k, v in params.items()}
        self.tx = tx(list(self._leaves.values()))
        self.version = 0
        self.applied = 0
        self.pushed_bytes = 0  # gradient bytes received
        self.published_bytes = 0  # parameter bytes published
        self._publish()

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self._leaves.items()}

    def _publish(self) -> None:
        data = tree_to_bytes(self.params)
        self.published_bytes += len(data)
        self.store.set(_PARAMS_KEY.format(v=self.version), data)
        self.store.set(_PARAMS_VERSION, str(self.version).encode())

    def apply_one(self, grad_bytes: bytes) -> None:
        grads = tree_from_bytes(grad_bytes, self.params)
        self.pushed_bytes += len(grad_bytes)
        for k, p in self._leaves.items():
            p.grad = grads[k]
        self.tx.step()
        self.tx.zero_grad()
        self.version += 1
        self.applied += 1
        self._publish()

    def serve(self, total_grads: int, *, timeout_ms: int = 120_000
              ) -> dict[str, torch.Tensor]:
        """Drain the ticket queue until ``total_grads`` gradients have
        been applied; returns the final parameters."""
        next_ticket = 1
        while self.applied < total_grads:
            data = self.store.get(_GRAD_KEY.format(t=next_ticket),
                                  timeout_ms=timeout_ms)
            self.apply_one(data)
            self.store.delete(_GRAD_KEY.format(t=next_ticket))
            next_ticket += 1
        self.store.set(_STOP_KEY, b"1")
        return self.params


class PSWorker:
    """One async worker: pull the newest parameters, a gradient on its own
    batch, push.

    ``max_staleness`` bounds how many tickets a worker may run ahead of
    the server's applied count (stale-synchronous parallel): unbounded
    asynchrony lets fast workers push a burst of gradients all computed
    at the initial parameters, which diverges. ``None`` is fully
    asynchronous; 0 with one worker is synchronous SGD.

    :attr:`stats` counts what a run did: pushes and pulls and their bytes,
    the seconds in store calls (the gate's waits and the
    (de)serialisation included) and in gradient compute, and each pushed
    gradient's staleness (its ticket less the version it was computed
    at)."""

    def __init__(self, store: StoreClient, grad_fn: Callable,
                 params_template: Mapping[str, torch.Tensor], *,
                 max_staleness: int | None = 8) -> None:
        self.store = store
        self.grad_fn = grad_fn  # (params, x, y) -> grads (name -> tensor)
        self.template = params_template
        self.max_staleness = max_staleness
        self._version_seen = -1
        self._params = None
        self._last_ticket = 0
        self.stats = dict(pushes=0, pulls=0, push_bytes=0, pull_bytes=0,
                          store_s=0.0, grad_s=0.0, staleness=[])

    def pull(self) -> dict[str, torch.Tensor]:
        v = int(self.store.get(_PARAMS_VERSION).decode())
        if v != self._version_seen:
            data = self.store.get(_PARAMS_KEY.format(v=v))
            self._params = tree_from_bytes(data, self.template)
            self._version_seen = v
            self.stats["pulls"] += 1
            self.stats["pull_bytes"] += len(data)
        return self._params

    def step(self, x, y) -> int:
        """One async step; returns the ticket this gradient got."""
        t0 = time.perf_counter()
        if self.max_staleness is not None:
            # SSP gate: wait until the server has applied to within
            # max_staleness of our last pushed ticket
            target = self._last_ticket - self.max_staleness
            while (target > 0 and
                   int(self.store.get(_PARAMS_VERSION).decode()) < target):
                if self.store.check(_STOP_KEY):  # the server is gone
                    raise RuntimeError("the parameter server stopped "
                                       "before this worker's gate opened")
                time.sleep(0.002)
        params = self.pull()
        version = self._version_seen
        t1 = time.perf_counter()
        grads = self.grad_fn(params, x, y)
        if grads and next(iter(grads.values())).is_cuda:
            torch.cuda.current_stream().synchronize()
        t2 = time.perf_counter()
        data = tree_to_bytes(grads)
        ticket = self.store.add(_GRAD_TICKET, 1)
        self.store.set(_GRAD_KEY.format(t=ticket), data)
        self._last_ticket = ticket
        st = self.stats
        st["store_s"] += (t1 - t0) + (time.perf_counter() - t2)
        st["grad_s"] += t2 - t1
        st["pushes"] += 1
        st["push_bytes"] += len(data)
        st["staleness"].append(ticket - version)
        return ticket

    def run(self, batches, *, poll_stop_every: int = 4) -> int:
        """Push gradients for ``batches`` until exhausted or the server
        says stop; returns how many this worker contributed."""
        pushed = 0
        for i, (x, y) in enumerate(batches):
            if i % poll_stop_every == 0 and self.store.check(_STOP_KEY):
                break
            self.step(x, y)
            pushed += 1
        return pushed


def model_grad_fn(model: torch.nn.Module, loss_fn: Callable) -> Callable:
    """``grad_fn(params, x, y) -> {name: gradient}`` of
    ``loss_fn(model(x), y)`` at ``params`` (the model's named
    parameters), the model in eval mode (the JAX script's
    ``train=False``). Each thread that calls it computes on its own deep
    copy of ``model``, never on the server's tensors or another worker's."""
    local = threading.local()

    def grad_fn(params, x, y):
        m = getattr(local, "model", None)
        if m is None:
            m = local.model = copy.deepcopy(model).eval()
        leaves = dict(m.named_parameters())
        with torch.no_grad():
            for k, p in leaves.items():
                p.copy_(params[k])
        loss = loss_fn(m(x), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads))

    return grad_fn


def run_ps_local(params, tx, grad_fn, worker_batches, *,
                 server_port: int = 0, max_staleness: int | None = 8,
                 device: str | torch.device = "cuda",
                 stats: list | None = None
                 ) -> tuple[dict[str, torch.Tensor], int]:
    """One-process harness: threads play the server and the workers (the
    multi-process form runs the same classes in other processes against
    one :class:`StoreServer`). Returns the final parameters and the count
    of gradients applied; ``stats``, a list, receives each worker's
    :attr:`PSWorker.stats` and then the server's bytes. A thread's
    exception is raised here once every thread has ended."""
    total = sum(len(b) for b in worker_batches)
    errors: list[BaseException] = []

    def guarded(fn, *args):
        def run():
            try:
                fn(*args)
            except BaseException as e:  # raised below, in the caller
                errors.append(e)
        return run

    with StoreServer(server_port) as srv:
        server = ParameterServer(StoreClient(port=srv.port), params, tx,
                                 device=device)
        result: dict = {}

        def serve():
            try:
                result["params"] = server.serve(total)
            finally:  # on a failure too: no worker waits at its gate
                server.store.set(_STOP_KEY, b"1")

        workers = [PSWorker(StoreClient(port=srv.port), grad_fn, params,
                            max_staleness=max_staleness)
                   for _ in worker_batches]
        threads = [threading.Thread(target=guarded(serve))]
        threads += [threading.Thread(target=guarded(w.run, b))
                    for w, b in zip(workers, worker_batches)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        log.info("ps: %d grads in %.3fs", server.applied,
                 time.perf_counter() - t0)
        for client in [server.store] + [w.store for w in workers]:
            client.close()
    if errors:
        raise errors[0]
    if stats is not None:
        stats.extend(w.stats for w in workers)
        stats.append(dict(applied=server.applied,
                          pushed_bytes=server.pushed_bytes,
                          published_bytes=server.published_bytes))
    return result["params"], server.applied

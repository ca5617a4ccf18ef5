"""Multi-step dispatch: k train steps in one launch from the host (the JAX
package's ``train/multistep.py``, where ``lax.scan`` runs k steps in one
device program).

On the card the k steps are one captured ``torch.cuda.CUDAGraph``: the
host replays it once a dispatch, so its per-launch cost is paid once for k
steps' thousands of kernels. What changes from one dispatch to the next
is copied into static device buffers before each replay: the k fresh
batches (or the pool), and the optimizer's per-update values (the lr,
adam's bias corrections: ``Optimizer.hyper``). The host's step and update
counters, which the captured Python advanced once, are advanced by k after
each replay. The graph is captured at the first call, after one warm-up
step on a side stream whose effect on the state is undone (every tensor
copied back in place, the counters reset), so the warm-up trains nothing.
On the CPU the k steps are a loop. Either way the math is that of k
``step_fn`` calls on the same batches, bit for bit.

A step that cannot be captured raises, naming the reason; nothing falls
back to eager steps on the card.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_distributed_nn_tpu_torch.train.state import TrainState


def make_multistep(step_fn: Callable, k: int, *, mempool=None
                   ) -> Callable:
    """Wrap ``step(state, x, y) -> (state, metrics)`` into
    ``multistep(state, xs, ys) -> (state, metrics)`` running ``k`` steps.
    ``xs``/``ys`` carry a leading pool axis of any length P <= k: step i
    trains on slice ``i % P``. The metrics are the last step's, with every
    step's stacked under ``"all"``. ``mempool`` (a
    ``torch.cuda.graph_pool_handle()``) is the private memory pool the
    graph allocates from; graphs of one trainer share it (each graph's
    allocations are dead when its replay ends)."""
    if k < 1:
        raise ValueError(f"multistep k must be >= 1, got {k}")
    return _Multistep(step_fn, k, mempool)


class _Multistep:
    def __init__(self, step_fn: Callable, k: int, mempool) -> None:
        self.step_fn = step_fn
        self.k = k
        self.mempool = mempool
        self.graph = None  # (signature, graph, xs, ys, rows, losses)
        self.replays = 0

    def __call__(self, state: TrainState, xs: torch.Tensor,
                 ys: torch.Tensor):
        pool = xs.shape[0]
        if pool > self.k:
            raise ValueError(
                f"batch pool ({pool}) larger than step count ({self.k}): "
                f"{pool - self.k} batches would silently never train")
        if not xs.is_cuda:
            return self._loop(state, xs, ys)
        return self._replay(state, xs, ys)

    def _loop(self, state, xs, ys):
        losses, metrics = [], None
        for i in range(self.k):
            state, metrics = self.step_fn(state, xs[i % xs.shape[0]],
                                          ys[i % ys.shape[0]])
            losses.append(metrics["loss"])
        out = dict(metrics)
        out["all"] = {"loss": torch.stack(losses)}
        return state, out

    def _replay(self, state, xs, ys):
        sig = (tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype)
        if self.graph is None or self.graph[0] != sig:
            self.graph = (sig, *self._capture(state, xs, ys))
        _, graph, static_x, static_y, rows, losses = self.graph
        opt = state.optimizer
        opt.release()  # a checkpoint's copy of the state, if one is queued
        static_x.copy_(xs)
        static_y.copy_(ys)
        rows.copy_(opt.hyper(opt.count, self.k))
        graph.replay()
        self.replays += 1
        state.step += self.k
        opt.count += self.k
        out = losses.clone()  # the next replay rewrites ``losses``
        return state, {"loss": out[-1], "all": {"loss": out}}

    def _capture(self, state: TrainState, xs, ys):
        static_x = torch.empty_like(xs).copy_(xs)
        static_y = torch.empty_like(ys).copy_(ys)
        opt = state.optimizer
        rows = opt.hyper(opt.count, self.k).clone()
        losses = torch.empty(self.k, dtype=torch.float32, device=xs.device)
        _warm_up(state, self.step_fn, static_x[0], static_y[0])
        live = {k: v.data_ptr() for k, v in state.state_dict().items()
                if v.is_cuda}
        counts = state.step, opt.count
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the loader's prefetch thread and the
            # checkpoint writer go on with their own CUDA calls meanwhile
            with torch.cuda.graph(graph, pool=self.mempool,
                                  capture_error_mode="thread_local"):
                for i in range(self.k):
                    with opt.reading(rows[i]):
                        state, metrics = self.step_fn(
                            state, static_x[i % xs.shape[0]],
                            static_y[i % ys.shape[0]])
                    losses[i].copy_(metrics["loss"])
                del metrics
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of the train step failed ({e}); the "
                "multistep loop does not fall back to eager steps on the "
                "card: run with multistep_k 1") from e
        finally:
            state.step, opt.count = counts
        moved = [k for k, v in state.state_dict().items()
                 if v.is_cuda and live.get(k) != v.data_ptr()]
        if moved:
            raise RuntimeError(
                "CUDA graph capture of the train step failed: the step "
                f"rebinds state tensors ({moved[:3]}) instead of updating "
                "them in place, so a replay would not carry them")
        return graph, static_x, static_y, rows, losses


def _warm_up(state: TrainState, step_fn: Callable, x, y) -> None:
    """One eager step on a side stream (kernels built and loaded, library
    handles and workspaces made), then the state as it was: every tensor
    copied back in place, the counters and the generator restored."""
    saved = {k: v.clone() for k, v in state.state_dict().items()}
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        step_fn(state, x, y)
        state.load_state_dict(saved)
    torch.cuda.current_stream(x.device).wait_stream(side)
    torch.cuda.synchronize(x.device)

"""Host-to-device loader with per-rank sharding and background prefetch
(the JAX package's ``data/loader.py``).

Every rank generates the same seed-deterministic GLOBAL batch and keeps its
rows ``[rank * B / n, (rank + 1) * B / n)`` (``runtime.mesh.batch_slice``,
the split the JAX loader's ``batch_pspec`` makes). A producer thread
generates the batches and copies them to the device through pinned host
memory (``non_blocking``), keeping ``prefetch`` batches ready, so host
generation overlaps device compute. On the CPU the arrays are wrapped as
they are.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.data.datasets import SyntheticDataset
from pytorch_distributed_nn_tpu_torch.runtime.mesh import batch_slice


class DataLoader:
    def __init__(self, dataset: SyntheticDataset, device: torch.device, *,
                 rank: int = 0, world_size: int = 1, start_step: int = 0,
                 prefetch: int = 2) -> None:
        self.dataset = dataset
        self.device = torch.device(device)
        self.rows = batch_slice(dataset.batch_size, rank, world_size)
        self.start_step = start_step
        self.prefetch = prefetch
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def batch_at(self, step: int) -> tuple[torch.Tensor, ...]:
        """This rank's rows of one step's batch on the device (no
        prefetch)."""
        return tuple(self._to_device(a[self.rows])
                     for a in self.dataset.batch(step))

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        """Batches from ``start_step`` on. With ``prefetch > 0`` a producer
        thread runs ahead; :meth:`close` (or closing the iterator) stops
        and joins it."""
        if self.prefetch <= 0:
            step = self.start_step
            while True:
                yield self.batch_at(step)
                step += 1
        self.close()  # one producer at a time
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = self._stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            step = self.start_step
            try:
                while put(self.batch_at(step)):
                    step += 1
            except Exception as e:  # surface the error to the consumer
                put(e)

        thread = self._thread = threading.Thread(
            target=producer, daemon=True, name="data-prefetch")
        thread.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not thread.is_alive():
                        raise RuntimeError(
                            "data prefetch thread died") from None
                    continue
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer thread and join it."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30.0)
            if thread.is_alive():
                raise RuntimeError("data prefetch thread did not stop")

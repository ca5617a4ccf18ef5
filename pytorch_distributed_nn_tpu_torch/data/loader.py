"""Host-to-device loader with per-rank sharding and background prefetch
(the JAX package's ``data/loader.py``).

Every rank generates the same seed-deterministic GLOBAL batch and keeps the
rows of its data coordinate, ``[i * B / n, (i + 1) * B / n)`` for index i
of n on the data x fsdp axis (``runtime.mesh.batch_slice``, the split the
JAX loader's ``batch_pspec`` makes); under sequence parallelism a (B, T)
token array also keeps only the columns of its seq coordinate
(``runtime.mesh.seq_slice``, the JAX loader's ``array_pspec``). A producer thread
generates the batches and copies them to the device through pinned host
memory (``non_blocking``), keeping ``prefetch`` batches ready, so host
generation overlaps device compute. On the CPU the arrays are wrapped as
they are. A multistep dispatch takes its k batches stacked
(:meth:`DataLoader.iter_stacked`), a pool its P once
(:meth:`DataLoader.stacked_batch_at`).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.data.datasets import SyntheticDataset
from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
    batch_slice,
    seq_slice,
)


class DataLoader:
    def __init__(self, dataset: SyntheticDataset, device: torch.device, *,
                 data_index: int = 0, data_degree: int = 1,
                 seq_index: int = 0, seq_degree: int = 1,
                 start_step: int = 0, prefetch: int = 2) -> None:
        self.dataset = dataset
        self.device = torch.device(device)
        self.rows = batch_slice(dataset.batch_size, data_index, data_degree)
        self.cols = None  # every token of a row
        if seq_degree > 1:
            seq_len = getattr(dataset, "seq_len", None)
            if seq_len is None:
                raise ValueError(
                    "mesh.seq > 1 shards the sequence dim of (B, T) token "
                    f"batches; {type(dataset).__name__} has none")
            self.cols = seq_slice(seq_len, seq_index, seq_degree)
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
        """This rank's rows (and, under sequence parallelism, tokens) of
        one step's batch on the device (no prefetch)."""
        index = self.rows if self.cols is None else (self.rows, self.cols)
        return tuple(self._to_device(a[index])
                     for a in self.dataset.batch(step))

    def stacked_batch_at(self, start: int, n: int
                         ) -> tuple[torch.Tensor, ...]:
        """Steps ``start`` ... ``start + n - 1`` stacked on a leading axis
        (n, ...) on the device: one multistep dispatch's batches, or its
        pool."""
        index = self.rows if self.cols is None else (self.rows, self.cols)
        batches = [self.dataset.batch(start + i) for i in range(n)]
        return tuple(self._to_device(np.stack([b[j][index] for b in batches]))
                     for j in range(len(batches[0])))

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        """Batches from ``start_step`` on. With ``prefetch > 0`` a producer
        thread runs ahead; :meth:`close` (or closing the iterator) stops
        and joins it."""
        start = self.start_step
        return self._run(lambda i: self.batch_at(start + i))

    def iter_stacked(self, window_sizes: list[int], start_step: int
                     ) -> Iterator[tuple[torch.Tensor, ...]]:
        """One :meth:`stacked_batch_at` a window of ``window_sizes``, the
        windows back to back from ``start_step``, prefetched as
        :meth:`__iter__` does."""
        firsts = np.cumsum([start_step, *window_sizes[:-1]]).tolist()
        return self._run(lambda i: self.stacked_batch_at(
            firsts[i], window_sizes[i]), count=len(window_sizes))

    def _run(self, make, count: int | None = None
             ) -> Iterator[tuple[torch.Tensor, ...]]:
        """``make(0)``, ``make(1)``, ... (``count`` of them, or without
        end), made ahead by a producer thread when ``prefetch > 0``."""
        if self.prefetch <= 0:
            i = 0
            while count is None or i < count:
                yield make(i)
                i += 1
            return
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
            i = 0
            try:
                while (count is None or i < count) and put(make(i)):
                    i += 1
            except Exception as e:  # surface the error to the consumer
                put(e)

        thread = self._thread = threading.Thread(
            target=producer, daemon=True, name="data-prefetch")
        thread.start()
        try:
            got = 0
            while count is None or got < count:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not thread.is_alive():
                        raise RuntimeError(
                            "data prefetch thread died") from None
                    continue
                if isinstance(item, Exception):
                    raise item
                got += 1
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

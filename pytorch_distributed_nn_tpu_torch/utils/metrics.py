"""Structured metrics logging with rank-0 aggregation (the JAX package's
``utils/metrics.py``, as far as the port's entry points use it).

A JSONL writer where only the coordinator (rank 0 of the process group,
or the one process where there is none) writes: the ``if rank == 0:
print`` idiom, machine-readable. Each record is ``{"event", "time",
"process", **fields}``, as the JAX module writes it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


class MetricsLogger:
    """JSONL metric stream appended to ``path``: one dict per event; the
    ranks but 0 write nothing."""

    def __init__(self, path: str | Path) -> None:
        self.enabled = process_index() == 0
        self._fh = None
        if self.enabled:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = p.open("a")

    def emit(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return
        rec = {"event": event, "time": time.time(),
               "process": process_index(), **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None  # idempotent: double-close is a no-op
            self.enabled = False  # emit after close: silent no-op

"""Preemption notice (the worker side of the JAX package's
``runtime/failure.py``): SIGTERM becomes a request to stop at the next step
boundary, after a synchronous checkpoint save, with
:data:`GRACEFUL_EXIT_CODE`. The heartbeats, the failure detector and the
restarts of ``launch.py`` are not ported yet (ROADMAP.md §1 item 3, the
remaining sharded strategies).
"""

from __future__ import annotations

import os
import signal
import threading

ENV_PREEMPT = "TPUNN_PREEMPT"  # "1" turns preemption handling on

# Worker exit code for a graceful preemption exit (SIGTERM -> finish the
# step in flight -> synchronous checkpoint save -> exit): the JAX package's
# elastic agent restarts on it without charging its restart budget.
GRACEFUL_EXIT_CODE = 83

_preempt_flag = threading.Event()
_preempt_prev_handler = None
_preempt_installed = False


def install_preemption_handler() -> bool:
    """SIGTERM only sets a flag that the training loop reads at the next
    step boundary (:func:`preempt_requested`). Installed only when
    ``TPUNN_PREEMPT=1`` asks for it (the elastic agent that would also
    turn it on is not ported). Main thread only; idempotent. Returns
    whether the handler is active."""
    global _preempt_installed, _preempt_prev_handler
    if _preempt_installed:
        return True
    if os.environ.get(ENV_PREEMPT, "0") != "1":
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


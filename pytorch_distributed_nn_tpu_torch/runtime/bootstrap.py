"""Process bootstrap: ``torch.distributed.init_process_group`` from the
environment (the JAX package's ``runtime/bootstrap.py`` and
``runtime/platform.py``).

The environment contract is the JAX package's, which is also ``torchrun``'s:
``NUM_PROCESSES`` or ``WORLD_SIZE``, ``PROCESS_ID`` or ``RANK``,
``MASTER_ADDR`` (default 127.0.0.1) and ``MASTER_PORT`` (default 12355);
``LOCAL_RANK`` picks the card (default: the rank). So a run under
``torchrun --nproc_per_node N`` needs nothing more.

The backend follows the device: NCCL on ``cuda``, gloo on the CPU. Nothing
falls back: a failed NCCL init raises. The one exception is a gloo group
that the caller formed itself before ``initialize`` (ranks that share a
card, which NCCL refuses: gloo's collectives take CUDA tensors through
host memory): on ``cuda`` it is kept, on the card the caller set, and
``ops.collectives.shared_card`` is set, so that the point-to-point CUDA
messages that gloo does not send go through host memory (the ring's
shifts). A pipeline on shared cards still holds every stage in each
process (``runtime/mesh.pipe_is_local``). A world of
one with no rendezvous in the environment uses an in-process
``dist.HashStore``, so a one-process run opens no port.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
import torch.distributed as dist

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    rank: int
    world_size: int
    local_rank: int
    backend: str
    device: torch.device

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0


def _env(*names: str, default: str | None = None) -> str | None:
    for name in names:
        if name in os.environ:
            return os.environ[name]
    return default


def initialize(device: str | torch.device = "cuda") -> ProcessInfo:
    """Join (or create) the default process group for ``device`` and
    return this process's place in it. Idempotent: a process whose group
    already has the right backend keeps it; one with the other backend
    raises (``shutdown`` first), except a gloo group on ``cuda`` (see the
    module's docstring)."""
    world = int(_env("NUM_PROCESSES", "WORLD_SIZE", default="1"))
    rank = int(_env("PROCESS_ID", "RANK", default="0"))
    local_rank = int(_env("LOCAL_RANK", default=str(rank)))
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_initialized() \
            and dist.get_backend() == "gloo":
        # the caller's group for ranks sharing a card, on its card
        dev = resolve_device("cuda")
        backend = "gloo"
        cc.shared_card = True
    elif dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local_rank))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()!r}, this run "
                f"needs {backend!r} for device {dev}")
    else:
        rendezvous = "MASTER_ADDR" in os.environ or "MASTER_PORT" in os.environ
        if world == 1 and not rendezvous:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
                init_method = "env://"  # torchrun's store (agent-hosted)
            else:
                addr = _env("MASTER_ADDR", default="127.0.0.1")
                port = _env("MASTER_PORT", default="12355")
                init_method = f"tcp://{addr}:{port}"
            log.info("init_process_group(%s, %s, rank=%d, world_size=%d)",
                     backend, init_method, rank, world)
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world)
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError(
            f"process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the environment says {rank} of "
            f"{world}")
    return ProcessInfo(rank=rank, world_size=world, local_rank=local_rank,
                       backend=backend, device=dev)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()

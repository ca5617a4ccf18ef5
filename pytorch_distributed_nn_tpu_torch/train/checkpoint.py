"""Checkpoint / resume: the JAX package's ``train/checkpoint.py`` contract
in a format of its own (orbax is JAX's).

Layout: ``<dir>/<step>/`` holds ``model.pt`` (parameters and buffers under
their flax names), ``optim.pt`` (the optimizer's moments and update count),
``train.pt`` (the generator's state and the step), each written by
``torch.save`` and read back by ``torch.load(weights_only=True)``,
``meta.json`` (``data_step``, ``step``) and ``manifest.json`` (each file's
size and SHA-256). A step is written into a temporary directory beside the
others and renamed into place, so a kill mid-write leaves no step
directory; the newest ``max_to_keep`` steps are kept.

Saves are asynchronous. :meth:`CheckpointManager.save` takes a snapshot
and queues it for a writer thread; :meth:`wait` and :meth:`close` drain the
thread (and re-raise what it failed on). As orbax's async save does, a save
first waits for the previous one to finish, so at most one snapshot (a
full copy of the state in host memory) is alive at a time. On the card the snapshot is taken
without holding the host: the step's stream records an event, a side
stream waits for it and copies every tensor into pinned host memory, and
the next optimizer update (the state is updated in place) waits for that
copy (``Optimizer.hold``). Buffers that the next forward writes in place
(BatchNorm's running statistics) are first cloned on the step's stream.

:meth:`restore` verifies the manifest and falls back past a torn or
corrupt newest step to the next-newest kept one; an explicit ``step`` is
restored as asked or raises; no checkpoint at all raises
``FileNotFoundError``.

A replicated state (``state.sharding`` None): the coordinator writes,
every rank passes a barrier in :meth:`wait`, and every rank restores from
the files, whatever the world size was when they were written.

A sharded state (ZeRO's slices, the pipeline's stages) is saved
synchronously by every rank that owns a piece (the first data replica):
``model-<part>.pt``, ``optim-<part>.pt`` and ``train-<part>.pt`` with the
part named by the layout (``fsdp<i>``, ``expert<e>-fsdp<i>`` under an
expert split, ``pipe<d>``, ``pipe<d>-expert<e>`` under an expert split,
or ``local`` where one process holds every stage; under a tensor split
``tensor<t>-`` before it, every tensor rank writing its slices and the
whole leaves alike; under sequence parallelism only the first seq rank,
the others holding the same slices), between barriers;
the coordinator then writes ``meta.json``, which names the layout
(strategy, mesh sizes with ``seq``, ``zero_stage``, schedule,
``pipe_chunks``, the split of each leaf, the expert-split leaves), and the
manifest over every file, and renames the step into place. Under an
expert split the ranks off expert 0 write only their expert slices and
those slices' moments (the layout's ``keeps``), so a replicated tensor is
written once, and read the rest back from expert 0's piece.

A rank restores its own part where the layout is the state's. Otherwise
it reshards on read, as orbax restores into the template's layout: each
tensor of the template's :meth:`~TrainState.state_dict` (parameters,
moments, counters) is read whole from the pieces that hold it
(:class:`_WholeState`, the files memory-mapped, so a rank's host holds one
whole leaf at a time) and cut to the template's slice by the rules that
laid the pieces out: the tensor split first, then the expert split along
E, then ZeRO's fsdp split (a stage-1 parameter whole, its moments
sliced). Any pair of replicated, ZeRO stage 0/1/3, tensor, expert and seq
layouts at any widths restores; a pipeline restores only onto a pipeline
of the same stages (``pipe`` and ``pipe_chunks``): the JAX Trainer stacks
the stages' parameters, and restores them onto that stacking only
(:class:`LayoutError` for the other pairs). :func:`read_full_params` reads
any checkpoint in one process into the whole flax-named ``state_dict``
that a replicated run loads.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import pickle
import queue
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import torch

from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

_FILES = ("model.pt", "optim.pt", "train.pt")
_META = "meta.json"
_MANIFEST = "manifest.json"


class LayoutError(Exception):
    """The checkpoint's layout cannot be restored onto the state's: a
    pipeline's stages onto another layout, as in the JAX Trainer."""


_COUNTERS = ("opt.count", "generator", "step")
_AXES = ("tensor", "expert", "fsdp")  # the order the pieces were cut in


def _file_of(name: str, part: str | None = None) -> str:
    base = ("model" if name.startswith("model.") else
            "optim" if name.startswith("opt.") else "train")
    return f"{base}.pt" if part is None else f"{base}-{part}.pt"


def _param_of(key: str) -> str | None:
    """The parameter (or buffer) a state key holds a tensor of:
    ``model.<name>`` and ``opt.<moment>.<name>``; None for the counters."""
    if key.startswith("model."):
        return key[len("model."):]
    if key.startswith("opt.") and key.count(".") >= 2:
        return key.split(".", 2)[2]
    return None


def _parts_files(parts: list[str]) -> list[str]:
    return [f"{base}-{part}.pt" for part in parts
            for base in ("model", "optim", "train")]


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointManager:
    """``save`` is asynchronous; ``wait`` and ``close`` drain the writer.
    The newest ``max_to_keep`` steps are kept."""

    def __init__(self, directory: str | Path, *,
                 max_to_keep: int = 3) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.is_writer = cc.rank() == 0
        self._queue: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._queued: set[int] = set()
        self._thread: threading.Thread | None = None
        self.last_save: dict = {}  # bytes and seconds of the newest write
        # the newest restore's step, whether it resharded, and the bytes
        # it read (its seconds where it resharded)
        self.last_restore: dict = {}

    # -- save ------------------------------------------------------------

    def save(self, state: TrainState, *, data_step: int,
             force: bool = False) -> bool:
        """Queue a save of ``state`` at its current step, after the
        previous save has been written. A step already saved (or queued)
        is not saved again unless ``force``. Returns whether a save was
        queued (on every rank alike)."""
        self._raise_failure()
        step = int(state.step)
        if not force and (step in self._queued or step in self.all_steps()):
            return False
        meta = {"data_step": int(data_step), "step": step}
        self._queued.add(step)
        if state.sharding is not None:
            self._save_sharded(state, step, meta)
            return True
        if not self.is_writer:
            return True
        if self._thread is not None:
            self._queue.join()  # at most one save in flight
            self._raise_failure()
        snapshot, ready = _snapshot(state)
        if self._thread is None:
            self._thread = threading.Thread(target=self._writer, daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()
        self._queue.put((step, snapshot, ready, meta))
        log.info("queued checkpoint save at step %d -> %s", step,
                 self.directory)
        return True

    def _save_sharded(self, state: TrainState, step: int,
                      meta: dict) -> None:
        """Every owner writes its part, then the coordinator the meta and
        the manifest; synchronous, between barriers."""
        t0 = time.perf_counter()
        sharding = state.sharding
        tmp = self.directory / f".tmp-{step}"
        if self.is_writer:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
        cc.barrier()
        if sharding.writes:
            live = state.state_dict()
            keeps = getattr(sharding, "keeps", None)
            for base in ("model", "optim", "train"):
                fname = f"{base}-{sharding.part_name}.pt"
                torch.save({k: v.detach().cpu() for k, v in live.items()
                            if _file_of(k, sharding.part_name) == fname
                            and (keeps is None or keeps(_param_of(k)))},
                           tmp / fname)
        cc.barrier()
        if self.is_writer:
            meta = dict(meta, layout=sharding.meta(),
                        parts=sharding.parts())
            (tmp / _META).write_text(json.dumps(meta))
            files = [*_parts_files(meta["parts"]), _META]
            manifest = {f: {"bytes": (tmp / f).stat().st_size,
                            "sha256": _sha256(tmp / f)} for f in files}
            (tmp / _MANIFEST).write_text(json.dumps(manifest))
            final = self.directory / str(step)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self.last_save = dict(
                step=step, seconds=time.perf_counter() - t0,
                bytes=sum(m["bytes"] for m in manifest.values()))
            self._prune()
        cc.barrier()

    def _writer(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    self._write(*item)
            except BaseException as e:  # re-raised by wait()/close()/save()
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, snapshot: dict[str, torch.Tensor], ready,
               meta: dict) -> None:
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()  # the side stream's copy to host memory
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {}
        for fname in _FILES:
            part = {k: v for k, v in snapshot.items() if _file_of(k) == fname}
            torch.save(part, tmp / fname)
        (tmp / _META).write_text(json.dumps(meta))
        for fname in (*_FILES, _META):
            path = tmp / fname
            manifest[fname] = {"bytes": path.stat().st_size,
                               "sha256": _sha256(path)}
        (tmp / _MANIFEST).write_text(json.dumps(manifest))
        final = self.directory / str(step)
        if final.exists():  # a forced rewrite of a saved step
            shutil.rmtree(final)
        os.rename(tmp, final)
        self.last_save = dict(
            step=step, seconds=time.perf_counter() - t0,
            bytes=sum(m["bytes"] for m in manifest.values()))
        self._prune()

    def _prune(self) -> None:
        for old in self.all_steps()[:-self.max_to_keep or None]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    # -- restore ---------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and p.is_dir())

    def restore(self, template: TrainState,
                step: int | None = None) -> tuple[TrainState, dict]:
        """Copy a checkpoint into ``template`` (in place) and return
        ``(template, meta)``. With no ``step``: the newest step that reads
        back whole, falling back past torn or corrupt ones."""
        if step is not None:
            return self._restore_step(template, step)
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        last_err: Exception | None = None
        for i, s in enumerate(steps):
            try:
                return self._restore_step(template, s)
            except LayoutError:
                raise
            except (OSError, ValueError, KeyError, RuntimeError,
                    pickle.UnpicklingError) as e:
                last_err = e
                log.warning(
                    "checkpoint step %d is torn/corrupt (%s: %s); falling "
                    "back to %s", s, type(e).__name__, e,
                    steps[i + 1] if i + 1 < len(steps) else "nothing")
        raise RuntimeError(
            f"every kept checkpoint step {steps} under {self.directory} "
            "failed to restore") from last_err

    def _restore_step(self, template: TrainState,
                      step: int) -> tuple[TrainState, dict]:
        path = self.directory / str(step)
        meta = _verified_meta(path)
        sharding = template.sharding
        want = None if sharding is None else sharding.meta()
        if meta.get("layout") != want:
            _check_restorable(path, meta.get("layout"), want)
            t0 = time.perf_counter()
            nbytes = _reshard_into(template, _WholeState(path, meta))
            self.last_restore = dict(step=step, resharded=True, bytes=nbytes,
                                     seconds=time.perf_counter() - t0)
            log.info("restored checkpoint step %d from %s onto another "
                     "layout", step, path)
            return template, meta
        if sharding is None:
            files = list(_FILES)
        else:  # its own piece first; what that lacks from the others
            files = _parts_files(getattr(sharding, "restore_parts",
                                         lambda: [sharding.part_name])())
        tensors: dict[str, torch.Tensor] = {}
        for fname in files:
            for k, v in torch.load(path / fname, map_location="cpu",
                                   weights_only=True).items():
                tensors.setdefault(k, v)
        template.load_state_dict(tensors)
        self.last_restore = dict(
            step=step, resharded=False, seconds=None,
            bytes=sum(t.numel() * t.element_size()
                      for t in tensors.values()))
        log.info("restored checkpoint step %d from %s", step, path)
        return template, meta

    # -- lifecycle -------------------------------------------------------

    def _raise_failure(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a checkpoint write failed") from err

    def wait(self) -> None:
        """Drain the writer (every queued save is on disk), then every
        rank passes a barrier."""
        if self._thread is not None:
            self._queue.join()
        self._raise_failure()
        cc.barrier()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._thread is not None:
                self._queue.put(None)
                self._thread.join(timeout=60.0)
                self._thread = None


def _verified_meta(path: Path) -> dict:
    """The meta of step directory ``path`` once every file matches the
    manifest and the manifest lists every file; raises ValueError."""
    manifest = json.loads((path / _MANIFEST).read_text())
    for fname, want in manifest.items():
        f = path / fname
        if f.stat().st_size != want["bytes"] or _sha256(f) != \
                want["sha256"]:
            raise ValueError(f"{f} does not match its manifest")
    meta = json.loads((path / _META).read_text())
    files = (_parts_files(meta["parts"]) if "layout" in meta
             else list(_FILES))
    if set(manifest) != {*files, _META}:
        raise ValueError(f"{path}: manifest lists {sorted(manifest)}")
    return meta


def checkpoint_meta(directory: str | Path, step: int | None = None, *,
                    verify: bool = True) -> tuple[int, dict]:
    """``(step, meta)`` of a checkpoint's newest step (or ``step``), its
    files verified against the manifest (``verify=False`` reads the meta
    alone, for a caller whose next read of the step verifies it);
    ``meta["layout"]`` names a sharded layout (absent for a replicated
    state). Raises FileNotFoundError where there is no step."""
    directory = Path(directory)
    if step is None:
        steps = sorted(int(p.name) for p in directory.iterdir()
                       if p.name.isdigit() and p.is_dir()) \
            if directory.is_dir() else []
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        step = steps[-1]
    path = directory / str(step)
    if not verify:
        return step, json.loads((path / _META).read_text())
    return step, _verified_meta(path)


def read_full_params(directory: str | Path,
                     step: int | None = None) -> dict[str, torch.Tensor]:
    """The whole parameters of a checkpoint (the newest step, or ``step``)
    as the flax-named ``state_dict`` a replicated run loads, read in one
    process whatever its layout (:class:`_WholeState`): a ZeRO-3 leaf's
    slices joined along their fsdp dim, the expert slices along E, the
    tensor slices along their dim, the pipeline's stages merged (the
    counterpart of the JAX ``restore_unstacked_params``)."""
    step, meta = checkpoint_meta(directory, step)
    whole = _WholeState(Path(directory) / str(step), meta)
    return {k[len("model."):]: whole.get(k).clone() for k in whole.keys
            if k.startswith("model.")}


def _check_restorable(path: Path, have: dict | None,
                      want: dict | None) -> None:
    """Raise :class:`LayoutError` for the layout pairs the JAX Trainer does
    not restore either: it stacks a pipeline's stages along a leading
    dim, so its checkpoint restores onto a pipeline of the same ``pipe``
    and ``pipe_chunks`` only, and no other layout onto a pipeline."""
    def stacking(layout):
        if layout is None or layout["strategy"] != "pipeline":
            return None
        return layout["mesh"]["pipe"], layout["pipe_chunks"]

    if stacking(have) != stacking(want):
        def name(st):
            return ("no pipeline" if st is None else
                    f"a pipeline of pipe {st[0]} x {st[1]} chunks")
        raise LayoutError(
            f"{path} holds {name(stacking(have))}, the state is "
            f"{name(stacking(want))}: the JAX Trainer restores a "
            "pipeline's stacked stages only onto the same stages, and the "
            "port refuses the same pairs (read_full_params reads any "
            "layout whole)")


def _splits(layout: dict | None, key: str) -> list[tuple[int, str]]:
    """The (dim, axis) cuts, in :data:`_AXES` order, that ``layout`` makes
    in the parameter dims of state tensor ``key``: the tensor split, the
    expert split along E, ZeRO's fsdp split (a stage-1 parameter stays
    whole, its moments are sliced)."""
    name = _param_of(key)
    if layout is None or name is None:
        return []
    tensor = layout.get("tensor", {}).get(name)
    split = layout.get("split", {}).get(name)
    cuts = []
    if tensor is not None:
        cuts.append((tensor[0], "tensor"))
    if name in layout.get("experts", {}):
        cuts.append((0, "expert"))
    if split is not None and (key.startswith("opt.")
                              or layout.get("zero_stage") == 3):
        cuts.append((split[0], "fsdp"))
    return cuts


def _moment_cuts(key: str, cuts, whole_param_shape):
    """``cuts`` over a parameter's dims moved onto state tensor ``key``'s:
    an adafactor ``v_row`` lacks the parameter's largest dim, ``v_col``
    its second-largest (a cut there is not made)."""
    from pytorch_distributed_nn_tpu_torch.train.optim import _factored_dims

    moment = key.split(".")[1] if key.startswith("opt.") else None
    if not cuts or moment not in ("v_row", "v_col"):
        return cuts
    d1, d0 = _factored_dims(tuple(whole_param_shape))
    drop = d0 if moment == "v_row" else d1
    return [(d - (d > drop), axis) for d, axis in cuts if d != drop]


def _cut(t: torch.Tensor, cuts, coords: dict, sizes: dict) -> torch.Tensor:
    """The view of the whole ``t`` that the piece at ``coords`` holds."""
    from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
        shard_slice,
    )

    for dim, axis in cuts:
        part = shard_slice(t.shape[dim], coords.get(axis, 0), sizes[axis])
        t = t.narrow(dim, part.start, part.stop - part.start)
    return t


def _sizes(layout: dict | None) -> dict:
    mesh = (layout or {}).get("mesh", {})
    return {axis: mesh.get(axis, 1) for axis in _AXES}


class _WholeState:
    """The whole tensors of a checkpoint step, one at a time: every state
    key (``model.``, ``opt.``, the counters) joined from the pieces of the
    parts that hold it. The files are memory-mapped: a piece is read when
    it is copied, so building one whole leaf reads that leaf alone."""

    def __init__(self, path: Path, meta: dict) -> None:
        self.layout = meta.get("layout")
        self.sizes = _sizes(self.layout)
        if self.layout is None:
            parts = [(None, list(_FILES))]
        else:
            parts = [(part, _parts_files([part])) for part in meta["parts"]]
        # key -> [(coords, piece)], in the parts' order
        self.pieces: dict[str, list] = {}
        for part, files in parts:
            coords = {} if part is None else {
                axis: int(i) for axis, i in
                re.findall(r"(tensor|expert|fsdp|pipe)(\d+)", part)}
            for fname in files:
                for k, v in torch.load(path / fname, map_location="cpu",
                                       weights_only=True,
                                       mmap=True).items():
                    self.pieces.setdefault(k, []).append((coords, v))
        self.keys = list(self.pieces)

    def param_shape(self, name: str) -> tuple[int, ...]:
        """The whole shape of parameter ``name``."""
        key = f"model.{name}"
        shape = list(self.pieces[key][0][1].shape)
        for dim, axis in _splits(self.layout, key):
            shape[dim] *= self.sizes[axis]
        return tuple(shape)

    def get(self, key: str) -> torch.Tensor:
        """The whole tensor of ``key`` (a view of a mapped file where one
        piece holds it whole)."""
        cuts = _splits(self.layout, key)
        if cuts:
            cuts = _moment_cuts(key, cuts,
                                self.param_shape(_param_of(key)))
        axes = {axis for _, axis in cuts}
        # a piece a coordinate of the axes that cut it, at 0 on the others
        use = {}
        for coords, t in self.pieces[key]:
            if all(coords.get(a, 0) == 0 for a in _AXES if a not in axes):
                use.setdefault(tuple(coords.get(a, 0) for a in _AXES), t)
        need = math.prod(self.sizes[a] for a in axes)
        if len(use) != need:
            raise ValueError(f"{key}: {len(use)} pieces of {need}")
        first = next(iter(use.values()))
        if not cuts:
            return first
        shape = list(first.shape)
        for dim, axis in cuts:
            shape[dim] *= self.sizes[axis]
        out = torch.empty(shape, dtype=first.dtype)
        for index, piece in use.items():
            _cut(out, cuts, dict(zip(_AXES, index)), self.sizes).copy_(
                piece)
        return out


@torch.no_grad()
def _reshard_into(template: TrainState, whole: _WholeState) -> int:
    """Copy ``whole`` into ``template`` in place, each tensor cut to the
    template rank's slice, one leaf at a time; returns the bytes copied."""
    sharding = template.sharding
    layout = None if sharding is None else sharding.meta()
    sizes = _sizes(layout)
    coords = {axis: getattr(getattr(sharding, axis, None), "index", 0)
              for axis in _AXES}
    want = template.state_dict()
    missing = sorted(set(want) - set(whole.keys))
    if missing:
        raise KeyError(f"the checkpoint lacks {missing[:5]}")
    nbytes = 0
    for key, t in want.items():
        if key in _COUNTERS:
            continue
        cuts = _splits(layout, key)
        if cuts:
            cuts = _moment_cuts(key, cuts,
                                whole.param_shape(_param_of(key)))
        src = _cut(whole.get(key), cuts, coords, sizes)
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(
                f"{key}: {tuple(src.shape)} {src.dtype} does not fit "
                f"{tuple(t.shape)} {t.dtype}")
        t.copy_(src)
        nbytes += src.numel() * src.element_size()
    template.optimizer.count = int(whole.get("opt.count"))
    template.generator.set_state(whole.get("generator").clone())
    template.step = int(whole.get("step"))
    return nbytes


def _snapshot(state: TrainState) -> tuple[dict[str, torch.Tensor], Any]:
    """Host copies of ``state.state_dict()`` and the event that says they
    are complete (None when they already are: a CPU state)."""
    live = state.state_dict()
    cuda = [t for t in live.values() if t.is_cuda]
    if not cuda:
        return {k: v.clone() for k, v in live.items()}, None
    device = cuda[0].device
    main = torch.cuda.current_stream(device)
    # what the next forward writes in place: cloned on the step's stream
    buffers = {f"model.{k}" for k, _ in state.model.named_buffers()}
    live = {k: (v.clone() if k in buffers and v.is_cuda else v)
            for k, v in live.items()}
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    out = {}
    with torch.cuda.stream(side):
        for k, v in live.items():
            if v.is_cuda:
                host = torch.empty(v.shape, dtype=v.dtype, device="cpu",
                                   pin_memory=True)
                host.copy_(v, non_blocking=True)
                v.record_stream(side)
                out[k] = host
            else:
                out[k] = v.clone()
        done = torch.cuda.Event()
        done.record(side)
    state.optimizer.hold(done)
    return out, done

"""The Trainer: config -> process group -> model -> data -> strategy -> step
loop (the JAX package's ``train/trainer.py``).

Ported: the process group (``runtime/bootstrap.py``: one process a
device, under ``torchrun`` or alone) and the mesh over it
(``runtime/mesh.py``: data, sequence, ZeRO, pipeline, expert and tensor
parallelism, each rank loading the rows of its data coordinate and the
tokens of its seq coordinate, every stage of a pipeline and every tensor
rank the same rows, the model built with the rank's seq ring and cut to
its tensor slices when the state is placed), the synthetic datasets and
those read from the user's files (``data/datasets.py``, ``data/readers.py``), initialisation from the model's own
seeded init or given weights, the per-step loop with its logging cadence
(on rank 0), the held-out evaluation, checkpoints (``train/checkpoint.py``:
restored at construction when ``resume`` is set, saved every
``checkpoint_every`` steps), the preemption notice (``runtime/failure.py``:
SIGTERM -> a synchronous save at the step boundary -> ``SystemExit(83)``)
and the multistep loop (``train/multistep.py``: ``multistep_k`` steps a
dispatch, one CUDA graph on the card). Not ported (ROADMAP.md §1 item 5):
the obs, chaos, xray and flight hooks; their config fields
(``--metrics_path``, ``--prom_path``, ``--profile_dir``) are not declared,
so asking for them fails as an unknown field.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Mapping, Optional

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.data.datasets import (
    EVAL_STEP_OFFSET,
    get_dataset,
)
from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.nn.layers import Dropout
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
from pytorch_distributed_nn_tpu_torch.parallel.pipeline import PipelineStages
from pytorch_distributed_nn_tpu_torch.parallel.tensor import whole_leaves
from pytorch_distributed_nn_tpu_torch.parallel.zero import ZeroShards
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap, failure
from pytorch_distributed_nn_tpu_torch.runtime.mesh import process_mesh
from pytorch_distributed_nn_tpu_torch.train.losses import (
    accuracy,
    chunked_lm_eval,
    get_loss_fn,
    valid_mask,
)
from pytorch_distributed_nn_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_nn_tpu_torch.train.state import (
    TrainState,
    param_count,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    seconds: float  # wall time since the previous record
    data_wait: float = 0.0  # of which the loop waited for batches


@dataclasses.dataclass
class EvalRecord:
    step: int
    loss: float
    accuracy: float


class Trainer:
    """``Trainer(cfg, device="cuda", params=None)``. The process group comes
    from the environment (``runtime.bootstrap``; a world of one without
    it); on ``cuda`` each rank uses ``cuda:LOCAL_RANK``. ``params`` is a
    ``state_dict`` of initial weights (for example the JAX package's init
    carried by ``utils.interop``); without it the weights are the model's
    own seeded ``init_params(seed=cfg.seed)``. Across ranks rank 0's
    weights are broadcast. With ``cfg.checkpoint_dir`` and ``cfg.resume``
    the newest checkpoint there replaces them (and the data position).
    ``with Trainer(cfg) as t:`` (or :meth:`close`) drains the checkpoint
    writer."""

    def __init__(self, cfg: TrainConfig, device="cuda",
                 params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        self.cfg = cfg
        self._preemptible = False
        self.process = bootstrap.initialize(device)
        self.device = self.process.device
        self.mesh = process_mesh(cfg.mesh, self.process.rank,
                                 self.process.world_size)
        spec, seq = self.mesh.spec, self.mesh.seq
        self.dataset = get_dataset(
            cfg.data.dataset, seed=cfg.seed,
            batch_size=cfg.data.batch_size, seq_len=cfg.data.seq_len,
            vocab_size=cfg.data.vocab_size, path=cfg.data.path,
            token_dtype=cfg.data.token_dtype, sample=cfg.data.sample,
            holdout_frac=cfg.data.holdout_frac,
            image_size=cfg.data.image_size,
            num_workers=cfg.data.num_workers)
        self.loader = DataLoader(self.dataset, self.device,
                                 data_index=self.mesh.data_index,
                                 data_degree=spec.data_degree(),
                                 seq_index=seq.index, seq_degree=seq.size,
                                 prefetch=cfg.data.prefetch)
        self.loss_fn = get_loss_fn(cfg.data.dataset,
                                   label_smoothing=cfg.label_smoothing)
        self.model = get_model(cfg.model, device=self.device,
                               input_shape=self.dataset.spec.x_shape,
                               seq=seq if seq.size > 1 else None)
        self.state = self._init_state(params)
        step_fn, place_fn = make_train_step(cfg, self.loss_fn, spec,
                                            process=self.mesh)
        self.step_fn = step_fn
        self.state = place_fn(self.state)
        if self.state.optimizer is None:  # zero and pipeline make theirs
            self.state.optimizer = make_optimizer(
                cfg.optim, self.model.parameters(), total_steps=cfg.steps)
        self.history: list[StepRecord] = []
        self.eval_history: list[EvalRecord] = []
        self.last_metrics = None
        self._eval_batches: dict[int, tuple] = {}  # device-resident cache
        self.data_step = 0  # next dataset step to consume
        self._multisteps: dict[int, object] = {}  # k -> its dispatch
        self._mempool = None  # the multistep graphs' private pool
        self._pool_batches = None  # multistep_pool's device-resident batches
        self.ckpt = None
        if cfg.checkpoint_dir:
            from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
                CheckpointManager,
            )

            self.ckpt = CheckpointManager(cfg.checkpoint_dir)
            if cfg.resume and self.ckpt.latest_step() is not None:
                self.state, meta = self.ckpt.restore(self.state)
                self.data_step = meta["data_step"]
                log.info("resumed from step %d (data_step %d)",
                         meta["step"], self.data_step)
        # SIGTERM -> finish the step -> synchronous save -> exit 83; only
        # under TPUNN_PREEMPT=1. Installed last, so a
        # failed constructor leaves no handler behind
        self._preemptible = failure.install_preemption_handler()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        """Drain the checkpoint writer, remove the SIGTERM handler and stop
        the dataset's decode threads (an image folder's)."""
        if self._preemptible:
            failure.uninstall_preemption_handler()
            self._preemptible = False
        if hasattr(self.dataset, "close"):
            self.dataset.close()
        if self.ckpt is not None:
            self.ckpt.close()

    def save_checkpoint(self) -> bool:
        if self.ckpt is None:
            raise RuntimeError("no checkpoint_dir configured")
        return self.ckpt.save(self.state, data_step=self.data_step,
                              force=True)

    @property
    def is_coordinator(self) -> bool:
        return self.process.is_coordinator

    def _init_state(self, params) -> TrainState:
        cfg = self.cfg
        if params is None:
            self.model.init_params(seed=cfg.seed)
        else:
            self.model.load_state_dict(params)
        self.model.train()
        # only its seed is read (the dropout stream's): a CPU generator, so
        # a checkpoint written on one device resumes on the other
        generator = torch.Generator()
        generator.manual_seed(cfg.seed + 1)  # apart from the init's seed
        if self.is_coordinator:
            log.info("model %s: %.2fM params", cfg.model.name,
                     param_count(self.model) / 1e6)
        # the optimizer comes after the strategy has placed the state:
        # under zero and pipeline it updates only what this rank holds
        return TrainState(model=self.model, optimizer=None,
                          generator=generator)

    def train(self, steps: int | None = None) -> list[StepRecord]:
        if steps is None:
            # the remaining budget: a resumed run ends at cfg.steps in all
            # (the lr schedule was built for cfg.steps)
            steps = max(self.cfg.steps - self.data_step, 0)
        if self.cfg.multistep_k > 1:
            return self._train_multistep(steps)
        self.loader.start_step = self.data_step  # don't replay batches
        it = iter(self.loader)
        try:
            return self._train_loop(it, steps)
        finally:
            it.close()  # joins the prefetch thread

    def _train_loop(self, it, steps: int) -> list[StepRecord]:
        cfg = self.cfg
        t_last = time.perf_counter()
        waited = 0.0
        for i in range(steps):
            t0 = time.perf_counter()
            x, y = next(it)
            waited += time.perf_counter() - t0
            self.data_step += 1
            g = self.data_step  # 1-based global step just run
            self.state, metrics = self.step_fn(self.state, x, y)
            self.last_metrics = metrics
            if (self.ckpt is not None and cfg.checkpoint_every
                    and g % cfg.checkpoint_every == 0):
                self.ckpt.save(self.state, data_step=self.data_step)
            if cfg.eval_every and g % cfg.eval_every == 0:
                self.evaluate()
            if cfg.log_every and ((g - 1) % cfg.log_every == 0
                                  or i == steps - 1):
                # the loop's fence: device work queued behind the
                # asynchronous launches finishes here
                loss = metrics["loss"].item()
                now = time.perf_counter()
                rec = StepRecord(step=g - 1, loss=loss, seconds=now - t_last,
                                 data_wait=waited)
                t_last, waited = now, 0.0
                self.history.append(rec)
                if self.is_coordinator:
                    log.info("step %d loss %.4f (%.3fs)", g - 1, loss,
                             rec.seconds)
            if failure.preempt_requested():
                self._graceful_preempt(g)
        return self.history

    def _graceful_preempt(self, step: int) -> None:
        """A preemption notice arrived and the step in flight is done: save
        a checkpoint synchronously and exit with the graceful code (the
        ``with Trainer(...)`` context and the entry point's ``finally``
        still run)."""
        log.warning("preemption notice at step %d: saving a checkpoint and "
                    "exiting", step)
        if self.ckpt is not None:
            self.ckpt.save(self.state, data_step=self.data_step, force=True)
            self.ckpt.wait()  # synchronous: the process is ending
        raise SystemExit(failure.GRACEFUL_EXIT_CODE)

    # -- multistep ---------------------------------------------------------

    def _capture_blockers(self) -> list[str]:
        """Why this run's step cannot be captured in a CUDA graph."""
        reasons = []
        if any(isinstance(m, Dropout) and m.rate > 0
               for m in self.model.modules()):
            reasons.append(
                "dropout draws its masks from generators the host seeds per "
                "step, which a captured graph would freeze")
        if self.cfg.model.remat_offload:
            reasons.append(
                "remat_offload copies the block inputs into pinned host "
                "buffers allocated each step, which a captured graph would "
                "freeze")
        sharding = self.state.sharding
        if isinstance(sharding, PipelineStages):
            reasons.append(
                "the pipeline's tick loop hands activations between stages "
                "on the host, which capture is not tried on")
        if isinstance(sharding, ZeroShards) and sharding.active:
            reasons.append(
                "ZeRO's hooks gather and free parameters across ranks, "
                "which capture is not tried on")
        quant = self.cfg.parallel.quantized_allreduce
        if self.cfg.parallel.strategy == "dp_explicit" and quant == "int8":
            reasons.append(
                "the int8 wire's stochastic rounding is seeded by the host's "
                "step count, which a captured graph would freeze")
        return reasons

    def _get_multistep(self, k: int):
        """The k-step dispatch, made once a distinct k (the last dispatch
        of a budget that k does not divide runs a shorter one); on the card
        each is one CUDA graph, all drawing on one private memory pool."""
        from pytorch_distributed_nn_tpu_torch.train.multistep import (
            make_multistep,
        )

        if k not in self._multisteps:
            if self.device.type == "cuda" and self._mempool is None:
                self._mempool = torch.cuda.graph_pool_handle()
            self._multisteps[k] = make_multistep(self.step_fn, k,
                                                 mempool=self._mempool)
        return self._multisteps[k]

    def _train_multistep(self, steps: int) -> list[StepRecord]:
        """``multistep_k`` steps a dispatch (``train/multistep.py``): the
        same math as the per-step loop on the same batches. Logging stays
        per step (the stacked losses); checkpoint and eval cadences round
        up to the dispatch boundary. ``multistep_pool`` > 0 cycles a pool
        of that many device-resident batches instead of fresh ones (a
        device-rate benchmark's mode: it repeats data)."""
        cfg = self.cfg
        k, pool = cfg.multistep_k, cfg.multistep_pool
        if self.device.type == "cuda":
            blockers = self._capture_blockers()
            if blockers:
                raise RuntimeError(
                    "multistep_k > 1 captures the step in a CUDA graph, and "
                    "this step cannot be captured: " + "; ".join(blockers))
        windows = [k] * (steps // k) + ([steps % k] if steps % k else [])
        batches = None
        if pool:
            if self._pool_batches is None:
                self._pool_batches = self.loader.stacked_batch_at(
                    self.data_step, min(pool, k))
        else:
            batches = self.loader.iter_stacked(windows,
                                               start_step=self.data_step)
        try:
            return self._multistep_loop(batches, windows)
        finally:
            if batches is not None:
                batches.close()  # joins the prefetch thread

    def _multistep_loop(self, batches, windows: list[int]
                        ) -> list[StepRecord]:
        cfg = self.cfg
        t_last = time.perf_counter()
        g_last = self.data_step
        waited = 0.0
        for n, k_eff in enumerate(windows):
            last_window = n == len(windows) - 1
            t0 = time.perf_counter()
            if batches is None:
                xs, ys = self._pool_batches
                if xs.shape[0] > k_eff:
                    xs, ys = xs[:k_eff], ys[:k_eff]
            else:
                xs, ys = next(batches)
            waited += time.perf_counter() - t0
            self.state, metrics = self._get_multistep(k_eff)(self.state,
                                                             xs, ys)
            self.data_step += k_eff
            g = self.data_step  # 1-based step count after this window
            self.last_metrics = metrics
            if (self.ckpt is not None and cfg.checkpoint_every
                    and g // cfg.checkpoint_every
                    > (g - k_eff) // cfg.checkpoint_every):
                self.ckpt.save(self.state, data_step=self.data_step)
            if (cfg.eval_every and g // cfg.eval_every
                    > (g - k_eff) // cfg.eval_every):
                self.evaluate()
            logged = []
            if cfg.log_every:
                logged = [s for s in range(g - k_eff + 1, g + 1)
                          if (s - 1) % cfg.log_every == 0
                          or (last_window and s == g)]
            if logged:
                # one (k_eff,) fetch covers every logged step of the window;
                # it is the loop's fence
                losses = metrics["all"]["loss"].tolist()
                now = time.perf_counter()
                span = max(g - g_last, 1)  # steps since the last record
                for s in logged:
                    rec = StepRecord(step=s - 1,
                                     loss=losses[s - (g - k_eff) - 1],
                                     seconds=(now - t_last) * (s - g_last)
                                     / span, data_wait=waited)
                    waited = 0.0
                    g_last = s
                    self.history.append(rec)
                    if self.is_coordinator:
                        log.info("step %d loss %.4f (%.3fs)", rec.step,
                                 rec.loss, rec.seconds)
                t_last = now
            if failure.preempt_requested():
                self._graceful_preempt(g)
        return self.history

    @torch.no_grad()
    def _eval_step(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        sharding = self.state.sharding
        if isinstance(sharding, PipelineStages):
            # the fill-drain forward; every stage gets the last one's
            return sharding.evaluate(x, y, self.loss_fn)
        chunk = self.cfg.xent_chunk
        # as training: the chunked loss only where the rank's T exceeds
        # one chunk
        if chunk and x.shape[-1] > chunk:
            hidden = self.model(x, return_hidden=True)
            reads = ["lm_head.kernel"]
            with (sharding.hold(reads) if isinstance(sharding, ZeroShards)
                  else contextlib.nullcontext()):
                kernel = whole_leaves(self.model, reads, {
                    reads[0]: self.model.lm_head.kernel})[reads[0]]
                return chunked_lm_eval(hidden, kernel, y, chunk=chunk)
        logits = self.model(x)
        return self.loss_fn(logits, y), accuracy(logits, y)

    def evaluate(self, num_batches: int | None = None) -> EvalRecord:
        """Forward-only pass over the held-out stream (steps from
        ``EVAL_STEP_OFFSET`` on; under the pipeline the fill-drain forward
        over the stages), BatchNorm on its running statistics;
        returns and records the mean loss and accuracy over every rank's
        rows (and sequence shards: the mean of equal shards' means); for
        the masked LM, over the valid labels of every rank's rows, the
        accuracy masked (labels < 0 count neither as hits nor in the
        denominator).
        ``step`` is 0-based as in ``StepRecord`` (-1 = before any
        training)."""
        n = self.cfg.eval_batches if num_batches is None else num_batches
        if n <= 0:
            raise ValueError(f"evaluate needs >= 1 batches, got {n}")
        losses, accs = [], []
        self.model.eval()
        try:
            for i in range(n):
                if i not in self._eval_batches:
                    self._eval_batches[i] = self.loader.batch_at(
                        EVAL_STEP_OFFSET + i)
                x, y = self._eval_batches[i]
                loss, acc = self._eval_step(x, y)
                if cc.world_size() > 1 and getattr(self.loss_fn,
                                                   "token_weighted", False):
                    # the masked LM: each rank's means weighted by its
                    # count of valid labels (the JAX eval's global means)
                    c = valid_mask(y).sum().float()
                    sums = cc.all_reduce_sum(
                        torch.stack([loss * c, acc * c, c]))
                    loss, acc = sums[:2] / sums[2].clamp(min=1)
                elif cc.world_size() > 1:
                    both = cc.all_reduce_mean(torch.stack([loss, acc]))
                    loss, acc = both[0], both[1]
                losses.append(loss.item())
                accs.append(acc.item())
        finally:
            self.model.train()
        rec = EvalRecord(step=self.data_step - 1,
                         loss=float(np.mean(losses)),
                         accuracy=float(np.mean(accs)))
        self.eval_history.append(rec)
        if self.is_coordinator:
            log.info("eval @ step %d: loss %.4f acc %.4f", rec.step,
                     rec.loss, rec.accuracy)
        return rec

    def losses(self) -> list[float]:
        return [r.loss for r in self.history]

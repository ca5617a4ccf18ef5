"""The Trainer: config -> process group -> model -> data -> strategy -> step
loop (the JAX package's ``train/trainer.py``).

Ported: the process group (``runtime/bootstrap.py``: one process a
device, under ``torchrun`` or alone), initialisation from the model's own
seeded init or given weights, the per-step loop with its logging cadence
(on rank 0), and the held-out evaluation. Not ported (ROADMAP.md, trainer
features still to port): the obs, chaos, xray and flight hooks,
checkpointing, the fused multistep loop and gradient accumulation. Their
config fields are not declared, so asking for them (``--checkpoint_dir``,
``--metrics_path``, ``--multistep_k``) fails as an unknown field.
"""

from __future__ import annotations

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
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.runtime.mesh import data_parallel
from pytorch_distributed_nn_tpu_torch.train.losses import (
    accuracy,
    chunked_lm_eval,
    get_loss_fn,
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
    weights are broadcast."""

    def __init__(self, cfg: TrainConfig, device="cuda",
                 params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        self.cfg = cfg
        self.process = bootstrap.initialize(device)
        self.device = self.process.device
        self.mesh = data_parallel(cfg.mesh, self.process.world_size)
        self.dataset = get_dataset(
            cfg.data.dataset, seed=cfg.seed,
            batch_size=cfg.data.batch_size, seq_len=cfg.data.seq_len,
            vocab_size=cfg.data.vocab_size)
        self.loader = DataLoader(self.dataset, self.device,
                                 rank=self.process.rank,
                                 world_size=self.mesh.data_degree(),
                                 prefetch=cfg.data.prefetch)
        self.loss_fn = get_loss_fn(cfg.data.dataset)
        self.model = get_model(cfg.model, device=self.device,
                               input_shape=self.dataset.spec.x_shape)
        self.state = self._init_state(params)
        step_fn, place_fn = make_train_step(cfg, self.loss_fn)
        self.step_fn = step_fn
        self.state = place_fn(self.state)
        self.history: list[StepRecord] = []
        self.eval_history: list[EvalRecord] = []
        self.last_metrics = None
        self._eval_batches: dict[int, tuple] = {}  # device-resident cache
        self.data_step = 0  # next dataset step to consume

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
        optimizer = make_optimizer(cfg.optim, self.model.parameters(),
                                   total_steps=cfg.steps)
        generator = torch.Generator(self.device)
        generator.manual_seed(cfg.seed + 1)  # apart from the init's seed
        if self.is_coordinator:
            log.info("model %s: %.2fM params", cfg.model.name,
                     param_count(self.model) / 1e6)
        return TrainState(model=self.model, optimizer=optimizer,
                          generator=generator)

    def train(self, steps: int | None = None) -> list[StepRecord]:
        if steps is None:
            steps = max(self.cfg.steps - self.data_step, 0)
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
        return self.history

    @torch.no_grad()
    def _eval_step(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        chunk = self.cfg.xent_chunk
        # as training: the chunked loss only where T exceeds one chunk
        if chunk and self.cfg.data.seq_len > chunk:
            hidden = self.model(x, return_hidden=True)
            return chunked_lm_eval(hidden, self.model.lm_head.kernel, y,
                                   chunk=chunk)
        logits = self.model(x)
        return self.loss_fn(logits, y), accuracy(logits, y)

    def evaluate(self, num_batches: int | None = None) -> EvalRecord:
        """Forward-only pass over the held-out stream (steps from
        ``EVAL_STEP_OFFSET`` on), BatchNorm on its running statistics;
        returns and records the mean loss and accuracy over every rank's
        rows. ``step`` is 0-based as in ``StepRecord`` (-1 = before any
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
                loss, acc = self._eval_step(*self._eval_batches[i])
                if cc.world_size() > 1:
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

"""Pipeline parallelism (the JAX package's ``parallel/pipeline.py``):
BASELINE.json config 4, "Transformer-LM pipeline-parallel
(torch.distributed send/recv p2p)".

The model splits into embed | blocks | head (:func:`partition_for`: the
transformer LM, the MoE LM and the float Llama). Stage s of S owns the layers
``[s L / S, (s + 1) L / S)``; stage 0 also owns the embeddings and the
last stage the final norm and ``lm_head`` (the JAX package replicates
those over ``pipe``; their gradients come from one stage either way, and
the optimizers update each parameter by itself, so the one difference is
that the global-norm clip sums over every stage, ``train.optim``'s
``ShardLayout.norm_group``). Under ``interleaved`` with ``pipe_chunks`` v
the layers split into S v virtual stages, and virtual stage k is chunk
k // S on device k % S. A rank drops the modules it does not own
(:class:`PipelineStages`).

A step runs the schedule's tables (``pipeline_schedule.py``) tick by tick:
each tick every stage runs its backward unit (which frees the activations
it reads) and its forward unit, then
the activations and cotangents the tables say cross an edge at the end of
that tick are exchanged in one hop of point-to-point traffic
(:class:`GroupTransport`, one ``batch_isend_irecv``), or handed over in
memory where one process holds every stage (:class:`LocalTransport`: the
one-card run, where NCCL refuses two ranks on one device). Both
transports give the same result bit for bit.

- ``gpipe``: all M forwards (fill-drain), then the head and the loss over
  the rank's whole batch (the JAX head's one computation), then all
  backwards, last microbatch first.
- ``1f1b``: ``one_f_one_b``'s tables. The last stage computes each
  microbatch's loss in its forward unit and backpropagates it in its
  backward unit; stage s holds at most ``2(S - s) - 1`` microbatches'
  activations.
- ``interleaved``: ``interleaved_1f1b``'s (chunk, microbatch) tables, the
  activations of virtual stage S - 1's chunk wrapping to device 0.

Shared by the three: a forward unit saves its input (a leaf that receives
the cotangent) and its output; the backward unit is
``torch.autograd.backward`` of that output with the received cotangent
(under remat the blocks recompute there), so no stage re-linearizes by
hand. Each microbatch's loss is weighted by its share of the global
count of valid tokens (:func:`microbatch_weights`), so a masked loss is
the global mean under every schedule; gpipe's whole-batch loss divides by
the global count directly. Dropout draws from a generator seeded by (the
run's seed, the microbatch, the virtual stage, the step, the data index),
the same in both units of a microbatch and under every schedule, so gpipe
and 1f1b draw the same masks. Stage gradients are averaged over data x
fsdp; the loss is summed over ``pipe`` (only the last stage's is not 0)
and averaged over data x fsdp. Evaluation (:meth:`PipelineStages.evaluate`)
is a forward-only fill-drain over the virtual stages in order.

The MoE LM (the JAX ``moe_block``/``period`` stacks): its MoE layers must
fall every ``moe_every``-th block, and a stage (or chunk) must hold whole
groups of ``moe_every`` blocks, as the JAX package demands of its two
stacks. Each forward unit collects the load-balance terms of the MoE
layers it runs (``expert.collect_aux_losses``); its objective adds their
sum over M, and its backward differentiates that too, so the step's loss
is the JAX one: the data loss plus the aux terms summed over the stages
and the M microbatches, over M, averaged over data x fsdp (fill and drain
run no unit and add nothing). Evaluation leaves the terms out. Under
``mesh.expert > 1`` a stage's MoE layers keep their E/n experts
(``expert.split_expert_layers``) and run over the stage's expert group;
the pipe group joins the same expert coordinate of every stage, and a
checkpoint's part is ``pipe<d>-expert<e>``.

Under ``mesh.tensor > 1`` (the JAX pipeline leaves ``tensor`` to the SPMD
partitioner inside each stage) the model is cut to the rank's Megatron
slices before the stages are pruned (``tensor.split_tensor_layers``): a
stage's blocks run tensor-parallel over the stage's tensor group, the
activations that cross an edge are the whole (replicated) ones, each
handed to the same tensor coordinate of the next stage, the optimizer's
layout sums the slices' squares over the tensor group, and a checkpoint's
part is ``tensor<t>-pipe<d>`` (``tensor<t>-local`` where one process holds
every stage, as on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pytorch_distributed_nn_tpu_torch.nn.layers import dropout_stream, fold_in
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel.expert import (
    MoEMLP,
    add_aux_losses,
    collect_aux_losses,
    expert_split_leaves,
    split_expert_layers,
)
from pytorch_distributed_nn_tpu_torch.parallel.pipeline_schedule import (
    NO_OP,
    interleaved_1f1b,
    one_f_one_b,
)
from pytorch_distributed_nn_tpu_torch.parallel.tensor import (
    split_tensor_layers,
    tensor_layout,
    tensor_meta,
    vocab_parallel_loss,
)
from pytorch_distributed_nn_tpu_torch.runtime.mesh import ProcessMesh
from pytorch_distributed_nn_tpu_torch.train.losses import accuracy, valid_mask
from pytorch_distributed_nn_tpu_torch.train.optim import (
    ShardLayout,
    make_optimizer,
)
from pytorch_distributed_nn_tpu_torch.train.state import TrainState

SCHEDULES = ("gpipe", "1f1b", "interleaved")


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """One model family as embed | blocks | head: the top-level module
    names of each part, in layer order. The model runs the parts itself
    (``embed(tokens)``, ``run_block(name, x)``, ``head(x)``)."""

    block_names: list[str]
    embed_names: tuple[str, ...]
    head_names: tuple[str, ...]
    period: int = 1  # blocks of a dense + MoE group (the MoE LM's moe_every)


def partition_for(model) -> StagePartition:
    """The partition of the transformer LM and the MoE LM (``block{i}``)
    or the float Llama (``layer{i}``); anything else raises. The MoE LM's
    MoE layers must be every ``moe_every``-th block's FFN, the last of each
    group, as the JAX stacking assumes."""
    from pytorch_distributed_nn_tpu_torch.models.llama import Llama
    from pytorch_distributed_nn_tpu_torch.models.moe_lm import (
        MoETransformerLM,
    )
    from pytorch_distributed_nn_tpu_torch.models.transformer_lm import (
        TransformerLM,
    )

    if isinstance(model, TransformerLM):
        names = [f"block{i}" for i in range(model.num_layers)]
        period = 1
        if isinstance(model, MoETransformerLM):
            e = model.moe_every
            mask = [getattr(model, n).ffn_name is not None for n in names]
            if mask != [i % e == e - 1 for i in range(model.num_layers)]:
                raise ValueError(
                    f"MoE placement {mask} is not the (e-1 dense, 1 MoE) "
                    f"period-{e} pattern the stage partition assumes")
            period = e
        return StagePartition(names, ("tok_embed", "pos_embed"),
                              ("ln_f", "lm_head"), period=period)
    if isinstance(model, Llama):
        if model.quantized:
            raise ValueError("the pipeline trains the float Llama; the "
                             "int8 model serves")
        if model.remat_offload:
            raise ValueError("remat_offload is not taken under the "
                             "pipeline (its stages keep their remat "
                             "boundaries on the device)")
        return StagePartition([f"layer{i}" for i in range(model.num_layers)],
                              ("tok_embed",), ("final_norm", "lm_head"))
    raise ValueError(
        f"pipeline parallelism supports TransformerLM/Llama, got "
        f"{type(model).__name__}")


def stage_blocks(part: StagePartition, n_stages: int, n_chunks: int,
                 k: int) -> list[str]:
    """The blocks of virtual stage ``k`` of ``n_stages * n_chunks``:
    ``[k Kc, (k + 1) Kc)`` with ``Kc = L / (S v)``; raises where L does
    not divide, or where Kc would split a dense + MoE group."""
    L, sv = len(part.block_names), n_stages * n_chunks
    if L % sv:
        raise ValueError(f"{L} blocks not divisible by {n_stages} stages x "
                         f"{n_chunks} chunks")
    per = L // sv
    if per % part.period:
        raise ValueError(
            f"each pipeline stage/chunk holds {per} layers, not divisible "
            f"by moe_every={part.period}, so stages would split a "
            "dense+MoE group; choose stages/chunks aligned to whole groups")
    return part.block_names[k * per:(k + 1) * per]


# --------------------------------------------------------------------------
# the schedules as units a tick
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Unit:
    """One unit of work: ``kind`` "F" (forward), "B" (backward) or "L"
    (gpipe's head and loss over the whole batch, on the last stage), of
    virtual stage ``k`` on microbatch ``m``."""

    kind: str
    k: int
    m: int = -1


def _ticks_1f1b(S: int, M: int) -> list[dict[int, list[Unit]]]:
    sched = one_f_one_b(S, M)
    ticks = []
    for t in range(sched.n_ticks):
        row: dict[int, list[Unit]] = {}
        for d in range(S):
            units = []  # the backward first: it frees what it read
            if sched.bwd[t, d] != NO_OP:
                units.append(Unit("B", d, int(sched.bwd[t, d])))
            if sched.fwd[t, d] != NO_OP:
                units.append(Unit("F", d, int(sched.fwd[t, d])))
            row[d] = units
        ticks.append(row)
    return ticks


def _ticks_interleaved(S: int, v: int, M: int) -> list[dict[int, list[Unit]]]:
    sched = interleaved_1f1b(S, v, M)
    ticks = []
    for t in range(sched.n_ticks):
        row: dict[int, list[Unit]] = {}
        for d in range(S):
            units = []  # the backward first: it frees what it read
            if sched.bwd_chunk[t, d] != NO_OP:
                units.append(Unit("B", int(sched.bwd_chunk[t, d]) * S + d,
                                  int(sched.bwd_mb[t, d])))
            if sched.fwd_chunk[t, d] != NO_OP:
                units.append(Unit("F", int(sched.fwd_chunk[t, d]) * S + d,
                                  int(sched.fwd_mb[t, d])))
            row[d] = units
        ticks.append(row)
    return ticks


def _ticks_gpipe(S: int, M: int) -> list[dict[int, list[Unit]]]:
    """Fill-drain forwards (stage s runs microbatch t - s at tick t), the
    last stage's head and loss, then each stage's backwards one tick after
    its successor's, the last microbatch first."""
    ticks = [{d: [Unit("F", d, t - d)] if 0 <= t - d < M else []
              for d in range(S)} for t in range(M + S - 1)]
    back = [Unit("B", 0, m) for m in reversed(range(M))]
    for i in range(S):
        d = S - 1 - i
        row = {e: [] for e in range(S)}
        row[d] = ([Unit("L", d)] if d == S - 1 else []) + [
            dataclasses.replace(u, k=d) for u in back]
        ticks.append(row)
    return ticks


def _ticks_fill_drain(sv: int, M: int) -> list[list[Unit]]:
    """Forward-only fill-drain over ``sv`` virtual stages (evaluation):
    virtual stage k runs microbatch t - k at tick t."""
    return [[Unit("F", k, t - k) for k in range(sv) if 0 <= t - k < M]
            for t in range(M + sv - 1)]


def messages(units: list[Unit], sv: int) -> list[tuple[str, int, int]]:
    """What the units of one tick send at its end, in the order every rank
    lists them: ``("f", k + 1, m)`` after the forward of (k, m) below the
    last virtual stage, ``("b", k - 1, m)`` after the backward of (k, m)
    above the first. (gpipe's last stage hands its own cotangents over.)"""
    out = []
    for u in units:
        if u.kind == "F" and u.k < sv - 1:
            out.append(("f", u.k + 1, u.m))
        elif u.kind == "B" and u.k > 0:
            out.append(("b", u.k - 1, u.m))
    return out


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------

class LocalTransport:
    """Every stage in this process: each message is handed over as the
    tensor it is."""

    def exchange(self, msgs, produced: dict, n_stages: int, me: list[int],
                 like: Callable) -> dict:
        return {key: produced[key] for key in msgs}


class GroupTransport:
    """One rank a stage: the tick's messages out of and into this rank as
    one ``batch_isend_irecv`` over the ``pipe`` group."""

    def __init__(self, group) -> None:
        self.group = group

    def exchange(self, msgs, produced: dict, n_stages: int, me: list[int],
                 like: Callable) -> dict:
        (d,) = me
        sends, recvs, got = [], [], {}
        for key in msgs:
            kind, k_dst, _ = key
            dst = k_dst % n_stages
            src = (k_dst - 1 if kind == "f" else k_dst + 1) % n_stages
            if src == d:
                sends.append((dst, produced[key]))
            elif dst == d:
                got[key] = like()
                recvs.append((src, got[key]))
        cc.exchange(sends, recvs, self.group)
        return got


# --------------------------------------------------------------------------
# the stages a rank holds, and the step
# --------------------------------------------------------------------------

def microbatch_weights(tgt_mb: list[torch.Tensor], n_data: int,
                       data_group) -> torch.Tensor:
    """Each microbatch's loss weight, its share of the GLOBAL count of
    valid targets (all microbatches, all data ranks) times the number of
    microbatches of the global batch, ``n_data * M``: 1.0 exactly where
    no target is masked (the JAX ``_microbatch_weights``)."""
    M = len(tgt_mb)
    n_valid = torch.stack([valid_mask(t).sum() for t in tgt_mb]).float()
    total = n_valid.sum().reshape(1)
    if n_data > 1:
        cc.all_reduce_sum(total, data_group)
    return n_valid * (n_data * M) / total.clamp(min=1.0)


class PipelineStages:
    """The virtual stages a rank holds (``state.sharding`` under the
    pipeline) and the executor of their schedule. ``mesh.pipe_local``: the
    process holds every stage of its data coordinate."""

    def __init__(self, model: torch.nn.Module, mesh: ProcessMesh, *,
                 schedule: str, microbatches: int, chunks: int) -> None:
        self.model = model
        self.mesh = mesh
        self.part = partition_for(model)
        self.S = mesh.spec.pipe
        self.v = chunks if schedule == "interleaved" else 1
        self.sv = self.S * self.v
        self.M = microbatches
        self.schedule = schedule
        self.devices = (list(range(self.S)) if mesh.pipe_local
                        else [mesh.pipe.index])
        self.blocks = {k: stage_blocks(self.part, self.S, self.v, k)
                       for k in range(self.sv)}
        if schedule == "1f1b":
            self.ticks = _ticks_1f1b(self.S, self.M)
        elif schedule == "interleaved":
            self.ticks = _ticks_interleaved(self.S, self.v, self.M)
        else:
            self.ticks = _ticks_gpipe(self.S, self.M)
        self.transport = (LocalTransport() if mesh.pipe_local
                          else GroupTransport(mesh.pipe.group))
        # the most microbatches whose activations a stage held at once
        # in the last step (per device)
        self.peak_live = {d: 0 for d in self.devices}
        self.moe = any(isinstance(m, MoEMLP) for m in model.modules())
        # the expert-split leaves of the whole model, with their whole
        # shapes (every rank's meta names them all); this rank splits the
        # layers of its stages
        self.expert = mesh.expert
        self.tensor = mesh.tensor
        if self.tensor.size > 1 and getattr(model, "tensor_split",
                                            None) is None:
            split_tensor_layers(model, self.tensor)
        # the whole model's tensor-split leaves (every rank's meta names
        # them all)
        self.tensor_leaves = getattr(model, "tensor_split", None) or {}
        self.expert_leaves = expert_split_leaves(model, self.expert.size)
        self._prune()
        split_expert_layers(model, self.expert, self.expert_leaves)
        self.experts = {k for k, _ in model.named_parameters()
                        if k in self.expert_leaves}

    def holds(self, k: int) -> bool:
        return k % self.S in self.devices

    def _prune(self) -> None:
        """Drop the modules of the stages this rank does not hold."""
        keep = set()
        for k, names in self.blocks.items():
            if self.holds(k):
                keep.update(names)
        if self.holds(0):
            keep.update(self.part.embed_names)
        if self.holds(self.sv - 1):
            keep.update(self.part.head_names)
        for name, _ in list(self.model.named_children()):
            if name not in keep:
                delattr(self.model, name)

    # -- what the optimizer and the checkpoint see -----------------------

    def owned_params(self) -> dict[str, torch.Tensor]:
        return {}  # the pruned module holds exactly this rank's tensors

    def meta(self) -> dict:
        out = {"strategy": "pipeline", "pipeline_schedule": self.schedule,
               "pipe_chunks": self.v, "microbatches": self.M,
               "mesh": self.mesh.spec.sizes(),
               "pipe_local": self.mesh.pipe_local}
        if self.expert_leaves:
            out["experts"] = {k: list(v) for k, v in
                              sorted(self.expert_leaves.items())}
        if self.tensor_leaves:
            out["tensor"] = tensor_meta(self.tensor_leaves)
        return out

    def _part(self, d: int | None, e: int, t: int | None = None) -> str:
        base = "local" if d is None else f"pipe{d}"
        base = f"{base}-expert{e}" if self.expert_leaves else base
        if self.tensor_leaves:
            return f"tensor{self.tensor.index if t is None else t}-{base}"
        return base

    @property
    def _device(self) -> int | None:
        """This rank's stage, None where it holds every stage."""
        return None if self.mesh.pipe_local else self.devices[0]

    @property
    def part_name(self) -> str:
        """This rank's piece of a checkpoint."""
        return self._part(self._device, self.expert.index)

    def parts(self) -> list[str]:
        stages = [None] if self.mesh.pipe_local else range(self.S)
        experts = self.expert.size if self.expert_leaves else 1
        tensors = self.tensor.size if self.tensor_leaves else 1
        return [self._part(d, e, t) for t in range(tensors) for d in stages
                for e in range(experts)]

    @property
    def writes(self) -> bool:
        return self.mesh.data.index == 0

    def keeps(self, param: str) -> bool:
        """Whether this rank's piece holds ``param``'s tensors: its expert
        slices, and on expert 0 everything else of its stages."""
        return self.expert.index == 0 or param in self.experts

    def restore_parts(self) -> list[str]:
        """The pieces a rank reads back: its own, and off expert 0 also
        expert 0's for the tensors its own does not hold."""
        if self.expert_leaves and self.expert.index:
            return [self.part_name, self._part(self._device, 0)]
        return [self.part_name]

    def layout(self, names: list[str], shapes) -> ShardLayout | None:
        """The optimizer's, over the parameters ``names``: the global norm
        sums over the other stages, the expert slices over the expert
        group and the tensor slices over the tensor group (None where one
        process holds the whole model)."""
        local = self.mesh.pipe_local
        if local and not self.experts and not self.tensor_leaves:
            return None
        n = self.expert.size
        whole = self.tensor_leaves
        return ShardLayout(
            dims=[None] * len(names),
            shapes=[tuple(whole[k][1]) if k in whole else
                    (s[0] * n, *s[1:]) if k in self.experts else tuple(s)
                    for k, s in zip(names, shapes)],
            norm_group=None if local else self.mesh.pipe.group,
            norm_size=1 if local else self.S,
            experts=[k in self.experts for k in names],
            expert_group=self.expert.group, expert_size=n,
            **tensor_layout(whole, dict.fromkeys(names), self.tensor))

    # -- the units ---------------------------------------------------------

    def _run_blocks(self, k: int, x: torch.Tensor) -> torch.Tensor:
        for name in self.blocks[k]:
            x = self.model.run_block(name, x)
        return x

    def _forward_unit(self, k: int, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Virtual stage ``k``'s blocks on ``x``, and the sum of the
        load-balance terms of the MoE layers among them over M (None
        without MoE layers)."""
        if not self.moe:
            return self._run_blocks(k, x), None
        with collect_aux_losses(self.model) as aux:
            y = self._run_blocks(k, x)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return y, add_aux_losses(zero, aux) / self.M

    def _like(self, rows: int, T: int) -> Callable:
        model = self.model
        dev = next(model.parameters()).device

        def make():
            return torch.empty((rows, T, model.d_model), dtype=model.dtype,
                               device=dev)

        return make

    def run(self, state: TrainState, tokens: torch.Tensor,
            targets: torch.Tensor, loss_fn: Callable) -> torch.Tensor:
        """One step's forwards and backwards: the gradients of the held
        stages in their ``.grad``; returns this rank's loss summed over
        its stages (0 but on the last)."""
        S, sv, M = self.S, self.sv, self.M
        rows, T = tokens.shape[0], tokens.shape[1]
        if rows % M:
            raise ValueError(f"this rank's {rows} rows of the batch not "
                             f"divisible by {M} microbatches")
        tok_mb, tgt_mb = tokens.chunk(M), targets.chunk(M)
        n_data = self.mesh.data.size
        gpipe = self.schedule == "gpipe"
        if not gpipe:
            weights = microbatch_weights(list(tgt_mb), n_data,
                                         self.mesh.data.group)
        seed = state.generator.initial_seed()
        data_index = self.mesh.data_index
        # the LM's cross-entropy on the vocab slices, under a split head
        split = vocab_parallel_loss(loss_fn, self.model, self.tensor)
        loss_fn = split or loss_fn
        head_kw = {"split_logits": True} if split else {}

        def stream(k, m):
            return dropout_stream(fold_in(fold_in(seed, m), k), state.step,
                                  data_index)

        saved: dict[tuple[int, int], tuple] = {}
        inbox: dict[tuple[str, int, int], torch.Tensor] = {}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
        self.peak_live = {d: 0 for d in self.devices}
        like = self._like(rows // M, T)
        for row in self.ticks:
            produced = {}
            for d in self.devices:
                for u in row.get(d, ()):
                    if u.kind == "F":
                        if u.k == 0:
                            x_in = self.model.embed(tok_mb[u.m])
                        else:
                            x_in = inbox.pop(("f", u.k, u.m))
                            x_in.requires_grad_()
                        with stream(u.k, u.m):
                            y, aux = self._forward_unit(u.k, x_in)
                            if u.k == sv - 1 and not gpipe:
                                logits = self.model.head(y, **head_kw)
                                y = loss_fn(logits, tgt_mb[u.m]) \
                                    * weights[u.m] / M
                                loss_sum = loss_sum + y.detach()
                        if aux is not None:
                            loss_sum = loss_sum + aux.detach()
                        saved[(u.k, u.m)] = (x_in, y, aux)
                        if u.k < sv - 1:
                            produced[("f", u.k + 1, u.m)] = y.detach()
                        live = sum(1 for k, _ in saved if k % S == d)
                        self.peak_live[d] = max(self.peak_live[d], live)
                    elif u.kind == "L":
                        loss_sum = loss_sum + self._whole_batch_loss(
                            saved, inbox, targets, loss_fn, n_data, head_kw)
                    else:
                        x_in, out, aux = saved.pop((u.k, u.m))
                        if u.k == sv - 1 and not gpipe:
                            outs, cots = [out], [torch.ones_like(out)]
                        else:
                            outs, cots = [out], [inbox.pop(("b", u.k, u.m))]
                        if aux is not None:
                            outs.append(aux)
                            cots.append(torch.ones_like(aux))
                        with stream(u.k, u.m):
                            torch.autograd.backward(outs, cots)
                        if u.k > 0:
                            produced[("b", u.k - 1, u.m)] = x_in.grad
            msgs = messages([u for d in range(S) for u in row.get(d, ())],
                            sv)
            inbox.update(self.transport.exchange(msgs, produced, S,
                                                 self.devices, like))
        if saved or inbox:
            raise RuntimeError(f"the schedule left units behind: "
                               f"{sorted(saved)[:4]} {sorted(inbox)[:4]}")
        return loss_sum

    def _whole_batch_loss(self, saved, inbox, targets, loss_fn,
                          n_data: int, head_kw: dict) -> torch.Tensor:
        """gpipe's last stage: the head and the loss over the rank's whole
        batch (a token-weighted loss over the global count), backward to
        each microbatch's output, whose cotangent it hands to its own
        backward units."""
        k = self.sv - 1
        hs = [saved[(k, m)][1].detach().requires_grad_()
              for m in range(self.M)]
        logits = self.model.head(torch.cat(hs), **head_kw)
        if getattr(loss_fn, "token_weighted", False) and n_data > 1:
            count = valid_mask(targets).sum().float().reshape(1)
            cc.all_reduce_sum(count, self.mesh.data.group)
            loss = loss_fn(logits, targets,
                           denom=count[0].clamp(min=1) / n_data)
        else:
            loss = loss_fn(logits, targets)
        loss.backward()
        for m, h in enumerate(hs):
            inbox[("b", k, m)] = h.grad
        return loss.detach()

    @torch.no_grad()
    def evaluate(self, tokens: torch.Tensor, targets: torch.Tensor,
                 loss_fn: Callable) -> tuple[torch.Tensor, torch.Tensor]:
        """Forward-only fill-drain over the virtual stages, the head, loss
        and masked accuracy over the rank's batch on the last stage;
        returns (loss, accuracy) summed over ``pipe`` (every stage gets
        the last one's)."""
        M, sv = self.M, self.sv
        rows, T = tokens.shape[0], tokens.shape[1]
        if rows % M:
            raise ValueError(f"this rank's {rows} rows of the batch not "
                             f"divisible by {M} microbatches")
        tok_mb = tokens.chunk(M)
        inbox, outs = {}, {}
        like = self._like(rows // M, T)
        for units in _ticks_fill_drain(sv, M):
            produced = {}
            for u in units:
                if not self.holds(u.k):
                    continue
                x = (self.model.embed(tok_mb[u.m]) if u.k == 0
                     else inbox.pop(("f", u.k, u.m)))
                y = self._run_blocks(u.k, x)
                if u.k == sv - 1:
                    outs[u.m] = y
                else:
                    produced[("f", u.k + 1, u.m)] = y
            inbox.update(self.transport.exchange(
                messages(units, sv), produced, self.S, self.devices,
                like))
        result = torch.zeros(2, dtype=torch.float32, device=tokens.device)
        if self.holds(sv - 1):
            logits = self.model.head(torch.cat([outs[m] for m in range(M)]))
            result = torch.stack([loss_fn(logits, targets).float(),
                                  accuracy(logits, targets).float()])
        if not self.mesh.pipe_local:
            cc.all_reduce_sum(result, self.mesh.pipe.group)
        return result[0], result[1]


def make_pipeline_train_step(cfg, loss_fn: Callable, mesh_of: Callable):
    """``(step, place_state)`` of the pipeline strategy. ``mesh_of()``
    gives the rank's :class:`ProcessMesh` when the state is placed;
    ``place_state`` drops the modules of other ranks' stages, keeps the
    layout as ``state.sharding`` (:class:`PipelineStages`) and builds the
    optimizer over the held parameters."""
    S = cfg.mesh.pipe
    M = max(cfg.parallel.microbatches, 1)
    schedule = cfg.parallel.pipeline_schedule
    if S < 2:
        raise ValueError("pipeline strategy needs mesh.pipe >= 2")
    if cfg.parallel.pipe_chunks > 1 and schedule != "interleaved":
        raise ValueError(
            f"parallel.pipe_chunks={cfg.parallel.pipe_chunks} only takes "
            f"effect with pipeline_schedule='interleaved' (got "
            f"{schedule!r}): refusing to train un-interleaved")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {schedule!r}; have "
                         f"{SCHEDULES}")
    if schedule == "interleaved":
        interleaved_1f1b(S, max(cfg.parallel.pipe_chunks, 1), M)  # checks
    if cfg.data.batch_size % M:
        raise ValueError(f"batch {cfg.data.batch_size} not divisible by "
                         f"{M} microbatches")

    def place_state(state: TrainState) -> TrainState:
        mesh = mesh_of()
        stages = PipelineStages(
            state.model, mesh, schedule=schedule, microbatches=M,
            chunks=max(cfg.parallel.pipe_chunks, 1))
        if mesh.data.size > 1:
            src = torch.distributed.get_global_rank(mesh.data.group, 0)
            with torch.no_grad():
                for t in (*state.model.parameters(),
                          *state.model.buffers()):
                    cc.broadcast(t.data, src=src, group=mesh.data.group)
        named = [(k, p) for k, p in state.model.named_parameters()
                 if p.requires_grad]
        state.sharding = stages
        state.optimizer = make_optimizer(
            cfg.optim, [p for _, p in named], total_steps=cfg.steps,
            layout=stages.layout([k for k, _ in named],
                                 [p.shape for _, p in named]))
        if not mesh.pipe_local:
            cc.barrier(mesh.pipe.group)  # the group's first collective
        return state

    def step(state: TrainState, x, y):
        stages: PipelineStages = state.sharding
        loss = stages.run(state, x, y, loss_fn)
        mesh = stages.mesh
        if not mesh.pipe_local:
            loss = cc.all_reduce_sum(loss.reshape(1), mesh.pipe.group)[0]
        if mesh.data.size > 1:
            loss = cc.all_reduce_mean(loss.reshape(1), mesh.data.group)[0]
            cc.tree_all_reduce_mean(
                [p.grad for p in state.model.parameters()
                 if p.requires_grad], mesh.data.group)
        state.apply_gradients()
        return state, {"loss": loss}

    return step, place_state

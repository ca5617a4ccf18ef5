"""``parallel.overlap`` in the port (``ops.buckets.OverlapReducer``): the
gradient reduction issued from the backward's post-accumulate-grad hooks
gives the parameters of the reduction after the backward, bit for bit.

Two gloo ranks (``torch.distributed.run``, ``OMP_NUM_THREADS=1``) train a
tiny ``bert_base_buckets`` (2 layers, d 32, 4 heads, vocab 97, T 16, batch
8) for 3 steps from the same seeded weights, with ``overlap`` off and on,
on each wire: 2 KB buckets (a plan of many buckets) exact, bf16 and int8;
no buckets (the per-tensor mean); and the ``dp`` step (per-tensor means,
the masked-LM loss divided by the global count of valid tokens). One
launch runs them all; each test reads its part.

Checks, all exact: every parameter after 3 steps and every loss equal with
and without overlap, and equal on both ranks; the buckets issued in the
order ``ops.buckets.issue_order`` derives from the hooks' order, each
once a step, at least one before the backward's last hook. Against the JAX
package, from its initial weights: the 2-rank losses of ``dp_explicit``
(exact wire) and of ``dp``, and the evaluation after them, equal the JAX
Trainer's on 2 CPU devices to 1e-5 relative (accuracy to 1e-6).

The subprocess has a hard timeout of 180 s, so a hang fails the test.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.ops import buckets
from pytorch_distributed_nn_tpu_torch.utils.interop import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 180
TINY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "mlp_dim": 64,
        "vocab_size": 97, "max_len": 32}
BASE = {"model.extra": json.dumps(TINY), "model.compute_dtype": "float32",
        "data.vocab_size": "97", "data.seq_len": "16",
        "data.batch_size": "8", "steps": "3", "log_every": "1",
        "data.prefetch": "0"}
RUNS = {
    "exact": {"parallel.bucket_mb": "0.002"},
    "bf16": {"parallel.bucket_mb": "0.002",
             "parallel.quantized_allreduce": "bf16"},
    "int8": {"parallel.bucket_mb": "0.002",
             "parallel.quantized_allreduce": "int8"},
    "per_tensor": {"parallel.bucket_mb": "0"},
    "dp": {"parallel.strategy": "dp"},
}

_WORKER = r"""
import json, sys
import numpy as np
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

import torch

out, base, runs = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
init = np.load(sys.argv[4])
params = {k: torch.from_numpy(init[k]) for k in init.files}
res, rank = {}, None
for run, ov in runs.items():
    for overlap in (False, True):
        cfg = get_config("bert_base_buckets", **base, **ov,
                         **{"parallel.overlap": str(overlap)})
        t = Trainer(cfg, device="cpu", params=params)
        rank = t.process.rank
        t.train()
        tag = f"{run}:{int(overlap)}"
        res[f"{tag}:losses"] = np.asarray(t.losses(), np.float32)
        for k, v in t.model.state_dict().items():
            res[f"{tag}:{k}"] = v.detach().numpy()
        if overlap and run in ("exact", "dp"):
            ev = t.evaluate(num_batches=2)
            res[f"{tag}:eval"] = np.asarray([ev.loss, ev.accuracy])
        reducer = getattr(t.step_fn, "reducer", None)
        if overlap and reducer is not None:
            last = reducer(t.state).last
            res[f"{tag}:last"] = np.frombuffer(
                json.dumps(last).encode(), np.uint8)
np.savez(f"{out}{rank}.npz", **res)
bootstrap.shutdown()
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    return env


def _jax_losses(run):
    """The JAX Trainer on 2 CPU devices: (initial params, (3 losses, the
    evaluation after them))."""
    cfg = jconfig.get_config("bert_base_buckets", **BASE, **RUNS[run])
    jt = JTrainer(cfg, mesh=make_mesh(JMeshSpec(data=2),
                                      devices=jax.devices()[:2]))
    init = jax.device_get(jt.state.params)
    jt.train()
    losses = jt.losses()
    ev = jt.evaluate(num_batches=2)
    jt.close()
    return init, (losses, (ev.loss, ev.accuracy))


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    jax_runs = {run: _jax_losses(run) for run in ("exact", "dp")}
    init = jax_runs["dp"][0]  # the seeded JAX init, the same in both
    np.savez(tmp / "init.npz", **{k: v.numpy() for k, v in
                                  params_from_jax(init).items()})
    (tmp / "worker.py").write_text(_WORKER)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", str(tmp / "worker.py"),
           str(tmp / "out"), json.dumps(BASE), json.dumps(RUNS),
           str(tmp / "init.npz")]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]
    return ranks, {run: losses for run, (_, losses) in jax_runs.items()}


def _by(res, tag):
    return {k[len(tag) + 1:]: v for k, v in res.items()
            if k.startswith(tag + ":")
            and not k.endswith((":last", ":eval"))}


@pytest.mark.parametrize("run", list(RUNS))
def test_overlap_is_bitwise_the_reduce_after_the_backward(gloo_runs, run):
    gloo_runs = gloo_runs[0]
    off, on = _by(gloo_runs[0], f"{run}:0"), _by(gloo_runs[0], f"{run}:1")
    assert sorted(off) == sorted(on) and len(off) > 10
    for k, v in off.items():
        np.testing.assert_array_equal(on[k], v, err_msg=k)
        # the replicas agree bit for bit
        np.testing.assert_array_equal(gloo_runs[1][f"{run}:1:{k}"], v,
                                      err_msg=k)
    assert np.all(np.isfinite(off["losses"])) and len(off["losses"]) == 3


@pytest.mark.parametrize("run", ["exact", "int8"])
def test_buckets_go_out_from_the_backward(gloo_runs, run):
    last = json.loads(gloo_runs[0][0][f"{run}:1:last"].tobytes())
    model = get_model(get_config("bert_base_buckets", **BASE).model,
                      device="meta")
    plan = buckets.make_bucket_reduce(bucket_mb=0.002).plan(
        {n: (p.shape, p.dtype) for n, p in model.named_parameters()})
    assert len(plan) >= 3
    assert last["buckets"] == len(plan)  # each bucket once a step
    assert last["hooks"] == len(last["hook_order"]) == sum(
        len(names) for _, names in plan)
    want = buckets.issue_order(plan, last["hook_order"])
    assert [tuple(x) for x in last["issued"]] == want
    assert sorted(b for b, _ in want) == list(range(len(plan)))
    early = [b for b, k in want if k < last["hooks"]]
    assert early  # some bucket went out before the backward's last hook
    assert 0 < last["bytes_before_last_hook"] < last["bytes_total"]


@pytest.mark.parametrize("run", ["exact", "dp"])
def test_two_ranks_match_the_jax_trainer(gloo_runs, run):
    """dp_explicit: each rank's masked-LM mean over its own rows, then the
    mean of the two (the JAX package's per-rank denominators); dp: the
    global token mean, as JAX's one computation over the global batch."""
    ranks, jax_runs = gloo_runs
    want, want_eval = jax_runs[run]
    got = ranks[0][f"{run}:1:losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if run == "dp":  # the per-rank mean of means would differ here
        assert not np.allclose(got, jax_runs["exact"][0], rtol=1e-5)
    # the evaluation: global means over the valid labels, as JAX's over
    # the global batch
    loss, acc = ranks[0][f"{run}:1:eval"]
    np.testing.assert_allclose(loss, want_eval[0], rtol=1e-5)
    assert acc == pytest.approx(want_eval[1], abs=1e-6)


def test_bert_base_plan_issues_early_under_the_jax_bucket_order():
    """BERT-base's 100 MB plan against the hooks' order of a 12-layer
    BERT's backward (the order depends on the names and the graph, not the
    widths): the buckets that hold ``tok_embed``/``pos_embed`` and
    ``ln_embed`` (the first two, by the flax order that also sorts
    ``layer10`` before ``layer2``) go out only as the backward ends."""
    twelve = get_config("bert_base_buckets", **{"model.extra": json.dumps(
        {"d_model": 32, "num_heads": 4, "mlp_dim": 64, "vocab_size": 97,
         "max_len": 32})})
    small = get_model(twelve.model, device="cpu").init_params(0)
    order = []
    for n, p in small.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: order.append(n))
    from pytorch_distributed_nn_tpu_torch.train.losses import masked_lm_xent

    x = torch.randint(0, 96, (2, 8))
    masked_lm_xent(small(x), x).backward()
    full = get_model(get_config("bert_base_buckets").model, device="meta")
    shapes = {n: (p.shape, p.dtype) for n, p in full.named_parameters()}
    plan = buckets.make_bucket_reduce(bucket_mb=100.0).plan(shapes)
    assert plan[0][1][0] == "tok_embed.embedding"
    assert "ln_embed.scale" in plan[1][1]
    issued = buckets.issue_order(plan, order)
    at = dict(issued)
    assert at[0] == len(order) and at[1] >= len(order) - 4
    assert issued[0][1] < 0.6 * len(order)  # the first, mid-way


def test_a_step_on_another_wire_replaces_the_reducer_and_its_hooks(
        tmp_path):
    """Two steps built on one model (as a run that switches to the int8
    wire does): the model keeps one reducer, the second step's, and the
    first's hooks are gone, so a backward reaches only the second's."""
    from types import SimpleNamespace

    import torch.distributed as dist

    from pytorch_distributed_nn_tpu_torch.parallel import dp

    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    state = SimpleNamespace(model=model)
    exact = dp.make_dp_train_step_explicit(
        lambda out, y: out.sum(), overlap=True,
        bucket_reduce=buckets.make_bucket_reduce(bucket_mb=1.0))
    int8 = dp.make_dp_train_step_explicit(
        lambda out, y: out.sum(), overlap=True,
        bucket_reduce=buckets.make_bucket_reduce(bucket_mb=1.0,
                                                 quantized="int8"))
    first = exact.reducer(state)
    assert exact.reducer(state) is first  # made once, kept on the model
    second = int8.reducer(state)
    assert second is not first and model.overlap_reducer is second
    first.arm()
    second.arm()
    if dist.is_initialized():
        # the one-process group an in-process Trainer of another test in
        # this worker may have left behind
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        model(torch.ones(2, 4)).sum().backward()
        second.finish()
    finally:
        dist.destroy_process_group()
    assert first.hook_order == []
    assert sorted(second.hook_order) == sorted(
        n for n, _ in model.named_parameters())
    assert second.last["buckets"] == len(second.buckets)

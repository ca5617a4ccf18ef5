"""Port parity for the compressed gradient all-reduce: the stochastic int8
``quantize`` and the DDP-style bucket reduce (``ops/buckets.py``), against
the JAX package's.

The TPU kernel's random bits come from the core's hardware generator, and
the JAX package's CPU path from ``jax.random``; the port draws ``u`` from a
counter-based hash. So the rounding is compared exactly where it is
deterministic (``x / scale`` an integer: ``floor(k + u) = k``), and
statistically elsewhere (unbiased over 50 seeds, as the JAX package's own
test holds its fallback). The bucket reduce runs on two gloo ranks in two
processes: the exact wire equals the f32 mean bit for bit (a sum of two
values is order-free), the bf16 wire is within two bf16 steps of it, and
the int8 wire equals the dequantized exact int32 sum of the two ranks'
codes bit for bit, within 2 x scale of the mean.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.ops import buckets as jbuckets
from pytorch_distributed_nn_tpu.ops.pallas import quantize as jq
from pytorch_distributed_nn_tpu_torch.ops import buckets as tbuckets
from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_quantize_exact_where_rounding_is_deterministic(seed):
    scale = 2.0 ** -5  # x / scale is exact in f32
    k = np.arange(-300, 300, dtype=np.float32)  # past +-127: saturates
    x = (k * scale).reshape(3, -1)
    got = tq.quantize_int8(torch.from_numpy(x), scale, seed=seed)
    want = np.asarray(jq.quantize_int8(jnp.asarray(x), scale, seed=seed))
    assert got.dtype == torch.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().ravel(),
                                  np.clip(k, -127, 127).astype(np.int8))


def test_quantize_is_unbiased_over_seeds():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 1024).astype(np.float32)
    scale = np.abs(x).max() / 127.0
    acc = np.zeros_like(x)
    n = 50
    for seed in range(n):
        q = tq.quantize_int8(torch.from_numpy(x), float(scale), seed=seed)
        deq = tq.dequantize_int8(q, float(scale)).numpy()
        assert np.all(np.abs(deq - x) < scale)  # one code step at most
        acc += deq
    np.testing.assert_allclose(acc / n, x, atol=3 * scale)
    # the mean rounding error over all draws is within 4 sigma of 0 (u is
    # uniform, so each error has variance <= scale^2 / 4)
    err = acc / n - x
    assert abs(err.mean()) <= 4 * (scale / 2) / np.sqrt(n * x.size)


def test_quantize_stream_is_the_hash_of_seed_and_index():
    u = tq.uniform(1 << 12, seed=5)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # keyed by the flat index: a prefix of a longer stream is the stream
    torch.testing.assert_close(tq.uniform(100, seed=5), u[:100], rtol=0,
                               atol=0)
    assert not torch.equal(tq.uniform(100, seed=6), u[:100])
    # the int64 torch arithmetic equals the Python-int finaliser
    h = tq._fmix32(torch.tensor([0, 1, 0xDEADBEEF, 0xFFFFFFFF]))
    assert h.tolist() == [tq._fmix32_int(v) for v in
                          (0, 1, 0xDEADBEEF, 0xFFFFFFFF)]
    assert abs(float(u.mean()) - 0.5) < 4 * (12 ** -0.5) / 64


def _jax_tiny_resnet_params():
    from pytorch_distributed_nn_tpu.models.resnet import ResNet

    model = ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                           train=False)
    return variables["params"]


def _jax_buckets(params, bucket_mb, monkeypatch):
    """The JAX package's bucket lists by dotted name: every leaf is filled
    with its own index, and the patched all-reduce records each bucket."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
    names = [".".join(k.key for k in path) for path, _ in paths]
    leaves = [jnp.full(leaf.shape, i, jnp.float32)
              for i, (_, leaf) in enumerate(paths)]
    seen = []

    class FakeCollectives:
        @staticmethod
        def all_reduce_mean(x, axis):
            seen.append(np.asarray(x))
            return x

    monkeypatch.setattr(jbuckets, "cc", FakeCollectives)
    reduce_fn = jbuckets.make_bucket_reduce(bucket_mb=bucket_mb)
    reduce_fn(jax.tree.unflatten(treedef, leaves))
    out = []
    for flat in seen:
        idx = flat.astype(np.int64)
        first = np.concatenate([[True], idx[1:] != idx[:-1]])
        out.append([names[i] for i in idx[first]])
    return out


@pytest.mark.parametrize("bucket_mb", [25.0, 0.02, 0.001])
def test_bucket_lists_equal_the_jax_package_by_name(bucket_mb, monkeypatch):
    from pytorch_distributed_nn_tpu_torch.models.resnet import ResNet

    want = _jax_buckets(_jax_tiny_resnet_params(), bucket_mb, monkeypatch)
    model = ResNet((1, 1, 1, 1), width=8, num_classes=10, device="cpu")
    shapes = {n: (p.shape, p.dtype) for n, p in model.named_parameters()}
    plan = tbuckets.bucket_plan(shapes, int(bucket_mb * 1024 * 1024))
    assert [names for _, names in plan] == want
    assert (len(want) == 1) == (bucket_mb == 25.0)


def test_partition_buckets_matches_jax():
    sizes = [10, 30, 5, 70, 1, 1, 100, 3]
    for budget in (1, 31, 40, 100, 1000):
        assert (tbuckets.partition_buckets(sizes, budget)
                == jbuckets.partition_buckets(sizes, budget))
    with pytest.raises(ValueError):
        tbuckets.partition_buckets(sizes, 0)
    with pytest.raises(ValueError, match="unknown quantized mode"):
        tbuckets.make_bucket_reduce(quantized="fp4")


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from pytorch_distributed_nn_tpu_torch.ops import buckets, collectives as cc

rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
inputs = np.load(data)
grads = {k[2:]: torch.from_numpy(inputs[k]) for k in inputs.files
         if k.startswith(f"{rank}:")}
res = {}
for wire in ("", "bf16", "int8"):
    fn = buckets.make_bucket_reduce(bucket_mb=0.001, quantized=wire)
    with cc.recording() as recs:
        red = fn({k: v.clone() for k, v in grads.items()}, seed=11)
    res[f"wire_bytes:{wire}"] = np.float64(cc.wire_bytes(recs))
    for k, v in red.items():
        res[f"{wire}:{k}"] = v.numpy()
big = torch.tensor([2 ** 29 + rank, -(2 ** 30) + rank], dtype=torch.int32)
res["int32_sum"] = cc.all_reduce_sum(big).numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


def test_bucket_reduce_on_two_gloo_ranks(tmp_path):
    rng = np.random.RandomState(3)
    shapes = {"head.kernel": (20, 10), "head.bias": (10,),
              "conv.kernel": (8, 3, 3, 3), "bn.scale": (8,)}
    grads = [{k: rng.randn(*s).astype(np.float32) * (1 + r)
              for k, s in shapes.items()} for r in range(2)]
    np.savez(tmp_path / "in.npz", **{f"{r}:{k}": v for r in range(2)
                                     for k, v in grads[r].items()})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=180)
        assert p.returncode == 0, out.decode()[-3000:]
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    # int32 sums are exact where f32 would round (2^30 + 1)
    np.testing.assert_array_equal(outs[0]["int32_sum"],
                                  [2 ** 30 + 1, -(2 ** 31) + 1])
    plan = tbuckets.bucket_plan(
        {k: (torch.Size(s), torch.float32) for k, s in shapes.items()},
        int(0.001 * 1024 * 1024))
    assert len(plan) > 1  # several buckets: the counter seeds each
    for name in shapes:
        mean = (grads[0][name] + grads[1][name]) / np.float32(2)
        for r in range(2):  # every rank holds the same result
            np.testing.assert_array_equal(outs[r][f":{name}"], mean)
            np.testing.assert_allclose(outs[r][f"bf16:{name}"], mean,
                                       rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(mean).max())
    # int8: rebuild each rank's codes from the JAX package's seed formula
    for counter, (_, names) in enumerate(plan, start=1):
        flats = [np.concatenate([grads[r][n].ravel() for n in names])
                 for r in range(2)]
        scale = torch.clamp(torch.tensor(max(np.abs(f).max() for f in flats))
                            / 127.0, min=1e-12)
        total = sum(tq.quantize_int8(torch.from_numpy(f), scale,
                                     seed=11 * 65537 + counter * 257 + r)
                    .to(torch.int32) for r, f in enumerate(flats))
        want = (tq.dequantize_int8(total, scale) / 2).numpy()
        exact = (flats[0] + flats[1]) / 2
        got = np.concatenate([outs[0][f"int8:{n}"].ravel() for n in names])
        np.testing.assert_array_equal(got, want)
        assert np.all(np.abs(got - exact) <= 2 * float(scale))
        for n in names:
            np.testing.assert_array_equal(outs[1][f"int8:{n}"],
                                          outs[0][f"int8:{n}"])
    # wire bytes per rank (ring accounting, n = 2: one payload each): f32
    # exact, bf16 half; the int8 codes are summed as int32 (as in the JAX
    # package), so that wire is the f32 one plus one f32 absmax a bucket
    n_el = sum(int(np.prod(s)) for s in shapes.values())
    wb = {w: float(outs[0][f"wire_bytes:{w}"]) for w in ("", "bf16", "int8")}
    assert wb[""] == 4 * n_el and wb["bf16"] == 2 * n_el
    assert wb["int8"] == 4 * n_el + 4 * len(plan)  # int32 sum on the wire


@pytest.mark.parametrize("wire,bucket_mb,want_wire,want_mb", [
    ("int8", "25", "int8", 25.0),
    ("true", "25", "bf16", 25.0),  # the legacy boolean flag: the bf16 wire
    ("int8", "0", "int8", 1e9),  # no buckets, but the wire needs one
    ("", "0", None, None),  # no buckets, exact: the per-tensor mean
])
def test_dp_explicit_step_builds_the_jax_bucket_reduce(monkeypatch, wire,
                                                       bucket_mb, want_wire,
                                                       want_mb):
    from pytorch_distributed_nn_tpu_torch import config as tconfig
    from pytorch_distributed_nn_tpu_torch.parallel import api
    from pytorch_distributed_nn_tpu_torch.train import losses as tlosses

    seen = []
    orig = tbuckets.make_bucket_reduce
    monkeypatch.setattr(tbuckets, "make_bucket_reduce",
                        lambda **kw: seen.append(kw) or orig(**kw))
    cfg = tconfig.get_config("mlp_mnist", **{
        "parallel.strategy": "dp_explicit",
        "parallel.quantized_allreduce": wire,
        "parallel.bucket_mb": bucket_mb})
    step, place = api.make_train_step(cfg, tlosses.softmax_xent)
    assert callable(step) and callable(place)
    if want_mb is None:
        assert seen == []
    else:
        assert seen == [{"bucket_mb": want_mb, "quantized": want_wire}]

"""Port parity of sequence parallelism across processes: 4 gloo ranks on
the CPU, each a ``torchrun`` worker (``torch.distributed.run
--standalone``, a free port, so gangs of other test workers never meet).

- The attention gang: ``ring_attention`` (``xla``, and ``pallas`` through
  the block update's and the flash backward's plain versions) with GQA
  Hkv = 2 and Hkv = H, and ``ulysses_attention``, causal, forward and
  q/k/v gradients, on a ``seq = 4`` ring. Held against the JAX package's
  ``ring_attention`` under ``shard_map`` on a ``seq = 4`` CPU mesh (as
  ``tests/test_sequence_parallel.py`` runs it) and against full attention.
  f32; 1e-5 of the largest element (the schemes sum their products in
  another order).
- The model-level golden run: tiny ``llama3_longcontext`` (2 layers, d 64,
  4/2 heads, T 256, ``xent_chunk`` 64, batch 2) trained 3 steps on
  ``seq = 2`` x ``data = 2`` with ring (and with Ulysses) attention,
  against the JAX ``Trainer`` on one device from the same weights (the JAX
  init carried by ``utils.interop``) and batches: f32 losses to 1e-5
  relative, parameters after three AdamW steps to 1e-4, and the held-out
  evaluation after them to 1e-5, as ``tests/test_torch_train.py`` holds
  the one-process run.

Every subprocess has a hard timeout, so a hang fails the test. Its
environment is the test worker's without any rendezvous, elastic or
collective-library variable (``_env``), and each gang's output carries the
nonce its fixture passed and the world it ran in, so a file of another or
an earlier gang, or a gang that did not form as 4 distinct ranks, fails
loudly instead of being compared.
"""

import json
import os
import subprocess
import sys
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.nn.attention import dot_product_attention
from pytorch_distributed_nn_tpu.parallel.sequence import (
    ring_attention as jring,
)
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
    llama_params_to_jax,
)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240
TOL = 1e-5
B, T, H, D, SEQ = 2, 64, 8, 16, 4
CASES = {"ring_xla-hkv2": ("xla", 2), "ring_xla-hkv8": ("xla", 8),
         "ring_pallas-hkv2": ("pallas", 2), "ring_pallas-hkv8": ("pallas", 8),
         "ulysses-hkv4": ("ulysses", 4), "ulysses-hkv8": ("ulysses", 8)}


def _inputs(hkv):
    rng = np.random.RandomState(hkv)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, T, hkv, D).astype(np.float32)
    v = rng.randn(B, T, hkv, D).astype(np.float32)
    g = rng.randn(B, T, H, D).astype(np.float32)
    return q, k, v, g


# what the gang's rendezvous and collectives read from the environment:
# none of it may leak in from the test worker (an earlier test in the same
# worker, or the worker's own launcher)
_RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "GROUP_RANK", "ROLE_RANK", "ROLE_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID",
              "COORDINATOR_ADDRESS")
_RENDEZVOUS_PREFIXES = ("TORCHELASTIC_", "PET_", "TORCH_DISTRIBUTED",
                        "TORCH_NCCL", "NCCL_", "GLOO_", "OMP_", "MKL_")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in _RANK_VARS and not k.startswith(_RENDEZVOUS_PREFIXES)}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return env


def _torchrun(script, *args, nproc=4):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(script), *map(str, args)]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=TIMEOUT)
    if out.returncode:
        # whole, into the test's captured output, which pytest shows
        # untruncated: a rank's own last words (an abort's reason) come
        # long before the launcher's summary
        print(out.stdout)
        print(out.stderr)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])


def _close(got, want, what=""):
    """``got`` within the tolerance of ``want``; a failure names ``what``
    and, for each rank's shard along the sequence (axis 1), the largest
    error against the limit."""
    got, want = np.asarray(got), np.asarray(want)
    limit = TOL * np.abs(want).max()
    shards = zip(np.array_split(got, SEQ, axis=1),
                 np.array_split(want, SEQ, axis=1))
    errs = ", ".join(
        f"seq shard {i}: max|err| {float(np.abs(g - w).max()):.3e}"
        for i, (g, w) in enumerate(shards)) if got.ndim > 1 else ""
    np.testing.assert_allclose(
        got, want, rtol=TOL, atol=limit,
        err_msg=f"{what}: limit {limit:.3e} + {TOL} relative; {errs}")


# --------------------------------------------------------------------------
# the attention gang
# --------------------------------------------------------------------------

_ATTN_WORKER = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.parallel.sequence import (
    ring_attention, ulysses_attention)
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.runtime.mesh import MeshSpec, process_mesh

out_dir, cases, nonce = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
proc = bootstrap.initialize("cpu")
mesh = process_mesh(MeshSpec(seq=4, data=1), proc.rank, proc.world_size)
seq = mesh.seq
ranks = [None] * proc.world_size
torch.distributed.all_gather_object(ranks, (proc.rank, nonce))
res = {"seq_index": seq.index, "nonce": nonce, "world": proc.world_size,
       "gang": json.dumps(ranks)}
for name, (impl, hkv) in cases.items():
    data = np.load(f"{out_dir}/inputs_hkv{hkv}.npz")
    Tl = data["q"].shape[1] // seq.size
    part = slice(seq.index * Tl, (seq.index + 1) * Tl)
    leaves = [torch.from_numpy(data[n][:, part].copy()).requires_grad_()
              for n in ("q", "k", "v")]
    with cc.recording() as recs:
        if impl == "ulysses":
            out = ulysses_attention(*leaves, seq=seq, causal=True)
        else:
            out = ring_attention(*leaves, seq=seq, causal=True, impl=impl)
        out.backward(torch.from_numpy(data["g"][:, part].copy()))
    res[f"{name}/out"] = out.detach().numpy()
    for n, t in zip(("dq", "dk", "dv"), leaves):
        res[f"{name}/{n}"] = t.grad.numpy()
    res[f"{name}/ops"] = np.array([r.op for r in recs])
np.savez(f"{out_dir}/rank{proc.rank}.npz", **res)
bootstrap.shutdown()
"""


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One 4-rank run of every case; each rank's shard by its seq index."""
    d = tmp_path_factory.mktemp("seq_gang")
    for hkv in sorted({h for _, h in CASES.values()}):
        q, k, v, g = _inputs(hkv)
        np.savez(d / f"inputs_hkv{hkv}.npz", q=q, k=k, v=v, g=g)
    script = d / "worker.py"
    script.write_text(_ATTN_WORKER)
    nonce = uuid.uuid4().hex
    _torchrun(script, d, json.dumps(CASES), nonce)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(SEQ)]
    # every file is this gang's, and the gang was 4 distinct ranks that
    # all saw the same nonce
    want = [[r, nonce] for r in range(SEQ)]
    for r in ranks:
        assert str(r["nonce"]) == nonce and int(r["world"]) == SEQ
        assert json.loads(str(r["gang"])) == want
    order = sorted(range(SEQ), key=lambda r: int(ranks[r]["seq_index"]))
    assert [int(ranks[r]["seq_index"]) for r in order] == list(range(SEQ))

    def whole(key):
        return np.concatenate([ranks[r][key] for r in order], axis=1)

    return whole, ranks


def _jax_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out), *(np.asarray(x) for x in vjp(jnp.asarray(g))))


@pytest.fixture(scope="module")
def jax_ring():
    mesh = make_mesh(JMeshSpec(seq=SEQ, data=1), devices=jax.devices()[:SEQ])
    mapped = jax.jit(jax.shard_map(
        lambda a, b, c: jring(a, b, c, causal=True), mesh=mesh,
        in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
        check_vma=False))
    return {hkv: _jax_grads(mapped, *_inputs(hkv)) for hkv in (2, 4, 8)}


@pytest.mark.parametrize("against", ["jax_ring", "full_attention"])
@pytest.mark.parametrize("case", list(CASES))
def test_four_rank_sequence_attention(gang, jax_ring, case, against):
    whole, _ = gang
    hkv = CASES[case][1]
    if against == "jax_ring":
        want = jax_ring[hkv]
    else:
        want = _jax_grads(lambda a, b, c: dot_product_attention(
            a, b, c, causal=True), *_inputs(hkv))
    for name, ref in zip(("out", "dq", "dk", "dv"), want):
        _close(whole(f"{case}/{name}"), ref, f"{case} {name} vs {against}")


def _replay_ring(q, k, v, g):
    """A seq = SEQ ring replayed in one process through the ring's own
    per-pair steps, as ``chip_smoke.py`` replays it on one card: the output
    and the q/k/v gradients."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops.flash_attention import (
        flash_delta,
    )
    from pytorch_distributed_nn_tpu_torch.parallel import sequence as sp

    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    Tl = T // SEQ
    shard = [slice(r * Tl, (r + 1) * Tl) for r in range(SEQ)]
    out, dq = torch.zeros_like(q), torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(SEQ):
        qr, gr = q[:, shard[r]], g[:, shard[r]]
        carries = sp.ring_carries(qr)
        for src in sp.ring_order(r, SEQ):
            sp.ring_forward_pair(qr, k[:, shard[src]], v[:, shard[src]],
                                 carries, r, src, True)
        out[:, shard[r]], lse = sp.ring_finish(carries, q.dtype)
        delta = flash_delta(out[:, shard[r]], gr)
        for src in sp.ring_order(r, SEQ):
            part = sp.ring_backward_pair(qr, k[:, shard[src]],
                                         v[:, shard[src]], gr, lse, delta, r,
                                         src, True)
            if part is not None:
                dq[:, shard[r]] += part[0]
                dk[:, shard[src]] += part[1]
                dv[:, shard[src]] += part[2]
    return out, dq, dk, dv


@pytest.mark.parametrize("hkv", [2, 8])
def test_ring_pairs_replayed_in_one_process_match_the_jax_ring(jax_ring,
                                                               hkv):
    """The per-pair steps that the ring runs (ring_order,
    ring_forward_pair, ring_finish, ring_backward_pair), replayed pair by
    pair in one process, give the JAX ``seq = 4`` ring's output and
    gradients: the replay by which the card checks the ring's geometry."""
    for got, want in zip(_replay_ring(*_inputs(hkv)), jax_ring[hkv]):
        _close(got.numpy(), want)


def test_four_rank_exchanges(gang):
    """The ring passes K/V on s - 1 times forward (the last shard is never
    sent), and the pallas backward shifts K/V and dk/dv s - 1 times and
    dk/dv home once more; the xla backward reverses each forward shift.
    Ulysses: three all-to-alls in, one out, and as many back."""
    _, ranks = gang
    ops = {case: list(ranks[0][f"{case}/ops"]) for case in CASES}
    every = {case: [list(r[f"{case}/ops"]) for r in ranks] for case in CASES}
    for case, want in (("ring_pallas-hkv2", ["shift"] * (2 * (SEQ - 1) + 1)),
                       ("ring_xla-hkv2", ["shift"] * (2 * (SEQ - 1))),
                       ("ulysses-hkv4", ["all_to_all"] * 8)):
        assert ops[case] == want, (
            f"{case}: rank 0 recorded {ops[case]}, expected {want}; every "
            f"rank recorded {every[case]}")


def test_ulysses_refuses_heads_the_ring_does_not_divide():
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel.sequence import (
        ulysses_attention,
    )
    from pytorch_distributed_nn_tpu_torch.runtime.mesh import SeqGroup

    x = torch.zeros((1, 8, 4, 8))
    with pytest.raises(ValueError, match="divisible by the seq degree"):
        ulysses_attention(x, x[:, :, :2], x[:, :, :2],
                          seq=SeqGroup(None, 0, 4))


# --------------------------------------------------------------------------
# the model-level golden run: seq = 2 x data = 2 against the JAX Trainer
# --------------------------------------------------------------------------

EXTRA = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "mlp_dim": 128, "vocab_size": 512}
OVERRIDES = {"model.compute_dtype": "float32", "data.vocab_size": "512",
             "data.seq_len": "256", "data.batch_size": "2",
             "xent_chunk": "64", "steps": "3", "log_every": "1"}

_TRAIN_WORKER = r"""
import json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out_dir, overrides = sys.argv[1], json.loads(sys.argv[2])
init = np.load(f"{out_dir}/init.npz")
params = {k: torch.from_numpy(init[k]) for k in init.files}
trainer = Trainer(get_config("llama3_longcontext", **overrides),
                  device="cpu", params=params)
trainer.train()
ev = trainer.evaluate(num_batches=2)
if trainer.is_coordinator:
    final = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    np.savez(f"{out_dir}/final.npz", **final)
    with open(f"{out_dir}/losses.json", "w") as f:
        json.dump({"losses": trainer.losses(), "eval": [ev.loss, ev.accuracy],
                   "mesh": trainer.mesh.spec.sizes()}, f)
bootstrap.shutdown()
"""


@pytest.fixture(scope="module")
def jax_run():
    ov = {**OVERRIDES, "model.extra": json.dumps(
        {**EXTRA, "attn_impl": "flash"})}
    trainer = JTrainer(jconfig.get_config("llama3_longcontext", **ov),
                       mesh=make_mesh(JMeshSpec(data=1),
                                      devices=jax.devices()[:1]))
    init = jax.device_get(trainer.state.params)  # before donation
    trainer.train()
    ev = trainer.evaluate(num_batches=2)
    final = jax.device_get(trainer.state.params)
    trainer.close()
    return init, trainer.losses(), final, ev


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq2_data2_training_matches_the_jax_trainer(jax_run, impl,
                                                     tmp_path):
    init, j_losses, j_final, j_eval = jax_run
    params = llama_params_from_jax(init)
    np.savez(tmp_path / "init.npz",
             **{k: v.numpy() for k, v in params.items()})
    ov = {**OVERRIDES, "mesh.seq": "2", "mesh.data": "2",
          "model.extra": json.dumps({**EXTRA, "attn_impl": impl})}
    script = tmp_path / "worker.py"
    script.write_text(_TRAIN_WORKER)
    _torchrun(script, tmp_path, json.dumps(ov))
    got = json.loads((tmp_path / "losses.json").read_text())
    assert got["mesh"]["seq"] == 2 and got["mesh"]["data"] == 2
    assert len(got["losses"]) == len(j_losses) == 3
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
    # the held-out pass after training: the mean of equal shards' means
    np.testing.assert_allclose(got["eval"][0], j_eval.loss, rtol=1e-5)
    assert got["eval"][1] == pytest.approx(j_eval.accuracy, abs=1e-6)
    import torch

    final = np.load(tmp_path / "final.npz")
    tree = llama_params_to_jax({k: torch.from_numpy(final[k])
                                for k in final.files})
    assert jax.tree.structure(tree) == jax.tree.structure(j_final)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(j_final)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

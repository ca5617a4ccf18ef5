"""Port parity of the sequence-parallel slice's pieces that run in one
process: the ring block update (``ops/ring_attention.py``) against the JAX
package's oracle and its Pallas kernel in interpret mode, the mesh's rank
coordinates and groups against the JAX mesh's device order, the loader's
sequence shards, the size-1 collectives, the preset and the step's
validations.

The block update: the same numpy inputs (B 2, H 2, Hkv 1, so B*H = 4;
Tl 64, D 32; non-trivial incoming carries) go to ``_ring_block_reference``
and to ``_ring_block_pallas(interpret=True)`` in the JAX layout ((B*H, Tl,
D), K/V expanded to B*H rows, m and l broadcast over 8 lanes) and to the
port's ``ring_block_update`` on CPU tensors, which runs its plain version.
All in f32; they agree to 1e-5 of the largest element (the JAX kernel sums
its K blocks in a loop, the oracles in one product).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.ops.pallas.ring_attention import (
    STAT_LANES,
    _ring_block_pallas,
    _ring_block_reference,
)
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.data import datasets as tdata
from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra
from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
    MeshSpec,
    axis_groups,
    coords,
    data_parallel,
)

B, H, HKV, TL, D = 2, 2, 1, 64, 32
TOL = 1e-5
# (q_off, k_off): the straddling pairs' offsets are no multiple of a tile,
# so part of their rows see no key
PAIRS = {"diagonal": (TL, TL), "past": (2 * TL, 0), "future": (0, TL),
         "straddle_future": (0, 37), "straddle_past": (37, 0)}


def _block_inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, TL, H, D).astype(np.float32)
    k = rng.randn(B, TL, HKV, D).astype(np.float32)
    v = rng.randn(B, TL, HKV, D).astype(np.float32)
    m = rng.randn(B * H, TL).astype(np.float32)
    l = (rng.rand(B * H, TL) * 4 + 0.5).astype(np.float32)
    acc = rng.randn(B, TL, H, D).astype(np.float32)
    return q, k, v, m, l, acc


def _bh(x):
    """(B, T, h, D) -> (B*h, T, D), the JAX kernel's layout."""
    b, t, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_ring_block_update_matches_jax(pair, causal, oracle):
    q, k, v, m, l, acc = _block_inputs(seed=len(pair) + causal)
    q_off, k_off = PAIRS[pair]
    G = H // HKV
    lanes = lambda x: jnp.broadcast_to(  # noqa: E731
        jnp.asarray(x)[..., None], (*x.shape, STAT_LANES))
    jargs = (jnp.asarray(_bh(q)), jnp.asarray(np.repeat(_bh(k), G, 0)),
             jnp.asarray(np.repeat(_bh(v), G, 0)), lanes(m), lanes(l),
             jnp.asarray(_bh(acc)), jnp.asarray([q_off, k_off], jnp.int32))
    if oracle == "reference":
        jm, jl, jacc = _ring_block_reference(*jargs, causal=causal)
    else:
        jm, jl, jacc = _ring_block_pallas(*jargs, causal=causal, block_q=TL,
                                          block_k=TL, interpret=True)
    tm, tl, tacc = (torch.from_numpy(x.copy()) for x in (m, l, acc))
    n = ra.ring_block_update.launches
    out = ra.ring_block_update(*(torch.from_numpy(x) for x in (q, k, v)),
                               tm, tl, tacc, q_off, k_off, causal=causal)
    assert out[0] is tm and out[1] is tl and out[2] is tacc  # in place
    assert ra.ring_block_update.launches == n  # the plain version
    _close(tm.numpy(), np.asarray(jm)[..., 0])
    _close(tl.numpy(), np.asarray(jl)[..., 0])
    _close(_bh(tacc.numpy()), jacc)
    # the rows that see no key (every row of the future pair) keep their
    # carries bit for bit
    dead = q_off + np.arange(TL) < k_off if causal else np.zeros(TL, bool)
    assert dead.all() == (causal and pair == "future")
    np.testing.assert_array_equal(tm.numpy()[:, dead], m[:, dead])
    np.testing.assert_array_equal(tl.numpy()[:, dead], l[:, dead])
    np.testing.assert_array_equal(tacc.numpy()[:, dead], acc[:, dead])


def test_ring_block_update_checks_shapes():
    q, k, v, m, l, acc = (torch.from_numpy(x) for x in _block_inputs(0))
    with pytest.raises(ValueError, match="m "):
        ra.ring_block_update(q, k, v, m[:, :8], l, acc, 0, 0, causal=True)
    with pytest.raises(ValueError, match="kv heads"):
        ra.ring_block_update(q, k[..., :16], v[..., :16], m, l, acc, 0, 0,
                             causal=True)


# --------------------------------------------------------------------------
# the mesh: rank coordinates and groups, as the JAX mesh lays devices out
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seq=4, data=2), dict(seq=2, data=4)],
                         ids=["seq4-data2", "seq2-data4"])
def test_mesh_coords_and_groups_follow_the_jax_device_order(kw):
    jmesh = make_mesh(JMeshSpec(**kw))
    spec = data_parallel(MeshSpec(**kw), 8)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        c = coords(spec, rank)
        assert ids[tuple(c[a] for a in jmesh.axis_names)] == rank
    # the seq rings: the devices along the seq axis, one ring per data
    # index; the data groups: the devices along data, one per seq index
    seq_rings = [tuple(int(i) for i in ids[0, d, 0, 0, :, 0])
                 for d in range(kw["data"])]
    data_groups = [tuple(int(i) for i in ids[0, :, 0, 0, s, 0])
                   for s in range(kw["seq"])]
    assert axis_groups(spec, ("seq",)) == seq_rings
    assert axis_groups(spec, ("data", "fsdp")) == data_groups


def test_mesh_lets_seq_through_and_refuses_the_model_axes():
    assert data_parallel(MeshSpec(seq=4, data=-1), 8).sizes()["data"] == 2
    assert data_parallel(MeshSpec(pipe=2, data=-1), 8).data_degree() == 4
    # the expert and tensor axes resolve (the batch splits over data x
    # fsdp only), and so do seq and tensor together
    ep = data_parallel(MeshSpec(expert=-1, data=2), 8)
    assert (ep.expert, ep.data_degree()) == (4, 2)
    tp = data_parallel(MeshSpec(data=-1, tensor=2), 8)
    assert (tp.tensor, tp.data_degree()) == (2, 4)
    st = data_parallel(MeshSpec(seq=2, data=-1, tensor=2), 8)
    assert (st.seq, st.tensor, st.data_degree()) == (2, 2, 2)


def test_loader_takes_the_data_rows_and_the_seq_tokens():
    ds = tdata.get_dataset("lm_synthetic", seed=3, batch_size=4, seq_len=16,
                           vocab_size=97)
    x, y = ds.batch(2)
    for di in range(2):
        for si in range(4):
            loader = DataLoader(ds, torch.device("cpu"), data_index=di,
                                data_degree=2, seq_index=si, seq_degree=4,
                                prefetch=0)
            xr, yr = loader.batch_at(2)
            rows, cols = slice(2 * di, 2 * di + 2), slice(4 * si, 4 * si + 4)
            np.testing.assert_array_equal(xr.numpy(), x[rows, cols])
            np.testing.assert_array_equal(yr.numpy(), y[rows, cols])
    images = tdata.get_dataset("cifar10", seed=1, batch_size=8)
    with pytest.raises(ValueError, match="sequence dim"):
        DataLoader(images, torch.device("cpu"), seq_degree=2)


# --------------------------------------------------------------------------
# collectives at ring size 1, and their wire accounting
# --------------------------------------------------------------------------

def test_size_one_ring_verbs_are_the_identity():
    x = torch.arange(24.0).reshape(2, 3, 4)
    with cc.recording() as recs:
        (y,) = cc.shift_right((x,), None, 1)
        z = cc.all_to_all(x, None, 1, split_axis=2, concat_axis=1)
    assert y is x and z is x
    assert [r.op for r in recs] == ["shift", "all_to_all"]
    assert cc.wire_bytes(recs) == 0.0
    assert cc.payload_bytes(recs) == 2 * x.numel() * 4
    assert cc.ring_wire_bytes("shift", 100, 4) == 100
    assert cc.ring_wire_bytes("all_to_all", 100, 4) == 75


# --------------------------------------------------------------------------
# the preset, the step's seq validations, tokens per card
# --------------------------------------------------------------------------

def test_96k_preset_matches_the_jax_preset():
    j = jconfig.get_config("llama3_longcontext_96k")
    t = tconfig.get_config("llama3_longcontext_96k")
    assert (t.data.seq_len, t.steps, t.xent_chunk) == (
        j.data.seq_len, j.steps, j.xent_chunk) == (98304, 5, 2048)
    assert t.model.extra == j.model.extra and t.model.remat == j.model.remat
    assert (t.optim.name, t.optim.lr) == (j.optim.name, j.optim.lr)


_SEQ2 = {"mesh.seq": "2", "data.seq_len": "256", "xent_chunk": "64",
         "model.extra": json.dumps({"attn_impl": "ring"})}


@pytest.mark.parametrize("override,match", [
    ({"data.dataset": "cifar10"}, "no sequence dim"),
    ({"parallel.strategy": "dp_explicit"}, "single/dp"),
    ({"data.seq_len": "255"}, "not divisible by mesh.seq"),
    ({"model.extra": json.dumps({"attn_impl": "flash"})}, "no compiler"),
], ids=["dataset", "strategy", "seq_len", "attn_impl"])
def test_seq_step_validations(override, match):
    from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
    from pytorch_distributed_nn_tpu_torch.train.losses import lm_xent

    cfg = tconfig.get_config("llama3_longcontext", **{**_SEQ2, **override})
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, lm_xent)
    ok = tconfig.get_config("llama3_longcontext", **_SEQ2)
    step, _ = make_train_step(ok, lm_xent)  # a rank's 128 tokens: chunked
    assert callable(step)


def test_tokens_per_card_split_over_data_and_seq():
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        lm_tokens_per_card,
    )

    assert lm_tokens_per_card(1, 32768, 1, 1) == 32768
    assert lm_tokens_per_card(4, 32768, 2, 4) == 16384

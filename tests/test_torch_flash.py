"""Port parity: flash attention (``ops/flash_attention.py``) against the
JAX package's Pallas kernels run in interpret mode on the CPU.

The same numpy inputs go to ``_flash_bhtd`` / ``_flash_bwd_pallas``
(interpret=True, block 8, so nq = 12 and the last lse group is partial)
and to the port's plain versions, which the wrappers run on a CPU tensor.
The JAX layout is (B*H, T, D); the port's is (B, T, H, D) with query head
h reading K/V head h // (H // Hkv), the same rows. All in f32.
Tolerances: the forward agrees to f32 rounding (2e-5, as the JAX package's
own interpret test); the backward sums more products in another order
(2e-4, likewise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.ops.pallas.flash_attention import (
    _attention_reference,
    _flash_bhtd,
    _flash_bwd_pallas,
)
from pytorch_distributed_nn_tpu_torch.nn.attention import (
    FLASH_MIN_T,
    _auto_impl,
    dot_product_attention,
)
from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

FWD_TOL = 2e-5
BWD_TOL = 2e-4
BLK = 8


def _inputs(B, T, H, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32) * 0.3
    k = rng.randn(B, T, Hkv, D).astype(np.float32) * 0.3
    v = rng.randn(B, T, Hkv, D).astype(np.float32)
    g = rng.randn(B, T, H, D).astype(np.float32)
    return q, k, v, g


def _to_bh(x):
    """(B, T, H, D) numpy -> (B*H, T, D) jax, as the JAX wrapper lays out."""
    B, T, H, D = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, T, D))


def _from_bh(x, B):
    """(B*H, T, D) -> (B, T, H, D) numpy."""
    BH, T, D = x.shape
    return np.asarray(x).reshape(B, BH // B, T, D).transpose(0, 2, 1, 3)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


# (B, H, Hkv): B*H = 4 query rows and B*Hkv = 2 K/V rows either way
GEOMS = [(1, 4, 2), (2, 2, 1)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv", GEOMS)
def test_forward_matches_pallas_interpret(causal, B, H, Hkv):
    T, D = 96, 16
    q, k, v, _ = _inputs(B, T, H, Hkv, D, seed=7)
    o_j, lse_j = _flash_bhtd(_to_bh(q), _to_bh(k), _to_bh(v), causal=causal,
                             block_q=BLK, block_k=BLK, interpret=True)
    o_j = _from_bh(o_j, B)
    lse_j = np.asarray(lse_j).reshape(B * H, T)  # (BH, nq, block_q) -> rows
    before = fa.flash_fwd.launches
    for o, lse in (fa.flash_forward_reference(_t(q), _t(k), _t(v), causal),
                   fa.flash_fwd(_t(q), _t(k), _t(v), causal)):
        np.testing.assert_allclose(o.numpy(), o_j, rtol=FWD_TOL,
                                   atol=FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), lse_j, rtol=FWD_TOL,
                                   atol=FWD_TOL)
    o = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), o_j, rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert fa.flash_fwd.launches == before  # the CPU runs no kernel


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv", GEOMS)
def test_backward_matches_pallas_interpret(causal, B, H, Hkv):
    T, D = 96, 16
    q, k, v, g = _inputs(B, T, H, Hkv, D, seed=8)
    o_j, lse_j = _flash_bhtd(_to_bh(q), _to_bh(k), _to_bh(v), causal=causal,
                             block_q=BLK, block_k=BLK, interpret=True)
    delta_j = jnp.sum(o_j * _to_bh(g), -1).reshape(B * H, T // BLK, BLK)
    dq_j, dk_j, dv_j = _flash_bwd_pallas(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(g), lse_j, delta_j,
        causal=causal, block_q=BLK, block_k=BLK, interpret=True)
    lse = _t(np.asarray(lse_j).reshape(B * H, T))
    delta = _t(np.asarray(delta_j).reshape(B * H, T))
    args = (_t(q), _t(k), _t(v), _t(g), lse, delta, causal)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), _from_bh(want, B),
                                   rtol=BWD_TOL, atol=BWD_TOL)
    # the row-slice options that chip_smoke.py uses at T = 32768
    rows = slice(40, 72)
    np.testing.assert_allclose(
        fa.flash_bwd_dq_reference(*args, q_rows=rows).numpy(),
        dq.numpy()[:, rows], rtol=1e-6, atol=1e-6)
    dk_r, dv_r = fa.flash_bwd_dkv_reference(*args, k_rows=rows)
    np.testing.assert_allclose(dk_r.numpy(), dk.numpy()[:, rows],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dv_r.numpy(), dv.numpy()[:, rows],
                               rtol=1e-6, atol=1e-6)
    o_r, lse_r = fa.flash_forward_reference(_t(q), _t(k), _t(v), causal,
                                            q_rows=rows)
    np.testing.assert_allclose(o_r.numpy(), _from_bh(o_j, B)[:, rows],
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse_r.numpy(), lse.numpy()[:, rows],
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("T", [96, 50])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_autograd_of_plain_attention(T, causal):
    """The Function's closed-form backward against torch.autograd through
    the plain softmax attention, and (ragged T = 50, which no block
    divides) against the JAX package's reference and its vjp. f32; the
    two backward forms differ by rounding only (1e-5)."""
    q, k, v, g = _inputs(2, T, 4, 2, 16, seed=T)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = dot_product_attention(*leaves, causal=causal, impl="flash")
    out.backward(_t(g))
    got = [out.detach()] + [x.grad for x in leaves]
    plain = [_t(x).requires_grad_() for x in (q, k, v)]
    ref = dot_product_attention(*plain, causal=causal, impl="xla")
    ref.backward(_t(g))
    for a, b in zip(got, [ref.detach()] + [x.grad for x in plain]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # JAX: its wrapper's off-TPU path, grads of the expanded K/V summed
    # over each group
    H, Hkv, B = 4, 2, 2
    kx = np.repeat(k, H // Hkv, axis=2)
    vx = np.repeat(v, H // Hkv, axis=2)
    o_j, vjp = jax.vjp(
        lambda a, b, c: _attention_reference(a, b, c, causal=causal),
        _to_bh(q), _to_bh(kx), _to_bh(vx))
    dq_j, dk_j, dv_j = vjp(_to_bh(g))

    def grouped(x):
        x = _from_bh(x, B)
        return x.reshape(B, T, Hkv, H // Hkv, -1).sum(3)

    for a, b in ((got[0], _from_bh(o_j, B)), (got[1], _from_bh(dq_j, B)),
                 (got[2], grouped(dk_j)), (got[3], grouped(dv_j))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_flash_rejects_mask_and_cross_length():
    q, k, v, _ = _inputs(1, 16, 4, 2, 8, seed=0)
    q, k, v = _t(q), _t(k), _t(v)
    with pytest.raises(ValueError, match="padding mask"):
        dot_product_attention(q, k, v, causal=True, impl="flash",
                              mask=torch.ones((1, 16), dtype=torch.bool))
    with pytest.raises(ValueError, match="self-attention"):
        dot_product_attention(q, k[:, :8], v[:, :8], causal=False,
                              impl="flash")
    with pytest.raises(ValueError, match="dividing"):
        fa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dq(q, k, v, q, torch.zeros(4, 15), torch.zeros(4, 16),
                        True)


def test_plain_attention_takes_masks_as_jax_does():
    from pytorch_distributed_nn_tpu.nn.attention import (
        dot_product_attention as j_dpa,
    )

    q, k, v, _ = _inputs(2, 12, 4, 2, 8, seed=3)
    pad = np.ones((2, 12), bool)
    pad[1, 9:] = False
    pos = np.tril(np.ones((12, 12), bool))[None]
    for mask in (pad, pos):
        got = dot_product_attention(_t(q), _t(k), _t(v), causal=False,
                                    mask=torch.from_numpy(mask))
        want = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, mask=jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_auto_picks_flash_on_cuda_only_where_it_applies():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    long, short = (1, FLASH_MIN_T, 8, 128), (1, FLASH_MIN_T - 1, 8, 128)
    kv = (1, FLASH_MIN_T, 4, 128)

    def auto(q, k, **kw):
        args = dict(has_mask=False, device=cuda, dtype=torch.bfloat16)
        return _auto_impl(q, k, **dict(args, **kw))

    assert auto(long, kv) == "flash"
    assert auto(short, (1, FLASH_MIN_T - 1, 4, 128)) == "xla"
    assert auto(long, kv, has_mask=True) == "xla"
    assert auto(long, (1, 16, 4, 128)) == "xla"
    # only where the kernels apply: bf16, head_dim 64 or 128
    assert auto(long, kv, dtype=torch.float32) == "xla"
    assert auto((1, FLASH_MIN_T, 8, 32), (1, FLASH_MIN_T, 4, 32)) == "xla"
    # off the card 'auto' stays on the plain path, as JAX does off the TPU
    assert auto(long, kv, device=cpu) == "xla"
    q = torch.zeros(long)
    k = torch.zeros(kv)
    before = fa.flash_fwd.launches
    dot_product_attention(q[:, :64], k[:, :64], k[:, :64], causal=True,
                          impl="auto")
    assert fa.flash_fwd.launches == before

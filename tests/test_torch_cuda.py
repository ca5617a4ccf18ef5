"""The port's CUDA kernels on the card: they build with nvcc, launch, and
agree with their plain PyTorch versions. Marked ``cuda``; each test skips
where no CUDA device is present (decided inside the fixture).

On a GPU machine: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the port does not need).
Tolerance of the W8A16 kernel: it and the plain version sum the same f32
products in another order (K split across blocks), so f32 outputs agree to
~1e-6 of the largest output and bf16 outputs to one bf16 rounding step
(2^-8). The flash kernels' tolerances are stated beside their tests.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 6144), (3, 200, 384),
                                   (8, 14336, 4096), (17, 96, 1000),
                                   (64, 2048, 1024)])
def test_int8_matmul_kernel_matches_plain_version(cuda, m, k, n, out_dtype):
    g = torch.Generator(cuda).manual_seed(m * 7 + k)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    kp, np_ = tmm.padded_kn(k, n)
    q = torch.zeros((kp, np_), dtype=torch.int8, device=cuda)
    q[:k, :n].random_(-127, 128, generator=g)
    s = torch.rand((1, np_), generator=g, device=cuda) * 1e-2
    before = tmm.int8_matmul.launches
    got = tmm.int8_matmul(x, q, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tmm.int8_matmul.launches == before + 1
    ref = tmm.int8_matmul_reference(torch.nn.functional.pad(x, (0, kp - k)),
                                    q, s, out_dtype=out_dtype)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    assert err <= tol * scale, (err, scale)


def test_int8_matmul_kernel_raises_on_bad_input(cuda):
    x = torch.zeros((2, 64), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((64, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="scale shape"):
        tmm.int8_matmul(x, q, torch.zeros((1, 64), device=cuda))
    with pytest.raises(TypeError):
        tmm.int8_matmul(x, q.float(), torch.zeros((1, 128), device=cuda))


def test_engine_on_cuda_matches_generate(cuda):
    from pytorch_distributed_nn_tpu_torch.config import ModelConfig
    from pytorch_distributed_nn_tpu_torch.inference.generate import generate
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.nn.quantized import (
        synthetic_int8_params,
    )
    from pytorch_distributed_nn_tpu_torch.serve import (
        InferenceServer,
        ServingEngine,
    )

    cfg = ModelConfig(name="llama3_8b", compute_dtype="bfloat16",
                      extra=dict(num_layers=2, d_model=128, num_heads=4,
                                 num_kv_heads=2, mlp_dim=256,
                                 vocab_size=512, quantized=True,
                                 fused_proj=True))
    model = synthetic_int8_params(get_model(cfg, device=cuda), seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=(n,)).astype(np.int32)
               for n in (5, 12, 3, 9)]
    srv = InferenceServer(ServingEngine(model, max_slots=2,
                                        max_seq_len=32)).start()
    try:
        reqs = [srv.submit(p, 4) for p in prompts]
        for r in reqs:
            assert r.done.wait(300)
    finally:
        srv.stop()
    for p, r in zip(prompts, reqs):
        assert r.ok
        ref = generate(model, p[None], 4).cpu().numpy()
        np.testing.assert_array_equal(r.tokens, ref[0, len(p):])


# --------------------------------------------------------------------------
# flash attention: forward, dq pass and dk/dv pass against the plain versions
# --------------------------------------------------------------------------
# The kernels round p (and ds in the backward) to bf16 for the tensor-core
# products and write bf16 outputs; the plain versions keep everything in
# f32. So O, dq, dk and dv agree to a few bf16 steps of the largest output
# (FLASH_TOL of max|ref|); lse is f32 statistics of the same bf16 inputs
# and agrees to f32 rounding (LSE_TOL, absolute). A gradient that is zero
# in exact arithmetic (dq at T = 1: one key, so ds = dp - delta = 0) is
# rounding noise on both sides: the error is then taken against FLOOR.
FLASH_TOL = 2e-2
LSE_TOL = 1e-4
FLOOR = 1e-3


def _flash_inputs(cuda, B, T, H, Hkv, D, seed):
    g = torch.Generator(cuda).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    return r(B, T, H, D), r(B, T, Hkv, D), r(B, T, Hkv, D), r(B, T, H, D)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=FLOOR)).item()


# T at the tile edges of the kernels (64-row and 128-row tiles) and past
# them; every GQA group size of the 8 query heads the tests use
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [8, 4, 2])  # G = H / Hkv = 1, 2, 4
@pytest.mark.parametrize("T,D", [(1, 128), (50, 128), (63, 128), (64, 128),
                                 (65, 128), (127, 128), (128, 128),
                                 (129, 128), (257, 128), (1000, 128),
                                 (63, 64), (129, 64), (257, 64), (1000, 64)])
def test_flash_kernels_match_plain_versions(cuda, T, D, hkv, causal):
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(cuda, 2, T, 8, hkv, D, seed=T)
    n = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(c + 1 for c in n)
    assert _rel(o, o_ref) <= FLASH_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal)
    assert _rel(dq, dq_ref) <= FLASH_TOL
    assert _rel(dk, dk_ref) <= FLASH_TOL
    assert _rel(dv, dv_ref) <= FLASH_TOL
    # f32 outputs, as the ring path asks for its partial sums
    dq32 = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                           out_dtype=torch.float32)
    dk32, dv32 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                  out_dtype=torch.float32)
    assert dq32.dtype == dk32.dtype == torch.float32
    assert _rel(dq32, dq_ref) <= FLASH_TOL
    assert _rel(dk32, dk_ref) <= FLASH_TOL and _rel(dv32, dv_ref) <= FLASH_TOL


@pytest.mark.parametrize("pair", ["diagonal", "past"])
def test_flash_backward_reads_row_slices_in_place(cuda, pair):
    """Both backward passes on row slices of a longer sequence, as the
    seq = 4 ring replay of chip_smoke.py hands them (a query shard against
    its own K/V shard, causal, or an earlier one, dense): bit for bit what
    contiguous copies give, and within FLASH_TOL of the plain versions."""
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(cuda, 2, 900, 8, 4, 128, seed=13)
    qs, ks = {"diagonal": (slice(300, 600), slice(300, 600)),
              "past": (slice(600, 900), slice(0, 300))}[pair]
    causal = pair == "diagonal"
    views = (q[:, qs], k[:, ks], v[:, ks], do[:, qs])
    o, lse = fa.flash_fwd(*views[:3], causal)
    delta = fa.flash_delta(o, views[3])
    f32 = torch.float32
    outs = []
    for args in (views, tuple(x.contiguous() for x in views)):
        args = (*args, lse, delta, causal)
        outs.append((fa.flash_bwd_dq(*args, out_dtype=f32),
                     *fa.flash_bwd_dkv(*args, out_dtype=f32)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    args = (*views, lse, delta, causal)
    dq, dk, dv = outs[0]
    assert _rel(dq, fa.flash_bwd_dq_reference(*args)) <= FLASH_TOL
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args)
    assert _rel(dk, dk_ref) <= FLASH_TOL and _rel(dv, dv_ref) <= FLASH_TOL


def test_flash_gradients_are_deterministic(cuda):
    from pytorch_distributed_nn_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    q, k, v, do = _flash_inputs(cuda, 1, 777, 8, 4, 128, seed=5)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*leaves, causal=True).backward(do)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_flash_kernels_raise_on_bad_input(cuda):
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_inputs(cuda, 1, 16, 4, 2, 128, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q.float(), k.float(), v.float(), True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :32], k[..., :32], v[..., :32], True)
    with pytest.raises(ValueError, match="self-attention"):
        fa.flash_fwd(q, k[:, :8], v[:, :8], True)


# --------------------------------------------------------------------------
# one tiny training step on the card: flash kernels against plain attention
# --------------------------------------------------------------------------
# Same weights and batch; the two attentions differ in where they round to
# bf16 (p and ds for the tensor cores against the plain path's bf16
# probabilities), so the loss agrees to 1e-3 relative and each gradient to
# TRAIN_GRAD_TOL of its largest element.
TRAIN_GRAD_TOL = 5e-2


def _tiny_trainer(cuda, impl):
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    extra = dict(num_layers=2, d_model=256, num_heads=2, num_kv_heads=1,
                 mlp_dim=512, vocab_size=512, attn_impl=impl)
    cfg = get_config("llama3_longcontext", **{
        "model.extra": json.dumps(extra), "data.vocab_size": "512",
        "data.seq_len": "200", "xent_chunk": "40", "log_every": "1"})
    return Trainer(cfg, device=cuda)


def _loss_and_grads(trainer):
    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )

    x, y = trainer.loader.batch_at(0)
    loss = dp._loss_and_grads(trainer.state, x, y, make_chunked_loss(40))
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    trainer.state.optimizer.zero_grad()
    return loss.item(), grads


def test_tiny_training_step_matches_plain_attention(cuda):
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    flash = _tiny_trainer(cuda, "flash")
    plain = _tiny_trainer(cuda, "xla")  # the same seeded init
    loss_f, grads_f = _loss_and_grads(flash)
    loss_x, grads_x = _loss_and_grads(plain)
    assert abs(loss_f - loss_x) <= 1e-3 * abs(loss_x)
    for name, gx in grads_x.items():
        err = (grads_f[name] - gx).abs().max() / gx.abs().max()
        assert err.item() <= TRAIN_GRAD_TOL, name
    # two full steps: 2 layers x 2 forwards (remat), 2 dq, 2 dk/dv each
    n = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    flash.train(steps=2)
    got = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
           fa.flash_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(got, n)) == (8, 4, 4)
    assert all(np.isfinite(flash.losses()))


# --------------------------------------------------------------------------
# bn_stats: per-channel (sum, sum of squares) and (sum, dot) on the card
# --------------------------------------------------------------------------
# The kernel and the plain version sum the same f32 terms in another order;
# both are held against an f64 sum, per channel, to 1e-5 of sum|term| (a
# bound on f32 summation error for these lengths).
BN_TOL = 1e-5


def _bn_check(got, ref64, mag):
    err = (got.double() - ref64).abs()
    assert bool((err <= BN_TOL * mag + 1e-30).all()), (
        err.max().item(), mag.max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(1000, 64), (333, 96), (4097, 2048),
                                 (7, 64), (12544, 3)])
def test_bn_stats_kernel_matches_f64_sums(cuda, m, c, dtype):
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    g = torch.Generator(cuda).manual_seed(m + c)
    a = (torch.randn((m, c), generator=g, device=cuda) + 0.5).to(dtype)
    b = torch.randn((m, c), generator=g, device=cuda).to(dtype)
    n = (bn_stats.sum_and_sumsq.launches, bn_stats.sum_and_dot.launches)
    s1, s2 = bn_stats.sum_and_sumsq(a)
    d1, d2 = bn_stats.sum_and_dot(a, b)
    torch.cuda.synchronize()
    assert (bn_stats.sum_and_sumsq.launches,
            bn_stats.sum_and_dot.launches) == (n[0] + 1, n[1] + 1)
    a64, b64 = a.double(), b.double()
    _bn_check(s1, a64.sum(0), a64.abs().sum(0))
    _bn_check(s2, (a64 * a64).sum(0), (a64 * a64).sum(0))
    _bn_check(d1, a64.sum(0), a64.abs().sum(0))
    _bn_check(d2, (a64 * b64).sum(0), (a64 * b64).abs().sum(0))
    r1, r2 = bn_stats.sum_and_sumsq_reference(a)
    _bn_check(r1, a64.sum(0), a64.abs().sum(0))
    # bitwise the same from run to run: no atomics
    again = bn_stats.sum_and_dot(a, b)
    assert torch.equal(again[0], d1) and torch.equal(again[1], d2)


def test_bn_stats_views_channels_last_without_a_copy(cuda):
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    x = torch.randn((4, 64, 9, 7), device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    copies = bn_stats.copies
    s1, s2 = bn_stats.sum_and_sumsq(x, dim=1)
    assert bn_stats.copies == copies
    r1, r2 = bn_stats.sum_and_sumsq_reference(x, dim=1)
    torch.testing.assert_close(s1, r1, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(s2, r2, rtol=1e-5, atol=1e-3)
    bn_stats.sum_and_sumsq(x.contiguous(), dim=1)  # NCHW: copied
    assert bn_stats.copies == copies + 1
    with pytest.raises(ValueError, match="shape mismatch"):
        bn_stats.sum_and_dot(x, x[:2], dim=1)


# --------------------------------------------------------------------------
# quantize: the stochastic int8 kernel equals its plain version bit for bit
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 4099, 1 << 20])
def test_quantize_kernel_equals_plain_version(cuda, n):
    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

    g = torch.Generator(cuda).manual_seed(n)
    x = torch.randn((n,), generator=g, device=cuda) * 3.0
    scale = (x.abs().max() / 100.0).reshape(())
    x[: max(n // 10, 1)] *= 2.0  # up to 200 * scale: these saturate
    before = tq.quantize_int8.launches
    q = tq.quantize_int8(x, scale, seed=12345 + n)
    torch.cuda.synchronize()
    assert tq.quantize_int8.launches == before + 1
    ref = tq.quantize_int8_reference(x, scale, seed=12345 + n)
    assert q.dtype == torch.int8 and torch.equal(q, ref)
    deq = q.float() * scale
    inside = x.abs() < 127 * scale
    assert bool(((deq - x).abs()[inside] < scale).all())
    assert bool((q[x >= 127 * scale] == 127).all())
    assert bool((q[x <= -127 * scale] == -127).all())
    # an unaligned view takes the copy path and still agrees
    if n > 4:
        q1 = tq.quantize_int8(x[1:], scale, seed=3)
        assert torch.equal(q1, tq.quantize_int8_reference(x[1:], scale,
                                                          seed=3))


def test_dp_explicit_int8_step_on_nccl_world_one(cuda):
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats
    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    extra = dict(stage_sizes=[1, 1, 1, 1], width=8, num_classes=10,
                 bn_impl="pallas")
    cfg = get_config("resnet50_dp", **{
        "model.extra": json.dumps(extra), "data.dataset": "cifar10",
        "data.batch_size": "16", "parallel.strategy": "dp_explicit",
        "parallel.quantized_allreduce": "int8", "log_every": "1"})
    t = Trainer(cfg, device=cuda)
    assert t.process.backend == "nccl" and t.process.world_size == 1
    n = (bn_stats.sum_and_sumsq.launches, bn_stats.sum_and_dot.launches,
         tq.quantize_int8.launches)
    t.train(steps=2)
    got = (bn_stats.sum_and_sumsq.launches - n[0],
           bn_stats.sum_and_dot.launches - n[1],
           tq.quantize_int8.launches - n[2])
    n_bn = len(t.model.batch_norms())
    assert got == (2 * n_bn, 2 * n_bn, 2)  # one f32 bucket a step
    assert all(np.isfinite(t.losses()))


# --------------------------------------------------------------------------
# the ring-attention block update on the card
# --------------------------------------------------------------------------
# The kernel rounds p to bf16 for the p.V product and scales the f32 dot
# after the product; the plain version keeps f32 p and scales q first. So
# acc and l agree to FLASH_TOL of their largest element and m (f32
# statistics of the same bf16 inputs) to LSE_TOL, absolute.

def _ring_carries(cuda, B, T, H, D, seed):
    """Non-trivial incoming carries: m near the logits' scale, l > 0."""
    g = torch.Generator(cuda).manual_seed(seed)
    m = torch.randn((B * H, T), generator=g, device=cuda)
    l = torch.rand((B * H, T), generator=g, device=cuda) * 4 + 0.5
    acc = torch.randn((B, T, H, D), generator=g, device=cuda)
    return m, l, acc


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pair", ["diagonal", "past", "future"])
@pytest.mark.parametrize("T,D,hkv", [(64, 128, 4), (200, 128, 2),
                                     (257, 64, 8)])
def test_ring_block_kernel_matches_plain_version(cuda, T, D, hkv, pair,
                                                 causal):
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    q, k, v, _ = _flash_inputs(cuda, 2, T, 8, hkv, D, seed=T + D)
    q_off, k_off = {"diagonal": (T, T), "past": (2 * T, 0),
                    "future": (0, T)}[pair]
    m, l, acc = _ring_carries(cuda, 2, T, 8, D, seed=T)
    want = ra.ring_block_reference(q, k, v, m, l, acc, q_off, k_off,
                                   causal=causal)
    before = (m.clone(), l.clone(), acc.clone())
    n = ra.ring_block_update.launches
    got = ra.ring_block_update(q, k, v, m, l, acc, q_off, k_off,
                               causal=causal)
    torch.cuda.synchronize()
    assert ra.ring_block_update.launches == n + 1
    assert got[0] is m and got[1] is l and got[2] is acc  # in place
    if causal and pair == "future":  # no iteration: untouched, bitwise
        for a, b in zip((m, l, acc), before):
            assert torch.equal(a, b)
    assert (m - want[0]).abs().max().item() <= LSE_TOL
    assert _rel(l, want[1]) <= FLASH_TOL
    assert _rel(acc, want[2]) <= FLASH_TOL


def test_ring_block_kernel_reads_row_slices_in_place(cuda):
    """A shard that is a row slice of the whole sequence (as the ring
    emulation of chip_smoke.py hands it) gives what a contiguous copy
    gives, bit for bit."""
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    q, k, v, _ = _flash_inputs(cuda, 1, 512, 8, 4, 128, seed=9)
    sl = slice(256, 512)
    outs = []
    for args in ((q[:, sl], k[:, :256], v[:, :256]),
                 (q[:, sl].contiguous(), k[:, :256].contiguous(),
                  v[:, :256].contiguous())):
        m, l, acc = _ring_carries(cuda, 1, 256, 8, 128, seed=1)
        outs.append(ra.ring_block_update(*args, m, l, acc, 256, 0,
                                         causal=True))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_ring_attention_on_the_card_matches_flash(cuda):
    """The one-rank ring (the world-1 main path: one diagonal pair) against
    flash attention, forward and gradients, and its launch counts."""
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra
    from pytorch_distributed_nn_tpu_torch.parallel.sequence import (
        ring_attention,
    )
    from pytorch_distributed_nn_tpu_torch.runtime.mesh import SeqGroup

    q, k, v, do = _flash_inputs(cuda, 2, 300, 8, 4, 128, seed=11)
    outs = {}
    for impl in ("ring", "flash"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n = (ra.ring_block_update.launches, fa.flash_fwd.launches,
             fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
        if impl == "ring":
            out = ring_attention(*leaves, seq=SeqGroup(), causal=True)
        else:
            out = fa.flash_attention(*leaves, causal=True)
        out.backward(do)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(
            (ra.ring_block_update.launches, fa.flash_fwd.launches,
             fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches), n))
        outs[impl] = (out, *[t.grad for t in leaves], counts)
    assert outs["ring"][4] == (1, 0, 1, 1)
    for a, b in zip(outs["ring"][:4], outs["flash"][:4]):
        assert _rel(a, b) <= FLASH_TOL

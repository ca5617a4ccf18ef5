"""The port's CUDA kernels on the card: they build with nvcc, launch, and
agree with their plain PyTorch versions. Marked ``cuda``; each test skips
where no CUDA device is present (decided inside the fixture).

On a GPU machine: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the port does not need).
Tolerance of the W8A16 kernel: it and the plain version sum the same f32
products in another order (tensor-core k16 steps, K split across blocks),
so f32 outputs agree to ~1e-6 of the largest output and bf16 outputs to one
bf16 rounding step (2^-8). The flash kernels' tolerances are stated beside their tests.
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
                                   (64, 2048, 1024), (512, 4096, 4096)])
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


def _int8_operands(cuda, m, k, n, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    kp, np_ = tmm.padded_kn(k, n)
    q = torch.zeros((kp, np_), dtype=torch.int8, device=cuda)
    q[:k, :n].random_(-127, 128, generator=g)
    s = torch.rand((1, np_), generator=g, device=cuda) * 1e-2
    return x, q, s


# The engine's contract: a row's output bits do not depend on M or on the
# other rows (prefill at a bucketed length, decode at M = live slots and
# generate() at M = 1 must give the same tokens).
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(4096, 6144), (200, 384), (96, 1000)])
def test_int8_matmul_rows_are_bitwise_batch_invariant(cuda, k, n, out_dtype):
    x, q, s = _int8_operands(cuda, 256, k, n, seed=k + n)
    alone = torch.cat([tmm.int8_matmul(x[i:i + 1], q, s, out_dtype)
                       for i in range(x.shape[0])])
    for m in (2, 3, 8, 16, 17, 64, 128, 256):
        got = tmm.int8_matmul(x[:m], q, s, out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, alone[:m]), m
        # the same rows behind other rows of the batch
        shifted = tmm.int8_matmul(x[-m:], q, s, out_dtype)
        assert torch.equal(shifted, alone[-m:]), m


@pytest.mark.parametrize("m", [1, 8, 128])
def test_int8_matmul_is_bitwise_repeatable(cuda, m):
    x, q, s = _int8_operands(cuda, m, 14336, 4096, seed=m)
    first = tmm.int8_matmul(x, q, s)
    second = tmm.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int8_matmul_launches_once_a_call(cuda):
    x, q, s = _int8_operands(cuda, 8, 4096, 4096, seed=3)
    before = tmm.int8_matmul.launches
    tmm.int8_matmul(x, q, s)
    assert tmm.int8_matmul.launches == before + 1
    tmm.int8_matmul(x, q, s, out_dtype=torch.float32)
    assert tmm.int8_matmul.launches == before + 2


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


def _tiny_int8_llama(cuda, cache_dtype="compute"):
    from pytorch_distributed_nn_tpu_torch.config import ModelConfig
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.nn.quantized import (
        synthetic_int8_params,
    )

    cfg = ModelConfig(name="llama3_8b", compute_dtype="bfloat16",
                      extra=dict(num_layers=2, d_model=128, num_heads=4,
                                 num_kv_heads=2, mlp_dim=256,
                                 vocab_size=512, quantized=True,
                                 fused_proj=True, cache_dtype=cache_dtype))
    return synthetic_int8_params(get_model(cfg, device=cuda), seed=0)


@pytest.mark.parametrize("cache_dtype", ["compute", "int8"])
def test_prefix_cache_engine_on_cuda_equals_cache_off(cuda, cache_dtype):
    """Prompts on a shared 32-token prefix with 16-24 token suffixes: the
    hits restore the prefix's rows from the block store and prefill the
    suffix (W8A16 at the suffix's rows); tokens equal the cache off."""
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    model = _tiny_int8_llama(cuda, cache_dtype)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 512, size=32)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, size=n)])
               .astype(np.int32) for n in (16, 20, 24, 17)]
    out = {}
    for on in (True, False):
        eng = ServingEngine(model, max_slots=2, max_seq_len=64,
                            prefix_cache=on)
        first = eng.submit(prompts[0], 6)
        eng.run_until_idle()
        tmm.int8_matmul.launches = 0
        reqs = [first] + [eng.submit(p, 6) for p in prompts[1:]]
        eng.run_until_idle()
        assert tmm.int8_matmul.launches > 0
        out[on] = (eng, [r.tokens for r in reqs])
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_array_equal(a, b)
    assert out[True][0].prefix_cache.stats()["prefix_hits"] == 3


@pytest.mark.parametrize("cache_dtype", ["compute", "int8"])
@pytest.mark.parametrize("suffix", [1, 2])
def test_short_suffix_hit_on_cuda_is_the_whole_prefill(cuda, cache_dtype,
                                                       suffix):
    """A prompt of 16k + 1 and 16k + 2 rows served as a hit of 16k rows at
    blocks of 16 (the prefill starts at ``suffix_prefill_start``, never a
    one-row forward): the slot's K/V rows and the tokens are the cache-off
    engine's bit for bit."""
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    model = _tiny_int8_llama(cuda, cache_dtype)
    rng = np.random.default_rng(21)
    donor = rng.integers(1, 512, size=40).astype(np.int32)
    prompt = np.concatenate([donor[:32], donor[32:32 + suffix] % 511 + 1]
                            ).astype(np.int32)
    out = {}
    for on in (True, False):
        eng = ServingEngine(model, max_slots=2, max_seq_len=64,
                            block_size=16, prefix_cache=on)
        eng.submit(donor, 6)
        eng.run_until_idle()
        req = eng.submit(prompt, 6)
        eng.step()  # the prefill into slot 0 and one decode round
        kv = {(n, k): v[0, :len(prompt)].clone()
              for n, layer in eng._cache.items() for k, v in layer.items()
              if v.dim() >= 2}
        eng.run_until_idle()
        out[on] = (eng, req.tokens, kv)
    assert out[True][0].prefix_cache.stats()["prefix_hits"] == 1
    np.testing.assert_array_equal(out[True][1], out[False][1])
    for key, want in out[False][2].items():
        assert torch.equal(out[True][2][key], want), key


def test_lora_engine_on_cuda(cuda):
    """A bank on the card: adapter 0 gives the no-bank engine's tokens,
    a row in a mixed batch what its adapter gives alone, and the adapters
    move the tokens."""
    from pytorch_distributed_nn_tpu_torch.nn.lora import init_lora_bank
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    model = _tiny_int8_llama(cuda)
    bank = init_lora_bank(model, num_adapters=3, rank=4, scale=0.3,
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (9, 20, 14)]

    def serve(rows, b=bank):
        eng = ServingEngine(model, max_slots=3, max_seq_len=64, lora_bank=b)
        reqs = [eng.submit(p, 6, adapter=a) for a, p in rows]
        eng.run_until_idle()
        return [r.tokens for r in reqs]

    mixed = serve([(1, prompts[0]), (0, prompts[1]), (2, prompts[2])])
    np.testing.assert_array_equal(
        mixed[1], serve([(0, prompts[1])], b=None)[0])
    for (a, p), got in zip([(1, prompts[0]), (2, prompts[2])],
                           (mixed[0], mixed[2])):
        np.testing.assert_array_equal(got, serve([(a, p)])[0])
    base = serve([(0, p) for p in prompts])
    assert any(not np.array_equal(x, y) for x, y in
               zip(serve([(a, p) for a, p in zip((1, 2, 1), prompts)]),
                   base))


def test_block_store_save_and_restore_on_cuda(cuda):
    """The int8 cache's rows and scales through the block store: saved
    blocks come back bit for bit in a row cache."""
    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )
    from pytorch_distributed_nn_tpu_torch.serve import engine as eng

    model = _tiny_int8_llama(cuda, "int8")
    cache = init_cache(model, 3, 64)
    g = torch.Generator(cuda).manual_seed(0)
    for layer in cache.values():
        for k, v in layer.items():
            if v.dim() >= 2:
                v.copy_(torch.randint(-127, 128, v.shape, generator=g,
                                      device=cuda).to(v.dtype))
    store = eng._block_store(cache, 24, 16)
    table = torch.tensor([7, 3, 11], device=cuda)
    eng._save_blocks(cache, store, 1, table)
    row = init_cache(model, 1, 64)
    eng._restore_blocks(row, store, table)
    for name, layer in cache.items():
        for k, v in layer.items():
            if v.dim() >= 2:
                assert torch.equal(row[name][k][0, :48], v[1, :48])
                assert not row[name][k][0, 48:].any()


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


# the shards' global offsets (q_off, k_off) of each pair: the straddling
# pairs' offsets are no multiple of a tile, so part of their rows see no key
RING_PAIRS = {"diagonal": lambda T: (T, T), "past": lambda T: (2 * T, 0),
              "future": lambda T: (0, T), "straddle_future": lambda T: (0, 37),
              "straddle_past": lambda T: (37, 0)}


def _dead_rows(Tq, q_off, k_off, causal):
    """The query rows that no key of the visiting shard is visible to."""
    r = torch.arange(Tq)
    return q_off + r < k_off if causal else torch.zeros(Tq, dtype=torch.bool)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pair", list(RING_PAIRS))
@pytest.mark.parametrize("Tq,Tk,D,hkv", [(64, 64, 128, 4), (200, 200, 128, 2),
                                         (257, 257, 64, 8),
                                         (200, 129, 128, 4)])
def test_ring_block_kernel_matches_plain_version(cuda, Tq, Tk, D, hkv, pair,
                                                 causal):
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    q, k, v, _ = _flash_inputs(cuda, 2, max(Tq, Tk), 8, hkv, D,
                               seed=Tq + D)
    q, k, v = q[:, :Tq], k[:, :Tk], v[:, :Tk]
    q_off, k_off = RING_PAIRS[pair](Tq)
    m, l, acc = _ring_carries(cuda, 2, Tq, 8, D, seed=Tq)
    want = ra.ring_block_reference(q, k, v, m, l, acc, q_off, k_off,
                                   causal=causal)
    before = (m.clone(), l.clone(), acc.clone())
    n = ra.ring_block_update.launches
    got = ra.ring_block_update(q, k, v, m, l, acc, q_off, k_off,
                               causal=causal)
    torch.cuda.synchronize()
    assert ra.ring_block_update.launches == n + 1
    assert got[0] is m and got[1] is l and got[2] is acc  # in place
    # the rows that see no key keep their carries bit for bit (every row of
    # the future pair: no iteration at all)
    dead = _dead_rows(Tq, q_off, k_off, causal).to(cuda)
    assert bool(dead.all()) == (causal and pair == "future")
    for a, b in zip((m, l), before[:2]):
        assert torch.equal(a[:, dead], b[:, dead])
    assert torch.equal(acc[:, dead], before[2][:, dead])
    assert (m - want[0]).abs().max().item() <= LSE_TOL
    assert _rel(l, want[1]) <= FLASH_TOL
    assert _rel(acc, want[2]) <= FLASH_TOL


def test_flash_forward_and_ring_block_are_deterministic(cuda):
    """Two launches on the same inputs give the same bits: every output
    element is summed in a fixed order (no atomics)."""
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    q, k, v, _ = _flash_inputs(cuda, 2, 777, 8, 4, 128, seed=7)
    fwd = [fa.flash_fwd(q, k, v, True) for _ in range(2)]
    ring = []
    for _ in range(2):
        m, l, acc = _ring_carries(cuda, 2, 777, 8, 128, seed=3)
        ring.append(ra.ring_block_update(q, k, v, m, l, acc, 100, 37,
                                         causal=True))
    torch.cuda.synchronize()
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    for a, b in zip(*ring):
        assert torch.equal(a, b)


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


# --------------------------------------------------------------------------
# config 4's transformer LM on the flash kernels at head_dim 64, and the
# overlapped bucket reduce on NCCL at world 1
# --------------------------------------------------------------------------
def _tiny_lm_trainer(cuda, impl):
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    extra = dict(num_layers=2, d_model=128, num_heads=2, mlp_dim=256,
                 vocab_size=512, max_len=256, attn_impl=impl)
    cfg = get_config("transformer_lm_pp", **{
        "model.extra": json.dumps(extra), "data.vocab_size": "512",
        "data.seq_len": "192", "data.batch_size": "4", "log_every": "1",
        "mesh.pipe": "1", "parallel.strategy": "dp"})
    return Trainer(cfg, device=cuda)


def test_tiny_transformer_lm_step_on_flash_at_head_dim_64(cuda):
    """Loss and every gradient with the flash kernels (D = 64) against the
    plain attention from the same seeded weights (limits as the Llama
    step's above; the key biases, whose exact gradient is zero, to the key
    kernel's gradient); two steps launch 2 forwards a layer (remat), one
    dq and one dk/dv."""
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.parallel import dp

    runs = {}
    for impl in ("flash", "xla"):
        t = _tiny_lm_trainer(cuda, impl)
        assert t.model.head_dim == 64
        x, y = t.loader.batch_at(0)
        loss = dp._loss_and_grads(t.state, x, y, t.loss_fn).item()
        runs[impl] = (loss, {n: p.grad.clone()
                             for n, p in t.model.named_parameters()}, t)
        t.state.optimizer.zero_grad()
    (loss_f, grads_f, flash), (loss_x, grads_x, _) = runs["flash"], \
        runs["xla"]
    assert abs(loss_f - loss_x) <= 1e-3 * abs(loss_x)
    for name, gx in grads_x.items():
        if name.endswith("attn.key.bias"):
            # exactly zero (softmax is shift-invariant): rounding noise in
            # both runs, held to the key kernel's gradient
            kernel = grads_x[name[:-4] + "kernel"].abs().max()
            for g in (grads_f[name], gx):
                assert (g.abs().max() / kernel).item() <= TRAIN_GRAD_TOL
            continue
        err = (grads_f[name] - gx).abs().max() / gx.abs().max()
        assert err.item() <= TRAIN_GRAD_TOL, name
    n = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    flash.train(steps=2)
    got = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
           fa.flash_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(got, n)) == (8, 4, 4)
    assert all(np.isfinite(flash.losses()))


@pytest.mark.parametrize("wire", ["", "int8"])
def test_overlap_on_nccl_world_one_is_bitwise(cuda, wire):
    """Tiny bert_base_buckets on dp_explicit with 2 KB buckets, two steps
    with and without overlap from the same seeded weights: parameters
    equal bit for bit; under int8 one quantize launch a f32 bucket a
    step, issued from the backward's hooks, the buckets' chains on the
    reducer's side stream."""
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    extra = dict(num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
                 vocab_size=512, max_len=64)
    out = {}
    for overlap in (False, True):
        cfg = get_config("bert_base_buckets", **{
            "model.extra": json.dumps(extra), "data.vocab_size": "512",
            "data.seq_len": "64", "data.batch_size": "8", "log_every": "1",
            "parallel.bucket_mb": "0.01", "parallel.overlap": str(overlap),
            "parallel.quantized_allreduce": wire})
        t = Trainer(cfg, device=cuda)
        assert t.process.backend == "nccl" and t.process.world_size == 1
        before = tq.quantize_int8.launches
        t.train(steps=2)
        torch.cuda.synchronize()
        out[overlap] = ({k: v.clone() for k, v in
                         t.model.state_dict().items()},
                        tq.quantize_int8.launches - before)
        if overlap:
            reducer = t.step_fn.reducer(t.state)
            assert reducer.stream is not None
            assert reducer.stream != torch.cuda.current_stream()
            last = reducer.last
            assert last["buckets"] > 2
            assert last["bytes_before_last_hook"] > 0
    for k, v in out[False][0].items():
        assert torch.equal(out[True][0][k], v), k
    if wire == "int8":
        assert out[True][1] == out[False][1] == 2 * last["buckets"]
    else:
        assert out[True][1] == out[False][1] == 0


# --------------------------------------------------------------------------
# the trainer features on the card: CUDA graphs, offload, async saves
# --------------------------------------------------------------------------

def _tiny_resnet_cfg(**ov):
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config

    extra = dict(stage_sizes=[1, 1, 1, 1], width=8, num_classes=10,
                 bn_impl="pallas")
    return get_config("resnet50_dp", **{
        "model.extra": json.dumps(extra), "data.dataset": "cifar10",
        "data.batch_size": "16", "log_every": "1", "steps": "8",
        "optim.warmup_steps": "3", **ov})


@pytest.mark.parametrize("pool", ["0", "2"])
def test_graph_captured_steps_are_bitwise_the_eager_steps(cuda, pool):
    """8 steps of the tiny ResNet (bn_stats kernels, momentum, warmup and
    cosine lr) as two replays of a captured 4-step graph against 8 eager
    steps on the same batches: losses and state bit for bit."""
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    pooled = {"multistep_pool": pool}
    eager = Trainer(_tiny_resnet_cfg(), device=cuda)
    if pool != "0":  # the same two batches, cycled
        xs, ys = eager.loader.stacked_batch_at(0, 2)
        eager_losses = []
        for i in range(8):
            eager.state, m = eager.step_fn(eager.state, xs[i % 2], ys[i % 2])
            eager_losses.append(m["loss"].item())
    else:
        eager.train()
        eager_losses = eager.losses()
    n = bn_stats.sum_and_sumsq.launches
    graph = Trainer(_tiny_resnet_cfg(multistep_k="4", **pooled), device=cuda)
    graph.train()
    run = graph._multisteps[4]
    assert run.replays == 2
    n_bn = len(graph.model.batch_norms())
    # one eager warm-up step and one capture of 4 steps
    assert bn_stats.sum_and_sumsq.launches - n == 5 * n_bn
    assert graph.losses() == eager_losses
    for k, v in eager.state.state_dict().items():
        assert torch.equal(graph.state.state_dict()[k].cpu(), v.cpu()), k


@pytest.mark.parametrize("blocker", ["int8 wire", "remat_offload"])
def test_a_step_that_cannot_be_captured_raises(cuda, blocker):
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    if blocker == "int8 wire":
        cfg = _tiny_resnet_cfg(**{
            "multistep_k": "2", "parallel.strategy": "dp_explicit",
            "parallel.quantized_allreduce": "int8"})
    else:
        cfg = _tiny_llama_cfg(**{"multistep_k": "2",
                                 "model.remat_offload": "true"})
    t = Trainer(cfg, device=cuda)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        t.train()
    assert t.data_step == 0 and t.state.step == 0  # nothing ran


def _tiny_llama_cfg(**ov):
    from pytorch_distributed_nn_tpu_torch.config import get_config

    extra = ('{"num_layers": 2, "d_model": 128, "num_heads": 2, '
             '"num_kv_heads": 1, "mlp_dim": 256, "vocab_size": 512}')
    return get_config("llama3_longcontext", **{
        "model.extra": extra, "data.vocab_size": "512",
        "data.seq_len": "1024", "xent_chunk": "256", "steps": "4",
        "log_every": "1", **ov})


def test_offload_keeps_pinned_boundaries_and_the_remat_result(cuda):
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    runs = {}
    for offload in (False, True):
        t = Trainer(_tiny_llama_cfg(**{"model.remat_offload": str(offload)}),
                    device=cuda)
        t.train(steps=2)
        torch.cuda.synchronize()
        runs[offload] = (t.losses(), {k: v.clone() for k, v in
                                      t.model.state_dict().items()},
                         dict(t.model.offloaded))
    assert runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k
    off = runs[True][2]
    assert off["tensors"] == 2 and off["pinned"]
    assert off["bytes"] == 2 * 1024 * 128 * 2  # (B, T, D) bf16 a block


def test_an_async_save_on_the_card_holds_its_step(cuda, tmp_path):
    """Save at step 2 and update in place at once: the side stream's copy
    must hold step 2, and a trainer resumed from it trains on as the
    straight run does, bit for bit."""
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    straight = Trainer(_tiny_llama_cfg(), device=cuda)
    straight.train()
    cfg = _tiny_llama_cfg(checkpoint_dir=str(tmp_path))
    with Trainer(cfg, device=cuda) as t:
        t.train(steps=2)
        assert t.save_checkpoint()
        t.train(steps=2)
    with Trainer(cfg, device=cuda) as resumed:
        assert resumed.data_step == 2
        resumed.train()
    assert resumed.losses() == straight.losses()[2:]
    for k, v in straight.state.state_dict().items():
        assert torch.equal(resumed.state.state_dict()[k].cpu(), v.cpu()), k


@pytest.mark.parametrize("preset", ["llama3_longcontext", "transformer_lm_pp"])
def test_lm_steps_as_a_graph_are_bitwise_the_eager_steps(cuda, preset):
    """The LMs' steps (remat's checkpoint, the flash kernels' autograd
    functions, the chunked loss) capture too: 4 steps as two replays of a
    2-step graph against 4 eager steps, bit for bit."""
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    if preset == "llama3_longcontext":
        ov = {"model.extra": ('{"num_layers": 2, "d_model": 128, '
                              '"num_heads": 2, "num_kv_heads": 1, '
                              '"mlp_dim": 256, "vocab_size": 512}'),
              "data.vocab_size": "512", "data.seq_len": "1024",
              "xent_chunk": "256"}
    else:
        ov = {"mesh.pipe": "1", "parallel.strategy": "dp",
              "data.batch_size": "4", "data.seq_len": "256",
              "data.vocab_size": "512", "model.extra": json.dumps(dict(
                  num_layers=2, d_model=128, num_heads=2, mlp_dim=256,
                  vocab_size=512, max_len=256))}
    losses, states = {}, {}
    for k in ("1", "2"):
        t = Trainer(get_config(preset, steps="4", log_every="1",
                               multistep_k=k, **ov), device=cuda)
        t.train()
        losses[k], states[k] = t.losses(), t.state.state_dict()
    assert losses["2"] == losses["1"]
    for name, v in states["1"].items():
        assert torch.equal(states["2"][name].cpu(), v.cpu()), name


def test_token_file_batches_on_the_card_are_the_memmap_windows(cuda,
                                                                tmp_path):
    """The transformer LM from a uint16 token file (holdout 0.1): the
    loader's device batches of two training steps and an evaluation step
    equal the memmap's windows bit for bit (the starts drawn by
    default_rng(SeedSequence([seed, step])), the eval ones from the tail);
    two steps on the flash kernels, finite losses."""
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.data.datasets import (
        EVAL_STEP_OFFSET,
    )
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    B, T, n, holdout = 4, 192, 50000, 0.1
    tokens = np.random.default_rng(0).integers(0, 512, n, dtype=np.uint16)
    path = tmp_path / "tokens.bin"
    tokens.tofile(path)
    extra = dict(num_layers=2, d_model=128, num_heads=2, mlp_dim=256,
                 vocab_size=512, max_len=256)
    t = Trainer(get_config("transformer_lm_pp", **{
        "model.extra": json.dumps(extra), "data.vocab_size": "512",
        "data.seq_len": str(T), "data.batch_size": str(B),
        "data.dataset": "token_file", "data.path": str(path),
        "data.holdout_frac": str(holdout), "log_every": "1",
        "mesh.pipe": "1", "parallel.strategy": "dp"}), device=cuda)
    tail = n - int(n * holdout)
    for step in (0, 1, EVAL_STEP_OFFSET):
        lo, hi = ((tail, n - T) if step >= EVAL_STEP_OFFSET
                  else (0, tail - T))
        starts = np.random.default_rng(np.random.SeedSequence(
            [t.cfg.seed, step])).integers(lo, hi, size=B)
        rows = np.stack([tokens[s:s + T + 1] for s in starts]).astype(
            np.int32)
        x, y = t.loader.batch_at(step)
        assert x.is_cuda and y.is_cuda
        assert torch.equal(x.cpu(), torch.from_numpy(rows[:, :-1]))
        assert torch.equal(y.cpu(), torch.from_numpy(rows[:, 1:]))
    before = fa.flash_fwd.launches
    t.train(steps=2)
    assert fa.flash_fwd.launches - before == 8  # 2 layers, remat, 2 steps
    assert all(np.isfinite(t.losses()))
    assert np.isfinite(t.evaluate(num_batches=2).loss)


@pytest.mark.parametrize("schedule,pipe,chunks,moe_every", [
    ("1f1b", 4, 1, 1), ("interleaved", 2, 2, 2)])
def test_moe_pipeline_first_loss_matches_the_dp_step(cuda, schedule, pipe,
                                                     chunks, moe_every):
    """A tiny MoE LM (head_dim 64, T 256: flash in bf16) under the
    pipeline, every stage in this process, against the dp step from the
    same weights and batch: the first loss, load-balance terms included,
    within 1e-3 relative (bf16 products over other row counts); one flash
    forward, dq and dk/dv a layer a microbatch."""
    import json

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    L, M = 8, 4
    extra = dict(num_layers=L, d_model=128, num_heads=2, mlp_dim=256,
                 vocab_size=512, max_len=256, num_experts=4,
                 group_size=256, moe_every=moe_every)
    ov = {"model.extra": json.dumps(extra), "data.vocab_size": "512",
          "data.seq_len": "256", "data.batch_size": "8", "log_every": "1"}
    ref = Trainer(get_config("moe_lm_ep", **ov), device=cuda)
    init = {k: v.detach().clone() for k, v in ref.model.state_dict().items()}
    ref.train(steps=1)
    t = Trainer(get_config("moe_lm_ep", **ov, **{
        "parallel.strategy": "pipeline", "mesh.pipe": str(pipe),
        "mesh.expert": "1", "parallel.microbatches": str(M),
        "parallel.pipeline_schedule": schedule,
        "parallel.pipe_chunks": str(chunks)}), device=cuda, params=init)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    t.train(steps=1)
    after = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
             fa.flash_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (L * M,) * 3
    got, want = t.losses()[0], ref.losses()[0]
    assert np.isfinite(got) and abs(got - want) <= 1e-3 * abs(want)


def _float_model(cuda, name):
    from pytorch_distributed_nn_tpu_torch.config import ModelConfig
    from pytorch_distributed_nn_tpu_torch.models import get_model

    extra = (dict(num_layers=2, d_model=1024, num_heads=8, num_kv_heads=4,
                  mlp_dim=2816, vocab_size=4096) if name == "llama3_8b"
             else dict(num_layers=2, d_model=768, num_heads=12,
                       mlp_dim=3072, vocab_size=4096, max_len=256))
    model = get_model(ModelConfig(name=name, compute_dtype="bfloat16",
                                  extra=extra), device=cuda)
    return model.init_params(seed=16).eval()


@pytest.mark.parametrize("name", ["llama3_8b", "transformer_lm"])
def test_float_engine_rows_are_solo_generate_logits_on_cuda(cuda, name):
    """ROADMAP §3 fault 1: a float bf16 model's greedy rows in engines of
    1, 3 and 8 slots give, for every request, a solo ``generate()``'s
    next-token logits bit for bit and its tokens (the decode step's dense
    products run on fixed row blocks, ``nn.layers.dense_product``)."""
    from chip_smoke import f1_engine_logits, f1_solo_logits

    model = _float_model(cuda, name)
    rng = np.random.default_rng(16)
    for slots in (1, 3, 8):
        prompts = [rng.integers(0, 4096, size=int(n)).astype(np.int32)
                   for n in rng.integers(5, 120, size=slots)]
        for p, (logits, toks) in zip(prompts,
                                     f1_engine_logits(model, prompts, slots)):
            ref, ref_toks = f1_solo_logits(model, p)
            np.testing.assert_array_equal(toks, ref_toks)
            assert len(logits) == len(ref) == 8
            for step, (a, b) in enumerate(zip(logits, ref)):
                assert torch.equal(a, b), (slots, step,
                                           (a - b).abs().max().item())


def test_int8_cache_engine_rows_are_solo_generate_logits_on_cuda(cuda):
    """ROADMAP §3 item 5: the int8 8B at full width and 16 of 32 layers on
    the int8 KV cache, phase 7's greedy prompts through an engine of 8
    slots (prefix cache on, two admissions a round, 32 tokens each): every
    request's next-token logits are a solo ``generate()``'s bit for bit.
    Before the norms' statistics ran on fixed row blocks
    (``nn.layers.row_mean``) a request parted from it at a decode round's
    RMSNorm, whose library mean sums in an order set by the number of
    rows."""
    import chip_smoke as cs

    model = cs.twin(cs.build_model(seed=0, layers=16), "bfloat16", "int8")
    prompts = cs.mix_prompts(3)
    greedy = [prompts[n] for n, kw, _ in cs.SERVE_MIX if kw is None]
    served = cs.f1_engine_logits(model, greedy, 8, n_new=32,
                                 prefix_cache=True,
                                 max_prefills_per_round=2)
    for i, (p, (logits, toks)) in enumerate(zip(greedy, served)):
        ref, ref_toks = cs.f1_solo_logits(model, p, n_new=32)
        np.testing.assert_array_equal(toks, ref_toks)
        assert len(logits) == len(ref) == 32
        for step, (a, b) in enumerate(zip(logits, ref)):
            assert torch.equal(a, b), (i, step, (a - b).abs().max().item())


def test_scripts_and_metrics_out_on_cuda(cuda, tmp_path, capsys):
    """The new entry points on the card: an HF-layout state_dict of a tiny
    float Llama (the port's own export) converted on the CPU, then
    ``generate`` (its tokens ``generate()``'s on the weights in memory),
    ``eval`` (its line the Trainer's) and the serve entry point with
    ``--metrics-out`` (one serve_request a finished request, one
    serve_summary), each on ``cuda`` by default."""
    import json

    from pytorch_distributed_nn_tpu_torch.config import ModelConfig, \
        get_config
    from pytorch_distributed_nn_tpu_torch.inference.generate import generate
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
    from pytorch_distributed_nn_tpu_torch.scripts import convert
    from pytorch_distributed_nn_tpu_torch.scripts import eval as evals
    from pytorch_distributed_nn_tpu_torch.scripts import generate as gen
    from pytorch_distributed_nn_tpu_torch.serve import __main__ as serve_main
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils import torch_interop as ti
    from pytorch_distributed_nn_tpu_torch.utils.interop import (
        vision_params_to_jax,
    )

    extra = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                 mlp_dim=256, vocab_size=512)
    src = get_model(ModelConfig(name="llama3_8b", extra=extra),
                    device="cpu").init_params(seed=3)
    sd = ti.llama_params_to_torch(vision_params_to_jax(src.state_dict())[0])
    pt = tmp_path / "llama.pt"
    torch.save(sd, pt)
    ov = ["--model.extra", json.dumps(extra), "--data.vocab_size", "512",
          "--data.seq_len", "128", "--data.batch_size", "2"]
    ckpt = str(tmp_path / "ckpt")
    bootstrap.shutdown()  # the conversion's CPU Trainer joins gloo
    assert convert.main(["--arch", "llama3", "--preset", "llama3_8b_zero",
                         "--torch-checkpoint", str(pt), "--out", ckpt,
                         *ov]) == 0
    capsys.readouterr()
    assert gen.main(["--preset", "llama3_8b_zero", "--checkpoint-dir",
                     ckpt, "--prompt", "5 9 42 7", "--max-new", "6",
                     *ov]) == 0
    got = [int(t) for t in capsys.readouterr().out.split()]
    model = get_model(ModelConfig(name="llama3_8b", extra=extra),
                      device=cuda)
    model.load_state_dict({k: v.to(cuda) for k, v in
                           src.state_dict().items()})
    want = generate(model.eval(), np.asarray([[5, 9, 42, 7]]), 6)
    assert got == want.cpu().numpy()[0].tolist()
    assert evals.main(["--preset", "llama3_8b_zero", "--checkpoint-dir",
                       ckpt, "--batches", "2", *ov]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    overrides = {k[2:]: v for k, v in zip(ov[0::2], ov[1::2])}
    try:
        with Trainer(get_config("llama3_8b_zero", **overrides,
                                checkpoint_dir=ckpt), device=cuda) as t:
            rec = t.evaluate(num_batches=2)
    finally:
        bootstrap.shutdown()
    assert line == dict(step=-1, eval_loss=round(rec.loss, 6),
                        eval_accuracy=round(rec.accuracy, 6), batches=2)
    path = tmp_path / "serve.jsonl"
    assert serve_main.main(["--preset", "llama3_8b_zero", "--checkpoint-dir",
                            ckpt, "--requests", "4", "--rate", "100",
                            "--max-new", "4", "--metrics-out", str(path),
                            *ov]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert sum(r["event"] == "serve_summary" for r in recs) == 1
    assert sum(r["event"] == "serve_request" for r in recs) > \
        summary["completed"] == 4


@pytest.mark.parametrize("B,T,H,Hkv,D", [(1, 4096, 16, 4, 128),
                                          (4, 1024, 6, 6, 64)])
def test_flash_kernels_at_tensor_shard_heads(cuda, B, T, H, Hkv, D):
    """The flash kernels at the heads a tensor = 2 rank runs (config 5's
    32/8 heads of 128 as 16/4, config 4's 12 heads of 64 as 6), on the
    slice of the whole heads the rank holds (a view of the whole q/k/v,
    made contiguous as the attention's projections give it), against
    their plain versions."""
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(cuda, B, T, 2 * H, 2 * Hkv, D, seed=H)
    q, do = q[:, :, H:].contiguous(), do[:, :, H:].contiguous()
    k, v = k[:, :, Hkv:].contiguous(), v[:, :, Hkv:].contiguous()
    o, lse = fa.flash_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                True)
    torch.cuda.synchronize()
    assert _rel(o, o_ref) <= FLASH_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert _rel(got, ref) <= FLASH_TOL


_TP_WORKER = r"""
import json, os, sys
import torch
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out, ov = sys.argv[1], json.loads(sys.argv[2])
if int(os.environ["WORLD_SIZE"]) > 1:
    # ranks sharing the card: their own gloo group, which the Trainer keeps
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo")
t = Trainer(get_config("transformer_lm_pp", **ov), device="cuda")
before = fa.flash_fwd.launches
t.train()
res = {"losses": t.losses(), "backend": torch.distributed.get_backend(),
       "device": str(t.device), "flash_fwd": fa.flash_fwd.launches - before,
       "split": sorted(getattr(t.model, "tensor_split", None) or {})}
if t.is_coordinator:
    with open(out, "w") as f:
        json.dump(res, f)
t.close()
bootstrap.shutdown()
"""


def test_tensor_ranks_sharing_the_card_train_as_one_process(cuda, tmp_path):
    """Two processes on one card (a gloo group they form themselves, on
    CUDA tensors, both on cuda:0) train the LM at tensor 2 on the flash
    kernels at 2 heads of 64 a rank, and give the one-process losses; the
    pipeline over pipe 2 x tensor 2 holds both stages in each process."""
    import json
    import os
    import subprocess
    import sys

    if torch.cuda.device_count() != 1:
        pytest.skip("the shared-card path is for one card")
    extra = {"num_layers": 2, "d_model": 256, "num_heads": 4, "mlp_dim": 512,
             "vocab_size": 256, "max_len": 256}
    # no warmup: the second loss follows a real update
    base = {"steps": "2", "log_every": "1", "data.batch_size": "4",
            "optim.warmup_steps": "0",
            "data.seq_len": "256", "data.vocab_size": "256",
            "model.extra": json.dumps(extra), "mesh.pipe": "1",
            "parallel.strategy": "dp"}
    script = tmp_path / "worker.py"
    script.write_text(_TP_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    results = {}
    for name, nproc, ov in (
            ("one", 1, base), ("tp2", 2, dict(base, **{"mesh.tensor": "2"})),
            ("pp_tp", 2, dict(base, **{
                "mesh.tensor": "2", "mesh.pipe": "2",
                "parallel.strategy": "pipeline",
                "parallel.microbatches": "2",
                "parallel.pipeline_schedule": "1f1b"}))):
        out = tmp_path / f"{name}.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), str(script), str(out),
               json.dumps(ov)]
        run = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                             text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-3000:]
        results[name] = json.loads(out.read_text())
    assert results["tp2"]["backend"] == "gloo"
    assert results["tp2"]["device"] == "cuda:0"
    assert results["one"]["backend"] == "nccl"
    assert results["tp2"]["flash_fwd"] == 2 * 2 * 2  # layers x steps x 2
    assert results["tp2"]["split"]
    # measured on the H100: 7.5e-6 and 1.3e-5 at the two steps
    np.testing.assert_allclose(results["tp2"]["losses"],
                               results["one"]["losses"], rtol=1e-4)
    np.testing.assert_allclose(results["pp_tp"]["losses"],
                               results["one"]["losses"], rtol=1e-4)

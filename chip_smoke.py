#!/usr/bin/env python
"""On-card smoke test of the PyTorch port (pytorch_distributed_nn_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   -- nvcc builds the five csrc/*.cu (int8_matmul, flash_attention,
              bn_stats, quantize, ring_attention) for sm_90a, one nvcc each,
              started together; prints seconds and the compiler's
              register/spill report.
2. kernel  -- int8_matmul (the W8A16 CUDA kernel) against its plain PyTorch
              version at every (K, N) of the Llama-3-8B path, M in
              {1, 8, 128}; times the kernel, the plain version and one
              library call with CUDA events (L2 flushed before each launch:
              the decode path reads every weight cold).
3. flash   -- the three flash-attention kernels (forward, dq pass, dk/dv
              pass) at the long-context shapes (B 1, H 8, Hkv 4, D 128,
              causal, bf16) against their plain versions: in full at
              T = 4096, on row slices at T = 32768; times each kernel, its
              plain version and F.scaled_dot_product_attention at T = 32768.
4. auto    -- one layer's attention forward + backward, flash against the
              plain path, at T from 128 to 4096: the sweep behind
              nn/attention.py's FLASH_MIN_T.
5. train   -- llama3_longcontext at full width (8 layers, d 1024, vocab
              32000) through Trainer: at T = 4096 one step's loss and every
              gradient with the kernels against the plain attention; then
              the main path, the preset as it is (T = 32768) for 4 steps
              with the flash counts reset just before and read just after
              (16 forward, 8 dq and 8 dk/dv launches a step), finite losses,
              step time, tokens/s, MFU and peak memory; one more step under
              torch.profiler for the device-time breakdown.
6. forward -- the full-width quantized Llama-3-8B (32 layers, d 4096, vocab
              128256, seeded synthetic int8 weights): one prefill and 4
              teacher-forced decode steps with the kernel (129 launches per
              forward), again with every kernel call held against the plain
              version on its own live activations, and again with the plain
              version swapped in; the logits must agree, and the greedy
              token must agree on every row where the plain top-2 margin is
              decisive.
7. serve   -- the serving path: InferenceServer(ServingEngine(...)) with 8
              slots answers 16 ragged requests (prompts 16-128 tokens, 32
              new tokens each); launch counts are reset just before and
              read just after; three requests' tokens must equal a solo
              sequential generate() of their prompts.

The data-parallel slice (run after phase 3, and after phase 5):

8. bn_stats -- the BatchNorm-statistics kernel at ResNet-50's largest and
              smallest BatchNorm at batch 256 and one ragged M, bf16 and
              f32, kernel and plain version against an f64 sum (1e-5 of
              sum|term| per channel), bitwise repeatable; one training
              step's 53 + 53 calls timed for the kernel, the plain version
              and torch.batch_norm_stats / batch_norm_backward_reduce.
9. quantize -- the stochastic int8 kernel on a 25 MB bucket and on the
              whole ResNet-50 gradient: bit for bit its plain version,
              |q scale - x| < scale, mean error within 4 sigma, saturation;
              one step's buckets timed for the kernel and the plain version.
10. dp_check -- one full-width ResNet-50 step at batch 256, bn_stats kernel
              against the torch reductions: loss and every gradient.
11. dp_train -- the main path: resnet50_dp with parallel.strategy
              dp_explicit, the int8 wire and bn_impl pallas, batch 256 on
              one card (NCCL, world 1): 2 warm-up and 4 timed steps with the
              counts reset just before and read just after (53 + 53
              bn_stats and one quantize a bucket a step), images/s, MFU,
              peak memory, loader wait, bytes a step on each wire; one step
              under torch.profiler.
12. dp_preset -- resnet50_dp as it is (dp, flax BatchNorm, exact reduce) at
              batch 256, and mlp_mnist as it is for 20 steps.

The sequence-parallel slice (ring attention; phase 13 runs after phase 3,
phase 14 after phase 5's check step, phases 15 and 16 after phase 5):

13. ring      -- the ring block kernel at the long-context shapes (B 1, H 8,
              Hkv 4, D 128, bf16): (a) against its plain version at Tl = 8192
              on a diagonal, a past and a future pair with random incoming
              carries (the future pair's carries bit for bit untouched);
              (b) the 16 (query shard, visiting shard) pairs of a seq = 4
              ring at T = 32768 replayed in ring order through the ring's
              own per-pair steps (parallel/sequence.py: ring_order,
              ring_forward_pair, ring_finish), the assembled output and lse
              against flash_fwd at T = 32768; (c) the same 16 pairs through
              its ring_backward_pair (flash dq and dk/dv with f32 outputs;
              diagonal causal, past dense, future skipped), the summed dq,
              dk, dv against the full-T flash backward; (d) the main path's
              pairs at world 1 against the plain versions: the kernel with
              fresh and with random carries at Tl = 32768 (every row) and
              98304 (the first and last 512 rows), and the pair's f32 dq and
              dk/dv on 512-row slices; (e) times of the kernel at Tl = 32768
              (the world-1 main path's one pair) and at Tl = 8192 (diagonal,
              past), its plain version, its bound and the nearest library
              call (F.scaled_dot_product_attention on the same pair).
14. ring_check -- one full-width llama3_longcontext step at T = 4096 from
              the same weights and batch: attn_impl ring and ulysses against
              flash, loss and every gradient.
15. ring_train -- the main path: llama3_longcontext as it is (T = 32768)
              with model.extra.attn_impl = ring through Trainer on NCCL at
              world 1, 4 steps, the launch counts reset just before and read
              just after (16 ring_block_update, 8 flash_bwd_dq, 8
              flash_bwd_dkv and no flash_fwd a step), one more step under
              torch.profiler; then 2 steps of llama3_longcontext_96k
              (T = 98304) on the same path.
16. ring4     -- only on a machine with 4 or more cards: the train entry
              point under torchrun on 4 ranks with mesh.seq = 4, 2 steps with
              ring and 2 with Ulysses attention, the losses against the
              world-1 run's.

The last three lines of standard output are the kernels JSON line, the
card's name and power limit from nvidia-smi, and the result JSON line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

TPU_KERNEL = "pytorch_distributed_nn_tpu/ops/pallas/int8_matmul.py:72"
SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/int8_matmul.cu"
FLASH_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "pytorch_distributed_nn_tpu/ops/pallas/flash_attention.py"
# kernel -> (TPU kernel body it replaces, causal FLOPs per head / (T^2 D))
FLASH_KERNELS = {"flash_fwd": (f"{FLASH_TPU}:56", 2),
                 "flash_bwd_dq": (f"{FLASH_TPU}:227", 3),
                 "flash_bwd_dkv": (f"{FLASH_TPU}:257", 4)}
# the long-context preset's attention: B 1, 8 query heads, 4 K/V heads, D 128
FLASH_B, FLASH_H, FLASH_HKV, FLASH_D = 1, 8, 4, 128
# flash kernel vs plain version. The kernels round p (and ds) to bf16 for
# the tensor cores and write bf16 outputs; the plain versions keep f32:
# O, dq, dk and dv agree to a few bf16 steps of the largest output.
# lse is f32 statistics of the same inputs (absolute limit).
FLASH_TOL = 2e-2
LSE_TOL = 1e-4
# one full-width training step at T = 4096, flash kernels vs the plain
# attention from the same weights and batch: the two round to bf16 at
# other places (p and ds for the tensor cores; the plain path's bf16
# probabilities), and 8 layers carry the differences into every gradient
TRAIN_LOSS_TOL = 1e-3  # relative
TRAIN_GRAD_TOL = 5e-2  # max|err| / max|ref|, per parameter
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
V = 128256  # Llama-3 vocabulary
# the (K, N) of every int8 matmul on the fused 8B path, and the count of
# each in one forward (32 layers of qkv/out/gate_up/down + the lm_head)
PATH_SHAPES = [("qkv", 4096, 6144, 32), ("out", 4096, 4096, 32),
               ("gate_up", 4096, 28672, 32), ("down", 14336, 4096, 32),
               ("lm_head", 4096, 128256, 1)]
# kernel vs plain version: the same f32 products summed in another order;
# a bf16 output may round to the neighbouring bf16 value
TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
# full-width logits, kernel vs plain version, max|diff| over the largest
# logit. The two differ in summation order only, but 32 layers of random
# weights amplify rounding-order noise: an element that rounds to the
# neighbouring bf16 value in one run and not the other grows to a few
# percent of the logits (measured on an H100: 4.3e-2 in bf16 compute,
# 9.8e-3 in f32 compute). The per-call check of phase 3 holds every launch
# to TOL on the model's own activations, where that noise has not grown.
LOGIT_TOL = {"bfloat16": 8e-2, "float32": 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, flush=None):
    """Median milliseconds of ``fn`` by CUDA events, one warm-up call
    first, the L2 cache flushed (``flush`` zeroed) before every timed
    launch when ``flush`` is given."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in pairs:
        if flush is not None:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    ts = sorted(e0.elapsed_time(e1) for e0, e1 in pairs)
    return ts[len(ts) // 2]


def library_call(x, q, s, out_dtype):
    """The yardstick (never used by the port): torch._weight_int8pack_mm
    where this PyTorch has it on CUDA, else a bf16 matmul against weights
    dequantized ahead of time. Returns (label, fn)."""
    import torch

    wt = q.t().contiguous()  # (N, K) int8
    sc = s.reshape(-1).to(torch.bfloat16)
    op = getattr(torch, "_weight_int8pack_mm", None)
    if op is not None:
        try:
            op(x[:1], wt, sc)
            torch.cuda.synchronize()
            return "torch._weight_int8pack_mm", lambda: op(x, wt, sc)
        except (RuntimeError, NotImplementedError):
            pass
    w = (q.to(torch.float32) * s).to(torch.bfloat16)
    return ("torch.matmul(bf16 x, bf16 weights dequantized ahead)",
            lambda: torch.matmul(x, w))


def phase_kernel(flush):
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    rows, max_err, library_label = [], 0.0, None
    for name, k, n, per_fwd in PATH_SHAPES:
        kp, np_ = tmm.padded_kn(k, n)
        q = torch.empty((kp, np_), dtype=torch.int8, device=dev)
        q.random_(-64, 64, generator=g)
        s = torch.full((1, np_), 2.7e-4, device=dev)
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        dt = "float32" if name == "lm_head" else "bfloat16"
        for m in (1, 8, 128):
            x = torch.randn((m, kp), generator=g, device=dev).to(
                torch.bfloat16)
            got = tmm.int8_matmul(x, q, s, out_dtype=out_dtype)
            ref = tmm.int8_matmul_reference(x, q, s, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= TOL[dt] * scale:
                raise AssertionError(
                    f"int8_matmul {name} M={m}: max|err| {err} > "
                    f"{TOL[dt]} * max|ref| {scale}")
            max_err = max(max_err, err)
            ms = time_ms(lambda: tmm.int8_matmul(x, q, s, out_dtype),
                         20, flush)
            plain_ms = time_ms(
                lambda: tmm.int8_matmul_reference(x, q, s, out_dtype),
                3, flush)
            library_label, lib_fn = library_call(x, q, s, out_dtype)
            library_ms = time_ms(lib_fn, 20, flush)
            nbytes = (x.numel() * 2 + q.numel() + s.numel() * 4
                      + m * np_ * got.element_size())
            ops = 2 * m * kp * np_
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / BF16_OPS_PER_S * 1e3
            row = dict(shape=name, m=m, k=kp, n=np_, per_forward=per_fwd,
                       out=dt, max_abs_err=err, max_abs_ref=scale, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       gbytes_per_s=nbytes / ms / 1e6)
            rows.append(row)
            log(f"[kernel] {json.dumps(row)}")
            del got, ref, lib_fn
        del q, s
        torch.cuda.empty_cache()
    log(f"[kernel] library yardstick: {library_label}")
    return rows, max_err, library_label


def flash_inputs(T, seed):
    """q, k, v, dO of the long-context attention, bf16 on the card."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)

    def r(h):
        return torch.randn((FLASH_B, T, h, FLASH_D), generator=g,
                           device="cuda").to(torch.bfloat16)

    return r(FLASH_H), r(FLASH_HKV), r(FLASH_HKV), r(FLASH_H)


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def flash_check(name, got, ref, tol=FLASH_TOL):
    err = rel_err(got, ref)
    if not err <= tol:
        raise AssertionError(f"{name}: max|err|/max|ref| {err} > {tol}")
    return (got.float() - ref.float()).abs().max().item()


def flash_bound_ms(name, T):
    """max(operations / bf16 peak, bytes / HBM rate) of one call: causal
    FLOPs per head from FLASH_KERNELS; each input read once, each output
    written once."""
    n_q = FLASH_B * T * FLASH_H * FLASH_D * 2  # bf16 bytes of q (or dO, O)
    n_kv = FLASH_B * T * FLASH_HKV * FLASH_D * 2
    n_stat = FLASH_B * FLASH_H * T * 4  # f32 lse or delta
    nbytes = {"flash_fwd": 2 * n_q + 2 * n_kv + n_stat,  # q k v -> O lse
              "flash_bwd_dq": 3 * n_q + 2 * n_kv + 2 * n_stat,
              "flash_bwd_dkv": 2 * n_q + 4 * n_kv + 2 * n_stat}[name]
    ops = FLASH_KERNELS[name][1] * FLASH_B * FLASH_H * T * T * FLASH_D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_once_ms(fn):
    """Milliseconds of one call of ``fn`` by CUDA events (for the plain
    versions, which are slow and large)."""
    import torch

    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def phase_flash(flush):
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    errs = {name: 0.0 for name in FLASH_KERNELS}
    # T = 4096: every output in full against the plain versions
    T = 4096
    q, k, v, do = flash_inputs(T, seed=0)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True)
    errs["flash_fwd"] = flash_check("flash_fwd O, T=4096", o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse, T=4096: {lse_err} > {LSE_TOL}")
    args = (q, k, v, do, lse, delta, True)
    errs["flash_bwd_dq"] = flash_check(
        "flash_bwd_dq, T=4096", dq, fa.flash_bwd_dq_reference(*args))
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args)
    errs["flash_bwd_dkv"] = max(flash_check("flash_bwd_dkv dk, T=4096", dk,
                                            dk_ref),
                                flash_check("flash_bwd_dkv dv, T=4096", dv,
                                            dv_ref))
    log(f"[flash] T=4096 in full: max|err| {errs}, lse {lse_err:.3e}")
    del o_ref, lse_ref, dk_ref, dv_ref
    torch.cuda.empty_cache()

    # T = 32768: the last 512 query rows (they see every key) for O, lse
    # and dq; the first and last 512-key tiles for dk and dv
    T = 32768
    q, k, v, do = flash_inputs(T, seed=1)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    last = slice(T - 512, T)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True, q_rows=last)
    errs["flash_fwd"] = max(errs["flash_fwd"], flash_check(
        "flash_fwd O, T=32768", o[:, last], o_ref))
    lse_err = max(lse_err, (lse[:, last] - lse_ref).abs().max().item())
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse, T=32768: {lse_err} > {LSE_TOL}")
    errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], flash_check(
        "flash_bwd_dq, T=32768", dq[:, last],
        fa.flash_bwd_dq_reference(*args, q_rows=last)))
    for rows in (slice(0, 512), last):
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args, k_rows=rows)
        errs["flash_bwd_dkv"] = max(
            errs["flash_bwd_dkv"],
            flash_check(f"flash_bwd_dkv dk rows {rows}", dk[:, rows], dk_ref),
            flash_check(f"flash_bwd_dkv dv rows {rows}", dv[:, rows], dv_ref))
    del o_ref, lse_ref, dk_ref, dv_ref
    torch.cuda.empty_cache()
    log(f"[flash] T=32768 on row slices: max|err| {errs}, lse {lse_err:.3e}")

    # times at T = 32768: the kernels (median of 10), their plain versions
    # (the whole output, 2048 rows at a time, one run), the library call
    kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*args)}
    step = 2048

    def plain_rows(fn):
        def run():
            for r0 in range(0, T, step):
                fn(slice(r0, r0 + step))
        return run

    plain = {
        "flash_fwd": lambda r: fa.flash_forward_reference(
            q, k, v, True, q_rows=r),
        "flash_bwd_dq": lambda r: fa.flash_bwd_dq_reference(
            *args, q_rows=r),
        "flash_bwd_dkv": lambda r: fa.flash_bwd_dkv_reference(
            *args, k_rows=r)}
    # the yardstick, never used by the port: PyTorch's fused attention on
    # the same inputs, its forward and its backward (which computes dq, dk
    # and dv in one call)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, 10, flush)
    out_t = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dot, retain_graph=True), 10, flush)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    rows = {}
    for name in FLASH_KERNELS:
        ms = time_ms(kern[name], 10, flush)
        plain[name](slice(0, step))  # warm-up
        plain_ms = time_once_ms(plain_rows(plain[name]))
        torch.cuda.empty_cache()
        bound, by = flash_bound_ms(name, T)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library[name],
                          bound_ms=bound, bound_by=by,
                          share_of_bound=bound / ms,
                          max_abs_err=errs[name],
                          tflops=FLASH_KERNELS[name][1] * FLASH_B * FLASH_H
                          * T * T * FLASH_D / ms / 1e9)
        log(f"[flash] {name} T=32768: {json.dumps(rows[name])}")
    log("[flash] library yardstick: F.scaled_dot_product_attention("
        "is_causal=True, enable_gqa=True); its backward computes dq, dk "
        "and dv in one call")
    del qt, kt, vt, out_t, q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rows, lse_err


def phase_auto():
    """One layer's attention forward + backward at the long-context
    shapes, flash against the plain path: the sweep behind FLASH_MIN_T."""
    import torch

    from pytorch_distributed_nn_tpu_torch.nn.attention import (
        FLASH_MIN_T,
        dot_product_attention,
    )

    sweep = {}
    for T in (128, 256, 512, 1024, 2048, 4096):
        q, k, v, do = flash_inputs(T, seed=T)
        leaves = [x.requires_grad_() for x in (q, k, v)]
        ms = {}
        for impl in ("flash", "xla", "xla", "flash"):  # in turns
            def fn(impl=impl):
                out = dot_product_attention(*leaves, causal=True, impl=impl)
                torch.autograd.grad(out, leaves, do)
            t = time_ms(fn, 10)
            ms[impl] = min(ms.get(impl, t), t)
        sweep[T] = ms
        log(f"[auto] T={T} fwd+bwd ms: flash {ms['flash']:.4f} "
            f"xla {ms['xla']:.4f}")
    wins = [T for T in sweep
            if all(sweep[u]["flash"] <= sweep[u]["xla"] for u in sweep
                   if u >= T)]
    measured = min(wins) if wins else None
    log(f"[auto] flash wins from T={measured} on; FLASH_MIN_T={FLASH_MIN_T}")
    return dict(sweep=sweep, flash_wins_from=measured,
                flash_min_t=FLASH_MIN_T)


def flash_counts():
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    return {name: getattr(fa, name).launches for name in FLASH_KERNELS}


def reset_flash_counts():
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0


def longcontext(**overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config("llama3_longcontext", log_every="1", **overrides)
    return Trainer(cfg, device="cuda")  # seeded init (cfg.seed)


def phase_train_check():
    """T = 4096, full width: one step's loss and gradients with the flash
    kernels against the same step with the plain attention, from the same
    weights and batch."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )

    trainer = longcontext(**{"data.seq_len": "4096"})
    x, y = trainer.loader.batch_at(0)
    loss_fn = make_chunked_loss(trainer.cfg.xent_chunk)
    out = {}
    for impl in ("flash", "xla"):
        for i in range(trainer.model.num_layers):
            getattr(trainer.model, f"layer{i}").attn.impl = impl
        reset_flash_counts()
        loss = dp._loss_and_grads(trainer.state, x, y, loss_fn).item()
        counts = flash_counts()
        grads = {n: p.grad.clone()
                 for n, p in trainer.model.named_parameters()}
        trainer.state.optimizer.zero_grad()
        out[impl] = (loss, grads, counts)
    L = trainer.model.num_layers
    if out["flash"][2] != {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                           "flash_bwd_dkv": L}:
        raise AssertionError(f"flash launches in one step: {out['flash'][2]}")
    if any(out["xla"][2].values()):
        raise AssertionError("the plain step launched a flash kernel")
    loss_f, grads_f, _ = out["flash"]
    loss_x, grads_x, _ = out["xla"]
    loss_err = abs(loss_f - loss_x) / abs(loss_x)
    grad_err = {n: rel_err(grads_f[n], g) for n, g in grads_x.items()}
    worst = max(grad_err, key=grad_err.get)
    log(f"[train] T=4096 one step, flash vs plain attention: loss "
        f"{loss_f:.6f} vs {loss_x:.6f} (rel {loss_err:.3e}); worst gradient "
        f"{worst} max|err|/max|ref| {grad_err[worst]:.3e}")
    if not (loss_err <= TRAIN_LOSS_TOL
            and grad_err[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError("flash training step disagrees with the plain "
                             f"attention (limits {TRAIN_LOSS_TOL}, "
                             f"{TRAIN_GRAD_TOL})")
    del trainer, out, grads_f, grads_x
    torch.cuda.empty_cache()
    return dict(loss_rel_err=loss_err, worst_grad=worst,
                worst_grad_rel_err=grad_err[worst])


def matmul_params(model):
    """Parameters that take part in a matmul: every 2-D one but the
    embedding table (a lookup)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and not n.startswith("tok_embed"))


def profile_train_step(trainer):
    """Device time of one training step by torch.profiler, by kernel
    family; None where the profiler records no device activity.
    Measurement only: the step itself runs outside any ``except``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[train] profiler did not start: {e}")
        return None
    t0 = time.monotonic()
    try:
        trainer.train(steps=1)
        torch.cuda.synchronize()
    finally:
        stopped = _profiler_stop(prof)
    wall = time.monotonic() - t0
    if not stopped:
        return None
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    fams, names = {}, {}
    for e in kern:
        name = e.name
        fam = ("ring_block_update" if "ring_block" in name
               else "flash_fwd" if "flash_fwd" in name
               else "flash_bwd_dq" if "flash_bwd_dq" in name
               else "flash_bwd_dkv" if "flash_bwd_dkv" in name
               else "gemm" if any(s in name.lower() for s in
                                  ("gemm", "cutlass", "sm90_xmma", "nvjet"))
               else "other")
        ms = e.time_range.elapsed_us() / 1e3
        fams[fam] = fams.get(fam, 0.0) + ms
        n, t = names.get(name[:96], (0, 0.0))
        names[name[:96]] = (n + 1, t + ms)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(kernels=len(kern), device_ms=sum(fams.values()),
                profiled_wall_ms=wall * 1e3, by_family_ms=fams,
                top_kernels=[dict(name=k, calls=n, ms=t)
                             for k, (n, t) in top])


def phase_train():
    """The main path: the preset as it is (T = 32768) for 4 steps."""
    import torch

    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        lm_train_flops_per_token,
    )

    trainer = longcontext()
    cfg, model = trainer.cfg, trainer.model
    T, L, steps = cfg.data.seq_len, model.num_layers, 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()  # the main path's count starts here
    trainer.train(steps=steps)
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches} in {steps} steps, "
                             f"expected {want}")
    losses = trainer.losses()
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    secs = sorted(r.seconds for r in trainer.history)
    step_s = (secs[steps // 2 - 1] + secs[steps // 2]) / 2  # median
    tokens = cfg.data.batch_size * T
    n_mm = matmul_params(model)
    model_flops = tokens * lm_train_flops_per_token(
        n_mm, L, T, model.d_model, causal=True)
    # the work the card does: attention forward twice (remat) + both
    # backward passes; every matmul forward, rerun (remat, chunked head)
    # and twice in the backward
    D, H = model.head_dim, model.num_heads
    hw_flops = (L * H * T * T * D * (2 * 2 + 3 + 4)
                + 8 * n_mm * tokens)
    prof = profile_train_step(trainer)
    if prof is not None:
        # against the unprofiled median step: the profiler's own host
        # overhead stretches the profiled step's wall time
        prof["idle_share_vs_unprofiled_step"] = (
            1 - prof["device_ms"] / (step_s * 1e3))
    result = dict(
        seq_len=T, steps=steps, losses=losses,
        step_s=[r.seconds for r in trainer.history[:steps]],
        median_step_s=step_s, tokens_per_s=tokens / step_s,
        model_tflop_per_step=model_flops / 1e12,
        mfu=model_flops / step_s / BF16_OPS_PER_S,
        hw_tflop_per_step=hw_flops / 1e12,
        hfu=hw_flops / step_s / BF16_OPS_PER_S,
        peak_mem_gb=peak / 1e9, launches=launches,
        params=sum(p.numel() for p in model.parameters()),
        matmul_params=n_mm, profile=prof)
    log(f"[train] {json.dumps(result)}")
    del trainer, model
    torch.cuda.empty_cache()
    return result, launches


# ---------------------------------------------------------------------------
# slice 4: sequence parallelism, the ring block kernel
# ---------------------------------------------------------------------------
RING_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/ring_attention.cu"
RING_TPU = "pytorch_distributed_nn_tpu/ops/pallas/ring_attention.py:57"
RING_SEQ = 4  # the ring replayed in one process at T = 32768
RING_LIBRARY = ("F.scaled_dot_product_attention(enable_gqa=True) forward on "
                "the same pair (nearest: no PyTorch call updates a carry)")


def reset_ring_counts():
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    reset_flash_counts()
    ra.ring_block_update.launches = 0


def ring_counts():
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    return {"ring_block_update": ra.ring_block_update.launches,
            **flash_counts()}


def ring_carries(T, seed):
    """Random non-trivial incoming carries (m, l, acc) for Tl = T."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    m = torch.randn((FLASH_B * FLASH_H, T), generator=g, device="cuda")
    l = torch.rand((FLASH_B * FLASH_H, T), generator=g, device="cuda") * 4 \
        + 0.5
    acc = torch.randn((FLASH_B, T, FLASH_H, FLASH_D), generator=g,
                      device="cuda")
    return m, l, acc


def ring_plain(q, k, v, m, l, acc, q_off, k_off, causal, step=2048):
    """The plain version, 2048 query rows at a time (it is row by row the
    same function; a whole Tl = 32768 pair's f32 scores would not fit)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    parts = [ra.ring_block_reference(
        q[:, r0:r0 + step], k, v, m[:, r0:r0 + step], l[:, r0:r0 + step],
        acc[:, r0:r0 + step], q_off + r0, k_off, causal=causal)
        for r0 in range(0, q.shape[1], step)]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def ring_check(label, got, want):
    """Kernel carries ``got`` = (m, l, acc) against the plain version's
    ``want``, and the (O, lse) that parallel/sequence.py's ring_finish makes
    of each: m and lse within LSE_TOL, l, acc and O within FLASH_TOL of
    their largest elements, or raise. Returns the errors."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import sequence as sp

    m, l, acc = got
    o, lse = sp.ring_finish(got, torch.float32)
    o_ref, lse_ref = sp.ring_finish(want, torch.float32)
    e = dict(m=(m - want[0]).abs().max().item(),
             lse=(lse - lse_ref).abs().max().item(),
             l_rel=rel_err(l, want[1]), o_rel=rel_err(o, o_ref),
             acc_rel=rel_err(acc, want[2]),
             max_abs_err=(acc - want[2]).abs().max().item())
    if not (e["m"] <= LSE_TOL and e["lse"] <= LSE_TOL
            and max(e["l_rel"], e["o_rel"], e["acc_rel"]) <= FLASH_TOL):
        raise AssertionError(f"ring block, {label}: {e} (limits lse "
                             f"{LSE_TOL}, {FLASH_TOL})")
    log(f"[ring] {label} vs plain: {json.dumps(e)}")
    return e


def ring_bound_ms(Tq, Tk, causal_diagonal):
    """Operations 4 BH Tq Tk D (half on a causal diagonal) over the bf16
    peak, against bytes (q, k, v read once; m, l, acc read and written)
    over the HBM rate: the larger."""
    bh = FLASH_B * FLASH_H
    ops = 4 * bh * Tq * Tk * FLASH_D / (2 if causal_diagonal else 1)
    nbytes = (bh * Tq * FLASH_D * 2 + 2 * FLASH_B * FLASH_HKV * Tk
              * FLASH_D * 2 + 2 * (2 * bh * Tq * 4 + bh * Tq * FLASH_D * 4))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ring_main_pair_check(T, seed, q_rows, edge=512):
    """The main path's one pair at world 1 (Tl = T, the diagonal, offsets
    0 and 0) through parallel/sequence.py's per-pair steps: the block
    update with fresh and with random carries against the plain version on
    the query rows ``q_rows``; then the pair's backward (ring_backward_pair:
    flash dq and dk/dv with f32 outputs, from the fresh run's lse) against
    their plain versions, dq on the last ``edge`` query rows (they see
    every key), dk and dv on the first and last ``edge`` key rows."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.parallel import sequence as sp

    f32 = torch.float32
    q, k, v, do = flash_inputs(T, seed=seed)
    errs = {}
    for label in ("fresh", "random"):
        carries = (sp.ring_carries(q) if label == "fresh"
                   else ring_carries(T, seed))
        m, l, acc = carries
        want = [ring_plain(q[:, r], k, v, m[:, r], l[:, r], acc[:, r],
                           r.start, 0, True) for r in q_rows]
        sp.ring_forward_pair(q, k, v, carries, 0, 0, True)
        torch.cuda.synchronize()
        for r, w in zip(q_rows, want):
            errs[f"{label} rows {r.start}:{r.stop}"] = ring_check(
                f"Tl={T} main-path pair, {label} carries, rows "
                f"{r.start}:{r.stop}", (m[:, r], l[:, r], acc[:, r]), w)
        if label == "fresh":
            out, lse = sp.ring_finish(carries, q.dtype)
        del want, carries, m, l, acc
    delta = fa.flash_delta(out, do)
    args = (q, k, v, do, lse, delta, True)
    dq, dk, dv = sp.ring_backward_pair(q, k, v, do, lse, delta, 0, 0, True)
    torch.cuda.synchronize()
    last = slice(T - edge, T)
    bwd = {"dq": flash_check(f"ring pair dq (f32), T={T}", dq[:, last],
                             fa.flash_bwd_dq_reference(*args, q_rows=last,
                                                       out_dtype=f32))}
    for r in (slice(0, edge), last):
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args, k_rows=r,
                                                    out_dtype=f32)
        bwd[f"dk rows {r.start}:{r.stop}"] = flash_check(
            f"ring pair dk (f32), T={T}", dk[:, r], dk_ref)
        bwd[f"dv rows {r.start}:{r.stop}"] = flash_check(
            f"ring pair dv (f32), T={T}", dv[:, r], dv_ref)
        del dk_ref, dv_ref
    log(f"[ring] T={T} main-path pair backward (f32 out) vs plain, "
        f"max|err|: {json.dumps(bwd)}")
    del q, k, v, do, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return dict(forward=errs, backward_max_abs_err=bwd)


def phase_ring(flush):
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra
    from pytorch_distributed_nn_tpu_torch.parallel import sequence as sp

    f32 = torch.float32
    # (a) Tl = 8192 against the plain version, carries random
    Tl = 8192
    q, k, v, _ = flash_inputs(Tl, seed=20)
    pairs = {"diagonal": (Tl, Tl), "past": (2 * Tl, 0), "future": (0, Tl)}
    errs = {}
    for name, (q_off, k_off) in pairs.items():
        m, l, acc = ring_carries(Tl, seed=len(name))
        want = ring_plain(q, k, v, m, l, acc, q_off, k_off, True)
        before = (m.clone(), l.clone(), acc.clone())
        ra.ring_block_update(q, k, v, m, l, acc, q_off, k_off, causal=True)
        torch.cuda.synchronize()
        if name == "future" and not all(
                torch.equal(a, b) for a, b in zip((m, l, acc), before)):
            raise AssertionError("ring block: the future pair changed its "
                                 "carries")
        errs[name] = ring_check(f"Tl={Tl} {name} pair", (m, l, acc), want)
        del want, before, m, l, acc
    torch.cuda.empty_cache()

    # (b) the 16 pairs of a seq = 4 ring at T = 32768, in ring order, through
    # the ring's own per-pair steps (parallel/sequence.py)
    T = 32768
    Tl = T // RING_SEQ
    q, k, v, do = flash_inputs(T, seed=21)
    o_full, lse_full = fa.flash_fwd(q, k, v, True)
    shard = [slice(r * Tl, (r + 1) * Tl) for r in range(RING_SEQ)]
    n0 = ra.ring_block_update.launches
    outs, lses = [], []
    for r in range(RING_SEQ):
        qr = q[:, shard[r]]
        carries = sp.ring_carries(qr)
        for src in sp.ring_order(r, RING_SEQ):
            sp.ring_forward_pair(qr, k[:, shard[src]], v[:, shard[src]],
                                 carries, r, src, True)
        o, lse = sp.ring_finish(carries, q.dtype)
        outs.append(o)
        lses.append(lse)
        del carries
    torch.cuda.synchronize()
    pairs_run = ra.ring_block_update.launches - n0
    o_ring = torch.cat(outs, dim=1)
    lse_ring = torch.cat(lses, dim=1)
    fwd = dict(pairs=pairs_run, o_rel=rel_err(o_ring, o_full),
               lse=(lse_ring - lse_full).abs().max().item())
    log(f"[ring] seq=4 ring at T={T}, 16 pairs vs flash_fwd: "
        f"{json.dumps(fwd)}")
    if not (pairs_run == RING_SEQ ** 2 and fwd["o_rel"] <= FLASH_TOL
            and fwd["lse"] <= LSE_TOL):
        raise AssertionError(f"seq=4 ring forward disagrees with flash_fwd "
                             f"(limits {FLASH_TOL}, lse {LSE_TOL})")

    # (c) the same pairs through the ring backward's pair step
    delta_full = fa.flash_delta(o_full, do)
    dq_full = fa.flash_bwd_dq(q, k, v, do, lse_full, delta_full, True)
    dk_full, dv_full = fa.flash_bwd_dkv(q, k, v, do, lse_full, delta_full,
                                        True)
    dq = torch.zeros(q.shape, dtype=f32, device="cuda")
    dk = torch.zeros(k.shape, dtype=f32, device="cuda")
    dv = torch.zeros(k.shape, dtype=f32, device="cuda")
    n_dq, n_dkv = fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches
    for r in range(RING_SEQ):
        qr, dor = q[:, shard[r]], do[:, shard[r]]
        delta_r = fa.flash_delta(outs[r], dor)
        for src in sp.ring_order(r, RING_SEQ):
            part = sp.ring_backward_pair(qr, k[:, shard[src]],
                                         v[:, shard[src]], dor, lses[r],
                                         delta_r, r, src, True)
            if part is None:  # the future: no gradient
                continue
            dq[:, shard[r]] += part[0]
            dk[:, shard[src]] += part[1]
            dv[:, shard[src]] += part[2]
    torch.cuda.synchronize()
    bwd = dict(dq_pairs=fa.flash_bwd_dq.launches - n_dq,
               dkv_pairs=fa.flash_bwd_dkv.launches - n_dkv,
               dq_rel=rel_err(dq, dq_full), dk_rel=rel_err(dk, dk_full),
               dv_rel=rel_err(dv, dv_full))
    log(f"[ring] seq=4 ring backward at T={T}, pair schedule (f32 out) vs "
        f"the full flash backward: {json.dumps(bwd)}")
    live = RING_SEQ * (RING_SEQ + 1) // 2  # diagonal and past pairs
    if not (bwd["dq_pairs"] == bwd["dkv_pairs"] == live
            and max(bwd["dq_rel"], bwd["dk_rel"], bwd["dv_rel"])
            <= FLASH_TOL):
        raise AssertionError(f"seq=4 ring backward disagrees with the flash "
                             f"backward (limit {FLASH_TOL})")
    del o_full, lse_full, o_ring, lse_ring, outs, lses, delta_full, dq_full
    del dk_full, dv_full, dq, dk, dv
    torch.cuda.empty_cache()

    # (d) the main path's pairs at world 1 against the plain versions: the
    # whole Tl = 32768 diagonal; the first and last 512 rows of the
    # Tl = 98304 one (llama3_longcontext_96k)
    T96 = 3 * T
    main = {T: ring_main_pair_check(T, 22, [slice(0, T)]),
            T96: ring_main_pair_check(T96, 23, [slice(0, 512),
                                                slice(T96 - 512, T96)])}

    # (e) times: the world-1 main path's pair (Tl = 32768, diagonal), and
    # the diagonal and a past pair of a seq = 4 ring (Tl = 8192)
    rows = {}
    for label, Tq, q_off, k_off in (("diagonal_32768", T, 0, 0),
                                    ("diagonal_8192", Tl, Tl, Tl),
                                    ("past_8192", Tl, 2 * Tl, 0)):
        qq, kk, vv = q[:, :Tq], k[:, :Tq], v[:, :Tq]
        causal_diag = q_off == k_off
        m, l, acc = sp.ring_carries(qq)
        ms = time_ms(lambda: ra.ring_block_update(
            qq, kk, vv, m, l, acc, q_off, k_off, causal=True), 10, flush)
        ring_plain(qq[:, :2048], kk, vv, m[:, :2048], l[:, :2048],
                   acc[:, :2048], q_off, k_off, True)  # warm-up
        plain_ms = time_once_ms(lambda: ring_plain(qq, kk, vv, m, l, acc,
                                                   q_off, k_off, True))
        torch.cuda.empty_cache()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kk, vv))
        with torch.no_grad():
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal_diag, enable_gqa=True), 10,
                flush)
        bound, by = ring_bound_ms(Tq, Tq, causal_diag)
        flops = 4 * FLASH_B * FLASH_H * Tq * Tq * FLASH_D / (
            2 if causal_diag else 1)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound, bound_by=by,
                           tflops=flops / ms / 1e9)
        log(f"[ring] {label}: {json.dumps(rows[label])}")
        del m, l, acc, qt, kt, vt
    del q, k, v, do
    torch.cuda.empty_cache()
    checks = [*errs.values()] + [e for c in main.values()
                                 for e in c["forward"].values()]
    return dict(check_8192=errs, ring_forward=fwd, ring_backward=bwd,
                main_pairs=main, times=rows,
                max_abs_err=max(e["max_abs_err"] for e in checks))


def set_attn_impl(model, impl):
    for i in range(model.num_layers):
        getattr(model, f"layer{i}").attn.impl = impl


def phase_ring_check():
    """T = 4096, full width: one step's loss and gradients with ring and
    with ulysses attention (world 1) against flash, from the same weights
    and batch."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )

    trainer = longcontext(**{"data.seq_len": "4096"})
    x, y = trainer.loader.batch_at(0)
    loss_fn = make_chunked_loss(trainer.cfg.xent_chunk)
    L = trainer.model.num_layers
    want = {"flash": {"ring_block_update": 0, "flash_fwd": 2 * L,
                      "flash_bwd_dq": L, "flash_bwd_dkv": L},
            "ring": {"ring_block_update": 2 * L, "flash_fwd": 0,
                     "flash_bwd_dq": L, "flash_bwd_dkv": L},
            "ulysses": {"ring_block_update": 0, "flash_fwd": 2 * L,
                        "flash_bwd_dq": L, "flash_bwd_dkv": L}}
    out = {}
    for impl in want:
        set_attn_impl(trainer.model, impl)
        reset_ring_counts()
        loss = dp._loss_and_grads(trainer.state, x, y, loss_fn).item()
        if ring_counts() != want[impl]:
            raise AssertionError(f"{impl}: launches in one step "
                                 f"{ring_counts()}, expected {want[impl]}")
        out[impl] = (loss, {n: p.grad.clone()
                            for n, p in trainer.model.named_parameters()})
        trainer.state.optimizer.zero_grad()
    loss_f, grads_f = out["flash"]
    result = {}
    for impl in ("ring", "ulysses"):
        loss, grads = out[impl]
        loss_err = abs(loss - loss_f) / abs(loss_f)
        grad_err = {n: rel_err(grads[n], g) for n, g in grads_f.items()}
        worst = max(grad_err, key=grad_err.get)
        log(f"[ring_check] T=4096 one step, {impl} vs flash: loss "
            f"{loss:.6f} vs {loss_f:.6f} (rel {loss_err:.3e}); worst "
            f"gradient {worst} max|err|/max|ref| {grad_err[worst]:.3e}")
        if not (loss_err <= TRAIN_LOSS_TOL
                and grad_err[worst] <= TRAIN_GRAD_TOL):
            raise AssertionError(f"{impl} training step disagrees with "
                                 f"flash (limits {TRAIN_LOSS_TOL}, "
                                 f"{TRAIN_GRAD_TOL})")
        result[impl] = dict(loss_rel_err=loss_err, worst_grad=worst,
                            worst_grad_rel_err=grad_err[worst])
    del trainer, out, grads_f
    torch.cuda.empty_cache()
    return result


def ring_trainer(preset="llama3_longcontext", **overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    extra = dict(get_config(preset).model.extra, attn_impl="ring")
    cfg = get_config(preset, log_every="1",
                     **{"model.extra": json.dumps(extra)}, **overrides)
    return Trainer(cfg, device="cuda")


def phase_ring_train():
    """The main path: llama3_longcontext as it is with attn_impl ring on
    NCCL at world 1, 4 steps, counts reset just before and read just
    after; then 2 steps of llama3_longcontext_96k on the same path."""
    import torch

    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        lm_tokens_per_card,
        lm_train_flops_per_token,
    )

    result = {}
    for preset, steps in (("llama3_longcontext", 4),
                          ("llama3_longcontext_96k", 2)):
        trainer = ring_trainer(preset)
        if (trainer.process.backend, trainer.process.world_size) != (
                "nccl", 1):
            raise AssertionError(f"process group {trainer.process}")
        cfg, model = trainer.cfg, trainer.model
        T, L = cfg.data.seq_len, model.num_layers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_ring_counts()  # the main path's count starts here
        trainer.train(steps=steps)
        launches = ring_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {"ring_block_update": 2 * L * steps, "flash_fwd": 0,
                "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps}
        if launches != want:
            raise AssertionError(f"{preset}: launches {launches} in {steps} "
                                 f"steps, expected {want}")
        losses = trainer.losses()
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{preset}: losses {losses}")
        step_s, _ = step_stats(trainer, steps)
        tokens = lm_tokens_per_card(cfg.data.batch_size, T, 1, 1)
        flops = tokens * lm_train_flops_per_token(
            matmul_params(model), L, T, model.d_model, causal=True)
        result[preset] = dict(
            seq_len=T, steps=steps, losses=losses,
            step_s=[r.seconds for r in trainer.history],
            median_step_s=step_s, tokens_per_s=tokens / step_s,
            mfu=flops / step_s / BF16_OPS_PER_S, peak_mem_gb=peak / 1e9,
            launches=launches)
        if preset == "llama3_longcontext":  # one more step, profiled
            prof = profile_train_step(trainer)
            if prof is not None:
                prof["idle_share_vs_unprofiled_step"] = (
                    1 - prof["device_ms"] / (step_s * 1e3))
            result[preset]["profile"] = prof
        log(f"[ring_train] {preset} attn_impl=ring: "
            f"{json.dumps(result[preset])}")
        del trainer, model
        torch.cuda.empty_cache()
    return result


def phase_ring4(world1_losses):
    """The train entry point on 4 cards under torchrun (NCCL, one card a
    rank), mesh.seq = 4, 2 steps with ring attention and 2 with Ulysses:
    the losses against the world-1 ring run's; rank 0's logged step
    seconds. Needs 4 cards."""
    import re

    import torch

    n = torch.cuda.device_count()
    if n < 4:
        log(f"[ring4] not run: {n} card{'s' if n != 1 else ''}")
        return None
    from pytorch_distributed_nn_tpu_torch.config import get_config

    result = {}
    for impl in ("ring", "ulysses"):
        extra = dict(get_config("llama3_longcontext").model.extra,
                     attn_impl=impl)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "4", "-m",
               "pytorch_distributed_nn_tpu_torch.train", "--preset",
               "llama3_longcontext", "--steps", "2", "--log_every", "1",
               "--mesh.seq", "4", "--model.extra", json.dumps(extra)]
        env = dict(os.environ, PYTHONPATH=HERE)
        out = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"ring4 {impl} exit {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        line = [x for x in out.stdout.splitlines()
                if x.startswith('{"losses"')]
        losses = json.loads(line[0])["losses"]
        step_s = [float(t) for t in re.findall(
            r"step \d+ loss \S+ \(([\d.]+)s\)", out.stderr)]
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, world1_losses))
        log(f"[ring4] 4 cards, seq=4, {impl}: losses {losses} vs world 1 "
            f"{world1_losses[:2]} (rel {err:.3e}); step s {step_s}")
        if not err <= TRAIN_LOSS_TOL:
            raise AssertionError(f"ring4 {impl} losses differ from world 1 "
                                 f"by {err}")
        result[impl] = dict(losses=losses, rel_err=err, step_s=step_s)
    return result


# ---------------------------------------------------------------------------
# slice 3: the data-parallel path (ResNet-50), its bn_stats and quantize
# ---------------------------------------------------------------------------
BN_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/bn_stats.cu"
BN_TPU = "pytorch_distributed_nn_tpu/ops/pallas/bn_stats.py:64"
QUANT_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/quantize.cu"
QUANT_TPU = "pytorch_distributed_nn_tpu/ops/pallas/quantize.py:33"
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# per-channel sums, kernel or plain version, against an f64 sum: f32
# summation error for these lengths stays well inside 1e-5 of sum|term|
BN_TOL = 1e-5
# one full-width ResNet-50 step, bn_stats kernel vs the torch reductions
# (bn_impl pallas vs flax) from the same weights and batch: the sums round
# in another order, and a bf16 activation may round to its neighbour, which
# 53 BatchNorms carry into every gradient. The backward's raw moments
# (sum dy*x - mean * sum dy, the JAX formula) cancel where a channel's mean
# is large against its spread, so even in f32 a last-bit difference in the
# sums grows to percents in a few gradient elements
DP_LOSS_TOL = 1e-3  # relative
DP_GRAD_TOL = 5e-2  # max|err| / max|ref|, per parameter
DP_BATCH = 256  # one card's share of the preset's 1024 on a four-card mesh
RESNET_BN_PER_STEP = 53
DP_OVERRIDES = {"parallel.strategy": "dp_explicit",
                "parallel.quantized_allreduce": "int8",
                "model.extra": json.dumps({"bn_impl": "pallas"}),
                "data.batch_size": str(DP_BATCH), "log_every": "1"}


def resnet50_bn_shapes(batch, image=224):
    """(M, C) of the 53 BatchNorms of ResNet-50 at ``batch``, in forward
    order: the stem's, then each bottleneck's bn1, bn2, bn3 (and bn_proj)."""
    h = image // 2
    shapes = [(batch * h * h, 64)]
    h //= 2
    ch = 64
    for stage, n in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for block in range(n):
            stride = 2 if stage > 0 and block == 0 else 1
            ho = (h - 1) // stride + 1
            shapes += [(batch * h * h, f), (batch * ho * ho, f),
                       (batch * ho * ho, 4 * f)]
            if ch != 4 * f or stride != 1:
                shapes.append((batch * ho * ho, 4 * f))
            h, ch = ho, 4 * f
    return shapes


def bn_counts():
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    return {"sum_and_sumsq": bn_stats.sum_and_sumsq.launches,
            "sum_and_dot": bn_stats.sum_and_dot.launches}


def quantize_count():
    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

    return tq.quantize_int8.launches


def reset_dp_counts():
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats
    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

    bn_stats.sum_and_sumsq.launches = 0
    bn_stats.sum_and_dot.launches = 0
    bn_stats.copies = 0
    tq.quantize_int8.launches = 0


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bn_check(name, got, ref64, mag):
    err = (got.double() - ref64).abs()
    worst = float((err / mag.clamp(min=1e-300)).max())
    if not bool((err <= BN_TOL * mag).all()):
        raise AssertionError(f"{name}: per-channel |err| / sum|term| "
                             f"{worst:.3e} > {BN_TOL}")
    return float(err.max()), worst


def phase_bn_stats():
    """bn_stats at ResNet-50's largest and smallest BatchNorm at batch 256
    and one ragged M, bf16 and f32: kernel and plain version against an
    f64 sum; then the 53 forward and 53 backward calls of one training
    step at their shapes, timed for the kernel, the plain version and the
    library (torch.batch_norm_stats / batch_norm_backward_reduce)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(3)
    rows, max_err, worst_rel = [], 0.0, 0.0
    for m, c in ((DP_BATCH * 112 * 112, 64), (DP_BATCH * 7 * 7, 2048),
                 (200_003, 96)):
        for dtype in (torch.bfloat16, torch.float32):
            a = (torch.randn((m, c), generator=g, device=dev) + 0.5).to(dtype)
            b = torch.randn((m, c), generator=g, device=dev).to(dtype)
            a64, b64 = a.double(), b.double()
            want = {"s1": a64.sum(0), "sq": (a64 * a64).sum(0),
                    "dot": (a64 * b64).sum(0)}
            mag = {"s1": a64.abs().sum(0), "sq": want["sq"],
                   "dot": (a64 * b64).abs().sum(0)}
            del a64, b64
            outs = {"kernel": (bn_stats.sum_and_sumsq(a),
                               bn_stats.sum_and_dot(a, b)),
                    "plain": (bn_stats.sum_and_sumsq_reference(a),
                              bn_stats.sum_and_dot_reference(a, b))}
            torch.cuda.synchronize()
            for who, ((s1, s2), (d1, d2)) in outs.items():
                for key, got in (("s1", s1), ("sq", s2), ("s1", d1),
                                 ("dot", d2)):
                    err, rel = bn_check(f"bn_stats {who} {key} ({m}, {c}) "
                                        f"{dtype}", got, want[key], mag[key])
                    if who == "kernel":
                        max_err, worst_rel = max(max_err, err), max(worst_rel,
                                                                     rel)
            again = bn_stats.sum_and_dot(a, b)
            if not (torch.equal(again[0], outs["kernel"][1][0])
                    and torch.equal(again[1], outs["kernel"][1][1])):
                raise AssertionError("bn_stats is not bitwise repeatable")
            nbytes = m * c * a.element_size()
            row = dict(m=m, c=c, dtype=str(dtype).split(".")[-1],
                       fwd_ms=time_ms(lambda: bn_stats.sum_and_sumsq(a), 10),
                       bwd_ms=time_ms(lambda: bn_stats.sum_and_dot(a, b), 10),
                       fwd_bound_ms=bound(nbytes, 3 * m * c)[0],
                       bwd_bound_ms=bound(2 * nbytes, 3 * m * c)[0])
            rows.append(row)
            log(f"[bn_stats] {json.dumps(row)}")
            del a, b, outs, again, want, mag
            torch.cuda.empty_cache()

    # one training step's 106 calls at ResNet-50's shapes, bf16
    shapes = resnet50_bn_shapes(DP_BATCH)
    if len(shapes) != RESNET_BN_PER_STEP:
        raise AssertionError(f"{len(shapes)} BatchNorm shapes")
    big = max(m * c for m, c in shapes)
    a = torch.randn((big,), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((big,), generator=g, device=dev).to(torch.bfloat16)

    def views(t):
        return [t[:m * c].view(m, c) for m, c in shapes]

    def nchw(t, m, c):  # the (M, C) matrix as channels_last (N, C, H, W)
        hw = m // DP_BATCH
        side = int(round(hw ** 0.5))
        return t[:m * c].view(DP_BATCH, side, side, c).permute(0, 3, 1, 2)

    av, bv = views(a), views(b)
    a4 = [nchw(a, m, c) for m, c in shapes]
    b4 = [nchw(b, m, c) for m, c in shapes]

    def loop(fn, xs, ys=None):
        def run():
            for i, x in enumerate(xs):
                fn(x) if ys is None else fn(x, ys[i])
        return run

    t = {"kernel_fwd": time_ms(loop(bn_stats.sum_and_sumsq, av), 10),
         "kernel_bwd": time_ms(loop(bn_stats.sum_and_dot, av, bv), 10),
         "plain_fwd": time_ms(loop(bn_stats.sum_and_sumsq_reference, av), 3),
         "plain_bwd": time_ms(loop(bn_stats.sum_and_dot_reference, av, bv),
                              3)}
    try:
        stats = [torch.batch_norm_stats(x, 1e-5) for x in a4]
        t["library_fwd"] = time_ms(
            loop(lambda x: torch.batch_norm_stats(x, 1e-5), a4), 10)
        t["library_bwd"] = time_ms(lambda: [
            torch.batch_norm_backward_reduce(dy, x, mu, inv, None, True,
                                             False, False)
            for dy, x, (mu, inv) in zip(b4, a4, stats)], 10)
    except RuntimeError as e:  # a yardstick only: report it as missing
        log(f"[bn_stats] library call failed: {e}")
        t["library_fwd"] = t["library_bwd"] = None
    el = sum(m * c for m, c in shapes)
    b_fwd = bound(2 * el + 8 * sum(c for _, c in shapes), 3 * el)
    b_bwd = bound(4 * el + 8 * sum(c for _, c in shapes), 3 * el)
    step = dict(calls=2 * len(shapes), elements=el,
                ms=t["kernel_fwd"] + t["kernel_bwd"],
                plain_ms=t["plain_fwd"] + t["plain_bwd"],
                library_ms=(None if t["library_fwd"] is None
                            else t["library_fwd"] + t["library_bwd"]),
                bound_ms=b_fwd[0] + b_bwd[0], bound_by=b_fwd[1],
                fwd_bound_ms=b_fwd[0], bwd_bound_ms=b_bwd[0], **t)
    log(f"[bn_stats] one step's 53 + 53 calls at batch {DP_BATCH}, bf16: "
        f"{json.dumps(step)}")
    del a, b, av, bv, a4, b4
    torch.cuda.empty_cache()
    return dict(shapes=rows, step=step, max_abs_err=max_err,
                worst_rel_err=worst_rel)


def bucket_sizes(model=None):
    """Element counts of the f32 buckets of ``model``'s gradient (ResNet-50
    by default) at the preset's bucket_mb = 25, in reduction order
    (ops/buckets.py's plan)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.ops.buckets import bucket_plan

    cfg = get_config("resnet50_dp")
    if model is None:
        model = get_model(cfg.model, device="meta")
    shapes = {n: (p.shape, p.dtype) for n, p in model.named_parameters()}
    plan = bucket_plan(shapes, int(cfg.parallel.bucket_mb * 1024 * 1024))
    return [sum(shapes[n][0].numel() for n in names)
            for dtype, names in plan if dtype == torch.float32]


def phase_quantize():
    """The stochastic int8 kernel on a 25 MB bucket and on the whole
    ResNet-50 gradient: bit for bit its plain version, within one code
    step of x, unbiased to 4 sigma, saturating past 127 scale; the
    kernel and the plain version timed over one step's buckets."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(4)
    sizes = bucket_sizes()
    total = sum(sizes)
    checks = {}
    for label, n in (("bucket_25MB", 25 * 2 ** 20 // 4),
                     ("resnet50_gradient", total)):
        x = torch.randn((n,), generator=g, device=dev) * 1e-3
        scale = (x.abs().max() / 127.0).clamp(min=1e-12)
        q = tq.quantize_int8(x, scale, seed=n)
        ref = tq.quantize_int8_reference(x, scale, seed=n)
        torch.cuda.synchronize()
        if not torch.equal(q, ref):
            diff = int((q != ref).sum())
            raise AssertionError(f"quantize {label}: {diff} codes differ "
                                 "from the plain version")
        err = q.float() * scale - x
        worst = float(err.abs().max() / scale)
        if not worst < 1.0:
            raise AssertionError(f"quantize {label}: |q scale - x| / scale "
                                 f"{worst} >= 1")
        mean = float(err.double().mean() / scale)
        limit = 4 * 0.5 / n ** 0.5  # 4 sigma, sigma <= scale / 2 each
        if not abs(mean) <= limit:
            raise AssertionError(f"quantize {label}: mean error {mean} "
                                 f"scale, limit {limit}")
        small = scale / 4  # values past 127 * small saturate
        qs = tq.quantize_int8(x, small, seed=1)
        over = x >= 127 * small
        under = x <= -127 * small
        if not (bool((qs[over] == 127).all())
                and bool((qs[under] == -127).all())
                and int(over.sum()) > 0):
            raise AssertionError(f"quantize {label}: no saturation")
        checks[label] = dict(n=n, worst_err_over_scale=worst,
                             mean_err_over_scale=mean, mean_limit=limit,
                             saturated=int(over.sum() + under.sum()))
        log(f"[quantize] {label}: bitwise equal to the plain version; "
            f"{json.dumps(checks[label])}")
        del x, q, ref, err, qs
    torch.cuda.empty_cache()
    # one step: one call a bucket, on the bucket's slice of the gradient
    grad = torch.randn((total,), generator=g, device=dev) * 1e-3
    scale = (grad.abs().max() / 127.0).reshape(())
    parts = list(torch.split(grad, sizes))

    def step(fn):
        def run():
            for i, part in enumerate(parts):
                fn(part, scale, seed=i)
        return run

    ms = time_ms(step(tq.quantize_int8), 20)
    plain_ms = time_ms(step(tq.quantize_int8_reference), 3)
    b = bound(5 * total, 4 * total)
    row = dict(buckets=len(sizes), elements=total, ms=ms, plain_ms=plain_ms,
               bound_ms=b[0], bound_by=b[1], checks=checks)
    log(f"[quantize] one step's {len(sizes)} buckets: {json.dumps(row)}")
    del grad, parts
    torch.cuda.empty_cache()
    return row


def resnet_trainer(**overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config("resnet50_dp", **overrides)
    return Trainer(cfg, device="cuda")  # seeded init (cfg.seed)


def grad_rel_err(got, ref):
    """max|err| / max|ref| of one gradient; a gradient that is zero in the
    reference (the residual branches behind a zero-initialised bn3 scale)
    must be zero in the other run too."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if scale == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / scale


def phase_dp_check():
    """One full-width ResNet-50 step (batch 256) with the bn_stats kernel
    and with the torch reductions, from the same weights and batch: the
    loss and every gradient before the reduce, in the main path's bf16
    compute and in f32 (where no bf16 rounding of the activations can
    flip between the two runs, and the kernel's sums are all that
    differs)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp

    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    plain = (bn_stats.sum_and_sumsq_reference, bn_stats.sum_and_dot_reference)

    def f64_sums():  # the sums taken in f64, rounded once to f32
        def sumsq(x, dim=-1):
            x64 = x.double()
            dims = bn_stats._reduce_dims(x, dim)
            return x64.sum(dims).float(), (x64 * x64).sum(dims).float()

        def dot(a, b, dim=-1):
            a64 = a.double()
            dims = bn_stats._reduce_dims(a, dim)
            return (a64.sum(dims).float(),
                    (a64 * b.double()).sum(dims).float())
        return sumsq, dot

    result = {}
    for dtype in ("bfloat16", "float32"):
        trainer = resnet_trainer(**DP_OVERRIDES,
                                 **{"model.compute_dtype": dtype})
        x, y = trainer.loader.batch_at(0)
        out = {}
        for impl in ("pallas", "flax", "f64"):
            trainer.model.set_bn_impl("flax" if impl == "f64" else impl)
            if impl == "f64":  # the check only: restored just below
                (bn_stats.sum_and_sumsq_reference,
                 bn_stats.sum_and_dot_reference) = f64_sums()
            reset_dp_counts()
            try:
                loss = dp._loss_and_grads(trainer.state, x, y,
                                          trainer.loss_fn).item()
            finally:
                (bn_stats.sum_and_sumsq_reference,
                 bn_stats.sum_and_dot_reference) = plain
            counts = bn_counts()
            grads = {n: p.grad.clone()
                     for n, p in trainer.model.named_parameters()}
            trainer.state.optimizer.zero_grad()
            out[impl] = (loss, grads, counts)
        per = RESNET_BN_PER_STEP
        if out["pallas"][2] != {"sum_and_sumsq": per, "sum_and_dot": per}:
            raise AssertionError(f"bn_stats launches in one step: "
                                 f"{out['pallas'][2]}")
        if any(out["flax"][2].values()):
            raise AssertionError("the flax BatchNorm launched bn_stats")
        loss_k, grads_k, _ = out["pallas"]
        loss_p, grads_p, _ = out["flax"]
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        grad_err = {n: grad_rel_err(grads_k[n], gp)
                    for n, gp in grads_p.items()}
        worst = max(grad_err, key=grad_err.get)
        # the same worst tensor by norms, for scale: max|err| is set by a
        # few elements where a ReLU mask flipped
        norm_err = ((grads_k[worst] - grads_p[worst]).float().norm()
                    / grads_p[worst].float().norm()).item()
        zero = sum(1 for g in grads_p.values() if not bool(g.any()))
        log(f"[dp_check] ResNet-50 batch {DP_BATCH}, {dtype}, bn_stats "
            f"kernel vs torch reductions: loss {loss_k:.6f} vs {loss_p:.6f} "
            f"(rel {loss_err:.3e}); worst gradient {worst} max|err|/max|ref| "
            f"{grad_err[worst]:.3e} (limit {DP_GRAD_TOL}), |err|/|ref| "
            f"{norm_err:.3e}; {zero} of {len(grads_p)} gradients are zero "
            "in both")
        result[dtype] = dict(loss_rel_err=loss_err, worst_grad=worst,
                             worst_grad_rel_err=grad_err[worst],
                             worst_grad_norm_rel_err=norm_err,
                             zero_grads=zero)
        # how far each run is from the same step with f64 sums: which of
        # the two is nearer the exact sums
        g64 = out["f64"][1]
        vs = {who: max(grad_rel_err(g[n], g64[n]) for n in g64)
              for who, g in (("kernel", grads_k), ("torch", grads_p))}
        result[dtype]["worst_vs_f64_sums"] = vs
        log(f"[dp_check] {dtype}, worst gradient max|err|/max|ref| against "
            f"the step with f64 sums: kernel {vs['kernel']:.3e}, torch "
            f"reductions {vs['torch']:.3e}")
        if not (math.isfinite(loss_k) and loss_err <= DP_LOSS_TOL
                and grad_err[worst] <= DP_GRAD_TOL):
            raise AssertionError("the bn_stats step disagrees with the "
                                 f"torch reductions ({dtype}; limits "
                                 f"{DP_LOSS_TOL}, {DP_GRAD_TOL})")
        del trainer, out, grads_k, grads_p, x, y
        torch.cuda.empty_cache()
    return result


def _top_level(events, key):
    """Events whose name contains ``key`` and no ancestor's does."""
    out = []
    for e in events:
        if key not in e.name:
            continue
        p = e.cpu_parent
        while p is not None and key not in p.name:
            p = p.cpu_parent
        if p is None:
            out.append(e)
    return out


def profile_dp_step(trainer):
    """Device time of one dp_explicit step by torch.profiler, split into
    convolutions, BatchNorm elementwise passes, bn_stats, quantize, NCCL,
    the optimizer and the rest; None where the profiler records no device
    activity. Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[dp_train] profiler did not start: {e}")
        return None
    try:
        trainer.train(steps=1)
        torch.cuda.synchronize()
    finally:
        stopped = _profiler_stop(prof)
    if not stopped:
        return None
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    fams, names = {}, {}
    for e in kern:
        low = e.name.lower()
        fam = ("bn_stats" if "bn_partial" in low or "bn_finish" in low
               else "quantize" if "quantize_kernel" in low
               else "nccl" if "nccl" in low
               else "optimizer" if "multi_tensor" in low or "foreach" in low
               else "conv" if any(k in low for k in (
                   "conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                   "fprop", "gemm", "nvjet", "cutlass", "nhwc", "nchw"))
               else "other")
        ms = e.time_range.elapsed_us() / 1e3
        fams[fam] = fams.get(fam, 0.0) + ms
        n, t = names.get(e.name[:96], (0, 0.0))
        names[e.name[:96]] = (n + 1, t + ms)
    # the BatchNorm autograd Function's forward and backward: their device
    # time, less the bn_stats kernels, is the elementwise passes
    bn_fn = _top_level(events, "_BatchNormTrain")
    bn_ms = sum(e.device_time_total for e in bn_fn) / 1e3
    elementwise = bn_ms - fams.get("bn_stats", 0.0) if bn_fn else None
    if elementwise is not None:
        fams["other"] -= elementwise
        fams["bn_elementwise"] = elementwise
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(kernels=len(kern), device_ms=sum(fams.values()),
                by_family_ms=fams, batchnorm_function_events=len(bn_fn),
                top_kernels=[dict(name=k, calls=n, ms=t)
                             for k, (n, t) in top])


def step_stats(trainer, steps):
    secs = sorted(r.seconds for r in trainer.history[-steps:])
    med = (secs[(steps - 1) // 2] + secs[steps // 2]) / 2
    wait = sum(r.data_wait for r in trainer.history[-steps:]) / steps
    return med, wait


def phase_dp_train():
    """The main path: resnet50_dp at full width, dp_explicit with the int8
    wire and bn_impl=pallas, batch 256 on one card (NCCL, world 1): 2
    warm-up steps, 4 timed steps with the launch counts reset just before
    and read just after, one profiled step, one step on the exact wire
    for its bytes."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import bn_stats
    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        resnet_train_flops_per_example,
    )

    trainer = resnet_trainer(**DP_OVERRIDES)
    if (trainer.process.backend, trainer.process.world_size) != ("nccl", 1):
        raise AssertionError(f"process group {trainer.process}")
    buckets = len(bucket_sizes(trainer.model))
    trainer.train(steps=2)  # warm-up: cuDNN picks its algorithms
    steps = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_dp_counts()  # the main path's count starts here
    with cc.recording() as recs:
        trainer.train(steps=steps)
    counts = bn_counts()
    q_launches = quantize_count()
    copies = bn_stats.copies
    peak = torch.cuda.max_memory_allocated()
    want = {"sum_and_sumsq": RESNET_BN_PER_STEP * steps,
            "sum_and_dot": RESNET_BN_PER_STEP * steps}
    if counts != want or q_launches != buckets * steps:
        raise AssertionError(f"launches {counts}, quantize {q_launches} in "
                             f"{steps} steps; expected {want} and "
                             f"{buckets * steps}")
    losses = trainer.losses()[-steps:]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    step_s, wait_s = step_stats(trainer, steps)
    flops = DP_BATCH * resnet_train_flops_per_example()
    payload_int8 = cc.payload_bytes(recs) / steps
    prof = profile_dp_step(trainer)
    if prof is not None:
        prof["idle_share_vs_unprofiled_step"] = (
            1 - prof["device_ms"] / (step_s * 1e3))
    # one step on the exact wire, for its bytes (the same weights go on)
    exact = trainer.cfg.override(**{"parallel.quantized_allreduce": ""})
    trainer.step_fn, _ = make_train_step(exact, trainer.loss_fn)
    with cc.recording() as recs_exact:
        trainer.train(steps=1)
    payload_exact = cc.payload_bytes(recs_exact)
    result = dict(
        batch=DP_BATCH, steps=steps, losses=losses, median_step_s=step_s,
        step_s=[r.seconds for r in trainer.history[-steps - 2:-2]],
        images_per_s=DP_BATCH / step_s, model_tflop_per_step=flops / 1e12,
        mfu=flops / step_s / BF16_OPS_PER_S, peak_mem_gb=peak / 1e9,
        loader_wait_s_per_step=wait_s, launches=counts,
        quantize_launches=q_launches, f32_buckets=buckets,
        bn_input_copies=copies,
        payload_bytes_per_step={"int8": payload_int8,
                                "exact": payload_exact},
        ring_wire_bytes_per_rank_at_4={
            "int8": cc.ring_wire_bytes("all_reduce", payload_int8, 4),
            "exact": cc.ring_wire_bytes("all_reduce", payload_exact, 4)},
        wire_bytes_per_step_at_1=cc.wire_bytes(recs) / steps,
        profile=prof)
    log(f"[dp_train] {json.dumps(result)}")
    del trainer
    torch.cuda.empty_cache()
    return result, counts, q_launches


def phase_dp_preset():
    """The preset as it is (dp, flax BatchNorm, exact reduce) at batch 256:
    one warm-up step and 4 timed; then mlp_mnist as it is, 20 steps."""
    import torch

    trainer = resnet_trainer(**{"data.batch_size": str(DP_BATCH),
                                "log_every": "1"})
    reset_dp_counts()
    trainer.train(steps=5)
    if any(bn_counts().values()) or quantize_count():
        raise AssertionError("the preset as it is launched a dp kernel")
    losses = trainer.losses()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    step_s, wait_s = step_stats(trainer, 4)
    preset = dict(losses=losses, median_step_s=step_s,
                  images_per_s=DP_BATCH / step_s,
                  loader_wait_s_per_step=wait_s)
    log(f"[dp_preset] resnet50_dp as it is, batch {DP_BATCH}: "
        f"{json.dumps(preset)}")
    del trainer
    torch.cuda.empty_cache()

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    mlp = Trainer(get_config("mlp_mnist", log_every="1"), device="cuda")
    mlp.train(steps=20)
    ml = mlp.losses()
    if not (len(ml) == 20 and all(math.isfinite(v) for v in ml)
            and ml[-1] < ml[0]):
        raise AssertionError(f"mlp_mnist losses {ml}")
    step_s, _ = step_stats(mlp, 19)
    mlp_row = dict(first_loss=ml[0], last_loss=ml[-1], median_step_s=step_s)
    log(f"[dp_preset] mlp_mnist 20 steps: {json.dumps(mlp_row)}")
    return dict(resnet50_dp=preset, mlp_mnist=mlp_row)


def build_model(seed=0):
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.nn.quantized import (
        synthetic_int8_params,
    )

    cfg = get_config("llama3_8b_zero", **{
        "model.extra": json.dumps(dict(quantized=True, fused_proj=True))})
    model = get_model(cfg.model, device=torch.device("cuda"))
    synthetic_int8_params(model, seed=seed)
    torch.cuda.synchronize()
    return model


def run_forwards(model, tokens, steps):
    """One prefill + ``steps`` teacher-forced decode steps; returns the
    list of f32 logits and the decode step seconds."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )

    B, total = tokens.shape
    P = total - steps
    cache = init_cache(model, B, total)
    outs, step_s = [], []
    with torch.inference_mode():
        zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        outs.append(model(tokens[:, :P], cache=cache,
                          cache_positions=zeros)[:, -1].float().cpu())
        for i in range(steps):
            pos = torch.full((B,), P + i, dtype=torch.int32,
                             device=tokens.device)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            lg = model(tokens[:, P + i:P + i + 1], cache=cache,
                       cache_positions=pos, last_only=True)[:, -1]
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t0)
            outs.append(lg.float().cpu())
    return outs, step_s


def profile_decode_step(model, tokens):
    """Device time of one B=8 decode step by torch.profiler: the sum of the
    CUDA kernels' own durations, and the W8A16 kernels' share of it. None
    where the profiler cannot start or records no device activity. Only
    the profiler's own errors are caught: the step itself runs outside any
    ``except``. Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )

    B, P = tokens.shape[0], tokens.shape[1] - 1
    cache = init_cache(model, B, P + 1)
    pos = torch.full((B,), P, dtype=torch.int32, device=tokens.device)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    with torch.inference_mode():
        model(tokens[:, :P], cache=cache, cache_positions=zeros)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA], acc_events=True)
        try:
            prof.start()
        except RuntimeError as e:
            log(f"[forward] profiler did not start: {e}")
            return None
        try:
            model(tokens[:, P:], cache=cache, cache_positions=pos,
                  last_only=True)
            torch.cuda.synchronize()
        finally:
            stopped = _profiler_stop(prof)
    if not stopped:
        return None
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    dev_us = sum(e.time_range.elapsed_us() for e in kern)
    w8_us = sum(e.time_range.elapsed_us() for e in kern
                if "w8a16" in e.name)
    return dict(kernels=len(kern), device_ms=dev_us / 1e3,
                w8a16_ms=w8_us / 1e3)


def _profiler_stop(prof) -> bool:
    try:
        prof.stop()
    except RuntimeError as e:
        log(f"[forward] profiler did not stop cleanly: {e}")
        return False
    return True


def twin(model, compute_dtype):
    """The same 8B model (the same weight tensors, shared) computing in
    ``compute_dtype``."""
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model

    cfg = get_config("llama3_8b_zero", **{
        "model.extra": json.dumps(dict(quantized=True, fused_proj=True)),
        "model.compute_dtype": compute_dtype})
    out = get_model(cfg.model, device="meta")
    out.load_state_dict(model.state_dict(), assign=True)
    return out


def phase_forward(model):
    import torch

    from pytorch_distributed_nn_tpu_torch.nn import quantized as nq
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    def plain(x, q, s, out_dtype=torch.bfloat16):
        x = torch.nn.functional.pad(x, (0, q.shape[0] - x.shape[1]))
        return tmm.int8_matmul_reference(x, q, s, out_dtype)

    calls = []  # (max|err|, max|ref|, tol) per kernel call, on the device

    def checked(x, q, s, out_dtype=torch.bfloat16):
        got = tmm.int8_matmul(x, q, s, out_dtype)
        ref = plain(x, q, s, out_dtype).float()
        tol = TOL["float32" if out_dtype == torch.float32 else "bfloat16"]
        calls.append(torch.stack([(got.float() - ref).abs().max(),
                                  ref.abs().max(), torch.tensor(
                                      tol, device=ref.device)]))
        return got

    def run_with(fn, m):  # the check only: swap the module's matmul
        nq.int8_matmul = fn
        try:
            return run_forwards(m, tokens, steps)[0]
        finally:
            nq.int8_matmul = tmm.int8_matmul

    g = torch.Generator("cuda").manual_seed(1)
    steps = 4
    tokens = torch.randint(0, V, (8, 64 + steps), generator=g,
                           device="cuda", dtype=torch.int32)
    result = {}
    for dtype, m in (("bfloat16", model), ("float32", twin(model,
                                                             "float32"))):
        tmm.int8_matmul.launches = 0
        got, step_s = run_forwards(m, tokens, steps)
        launches = tmm.int8_matmul.launches
        if launches != 129 * (1 + steps):
            raise AssertionError(
                f"{launches} kernel launches in {1 + steps} forwards, "
                f"expected {129 * (1 + steps)}")
        calls.clear()
        run_with(checked, m)
        err, scale, tol = torch.stack(calls).cpu().unbind(1)
        if len(calls) != launches or not bool((err <= tol * scale).all()):
            i = int(torch.argmax(err / (tol * scale)))
            raise AssertionError(
                f"{dtype}: kernel call {i} of {len(calls)} on the model's "
                f"activations: max|err| {float(err[i])} > {float(tol[i])} "
                f"* max|ref| {float(scale[i])}")
        call_err = float((err / scale).max())
        ref = run_with(plain, m)
        tol = LOGIT_TOL[dtype]
        worst, agree, rows, decisive, dis = 0.0, 0, 0, 0, 0
        for a, b in zip(got, ref):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError("non-finite logits on the kernel path")
            scale = b.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / scale)
            same = a.argmax(-1) == b.argmax(-1)
            agree += int(same.sum())
            rows += a.shape[0]
            # the greedy token must agree wherever the plain version's
            # top-1/top-2 margin exceeds twice the logit tolerance
            top2 = b.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
            decisive += int(sure.sum())
            dis += int((sure & ~same).sum())
        log(f"[forward] {dtype}: launches={launches} (129 x {1 + steps}); "
            f"every call on live activations max|err|/max|ref|="
            f"{call_err:.3e} (tol {TOL}); logits max|dlogit|/max|logit|="
            f"{worst:.3e} (tol {tol}); greedy token agrees in {agree}/{rows}"
            f" rows, differs on {dis} of {decisive} decisive rows; decode "
            f"step B=8 ms={[round(t * 1e3, 3) for t in step_s]}")
        if worst > tol:
            raise AssertionError(f"{dtype} kernel-path logits disagree "
                                 "with the plain version")
        if dis:
            raise AssertionError(
                f"{dtype}: the greedy token differs from the plain "
                f"version's on {dis} rows where its margin is decisive")
        result[dtype] = dict(launches=launches, call_rel_err=call_err,
                             rel_err=worst, argmax_agree=agree / rows,
                             decisive_rows=decisive,
                             decode_step_ms=[t * 1e3 for t in step_s])
    prof = profile_decode_step(model, tokens)
    if prof is None:
        log("[forward] device time of a decode step: not measured")
    else:
        wall = sorted(result["bfloat16"]["decode_step_ms"])[steps // 2]
        prof["idle_share_vs_unprofiled_step"] = 1 - prof["device_ms"] / wall
        log(f"[forward] decode step B=8 under torch.profiler: "
            f"{json.dumps(prof)}")
    result["profile"] = prof
    return result


def phase_serve(model):
    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import generate
    from pytorch_distributed_nn_tpu_torch.obs.stats import percentile
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.serve import (
        InferenceServer,
        ServingEngine,
        open_loop_client,
        ragged_prompt_sampler,
    )

    engine = ServingEngine(model, max_slots=8, max_seq_len=256,
                           max_queue=64, max_prefills_per_round=2)
    server = InferenceServer(engine).start()
    try:
        warm = np.random.default_rng(7)
        for L in (16, 32, 64, 128):  # every prefill bucket, + decode
            r = server.generate(warm.integers(0, V, size=(L,)), 2,
                                timeout=300)
            if not r.ok:
                raise AssertionError(f"warm-up request {r.state}")
        warm_done = len(engine.completed)
        warm_rounds = len(engine.round_seconds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tmm.int8_matmul.launches = 0  # the main path's count starts here
        t0 = time.monotonic()
        reqs = open_loop_client(
            server, num_requests=16, rate_hz=50.0, max_new_tokens=32,
            prompt_sampler=ragged_prompt_sampler(V, min_len=16,
                                                 max_len=128, seed=3))
        wall = time.monotonic() - t0
        launches = tmm.int8_matmul.launches
    finally:
        server.stop()
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        if not r.ok or len(r.tokens) != 32 or not (
                0 <= int(r.tokens.min()) and int(r.tokens.max()) < V):
            raise AssertionError(f"request {r.request_id}: {r.state} "
                                 f"{r.reject_reason} {r.tokens}")
    timed = engine.completed[warm_done:]
    rounds = engine.round_seconds[warm_rounds:]
    if launches != 129 * (len(timed) + len(rounds)):
        raise AssertionError(
            f"{launches} launches for {len(timed)} prefills and "
            f"{len(rounds)} decode rounds, expected 129 per forward")
    # the engine's contract: each request's tokens are those of a solo
    # sequential generate() of its prompt (batch composition, bucket
    # padding and slot reuse change nothing)
    for r in reqs[:3]:
        ref = generate(model, r.prompt[None], 32).cpu().numpy()
        if not np.array_equal(r.tokens, ref[0, len(r.prompt):]):
            raise AssertionError(f"request {r.request_id}: engine tokens "
                                 "differ from sequential generate")
    tokens_out = sum(c["new_tokens"] for c in timed)
    summary = dict(
        requests=len(reqs), completed=len(timed), tokens_out=tokens_out,
        wall_s=wall, tokens_per_s=tokens_out / wall,
        ttft_p50_s=percentile([c["ttft_s"] for c in timed], 0.5),
        token_lat_p50_s=percentile(rounds, 0.5),
        token_lat_p95_s=percentile(rounds, 0.95),
        rounds=len(rounds), occupancy=engine.summary()["occupancy"],
        peak_mem_gb=peak / 1e9, int8_matmul_launches=launches)
    log(f"[serve] {json.dumps(summary)}")
    return summary, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from pytorch_distributed_nn_tpu_torch.ops import build
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    sources = ("int8_matmul.cu", "flash_attention.cu", "bn_stats.cu",
               "quantize.cu", "ring_attention.cu")
    build.load_libraries(*sources)  # one nvcc each, all started together
    log(f"[build] {' + '.join(sources)}: {time.monotonic() - t0:.2f} s")
    for src in sources:
        secs, report = build.build_info[src]
        log(f"[build] {src}: nvcc {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"[build] {line.strip()}")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows, max_err, library_label = phase_kernel(flush)
    flash_rows, lse_err = phase_flash(flush)
    ring = phase_ring(flush)
    del flush
    torch.cuda.empty_cache()
    bn = phase_bn_stats()
    quant = phase_quantize()
    auto = phase_auto()
    train_check = phase_train_check()
    ring_check = phase_ring_check()
    train, flash_launches = phase_train()
    ring_train = phase_ring_train()
    ring4 = phase_ring4(ring_train["llama3_longcontext"]["losses"])
    dp_check = phase_dp_check()
    dp_train, bn_launches, q_launches = phase_dp_train()
    dp_preset = phase_dp_preset()

    model = build_model(seed=0)
    forward = phase_forward(model)
    serve, launches = phase_serve(model)

    at8 = {r["shape"]: r for r in rows if r["m"] == 8}

    def per_forward(key):
        return sum(at8[name][key] * per for name, _, _, per in PATH_SHAPES)

    kernels = [dict(
        name="int8_matmul", route="cuda", source=SOURCE,
        replaces=TPU_KERNEL, launches=launches, max_abs_err=max_err,
        # one 8B decode forward at 8 slots: 129 calls
        ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=per_forward("bound_ms"),
        bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                 for r in at8.values()) else "operations"),
        library_ms=per_forward("library_ms"), library=library_label,
        per="one 8B decode forward at M=8 (129 calls)", shapes=rows)]
    for name, (replaces, _) in FLASH_KERNELS.items():
        kernels.append(dict(
            name=name, route="cuda", source=FLASH_SOURCE, replaces=replaces,
            launches=flash_launches[name], **flash_rows[name],
            library="F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True)" + (" backward (dq, dk and dv)"
                                          if name != "flash_fwd" else ""),
            per="one call at B 1, T 32768, H 8, Hkv 4, D 128, causal"))
    bn_step = bn["step"]
    kernels.append(dict(
        name="bn_stats", route="cuda", source=BN_SOURCE, replaces=BN_TPU,
        launches=sum(bn_launches.values()), launches_by_mode=bn_launches,
        max_abs_err=bn["max_abs_err"], ms=bn_step["ms"],
        plain_ms=bn_step["plain_ms"], bound_ms=bn_step["bound_ms"],
        bound_by=bn_step["bound_by"], library_ms=bn_step["library_ms"],
        library="torch.batch_norm_stats + torch.batch_norm_backward_reduce",
        per=f"one ResNet-50 training step at batch {DP_BATCH}: 53 "
            "sum_and_sumsq + 53 sum_and_dot calls, bf16",
        shapes=bn["shapes"]))
    kernels.append(dict(
        name="quantize", route="cuda", source=QUANT_SOURCE,
        replaces=QUANT_TPU, launches=q_launches, max_abs_err=0.0,
        ms=quant["ms"], plain_ms=quant["plain_ms"],
        bound_ms=quant["bound_ms"], bound_by=quant["bound_by"],
        library_ms=None, library="none (no single PyTorch call rounds "
        "stochastically to int8)",
        per=f"one ResNet-50 step's {quant['buckets']} f32 buckets "
            f"({quant['elements']} elements); max_abs_err against the "
            "plain version, which it equals bit for bit"))
    main_pair = ring["times"]["diagonal_32768"]
    kernels.append(dict(
        name="ring_block_update", route="cuda", source=RING_SOURCE,
        replaces=RING_TPU,
        launches=ring_train["llama3_longcontext"]["launches"][
            "ring_block_update"],
        max_abs_err=ring["max_abs_err"], ms=main_pair["ms"],
        plain_ms=main_pair["plain_ms"], bound_ms=main_pair["bound_ms"],
        bound_by=main_pair["bound_by"], library_ms=main_pair["library_ms"],
        library=RING_LIBRARY,
        per="one call at the world-1 main path's shape: the diagonal pair "
            "at Tl = 32768 (B 1, H 8, Hkv 4, D 128, causal); max_abs_err "
            "of acc against the plain version over every check (Tl 8192; "
            "the main path's pairs at Tl 32768 and, on row slices, 98304)",
        at_8192={k: v for k, v in ring["times"].items() if "8192" in k}))
    log(json.dumps(dict(forward=forward, serve=serve, auto=auto,
                        train_check=train_check, train=train,
                        ring=ring, ring_check=ring_check,
                        ring_train=ring_train, ring4=ring4,
                        flash_lse_err=lse_err, bn_stats=bn,
                        quantize=quant, dp_check=dp_check,
                        dp_train=dp_train, dp_preset=dp_preset)))
    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap

    bootstrap.shutdown()  # the NCCL group of the data-parallel phases
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    raise SystemExit(rc)

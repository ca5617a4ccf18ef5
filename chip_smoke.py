#!/usr/bin/env python
"""On-card smoke test of the PyTorch port (pytorch_distributed_nn_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   -- nvcc builds csrc/int8_matmul.cu and csrc/flash_attention.cu
              for sm_90a, one nvcc each, started together; prints seconds
              and the compiler's register/spill report.
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
        fam = ("flash_fwd" if "flash_fwd" in name
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
    sources = ("int8_matmul.cu", "flash_attention.cu")
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
    del flush
    torch.cuda.empty_cache()
    auto = phase_auto()
    train_check = phase_train_check()
    train, flash_launches = phase_train()

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
    log(json.dumps(dict(forward=forward, serve=serve, auto=auto,
                        train_check=train_check, train=train,
                        flash_lse_err=lse_err)))
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

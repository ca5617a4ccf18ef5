#!/usr/bin/env python
"""Time the long-context attention kernels and the W8A16 matmul of one
checkout, to compare two commits on one card.

    python3 chip_ab.py ROOT [all|attention|int8|serve|train|prefill|decode]

imports ``chip_smoke`` and ``pytorch_distributed_nn_tpu_torch`` from the
checkout at ROOT, builds its kernels and times them with
``chip_smoke.time_ms``, the median of 20 launches with the L2 cache flushed
before each, twice each (the second argument picks the kernels; all by
default; ``serve``, ``train`` and ``prefill`` are run only when asked).
Prints one line
``AB {...}`` of milliseconds, keys ``<kernel>_<rep>``. The int8 keys:

- ``int8_m8`` and ``int8_m128``: one Llama-3-8B forward's 129 W8A16 calls
  at M = 8 (decode) and M = 128 (prefill), the sum over
  ``chip_smoke.PATH_SHAPES`` of each call's time times its count.

The serve keys: ``decode_profile``, one B = 8 decode step of the
full-width int8 Llama-3-8B under torch.profiler
(``chip_smoke.profile_decode_step``: device ms and kernel count);
``greedy``, one fixed greedy workload through the tree's
``ServingEngine`` (:func:`greedy_serve`: 16 requests, prompts 16-128
tokens, 32 new tokens each, 8 slots, cache length 256, the compute KV
cache; tokens/s and round p50/p95), the same calls in every tree; and
``decode_attention``, the tree's decode-step attention alone
(``_decode_attention`` where the tree has it, else ``_cache_attention``)
at B 8, H 32, Hkv 8, D 128, bf16, every row at the end of a cache of
256, 8192 and 32768 keys (:func:`decode_attention`: median ms and the
peak device memory it adds). The serving numbers are set largely by the
host, so compare trees only within one call.

The prefill keys (``prefill``), on the full-width int8 Llama-3-8B of
``chip_smoke.build_model`` with TF32 off as ``chip_smoke.py`` sets it:
``prefill``, the tree's prefill alone (:func:`prefill_times`: one forward
of B x T rows into an empty cache at B 8, T 64 (phase 6's), B 1 at T 129
and 320, median ms of 5 after one warm-up, synchronized host clock; and
one ``generate()`` of an 8192-token prompt with ``prefill_chunk`` 2048 and
one new token, median ms of 3 after one warm-up, with the peak device
memory it adds); ``phase6``, the tree's ``chip_smoke.phase_forward``
(the B 8 decode steps' ms per dtype); ``phase7``, the tree's
``chip_smoke.phase_serve`` (per KV cache: tokens/s, TTFT p50/p95, the
per-token latency p50/p95, i.e. one decode round, and the wall seconds).
The calls are the same in every tree; the engine runs with its own
defaults. Host clock: compare trees only within one call.

The decode keys (``decode``): ``float_decode``, one bf16 decode step of
a float Llama at the 8B's widths cut to 2 layers and of config 4's
transformer LM (seeded weights), at 1 and 8 rows over a 64-token cache
(:func:`float_decode`: the median of 50 steps after 10, synchronized host
clock; the step ``generate()`` and the engine run); then ``phase6`` and
``phase7`` as in ``prefill``.

The train keys (``train``): the tree's own training phases, each as
``chip_smoke.py`` runs it, reported by median step seconds, tokens or
images a second, MFU and peak device memory in GB: ``lm_32k``
(``phase_train``: ``llama3_longcontext``, flash, 4 steps), ``ring_32k``
and ``ring_96k`` (``phase_ring_train``: attn_impl ring, 4 and 2 steps) and
``resnet`` (``phase_dp_train``: ``resnet50_dp`` at batch 256 on
``dp_explicit`` + int8 + ``bn_impl=pallas``, NCCL at world 1, 4 steps).
Step times are the host's clock, so compare trees only within one call.

The attention keys, at B 1, T 32768, H 8, Hkv 4, D 128, causal, bf16:

- ``flash_fwd``: the forward;
- ``ring``: ``ring_block_update`` on the diagonal pair (offsets 0 and 0);
- ``dq`` and ``dkv``: the backward passes ``flash_bwd_dq`` and
  ``flash_bwd_dkv`` with bf16 outputs (the flash path's);
- ``dq_f32`` and ``dkv_f32``: the same with f32 outputs (the ring path's);
- ``sdpa_fwd`` and ``sdpa_bwd`` (once each): the forward of
  F.scaled_dot_product_attention on the same inputs, and its backward,
  which computes dq, dk and dv in one call; the yardsticks, never used by
  the port.

Beside each time, ``<key>_mhz`` and ``<key>_w``: the lowest SM clock and
the highest power draw ``nvidia-smi`` read (every 0.1 s) while it was
timed. A kernel that holds the card at its power limit runs at a lower
clock, so two trees compare only at like clocks.

Run one process a checkout, in the order before, after, after, before,
within one call to the card. Needs one card.
"""

import json
import os
import subprocess
import time
import sys
import threading


def under_watch(fn):
    """(fn(), lowest SM clock in MHz, highest power draw in W) with
    ``nvidia-smi`` read every 0.1 s while fn runs."""
    reads, stop = [], threading.Event()

    def poll():  # at least one read, however short fn is
        while True:
            out = subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30).stdout
            reads.append([float(x) for x in out.split(",")])
            if stop.wait(0.1):
                return

    watcher = threading.Thread(target=poll)
    watcher.start()
    try:
        result = fn()
    finally:
        stop.set()
        watcher.join()
    return result, min(r[0] for r in reads), max(r[1] for r in reads)


def int8_forward_ms(cs, tmm, m, flush):
    """One 8B forward's W8A16 calls at M = m: each PATH_SHAPES call timed
    alone (seeded weights, one shape on the card at a time) times its
    count."""
    import torch

    g = torch.Generator("cuda").manual_seed(0)
    total = 0.0
    for name, k, n, per in cs.PATH_SHAPES:
        kp, np_ = tmm.padded_kn(k, n)
        q = torch.empty((kp, np_), dtype=torch.int8, device="cuda")
        q.random_(-64, 64, generator=g)
        s = torch.full((1, np_), 2.7e-4, device="cuda")
        od = torch.float32 if name == "lm_head" else torch.bfloat16
        x = torch.randn((m, kp), generator=g, device="cuda").to(
            torch.bfloat16)
        total += per * cs.time_ms(lambda: tmm.int8_matmul(x, q, s, od), 20,
                                  flush)
        del q, s, x
    return total


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    if which not in ("all", "attention", "int8", "serve", "train",
                     "prefill", "decode"):
        raise SystemExit(f"unknown kernel set {which!r}")
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pytorch_distributed_nn_tpu_torch.ops import build
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    if not tmm.__file__.startswith(root):
        raise SystemExit(f"imported {tmm.__file__}, not the checkout {root}")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {"tree": sys.argv[1]}
    if which in ("all", "int8"):
        build.load_library("int8_matmul.cu")
        for rep in range(2):
            for m in (8, 128):
                key = f"int8_m{m}_{rep}"
                out[key], out[f"{key}_mhz"], out[f"{key}_w"] = under_watch(
                    lambda: int8_forward_ms(cs, tmm, m, flush))
    if which in ("all", "attention"):
        attention(cs, build, flush, out)
    if which == "serve":
        del flush
        build.load_library("int8_matmul.cu")
        model = cs.build_model(seed=0)
        g = torch.Generator("cuda").manual_seed(1)
        tokens = torch.randint(0, cs.V, (8, 65), generator=g, device="cuda",
                               dtype=torch.int32)
        out["decode_profile"] = cs.profile_decode_step(model, tokens)
        out["greedy"] = greedy_serve(cs, model)
        del model
        torch.cuda.empty_cache()
        out["decode_attention"] = decode_attention(cs)
    if which == "train":
        del flush
        train(cs, build, out)
    if which in ("prefill", "decode"):
        del flush
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.load_library("int8_matmul.cu")
        t0 = time.monotonic()
        if which == "decode":
            out["float_decode"] = float_decode()
        model = cs.build_model(seed=0)
        if which == "prefill":
            out["prefill"] = prefill_times(cs, model)
        fwd = cs.phase_forward(model)
        out["phase6"] = {k: v["decode_step_ms"] for k, v in fwd.items()
                         if isinstance(v, dict) and "decode_step_ms" in v}
        serve = cs.phase_serve(model)[0]
        keys = ("tokens_per_s", "ttft_p50_s", "ttft_p95_s",
                "token_lat_p50_s", "token_lat_p95_s", "wall_s")
        out["phase7"] = {c: {k: serve[c][k] for k in keys}
                         for c in ("compute", "int8")}
        out["seconds"] = time.monotonic() - t0
    print("AB " + json.dumps(out))
    return 0


def float_decode():
    """The bf16 decode step of the float models at 1 and 8 rows: ms, the
    median of 50 synchronized steps after 10 (host clock)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        decode_step_ragged,
        init_cache,
    )
    from pytorch_distributed_nn_tpu_torch.models import get_model

    res = {}
    for name, cfg in (
            ("llama_2l", get_config("llama3_8b_zero", **{
                "model.extra": json.dumps({"num_layers": 2})})),
            ("lm", get_config("transformer_lm_pp", **{
                "mesh.pipe": "1", "parallel.strategy": "dp"}))):
        model = get_model(cfg.model, device=torch.device("cuda"))
        model.init_params(seed=32)
        model.eval()
        for rows in (1, 8):
            cache = init_cache(model, rows, 128)
            tok = torch.ones((rows,), dtype=torch.int32, device="cuda")
            pos = torch.full((rows,), 64, dtype=torch.int32, device="cuda")
            times = []
            for _ in range(60):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                decode_step_ragged(model, cache, tok, pos)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            res[f"{name}_rows{rows}_ms"] = sorted(times[10:])[25]
        del model, cache
        torch.cuda.empty_cache()
    return res


def greedy_serve(cs, model):
    """16 greedy requests (prompts 16-128 tokens from one seeded sampler,
    32 new tokens each) through an 8-slot engine with a cache of 256, all
    submitted at once after one warm-up request; wall seconds, tokens/s
    and the decode rounds' p50/p95 in ms. Only calls every tree has."""
    from pytorch_distributed_nn_tpu_torch.serve import (
        ServingEngine,
        ragged_prompt_sampler,
    )

    engine = ServingEngine(model, max_slots=8, max_seq_len=256)
    sample = ragged_prompt_sampler(cs.V, min_len=16, max_len=128, seed=3)
    engine.submit(sample(), 4)
    engine.run_until_idle()
    warm = len(engine.round_seconds)
    t0 = time.monotonic()
    reqs = [engine.submit(sample(), 32) for _ in range(16)]
    engine.run_until_idle()
    wall = time.monotonic() - t0
    rounds = sorted(engine.round_seconds[warm:])
    tokens = sum(len(r.tokens) for r in reqs)
    return dict(requests=len(reqs), tokens=tokens, wall_s=wall,
                tokens_per_s=tokens / wall, rounds=len(rounds),
                round_p50_ms=rounds[len(rounds) // 2] * 1e3,
                round_p95_ms=rounds[int(0.95 * (len(rounds) - 1))] * 1e3)


def prefill_times(cs, model):
    """{"b8_t64", "b1_t129", "b1_t320": median ms of 5 forwards of B x T
    rows into an empty cache; "long_8k": median ms of 3 ``generate()``
    calls on an 8192-token prompt with ``prefill_chunk`` 2048 and one new
    token, and "long_8k_peak_gb", the device memory it adds}: each after
    one warm-up call, timed on the host clock between synchronizations.
    Only calls every tree has."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        generate,
        init_cache,
    )

    g = torch.Generator("cuda").manual_seed(4)

    def median_ms(fn, n):
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[n // 2]

    out = {}
    with torch.inference_mode():
        for B, T in ((8, 64), (1, 129), (1, 320)):
            toks = torch.randint(0, cs.V, (B, T),
                                 generator=g, device="cuda",
                                 dtype=torch.int32)
            zeros = torch.zeros((B,), dtype=torch.int32, device="cuda")

            def forward():
                model(toks, cache=init_cache(model, B, T),
                      cache_positions=zeros, last_only=True)

            out[f"b{B}_t{T}"] = median_ms(forward, 5)
        prompt = torch.randint(0, cs.V, (1, 8192), generator=g,
                               device="cuda", dtype=torch.int32).cpu().numpy()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out["long_8k"] = median_ms(
            lambda: generate(model, prompt, 1, prefill_chunk=2048), 3)
        out["long_8k_peak_gb"] = (torch.cuda.max_memory_allocated()
                                  - base) / 1e9
    return out


def decode_attention(cs):
    """The tree's decode-step attention alone at B 8, H 32, Hkv 8, D 128,
    bf16 (the 8B's), every row at the last of S keys: {S: median ms of 20
    (CUDA events), the peak device memory in GB it adds, which function}.
    """
    import torch

    from pytorch_distributed_nn_tpu_torch.nn import attention

    fn = getattr(attention, "_decode_attention", None)
    name = "_decode_attention" if fn else "_cache_attention"
    fn = fn or attention._cache_attention
    out = {"function": name}
    g = torch.Generator("cuda").manual_seed(2)
    for S in (256, 8192, 32768):
        q = torch.randn((8, 1, 32, 128), generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((8, S, 8, 128), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        mask = torch.ones((8, 1, S), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cs.time_ms(lambda: fn(q, k, v, mask, torch.bfloat16), 20)
        out[str(S)] = dict(
            ms=ms, peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        del q, k, v, mask
        torch.cuda.empty_cache()
    return out


def train(cs, build, out):
    build.load_libraries("flash_attention.cu", "ring_attention.cu",
                         "bn_stats.cu", "quantize.cu")
    keys = ("median_step_s", "tokens_per_s", "images_per_s", "mfu",
            "peak_mem_gb")

    def summary(result):
        return {k: result[k] for k in keys if k in result}

    out["lm_32k"] = summary(cs.phase_train()[0])
    ring = cs.phase_ring_train()
    out["ring_32k"] = summary(ring["llama3_longcontext"])
    out["ring_96k"] = summary(ring["llama3_longcontext_96k"])
    out["resnet"] = summary(cs.phase_dp_train()[0])
    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap

    bootstrap.shutdown()  # the NCCL group of the data-parallel phases


def attention(cs, build, flush, out):
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    build.load_libraries("flash_attention.cu", "ring_attention.cu")
    T = 32768
    q, k, v, do = cs.flash_inputs(T, seed=1)
    bh = cs.FLASH_B * cs.FLASH_H
    m = torch.full((bh, T), -1e30, device="cuda")
    l = torch.zeros((bh, T), device="cuda")
    acc = torch.zeros((cs.FLASH_B, T, cs.FLASH_H, cs.FLASH_D), device="cuda")
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    f32 = torch.float32
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa()

    out_t = sdpa()
    dot = do.transpose(1, 2).contiguous()
    kernels = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
        "ring": lambda: ra.ring_block_update(q, k, v, m, l, acc, 0, 0,
                                             causal=True),
        "dq": lambda: fa.flash_bwd_dq(*args),
        "dkv": lambda: fa.flash_bwd_dkv(*args),
        "dq_f32": lambda: fa.flash_bwd_dq(*args, out_dtype=f32),
        "dkv_f32": lambda: fa.flash_bwd_dkv(*args, out_dtype=f32)}
    runs = [(f"{name}_{rep}", fn) for rep in range(2)
            for name, fn in kernels.items()]
    runs.append(("sdpa_fwd", sdpa_fwd))
    runs.append(("sdpa_bwd", lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dot, retain_graph=True)))
    for key, fn in runs:
        out[key], out[f"{key}_mhz"], out[f"{key}_w"] = under_watch(
            lambda: cs.time_ms(fn, 20, flush))


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""Time the long-context attention kernels of one checkout, to compare two
commits on one card.

    python3 chip_ab.py ROOT

imports ``chip_smoke`` and ``pytorch_distributed_nn_tpu_torch`` from the
checkout at ROOT, builds its flash and ring kernels, and times them at B 1,
T 32768, H 8, Hkv 4, D 128, causal, bf16 inputs: ``chip_smoke.time_ms``,
the median of 20 launches with the L2 cache flushed before each, twice
each. Prints one line ``AB {...}`` of milliseconds, keys ``<kernel>_<rep>``:

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


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pytorch_distributed_nn_tpu_torch.ops import build
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    if not fa.__file__.startswith(root):
        raise SystemExit(f"imported {fa.__file__}, not the checkout {root}")
    build.load_libraries("flash_attention.cu", "ring_attention.cu")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
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
    out = {"tree": sys.argv[1]}
    for key, fn in runs:
        out[key], out[f"{key}_mhz"], out[f"{key}_w"] = under_watch(
            lambda: cs.time_ms(fn, 20, flush))
    print("AB " + json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

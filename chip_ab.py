#!/usr/bin/env python
"""Time the long-context attention kernels of one checkout, to compare two
commits on one card.

    python3 chip_ab.py ROOT

imports ``chip_smoke`` and ``pytorch_distributed_nn_tpu_torch`` from the
checkout at ROOT, builds its flash and ring kernels, and times ``flash_fwd``
and ``ring_block_update`` (the diagonal pair, offsets 0 and 0) at B 1,
T 32768, H 8, Hkv 4, D 128, causal, bf16: ``chip_smoke.time_ms``, the median
of 20 launches with the L2 cache flushed before each, twice each. Prints one
line ``AB {...}`` of milliseconds. Run one process a checkout, in the order
before, after, after, before, within one call to the card. Needs one card.
"""

import json
import os
import sys


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
    q, k, v, _ = cs.flash_inputs(T, seed=1)
    bh = cs.FLASH_B * cs.FLASH_H
    m = torch.full((bh, T), -1e30, device="cuda")
    l = torch.zeros((bh, T), device="cuda")
    acc = torch.zeros((cs.FLASH_B, T, cs.FLASH_H, cs.FLASH_D), device="cuda")
    out = {"tree": sys.argv[1]}
    for rep in range(2):
        out[f"flash_fwd_{rep}"] = cs.time_ms(
            lambda: fa.flash_fwd(q, k, v, True), 20, flush)
        out[f"ring_{rep}"] = cs.time_ms(lambda: ra.ring_block_update(
            q, k, v, m, l, acc, 0, 0, causal=True), 20, flush)
    print("AB " + json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training entry point (the JAX package's ``scripts/train.py``).

Usage:
    python -m pytorch_distributed_nn_tpu_torch.train \\
        --preset llama3_longcontext [--steps N] [--device cpu] \\
        [--optim.lr 3e-4] [--data.seq_len 4096] ...

Runs on ``cuda`` unless ``--device cpu`` is given, and raises where CUDA
is missing. Weights are seeded (``--seed``), data is the synthetic LM
stream. Prints ``final: step=... loss=...`` at the end.
"""

from __future__ import annotations

import logging
import sys

from pytorch_distributed_nn_tpu_torch.config import get_config, parse_overrides
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    overrides = parse_overrides(sys.argv[1:] if argv is None else argv)
    preset = overrides.pop("preset", "llama3_longcontext")
    device = overrides.pop("device", "cuda")
    cfg = get_config(preset, **overrides)
    history = Trainer(cfg, device=device).train()
    if history:
        final = history[-1]
        print(f"final: step={final.step} loss={final.loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training entry point (the JAX package's ``scripts/train.py``).

Usage:
    python -m pytorch_distributed_nn_tpu_torch.train \\
        --preset resnet50_dp [--steps N] [--device cpu] \\
        [--optim.lr 0.1] [--data.batch_size 256] \\
        [--parallel.strategy dp_explicit] ...

    torchrun --standalone --nproc_per_node N \\
        -m pytorch_distributed_nn_tpu_torch.train --preset mlp_mnist ...

Runs on ``cuda`` unless ``--device cpu`` is given, and raises where CUDA
is missing. Under ``torchrun`` (or with ``WORLD_SIZE``/``RANK`` set) each
process is one rank of the process group: NCCL on the card, one card a
rank (``LOCAL_RANK``), gloo on the CPU. Weights are seeded (``--seed``),
data is the preset's synthetic stream. Rank 0 prints the per-step losses
as a JSON line (``{"losses": [...]}``, each the mean over every rank's
rows, exact) and ``final: step=... loss=...`` at the end.
"""

from __future__ import annotations

import json
import logging
import sys

from pytorch_distributed_nn_tpu_torch.config import get_config, parse_overrides
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    overrides = parse_overrides(sys.argv[1:] if argv is None else argv)
    preset = overrides.pop("preset", "llama3_longcontext")
    device = overrides.pop("device", "cuda")
    cfg = get_config(preset, **overrides)
    trainer = Trainer(cfg, device=device)
    try:
        history = trainer.train()
        if trainer.is_coordinator and history:
            print(json.dumps({"losses": trainer.losses()}))
            final = history[-1]
            print(f"final: step={final.step} loss={final.loss:.4f}")
    finally:
        bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

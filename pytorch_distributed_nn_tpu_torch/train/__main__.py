"""Training entry point (the JAX package's ``scripts/train.py``).

Usage:
    python -m pytorch_distributed_nn_tpu_torch.train \\
        --preset resnet50_dp [--steps N] [--device cpu] \\
        [--optim.lr 0.1] [--data.batch_size 256] \\
        [--parallel.strategy dp_explicit] ...

    torchrun --standalone --nproc_per_node N \\
        -m pytorch_distributed_nn_tpu_torch.train --preset mlp_mnist ...

    # checkpoints every 100 steps, resumed from the newest on a rerun;
    # 4 microbatches a step, label smoothing, 20 steps a CUDA graph
    python -m pytorch_distributed_nn_tpu_torch.train --preset mlp_mnist \
        --checkpoint_dir /path/to/ckpt --checkpoint_every 100 \
        --parallel.grad_accum 4 --label_smoothing 0.1 --multistep_k 20

    # config 3 (BERT-base, overlapped 100 MB buckets); config 4 (the
    # transformer LM's 4-stage pipeline: one rank a stage under torchrun,
    # every stage in one process alone) and config 5 (ZeRO-3 over fsdp)
    python -m pytorch_distributed_nn_tpu_torch.train --preset bert_base_buckets
    python -m pytorch_distributed_nn_tpu_torch.train \\
        --preset transformer_lm_pp --parallel.pipeline_schedule 1f1b
    torchrun --standalone --nproc_per_node 4 \\
        -m pytorch_distributed_nn_tpu_torch.train --preset llama3_8b_zero

Runs on ``cuda`` unless ``--device cpu`` is given, and raises where CUDA
is missing. Under ``torchrun`` (or with ``WORLD_SIZE``/``RANK`` set) each
process is one rank of the process group: NCCL on the card, one card a
rank (``LOCAL_RANK``), gloo on the CPU. Weights are seeded (``--seed``),
data is the preset's synthetic stream or the user's files
(``--data.dataset token_file --data.path corpus.bin``, ``mnist_idx``,
``cifar10_bin``, ``image_folder``, ``array_file``). Rank 0 prints the per-step losses
as a JSON line (``{"losses": [...]}``, each the mean over every rank's
rows, exact) and ``final: step=... loss=...`` at the end. With
``TPUNN_PREEMPT=1`` a SIGTERM ends the run at the next step boundary after
a synchronous checkpoint save, with exit code 83 and no ``final:`` line.
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
    try:
        # a preemption notice ends train() with SystemExit(83) after a
        # synchronous checkpoint save; the context drains the writer
        with Trainer(cfg, device=device) as trainer:
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

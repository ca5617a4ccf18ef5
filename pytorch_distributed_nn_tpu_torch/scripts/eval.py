"""Evaluation entry point: checkpoint -> held-out loss and accuracy (the
JAX package's ``scripts/eval.py``).

Usage:
    python -m pytorch_distributed_nn_tpu_torch.scripts.eval \\
        --preset mlp_mnist --checkpoint-dir runs/ckpt [--batches 16] \\
        [--device cuda] [--a.b config overrides ...]

Restores the newest checkpoint into the preset's Trainer (its own layout:
replicated or ZeRO) and runs the held-out evaluation stream
(``Trainer.evaluate``). A pipeline checkpoint is read whole
(``train.checkpoint.read_full_params`` merges the stages) and evaluated
under plain dp, as the JAX script does; its ``step`` is then -1, the
fresh Trainer's. Prints one JSON line: ``step``, ``eval_loss``,
``eval_accuracy`` (rounded to 6 places) and ``batches``. Runs on ``cuda``
unless ``--device cpu`` is given, and raises where CUDA is missing.

For token_file/array_file datasets the eval stream is in-sample (drawn
from the training rows) unless the run set ``--data.holdout_frac`` > 0:
pass the value training used.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", required=True)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)

    import torch.distributed as dist

    from pytorch_distributed_nn_tpu_torch.config import (
        MeshSpec,
        get_config,
        parse_overrides,
    )
    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
    from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
        checkpoint_meta,
        read_full_params,
    )
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config(args.preset, **parse_overrides(rest))
    cfg.steps = 0  # restore only; no training
    try:
        # the layout decides the path; the read that follows verifies
        step, meta = checkpoint_meta(args.checkpoint_dir, verify=False)
    except FileNotFoundError:
        print(f"no checkpoint found in {args.checkpoint_dir}",
              file=sys.stderr)
        return 1
    params = None
    if meta.get("layout", {}).get("strategy") == "pipeline":
        # the stages merged into the whole model, evaluated under dp
        params = read_full_params(args.checkpoint_dir, step)
        cfg.parallel.strategy = "dp"
        cfg.mesh = MeshSpec()  # drop the pipe axis for eval
        cfg.checkpoint_dir = ""
    else:
        cfg.checkpoint_dir = args.checkpoint_dir
        cfg.resume = True
    own_group = not dist.is_initialized()
    try:
        with Trainer(cfg, device=args.device, params=params) as trainer:
            rec = trainer.evaluate(num_batches=args.batches)
    finally:
        if own_group:
            bootstrap.shutdown()
    print(json.dumps(dict(step=rec.step, eval_loss=round(rec.loss, 6),
                          eval_accuracy=round(rec.accuracy, 6),
                          batches=args.batches)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

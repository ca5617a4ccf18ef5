"""Asynchronous parameter-server training entry point (the JAX package's
``scripts/train_ps.py``): one server holds the parameters, workers push
gradients and pull parameters through the rendezvous store, without step
synchronisation (``parallel/ps.py``).

Usage:
    python -m pytorch_distributed_nn_tpu_torch.scripts.train_ps \\
        --preset mlp_mnist --workers 2 --steps 60 [--max-staleness 8] \\
        [--device cuda] [--a.b config overrides ...]

The ``--steps`` gradient pushes are split evenly over the workers, each
on its own batches of the preset's stream; the server and the workers run
as threads of this process (``ps.run_ps_local``), the server's parameters
and optimizer and every worker's gradient on ``--device``. Prints
``ps: applied N grads from W workers, held-out loss L`` (the batch at
step 10 000). Runs on ``cuda`` unless ``--device cpu`` is given, and
raises where CUDA is missing.
"""

from __future__ import annotations

import argparse
import functools
import logging
import sys

HELD_OUT_STEP = 10_000


def setup(preset: str, device: str, steps: int, overrides=None):
    """The run's pieces, seeded as the entry point makes them: the config,
    the dataset, the model (its seeded initial parameters on ``device``),
    ``tx`` (builds the preset's optimizer over the server's parameters),
    the workers' ``grad_fn`` and ``loss_of(params, x, y)``, each on a copy
    of the model."""
    import copy

    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.data.datasets import get_dataset
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.parallel import ps
    from pytorch_distributed_nn_tpu_torch.train.losses import get_loss_fn
    from pytorch_distributed_nn_tpu_torch.train.optim import make_optimizer

    cfg = get_config(preset, **(overrides or {}))
    dataset = get_dataset(cfg.data.dataset, seed=cfg.seed,
                          batch_size=cfg.data.batch_size,
                          seq_len=cfg.data.seq_len,
                          vocab_size=cfg.data.vocab_size,
                          path=cfg.data.path,
                          token_dtype=cfg.data.token_dtype,
                          sample=cfg.data.sample,
                          holdout_frac=cfg.data.holdout_frac,
                          image_size=cfg.data.image_size)
    model = get_model(cfg.model, device=device,
                      input_shape=dataset.spec.x_shape)
    model.init_params(seed=cfg.seed)
    model.eval()
    loss_fn = get_loss_fn(cfg.data.dataset)
    tx = functools.partial(make_optimizer, cfg.optim, total_steps=steps)
    grad_fn = ps.model_grad_fn(model, loss_fn)

    @torch.no_grad()
    def loss_of(params, x, y):
        m = copy.deepcopy(model).eval()
        for k, p in m.named_parameters():
            p.copy_(params[k])
        return float(loss_fn(m(x), y))

    return cfg, dataset, model, tx, grad_fn, loss_of


def batch_on(dataset, step: int, device):
    """The dataset's batch at ``step`` as tensors on ``device``."""
    import torch

    return tuple(torch.as_tensor(a).to(device) for a in dataset.batch(step))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="mlp_mnist")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=60,
                    help="total gradient pushes across workers")
    ap.add_argument("--max-staleness", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)

    from pytorch_distributed_nn_tpu_torch.config import parse_overrides
    from pytorch_distributed_nn_tpu_torch.parallel import ps
    from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg, dataset, model, tx, grad_fn, loss_of = setup(
        args.preset, device, args.steps, parse_overrides(rest))
    params = {k: p.detach() for k, p in model.named_parameters()}
    per_worker = args.steps // args.workers
    worker_batches = [
        [batch_on(dataset, w * per_worker + i, device)
         for i in range(per_worker)]
        for w in range(args.workers)
    ]
    final_params, applied = ps.run_ps_local(
        params, tx, grad_fn, worker_batches,
        max_staleness=args.max_staleness, device=device)
    x, y = batch_on(dataset, HELD_OUT_STEP, device)
    final_loss = loss_of(final_params, x, y)
    print(f"ps: applied {applied} grads from {args.workers} workers, "
          f"held-out loss {final_loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

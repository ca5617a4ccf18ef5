"""Serving entry point: continuous-batching engine + synthetic load.

Usage:
    python -m pytorch_distributed_nn_tpu_torch.serve --preset llama3_8b_zero \\
        --model.extra '{"quantized": true, "fused_proj": true}' \\
        [--checkpoint-dir DIR] [--device cuda] [--slots 4] \\
        [--max-seq-len 256] [--requests 32] [--rate 20] [--max-new 16] \\
        [--closed-loop] [--users 4] [--metrics-out serve.jsonl]

Runs the loopback server against a synthetic ragged workload and prints
one JSON summary line (requests, rejects, tokens/s, TTFT and per-token
latency percentiles, batch occupancy, KV utilization), as the JAX
package's ``scripts/serve.py`` does. ``--metrics-out`` appends the JSONL
records (``utils/metrics.py``): one ``serve_request`` a finished request
(the warm-up's included), one ``serve_reject`` a rejection, and the
``serve_summary``; stdout stays the one summary line.

Weights: with ``--checkpoint-dir``, the newest step that the port's
Trainer wrote there, read whole by ``train.checkpoint.read_full_params``
(a replicated or a ZeRO layout); float weights are quantized
at load (``nn.quantized.quantize_state_dict``) where the preset's
``model.extra`` says ``quantized``. A directory with no checkpoint exits 1,
and so does a pipeline layout: its stacked stage parameters are not a
model the engine serves (the JAX script fails on them too). Without it,
random seeded weights (``--seed``): synthetic int8 weights when the preset
says ``quantized``, seeded normal floats otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.obs.stats import percentile


def restore_params(directory: str) -> tuple[dict, int]:
    """The float parameters (a flax-named ``state_dict`` on the CPU) of the
    newest checkpoint under ``directory``, and its step, read whole by
    ``read_full_params`` whatever the layout (replicated or ZeRO). Raises
    FileNotFoundError where there is none, and ValueError for a pipeline
    layout."""
    from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
        checkpoint_meta,
        read_full_params,
    )

    # read_full_params verifies the step's files against its manifest
    step, meta = checkpoint_meta(directory, verify=False)
    if meta.get("layout", {}).get("strategy") == "pipeline":
        raise ValueError(
            f"{directory} step {step} holds the pipeline layout (stage "
            "parameters): the engine serves a whole model, and serving "
            "stage parameters is not a feature of the JAX package either "
            "(its scripts/serve.py fails on them)")
    return read_full_params(directory, step), step


def load_params(model, params: dict) -> None:
    """Load float ``params`` into ``model``, quantizing them first where
    the model is the int8 one."""
    from pytorch_distributed_nn_tpu_torch.nn.quantized import (
        quantize_state_dict,
    )

    dev = next(model.parameters()).device
    params = {k: v.to(dev) for k, v in params.items()}
    if getattr(model, "quantized", False):
        params = quantize_state_dict(params, model)
    model.load_state_dict(params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="llama3_longcontext")
    ap.add_argument("--checkpoint-dir", default="",
                    help="serve the newest checkpoint the port's Trainer "
                         "wrote here (default: random seeded weights)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch slots (concurrent sequences)")
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV pool block size in tokens")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-prefills", type=int, default=2,
                    help="admissions per decode round")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="open-loop arrival rate, req/s")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request queue deadline in seconds (0 = none)")
    ap.add_argument("--closed-loop", action="store_true",
                    help="closed-loop clients instead of open-loop")
    ap.add_argument("--users", type=int, default=4,
                    help="closed-loop user count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="",
                    help="JSONL path for serve_request/serve_summary "
                         "events")
    args, rest = ap.parse_known_args(argv)

    from pytorch_distributed_nn_tpu_torch.config import (
        get_config,
        parse_overrides,
    )
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.models.llama import (
        init_float_params,
    )
    from pytorch_distributed_nn_tpu_torch.nn.quantized import (
        synthetic_int8_params,
    )
    from pytorch_distributed_nn_tpu_torch.serve import (
        InferenceServer,
        ServingEngine,
        closed_loop_client,
        open_loop_client,
        ragged_prompt_sampler,
    )
    from pytorch_distributed_nn_tpu_torch.serve.engine import _bucket_len
    from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device
    from pytorch_distributed_nn_tpu_torch.utils.metrics import MetricsLogger

    device = resolve_device(args.device)
    cfg = get_config(args.preset, **parse_overrides(rest))
    model = get_model(cfg.model, device=device)
    if args.checkpoint_dir:
        try:
            params, step = restore_params(args.checkpoint_dir)
        except FileNotFoundError:
            print(f"no checkpoint found in {args.checkpoint_dir}",
                  file=sys.stderr)
            return 1
        except ValueError as e:
            print(f"[serve] {e}", file=sys.stderr)
            return 1
        load_params(model, params)
        print(f"[serve] {args.preset} on {device}: checkpoint step {step} "
              f"of {args.checkpoint_dir}", file=sys.stderr)
    else:
        if cfg.model.extra.get("quantized", False):
            synthetic_int8_params(model, seed=args.seed)
        else:
            init_float_params(model, seed=args.seed)
        print(f"[serve] {args.preset} on {device}: random weights "
              f"(seed {args.seed}, load test only)", file=sys.stderr)
    model.eval()

    # no --metrics-out: stdout stays the one summary line below
    metrics = MetricsLogger(args.metrics_out) if args.metrics_out else None
    engine = ServingEngine(
        model, max_slots=args.slots, max_seq_len=args.max_seq_len,
        block_size=args.block_size, max_queue=args.max_queue,
        max_prefills_per_round=args.max_prefills, metrics=metrics)
    vocab = model.vocab_size
    max_prompt = max(args.min_prompt,
                     min(args.max_prompt, args.max_seq_len - args.max_new))
    sampler = ragged_prompt_sampler(
        vocab, min_len=args.min_prompt, max_len=max_prompt, seed=args.seed)

    server = InferenceServer(engine).start()
    try:
        # warm every prefill bucket the sampler can hit, plus the decode
        # step, so TTFT measures serving, not first-call setup
        warm_rng = np.random.default_rng(args.seed)
        b = _bucket_len(args.min_prompt)
        top = min(_bucket_len(max_prompt), args.max_seq_len)
        while b <= top:
            # max_new=2 forces one decode round after the prefill
            L = min(b, args.max_seq_len - 2)
            server.generate(
                warm_rng.integers(0, vocab, size=(L,)).astype(np.int32), 2)
            b *= 2
        warm_done = len(engine.completed)
        warm_rounds = len(engine.round_seconds)
        t0 = time.monotonic()
        if args.closed_loop:
            per_user = max(args.requests // max(args.users, 1), 1)
            reqs = closed_loop_client(
                server, num_users=args.users, requests_per_user=per_user,
                max_new_tokens=args.max_new, prompt_sampler=sampler)
        else:
            reqs = open_loop_client(
                server, num_requests=args.requests, rate_hz=args.rate,
                max_new_tokens=args.max_new, prompt_sampler=sampler,
                deadline_s=args.deadline or None)
    finally:
        server.stop()
    wall = time.monotonic() - t0

    done = [r for r in reqs if r.ok]
    rejects: dict[str, int] = {}
    for r in reqs:
        if r.state == "rejected":
            rejects[r.reject_reason] = rejects.get(r.reject_reason, 0) + 1
    timed = engine.completed[warm_done:]  # warmup excluded
    ttfts = [c["ttft_s"] for c in timed]
    tok_lat = engine.round_seconds[warm_rounds:]
    tokens_out = int(sum(c["new_tokens"] for c in timed))
    summary = dict(
        requests=len(reqs), completed=len(done),
        rejected=sum(rejects.values()), reject_reasons=rejects,
        preempted=False,
        wall_s=round(wall, 3),
        tokens_out=tokens_out,
        tokens_per_s=round(tokens_out / max(wall, 1e-9), 2),
        ttft_p50_s=percentile(ttfts, 0.50),
        ttft_p95_s=percentile(ttfts, 0.95),
        token_lat_p50_s=percentile(tok_lat, 0.50),
        token_lat_p95_s=percentile(tok_lat, 0.95),
        token_lat_p99_s=percentile(tok_lat, 0.99),
        **{k: v for k, v in engine.summary().items()
           if k in ("rounds", "occupancy", "kv_util")},
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
    )
    if metrics is not None:
        metrics.emit("serve_summary", **summary)
        metrics.close()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

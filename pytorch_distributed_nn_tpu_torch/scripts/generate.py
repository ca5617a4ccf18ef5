"""Generation entry point: checkpoint -> KV-cache decode (the JAX package's
``scripts/generate.py``).

Usage:
    python -m pytorch_distributed_nn_tpu_torch.scripts.generate \\
        --preset llama3_longcontext [--checkpoint-dir runs/ckpt] \\
        [--prompt "5 17 42"] [--max-new 32] [--temperature 0.8] \\
        [--top-k 40] [--top-p 0.9] [--seed 0] [--prefill-chunk N] \\
        [--tokenizer path/to/tokenizer_dir_or_json] [--device cuda]

Prompts are space-separated token ids, or text when ``--tokenizer`` names a
local HF tokenizer (a saved directory, or a tokenizer.json; the
``transformers`` package is imported only then): the output is then
detokenized too, and the tokenizer's eos stops generation. Prints the
prompt and its continuation.

Weights: with ``--checkpoint-dir``, the newest step there, read whole
(``serve.__main__.restore_params``) and quantized at load where the
preset's ``model.extra`` says ``quantized``; without it, seeded random
weights (``--seed`` of the config, a smoke test of the decode path).
Sampling (``--temperature`` > 0) draws with JAX's threefry from
``--seed``, so a seeded run gives the JAX script's tokens. Runs on
``cuda`` unless ``--device cpu`` is given, and raises where CUDA is
missing. ``--tp N`` decodes tensor-parallel over a (tensor = N, data =
the rest) mesh of the process group, as the JAX script does over its
devices: run it under ``torchrun --nproc_per_node W`` (W a multiple of N);
every rank loads the whole weights, ``generate(mesh=)`` lays them out, and
rank 0 prints.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="llama3_longcontext")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--prompt", default="1 2 3 4")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass (0 = off)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="consume the prompt in chunks of N tokens "
                         "(bounds prefill attention memory for long "
                         "prompts; 0 = one-shot)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokenizer", default="",
                    help="local HF tokenizer dir or tokenizer.json; "
                         "prompt/output become text")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: decode over a (tensor=tp, "
                         "data=rest) mesh of the process group, params "
                         "and KV cache split")
    ap.add_argument("--device", default="cuda")
    # remaining --a.b style flags are config overrides, as for train
    # (the model dims must match the checkpoint being decoded)
    args, rest = ap.parse_known_args(argv)

    import numpy as np

    from pytorch_distributed_nn_tpu_torch.config import (
        get_config,
        parse_overrides,
    )
    from pytorch_distributed_nn_tpu_torch.inference.generate import generate
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.nn.quantized import (
        synthetic_int8_params,
    )
    from pytorch_distributed_nn_tpu_torch.serve.__main__ import (
        load_params,
        restore_params,
    )
    from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

    cfg = get_config(args.preset, **parse_overrides(rest))
    device = resolve_device(args.device)
    mesh, coordinator = None, True
    if args.tp > 1:
        from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
        from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
            MeshSpec,
            process_mesh,
        )

        proc = bootstrap.initialize(args.device)
        device, coordinator = proc.device, proc.is_coordinator
        mesh = process_mesh(MeshSpec(tensor=args.tp, data=-1), proc.rank,
                            proc.world_size)

    tokenizer = None
    eos_token = None
    if args.tokenizer:
        import transformers

        if args.tokenizer.endswith(".json"):
            tokenizer = transformers.PreTrainedTokenizerFast(
                tokenizer_file=args.tokenizer)
        else:
            tokenizer = transformers.AutoTokenizer.from_pretrained(
                args.tokenizer)
        eos_token = tokenizer.eos_token_id
        if eos_token is None:
            # a bare tokenizer.json carries no special-token config;
            # recover the conventional eos from the vocab so "eos stops
            # generation" holds, and say so if it can't
            vocab = tokenizer.get_vocab()
            for cand in ("</s>", "<|endoftext|>", "<eos>", "[SEP]"):
                if cand in vocab:
                    tokenizer.eos_token = cand
                    eos_token = vocab[cand]
                    break
            else:
                print("[generate] tokenizer defines no eos token; "
                      "generation will not early-stop", file=sys.stderr)
        ids = tokenizer.encode(args.prompt)
        if not ids:
            print("tokenizer produced an empty prompt", file=sys.stderr)
            return 1
        prompt = np.asarray([ids], np.int32)
    else:
        prompt = np.asarray([[int(t) for t in args.prompt.split()]],
                            np.int32)

    model = get_model(cfg.model, device=device)
    if args.checkpoint_dir:
        try:
            params, _ = restore_params(args.checkpoint_dir)
        except FileNotFoundError:
            print(f"no checkpoint found in {args.checkpoint_dir}",
                  file=sys.stderr)
            return 1
        except ValueError as e:
            print(f"[generate] {e}", file=sys.stderr)
            return 1
        load_params(model, params)
        del params
    else:
        print("[generate] no --checkpoint-dir: random init (smoke test)",
              file=sys.stderr)
        if getattr(model, "quantized", False):
            synthetic_int8_params(model, seed=cfg.seed)
        else:
            model.init_params(seed=cfg.seed)
    model.eval()

    out = generate(model, prompt, args.max_new,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p,
                   rng=args.seed if args.temperature > 0 else None,
                   eos_token=eos_token, mesh=mesh,
                   prefill_chunk=args.prefill_chunk)
    ids = [int(t) for t in out.cpu().numpy()[0]]
    if not coordinator:
        return 0
    if tokenizer is not None:
        print(tokenizer.decode(ids, skip_special_tokens=True))
    else:
        print(" ".join(str(t) for t in ids))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

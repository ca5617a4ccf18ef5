"""Checkpoint conversion: torch/HF weights <-> this package's checkpoints
(the JAX package's ``scripts/convert.py``).

Import (torch -> here): read a ``torch.save``'d state_dict
(``torch.load(weights_only=True)``) or an HF ``.safetensors`` file (with
the ``safetensors`` package, imported only for such a path), map it onto
the preset's model through ``utils/torch_interop.py`` and write a step-0
checkpoint that ``python -m pytorch_distributed_nn_tpu_torch.train
--checkpoint_dir`` resumes from and the serve, generate and eval entry
points read:

    python -m pytorch_distributed_nn_tpu_torch.scripts.convert \\
        --arch llama3 --preset llama3_8b_zero --torch-checkpoint llama.pt \\
        --out runs/llama_ckpt --model.extra '{"num_layers": 2, ...}'

The checkpoint is the state of the preset's Trainer at step 0 (its
optimizer's zero moments included) in the layout that Trainer writes:
replicated, ZeRO, or the pipeline's stages. ResNet-50's BatchNorm running
statistics go into the model's buffers.

Export (here -> torch): read the newest checkpoint whole, whatever its
layout (``train.checkpoint.read_full_params``), and write an HF-layout
state_dict of f32 tensors with ``torch.save``:

    python -m pytorch_distributed_nn_tpu_torch.scripts.convert \\
        --arch llama3 --preset llama3_8b_zero --export runs/llama_ckpt \\
        --torch-checkpoint out.pt ...

The model dims must match the weights being converted: set them with
``--model.extra`` exactly as for training (a mismatch exits with the
offending shapes; nothing half-loads). Conversion runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

ARCHS = ("llama3", "bert", "gpt2", "resnet50", "vit", "lenet", "mlp")
EXPORTERS = ("llama3", "bert", "gpt2", "vit", "resnet50")


def _load_state_dict(path: str):
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def converted_params(arch: str, state_dict, model_cfg):
    """``(params, model_state or None)``: the flax-named tree of the
    preset's model; ``model_state`` carries ResNet-50's BatchNorm running
    statistics (``{"batch_stats": ...}``)."""
    from pytorch_distributed_nn_tpu_torch.utils import torch_interop as ti

    e = model_cfg.extra
    if arch == "llama3":
        return ti.llama_params_from_torch(
            state_dict,
            num_layers=e.get("num_layers", 32),
            num_heads=e.get("num_heads", 32),
            num_kv_heads=e.get("num_kv_heads", 8),
        ), None
    if arch == "bert":
        return ti.bert_params_from_torch(
            state_dict,
            num_layers=e.get("num_layers", 12),
            num_heads=e.get("num_heads", 12),
        ), None
    if arch == "gpt2":
        return ti.gpt2_params_from_torch(
            state_dict,
            num_layers=e.get("num_layers", 12),
            num_heads=e.get("num_heads", 12),
        ), None
    if arch == "resnet50":
        return ti.resnet50_params_from_torch(
            state_dict,
            stage_sizes=tuple(e.get("stage_sizes", (3, 4, 6, 3))),
            stem=e.get("stem", "conv7"),
        )
    if arch == "vit":
        return ti.vit_params_from_torch(
            state_dict,
            num_layers=e.get("num_layers", 6),
            num_heads=e.get("num_heads", 3),
        ), None
    if arch == "lenet":
        return ti.lenet_params_from_torch(state_dict), None
    if arch == "mlp":
        return ti.mlp_params_from_torch(state_dict), None
    raise ValueError(
        f"unknown --arch {arch!r} (llama3 | bert | gpt2 | resnet50 | "
        "vit | lenet | mlp)"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--preset", required=True)
    ap.add_argument("--torch-checkpoint", required=True,
                    help="torch state_dict file (read on import, "
                         "written on export)")
    ap.add_argument("--out", default="",
                    help="checkpoint dir to write (import mode)")
    ap.add_argument("--export", default="",
                    help="checkpoint dir to read (export mode)")
    args, rest = ap.parse_known_args(argv)
    if bool(args.out) == bool(args.export):
        ap.error("exactly one of --out (import) / --export is required")

    import torch.distributed as dist

    from pytorch_distributed_nn_tpu_torch.config import (
        get_config,
        parse_overrides,
    )
    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap

    cfg = get_config(args.preset, **parse_overrides(rest))
    cfg.steps = 0
    cfg.checkpoint_dir = ""  # the Trainer must not resume anything
    # the Trainer joins a process group when there is none: this process
    # leaves it again at the end
    own_group = not dist.is_initialized()
    try:
        if args.out:
            return _import(args, cfg)
        return _export(args, cfg)
    finally:
        if own_group:
            bootstrap.shutdown()


def _import(args, cfg) -> int:
    from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils.interop import (
        vision_params_from_jax,
    )

    state_dict = _load_state_dict(args.torch_checkpoint)
    params, model_state = converted_params(args.arch, state_dict, cfg.model)
    del state_dict
    converted = vision_params_from_jax(
        params, (model_state or {}).get("batch_stats"))
    del params, model_state
    try:
        trainer = Trainer(cfg, device="cpu", params=converted)
    except RuntimeError as e:  # the model's strict load_state_dict
        if not str(e).startswith("Error(s) in loading state_dict"):
            raise
        raise SystemExit(
            f"converted weights do not fit the configured model (set "
            f"--model.extra to the checkpoint's dims): {e}") from e
    del converted
    with trainer:
        mgr = CheckpointManager(args.out)
        try:
            mgr.save(trainer.state, data_step=0, force=True)
        finally:
            mgr.close()
    print(f"wrote checkpoint: {args.out} (step 0, arch {args.arch})")
    return 0


def _export(args, cfg) -> int:
    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
        checkpoint_meta,
        read_full_params,
    )
    from pytorch_distributed_nn_tpu_torch.utils import torch_interop as ti
    from pytorch_distributed_nn_tpu_torch.utils.interop import (
        vision_params_to_jax,
    )

    step, _ = checkpoint_meta(args.export, verify=False)  # verified next
    params, stats = vision_params_to_jax(read_full_params(args.export, step))
    if args.arch not in EXPORTERS:
        raise SystemExit(f"export supports --arch {' | '.join(EXPORTERS)}")

    def host(tree):
        return {k: host(v) if isinstance(v, dict)
                else np.asarray(v, np.float32) for k, v in tree.items()}

    if args.arch == "resnet50":
        sd = ti.resnet50_params_to_torch(
            host(params), {"batch_stats": host(stats)},
            stage_sizes=tuple(cfg.model.extra.get("stage_sizes",
                                                  (3, 4, 6, 3))),
        )
    else:
        sd = {
            "llama3": ti.llama_params_to_torch,
            "bert": ti.bert_params_to_torch,
            "gpt2": ti.gpt2_params_to_torch,
            "vit": ti.vit_params_to_torch,
        }[args.arch](host(params))
    torch.save(sd, args.torch_checkpoint)
    print(f"wrote torch state_dict: {args.torch_checkpoint} "
          f"(from step {step})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

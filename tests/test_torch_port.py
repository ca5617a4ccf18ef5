"""Port boundaries: the PyTorch package imports neither JAX nor the JAX
package, and its entry points refuse CUDA when there is none."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pytorch_distributed_nn_tpu_torch as port
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    mods = _port_modules()
    for m in ("serve.engine", "train.trainer", "ops.flash_attention"):
        assert f"pytorch_distributed_nn_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    # exact names: the port's own prefix starts with the JAX package's
    bad = [m for m in loaded
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "pytorch_distributed_nn_tpu")]
    assert bad == []
    assert "pytorch_distributed_nn_tpu_torch.serve.engine" in loaded


def test_port_sources_name_no_jax_import():
    """A textual check beside the runtime one (catches imports on paths
    the import above does not execute)."""
    pkg = ROOT / "pytorch_distributed_nn_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        if "_build" in path.relative_to(pkg).parts:
            continue  # build outputs, not sources
        for line in path.read_text().splitlines():
            s = line.strip()
            if not s.startswith(("import ", "from ")):
                continue
            root = s.split()[1].split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax",
                                "pytorch_distributed_nn_tpu"), (path, s)


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    from pytorch_distributed_nn_tpu_torch.serve.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--device", "cuda"])
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(get_config("llama3_8b_zero").model)
    from pytorch_distributed_nn_tpu_torch.train.__main__ import (
        main as train_main,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--preset", "llama3_longcontext"])
    assert resolve_device("cpu") == torch.device("cpu")

"""Port: serve a checkpoint that the port's Trainer wrote
(``python -m pytorch_distributed_nn_tpu_torch.serve --checkpoint-dir``), on
the CPU at tiny dims, one process (no gang).

- The tiny transformer LM (config 4's model, ``--mesh.pipe 1
  --parallel.strategy dp``) and the tiny Llama (``llama3_8b_zero``'s
  model) each train 2 steps with a checkpoint, under ``dp`` and under
  ``zero_stage`` 3. The entry point prints one JSON summary line; the
  restored parameters are the trained ones bit for bit; the engine's
  greedy tokens on them equal ``generate()``'s.
- A quantized preset (``{"quantized": true, "fused_proj": true}``)
  quantizes at load, bit for bit ``quantize_model_params`` of the same
  float parameters.
- An empty directory exits 1 ("no checkpoint found in ..."); a pipeline
  layout (``transformer_lm_pp`` at ``mesh.pipe`` 4, every stage in this
  process) exits 1, as the JAX ``scripts/serve.py`` fails on one.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.inference.generate import generate
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.nn.quantized import (
    _flat,
    _nested,
    quantize_model_params,
)
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.serve import ServingEngine
from pytorch_distributed_nn_tpu_torch.serve import __main__ as serve_main
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

VOCAB = 97
LM = ("transformer_lm_pp", {
    "model.extra": json.dumps({"num_layers": 2, "d_model": 32,
                               "num_heads": 4, "mlp_dim": 64,
                               "vocab_size": VOCAB, "max_len": 64}),
    "mesh.pipe": "1"})
LLAMA = ("llama3_8b_zero", {
    "model.extra": json.dumps({"num_layers": 2, "d_model": 64,
                               "num_heads": 4, "num_kv_heads": 2,
                               "mlp_dim": 128, "vocab_size": VOCAB}),
    "xent_chunk": "8"})
COMMON = {"data.batch_size": "4", "data.seq_len": "16",
          "data.vocab_size": str(VOCAB), "steps": "2",
          "model.compute_dtype": "float32"}
STRATEGY = {"dp": {"parallel.strategy": "dp"},
            "zero3": {"parallel.strategy": "zero",
                      "parallel.zero_stage": "3"}}
SERVE = ["--device", "cpu", "--requests", "3", "--rate", "100",
         "--max-new", "4", "--max-seq-len", "64", "--max-prompt", "20"]


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """The Trainers here make a one-process group; none outlives a test."""
    yield
    bootstrap.shutdown()


def _argv(overrides):
    return [f"--{k}={v}" for k, v in overrides.items()]


def _train(preset, overrides, directory):
    cfg = get_config(preset, checkpoint_dir=str(directory),
                     checkpoint_every=2, **overrides)
    with Trainer(cfg, device="cpu") as t:
        t.train()  # saves at step 2
        t.ckpt.wait()
        return {k: v.detach().clone()
                for k, v in t.model.state_dict().items()}, cfg


def _serve(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_main.main(argv)
    return rc, out.getvalue().strip().splitlines()


@pytest.mark.parametrize("strategy", list(STRATEGY))
@pytest.mark.parametrize("model", ["lm", "llama"])
def test_checkpoint_is_served_as_trained(tmp_path, model, strategy):
    preset, extra = LM if model == "lm" else LLAMA
    overrides = {**COMMON, **extra, **STRATEGY[strategy]}
    trained, cfg = _train(preset, overrides, tmp_path)
    rc, lines = _serve(["--preset", preset, "--checkpoint-dir",
                        str(tmp_path), *SERVE, *_argv(overrides)])
    assert rc == 0 and len(lines) == 1
    summary = json.loads(lines[0])
    assert summary["completed"] == 3 and summary["device"] == "cpu"
    params, step = serve_main.restore_params(str(tmp_path))
    assert step == 2 and sorted(params) == sorted(trained)
    for k, v in trained.items():
        assert torch.equal(params[k], v), k
    served = get_model(cfg.model, device="cpu")
    serve_main.load_params(served, params)
    served.eval()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, size=(n,)).astype(np.int32)
               for n in (5, 9, 3)]
    eng = ServingEngine(served, max_slots=2, max_seq_len=32, block_size=8)
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.run_until_idle()
    for p, r in zip(prompts, reqs):
        ref = generate(served, p[None], 6).numpy()
        np.testing.assert_array_equal(r.tokens, ref[0, len(p):])


def test_quantized_preset_quantizes_at_load(tmp_path):
    preset, extra = LLAMA
    overrides = {**COMMON, **extra, **STRATEGY["zero3"]}
    trained, cfg = _train(preset, overrides, tmp_path)
    qextra = dict(json.loads(extra["model.extra"]), quantized=True,
                  fused_proj=True)
    qover = {**overrides, "model.extra": json.dumps(qextra)}
    rc, lines = _serve(["--preset", preset, "--checkpoint-dir",
                        str(tmp_path), *SERVE, *_argv(qover)])
    assert rc == 0 and json.loads(lines[0])["completed"] == 3
    qcfg = get_config(preset, **qover)
    params, _ = serve_main.restore_params(str(tmp_path))
    served = get_model(qcfg.model, device="cpu")
    serve_main.load_params(served, params)
    target = _nested({k: tuple(v.shape)
                      for k, v in served.state_dict().items()})
    want = _flat(quantize_model_params(_nested(trained), target))
    got = served.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert got["layer0.attn.qkv.kernel_q"].dtype == torch.int8


def test_empty_directory_exits_1(tmp_path, capsys):
    rc, lines = _serve(["--preset", LLAMA[0], "--checkpoint-dir",
                        str(tmp_path), *SERVE, *_argv(LLAMA[1])])
    assert rc == 1 and lines == []
    assert f"no checkpoint found in {tmp_path}" in capsys.readouterr().err


def test_pipeline_layout_is_refused_as_the_jax_script_fails(tmp_path,
                                                            capsys):
    extra = json.loads(LM[1]["model.extra"])
    overrides = {**COMMON, "data.batch_size": "8",
                 "model.extra": json.dumps(dict(extra, num_layers=4))}
    _train("transformer_lm_pp", overrides, tmp_path)
    rc, lines = _serve(["--preset", "transformer_lm_pp", "--checkpoint-dir",
                        str(tmp_path), *SERVE, *_argv(overrides)])
    assert rc == 1 and lines == []
    assert "pipeline layout" in capsys.readouterr().err

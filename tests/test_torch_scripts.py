"""The port's user scripts (``scripts/convert.py``, ``generate.py``,
``eval.py``) and the serve entry point's ``--metrics-out``, on the CPU
(``--device cpu``), held against the JAX package and the port's own
Trainer on seeded HF-layout weights (``test_torch_hf_interop``'s makers).

- convert: a Llama state_dict into ``llama3_8b_zero`` (ZeRO-3 at world 1)
  is resumed by the port's Trainer with the converted weights bit for bit
  and trains a step, and is served; a GPT-2 state_dict into
  ``transformer_lm_pp`` on ``mesh.pipe 2`` (the pipeline layout) is
  resumed by the train entry point and exported back; ResNet-50's running
  statistics land in the model's buffers; weights of other dims exit with
  the JAX message; the JAX exporters' archs only.
- generate: greedy and seeded sampled tokens equal the JAX ``generate()``
  on the same weights; a converted tiny HF Llama's equal ``hf.generate``
  (``transformers`` present only); ``--tp 2`` in one process raises.
- eval: its JSON line equals the port Trainer's evaluation, for a
  replicated and a pipeline checkpoint.
- serve ``--metrics-out``: one ``serve_request`` a finished request and
  one ``serve_summary``, with the JAX records' keys.

``main(argv)`` runs in process; each script runs once more as ``python
-m`` in a subprocess.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hf_interop import hf_gpt2, hf_llama, hf_resnet50

from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.inference.generate import (
    generate as jgenerate,
)
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.utils import torch_interop as jti
from pytorch_distributed_nn_tpu_torch.config import get_config
from pytorch_distributed_nn_tpu_torch.scripts import convert, eval as evals
from pytorch_distributed_nn_tpu_torch.scripts import generate
from pytorch_distributed_nn_tpu_torch.serve import __main__ as serve_main
from pytorch_distributed_nn_tpu_torch.train import __main__ as train_main
from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
    checkpoint_meta,
    read_full_params,
)
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 97
LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             mlp_dim=128, vocab_size=VOCAB)
LLAMA_OV = ["--model.extra", json.dumps(LLAMA), "--data.vocab_size",
            str(VOCAB), "--data.seq_len", "16", "--data.batch_size", "4",
            "--model.compute_dtype", "float32", "--xent_chunk", "8"]
GPT2 = dict(num_layers=4, d_model=32, num_heads=4, mlp_dim=128,
            vocab_size=VOCAB, max_len=64)
PIPE_OV = ["--model.extra", json.dumps(GPT2), "--data.vocab_size",
           str(VOCAB), "--data.seq_len", "16", "--data.batch_size", "8",
           "--model.compute_dtype", "float32", "--mesh.pipe", "2",
           "--parallel.microbatches", "2", "--model.remat", "false"]


def run_main(main, argv):
    """``main(argv)`` in process: (rc, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def run_module(name, *argv):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return subprocess.run(
        [sys.executable, "-m", f"pytorch_distributed_nn_tpu_torch.{name}",
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)


def flat_llama(sd):
    """The port's state_dict of an HF Llama state_dict."""
    return llama_params_from_jax(jti.llama_params_from_torch(
        sd, num_layers=2, num_heads=4, num_kv_heads=2))


@pytest.fixture(scope="module")
def llama_ckpt(tmp_path_factory):
    """A seeded HF Llama state_dict converted into llama3_8b_zero."""
    root = tmp_path_factory.mktemp("llama")
    sd = hf_llama(np.random.default_rng(0), V=VOCAB)
    pt = root / "llama.pt"
    torch.save(sd, pt)
    rc, out = run_main(convert.main, [
        "--arch", "llama3", "--preset", "llama3_8b_zero",
        "--torch-checkpoint", str(pt), "--out", str(root / "ckpt"),
        *LLAMA_OV])
    assert rc == 0 and "step 0, arch llama3" in out
    return sd, root / "ckpt"


def test_convert_llama_resumes_trains_serves_and_exports(llama_ckpt,
                                                         tmp_path):
    sd, ckpt = llama_ckpt
    step, meta = checkpoint_meta(ckpt)
    assert step == 0 and meta["layout"]["zero_stage"] == 3
    overrides = {k[2:]: v for k, v in zip(LLAMA_OV[0::2], LLAMA_OV[1::2])}
    cfg = get_config("llama3_8b_zero", **overrides, steps="1",
                     checkpoint_dir=str(ckpt))
    with Trainer(cfg, device="cpu") as trainer:
        assert trainer.data_step == 0
        got = read_full_params(ckpt)
        for k, want in flat_llama(sd).items():
            assert torch.equal(got[k], want), k
        loss = trainer.train()[-1].loss
    assert np.isfinite(loss)
    # the serve entry point reads the same checkpoint
    rc, out = run_main(serve_main.main, [
        "--preset", "llama3_8b_zero", "--checkpoint-dir", str(ckpt),
        "--device", "cpu", "--requests", "3", "--rate", "100",
        "--max-new", "3", "--max-prompt", "12", *LLAMA_OV])
    assert rc == 0 and json.loads(out)["completed"] == 3
    # export: every tensor of the state_dict back, bit for bit
    back = tmp_path / "back.pt"
    rc, _ = run_main(convert.main, [
        "--arch", "llama3", "--preset", "llama3_8b_zero", "--export",
        str(ckpt), "--torch-checkpoint", str(back), *LLAMA_OV])
    assert rc == 0
    exported = torch.load(back, weights_only=True)
    assert sorted(exported) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(exported[k], t), k


def test_convert_reads_safetensors(tmp_path, llama_ckpt):
    """An HF ``.safetensors`` file (the ``safetensors`` package, where it
    is importable) converts to the weights of the ``.pt`` file."""
    st = pytest.importorskip("safetensors.torch")
    sd, _ = llama_ckpt
    path = tmp_path / "llama.safetensors"
    st.save_file({k: v.contiguous() for k, v in sd.items()}, str(path))
    rc, _ = run_main(convert.main, [
        "--arch", "llama3", "--preset", "llama3_8b_zero",
        "--torch-checkpoint", str(path), "--out", str(tmp_path / "ckpt"),
        *LLAMA_OV])
    assert rc == 0
    got = read_full_params(tmp_path / "ckpt")
    for k, want in flat_llama(sd).items():
        assert torch.equal(got[k], want), k


def test_convert_gpt2_into_the_pipeline_layout(tmp_path):
    sd = hf_gpt2(np.random.default_rng(1), L=4, D=32, V=VOCAB, P=64)
    pt = tmp_path / "gpt2.pt"
    torch.save(sd, pt)
    ckpt = tmp_path / "ckpt"
    rc, _ = run_main(convert.main, [
        "--arch", "gpt2", "--preset", "transformer_lm_pp",
        "--torch-checkpoint", str(pt), "--out", str(ckpt), *PIPE_OV])
    assert rc == 0
    assert checkpoint_meta(ckpt)[1]["layout"]["strategy"] == "pipeline"
    # the train entry point resumes the pipeline layout and steps
    rc, out = run_main(train_main.main, [
        "--preset", "transformer_lm_pp", "--device", "cpu", "--steps", "1",
        "--log_every", "1", "--checkpoint_dir", str(ckpt), *PIPE_OV])
    assert rc == 0 and "final: step=0" in out
    # eval of the pipeline checkpoint: the stages merged, under dp
    rc, line = run_main(evals.main, [
        "--preset", "transformer_lm_pp", "--checkpoint-dir", str(ckpt),
        "--batches", "2", "--device", "cpu", *PIPE_OV])
    assert rc == 0
    overrides = {k[2:]: v for k, v in zip(PIPE_OV[0::2], PIPE_OV[1::2])}
    cfg = get_config("transformer_lm_pp", **overrides)
    cfg.parallel.strategy = "dp"
    cfg.mesh.pipe = 1
    with Trainer(cfg, device="cpu",
                 params=read_full_params(ckpt)) as trainer:
        rec = trainer.evaluate(num_batches=2)
    assert json.loads(line) == dict(step=-1, eval_loss=round(rec.loss, 6),
                                    eval_accuracy=round(rec.accuracy, 6),
                                    batches=2)
    # export of the step-0 conversion (the run saved no new step): the
    # state_dict back, the still-tied head omitted, the mask buffers not
    # written
    back = tmp_path / "back.pt"
    rc, _ = run_main(convert.main, [
        "--arch", "gpt2", "--preset", "transformer_lm_pp", "--export",
        str(ckpt), "--torch-checkpoint", str(back), *PIPE_OV])
    assert rc == 0
    exported = torch.load(back, weights_only=True)
    assert sorted(exported) == sorted(k for k in sd
                                      if not k.endswith(".attn.bias"))
    for k, t in exported.items():
        assert torch.equal(t, sd[k]), k


def test_convert_resnet50_carries_the_running_statistics(tmp_path):
    sd = hf_resnet50(np.random.default_rng(2), width=8, classes=10)
    pt = tmp_path / "r.pt"
    torch.save(sd, pt)
    extra = json.dumps({"stage_sizes": [1, 1, 1, 1], "width": 8,
                        "num_classes": 10})
    ov = ["--model.extra", extra, "--data.dataset", "cifar10",
          "--data.batch_size", "4", "--parallel.strategy", "dp"]
    ckpt = tmp_path / "ckpt"
    rc, _ = run_main(convert.main, [
        "--arch", "resnet50", "--preset", "resnet50_dp",
        "--torch-checkpoint", str(pt), "--out", str(ckpt), *ov])
    assert rc == 0
    got = read_full_params(ckpt)
    assert torch.equal(got["bn_init.mean"], sd["bn1.running_mean"])
    assert torch.equal(got["stage3_block0.bn_proj.var"],
                       sd["layer4.0.downsample.1.running_var"])
    back = tmp_path / "back.pt"
    rc, _ = run_main(convert.main, [
        "--arch", "resnet50", "--preset", "resnet50_dp", "--export",
        str(ckpt), "--torch-checkpoint", str(back), *ov])
    assert rc == 0
    exported = torch.load(back, weights_only=True)
    for k, t in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(exported[k], t), k


def test_convert_refuses_what_the_jax_script_refuses(tmp_path, llama_ckpt):
    sd, ckpt = llama_ckpt
    pt = tmp_path / "llama.pt"
    torch.save(sd, pt)
    wide = ["--model.extra", json.dumps(dict(LLAMA, mlp_dim=256))]
    with pytest.raises(SystemExit, match="do not fit the configured model"):
        convert.main(["--arch", "llama3", "--preset", "llama3_8b_zero",
                      "--torch-checkpoint", str(pt), "--out",
                      str(tmp_path / "x"), *wide])
    with pytest.raises(SystemExit, match="export supports --arch"):
        convert.main(["--arch", "mlp", "--preset", "llama3_8b_zero",
                      "--export", str(ckpt), "--torch-checkpoint",
                      str(tmp_path / "y.pt"), *LLAMA_OV])


def _jax_llama(sd):
    model = jget_model(JModelConfig(name="llama3_8b", compute_dtype="float32",
                                    dtype="float32", extra=LLAMA))
    params = jax.tree.map(jnp.asarray, jti.llama_params_from_torch(
        sd, num_layers=2, num_heads=4, num_kv_heads=2))
    return model, params


@pytest.mark.parametrize("sampling", [
    [], ["--temperature", "0.8", "--top-k", "20", "--top-p", "0.9",
         "--seed", "7"]])
def test_generate_equals_the_jax_generate(llama_ckpt, sampling):
    sd, ckpt = llama_ckpt
    prompt = [5, 9, 42, 7, 11]
    rc, out = run_main(generate.main, [
        "--preset", "llama3_8b_zero", "--checkpoint-dir", str(ckpt),
        "--prompt", " ".join(map(str, prompt)), "--max-new", "6",
        "--device", "cpu", *sampling, *LLAMA_OV])
    assert rc == 0
    got = [int(t) for t in out.split()]
    model, params = _jax_llama(sd)
    kw = {}
    if sampling:
        kw = dict(temperature=0.8, top_k=20, top_p=0.9,
                  rng=jax.random.key(7))
    want = jgenerate(model, params, jnp.asarray([prompt], jnp.int32), 6,
                     **kw)
    assert got == np.asarray(want)[0].tolist()


def test_generate_of_a_converted_hf_llama_equals_hf_generate(tmp_path):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=False,
        attention_bias=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(cfg).eval()
    pt = tmp_path / "llama.pt"
    torch.save(hf.state_dict(), pt)
    ckpt = tmp_path / "ckpt"
    assert run_main(convert.main, [
        "--arch", "llama3", "--preset", "llama3_8b_zero",
        "--torch-checkpoint", str(pt), "--out", str(ckpt), *LLAMA_OV])[0] \
        == 0
    rc, out = run_main(generate.main, [
        "--preset", "llama3_8b_zero", "--checkpoint-dir", str(ckpt),
        "--prompt", "5 9 42 7", "--max-new", "6", "--device", "cpu",
        *LLAMA_OV])
    assert rc == 0
    with torch.no_grad():
        want = hf.generate(torch.tensor([[5, 9, 42, 7]]), max_new_tokens=6,
                           do_sample=False)
    assert [int(t) for t in out.split()] == want[0].tolist()


def test_generate_text_mode_with_a_local_tokenizer(llama_ckpt, tmp_path,
                                                  capsys):
    """``--tokenizer`` (a bare tokenizer.json, as the JAX script's test):
    text in, the continuation detokenized; no eos in the vocab is said on
    stderr."""
    tokenizers = pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    _, ckpt = llama_ckpt
    vocab = {f"w{i}": i for i in range(90)}
    vocab["[UNK]"] = 90
    tok = tokenizers.Tokenizer(
        tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    rc = generate.main(["--preset", "llama3_8b_zero", "--checkpoint-dir",
                        str(ckpt), "--prompt", "w5 w9 w42", "--max-new", "4",
                        "--tokenizer", str(path), "--device", "cpu",
                        *LLAMA_OV])
    out = capsys.readouterr()
    assert rc == 0 and "defines no eos token" in out.err
    text = out.out.strip().splitlines()[-1]
    assert text.startswith("w5 w9 w42") and len(text.split()) == 7


def test_generate_refuses_the_tensor_axis_and_a_missing_card(llama_ckpt):
    # --tp 2 decodes over a tensor = 2 mesh of the process group: one
    # process cannot hold it (tests/test_torch_tensor_pipe.py runs it on 2)
    with pytest.raises(ValueError, match="1 devices not divisible by fixed "
                       "axes product 2"):
        generate.main(["--preset", "llama3_8b_zero", "--tp", "2",
                       "--device", "cpu", *LLAMA_OV])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate.main(["--preset", "llama3_8b_zero", *LLAMA_OV])


def test_eval_equals_the_trainer(tmp_path):
    ov = ["--steps", "2", "--checkpoint_every", "2", "--log_every", "1",
          "--checkpoint_dir", str(tmp_path / "ckpt")]
    assert run_main(train_main.main, ["--preset", "mlp_mnist", "--device",
                                      "cpu", *ov])[0] == 0
    rc, line = run_main(evals.main, [
        "--preset", "mlp_mnist", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--batches", "3", "--device", "cpu"])
    assert rc == 0
    cfg = get_config("mlp_mnist", checkpoint_dir=str(tmp_path / "ckpt"))
    with Trainer(cfg, device="cpu") as trainer:
        rec = trainer.evaluate(num_batches=3)
    assert json.loads(line) == dict(step=1, eval_loss=round(rec.loss, 6),
                                    eval_accuracy=round(rec.accuracy, 6),
                                    batches=3)
    assert run_main(evals.main, ["--preset", "mlp_mnist", "--device", "cpu",
                                 "--checkpoint-dir",
                                 str(tmp_path / "none")])[0] == 1


# the JAX serve script's summary keys (scripts/serve.py); the port's adds
# the device's name
JAX_SUMMARY = {"requests", "completed", "rejected", "reject_reasons",
               "preempted", "wall_s", "tokens_out", "tokens_per_s",
               "ttft_p50_s", "ttft_p95_s", "token_lat_p50_s",
               "token_lat_p95_s", "token_lat_p99_s", "rounds", "occupancy",
               "kv_util"}


def test_metrics_out_records_have_the_jax_keys(tmp_path, tiny_llama):
    from pytorch_distributed_nn_tpu.serve import ServingEngine as JEngine
    from pytorch_distributed_nn_tpu.utils.metrics import (
        MetricsLogger as JMetrics,
    )

    path = tmp_path / "serve.jsonl"
    rc, out = run_main(serve_main.main, [
        "--preset", "llama3_8b_zero", "--device", "cpu", "--requests", "4",
        "--rate", "100", "--max-new", "3", "--max-prompt", "12",
        "--metrics-out", str(path), *LLAMA_OV])
    assert rc == 0 and len(out.strip().splitlines()) == 1
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    reqs = [r for r in recs if r["event"] == "serve_request"]
    summary = [r for r in recs if r["event"] == "serve_summary"]
    assert len(summary) == 1 and summary[0]["completed"] == 4
    # every finished request, the warm-up's included
    assert len(reqs) > 4
    assert set(summary[0]) == JAX_SUMMARY | {"event", "time", "process",
                                             "device"}
    # the JAX engine's record of the same kind of request
    jpath = tmp_path / "jax.jsonl"
    jm, params = tiny_llama
    metrics = JMetrics(str(jpath))
    eng = JEngine(jm, params, max_slots=2, max_seq_len=32, metrics=metrics)
    eng.submit(np.asarray([3, 4, 5], np.int32), 3)
    eng.run_until_idle()
    metrics.close()
    jrec = [json.loads(x) for x in jpath.read_text().splitlines()
            if json.loads(x)["event"] == "serve_request"]
    assert {tuple(sorted(r)) for r in reqs} == {tuple(sorted(jrec[0]))}
    assert set(reqs[0]["waterfall"]) == set(jrec[0]["waterfall"])


def test_scripts_run_as_modules(tmp_path, llama_ckpt):
    sd, ckpt = llama_ckpt
    pt = tmp_path / "llama.pt"
    torch.save(sd, pt)
    r = run_module("scripts.convert", "--arch", "llama3", "--preset",
                   "llama3_8b_zero", "--torch-checkpoint", str(pt), "--out",
                   str(tmp_path / "ckpt"), *LLAMA_OV)
    assert r.returncode == 0, r.stderr[-2000:]
    r = run_module("scripts.generate", "--preset", "llama3_8b_zero",
                   "--checkpoint-dir", str(tmp_path / "ckpt"), "--prompt",
                   "5 9 42", "--max-new", "3", "--device", "cpu", *LLAMA_OV)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(r.stdout.split()) == 6
    r = run_module("scripts.eval", "--preset", "llama3_8b_zero",
                   "--checkpoint-dir", str(tmp_path / "ckpt"), "--batches",
                   "1", "--device", "cpu", *LLAMA_OV)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["step"] == -1

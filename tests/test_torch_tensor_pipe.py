"""Port parity of the tensor axis inside the pipeline and in decoding,
against the JAX package, on the CPU (``tests/test_torch_tensor.py`` holds
the layout and the Trainer's other strategies).

- Pipeline x tensor (``tests/test_pipeline.py``'s
  ``test_pipeline_x_tensor_parallel`` cases on 4 gloo ranks): the tiny LM
  (4 layers, d 64, 4 heads, MLP 128, vocab 128, T 16, batch 8, 4
  microbatches, f32, 2 adam steps) at pipe 2 x tensor 2 under gpipe, 1f1b
  and interleaved (2 chunks), one rank a stage, against the JAX
  ``Trainer`` on one device from the same weights: losses at rtol 2e-5 and
  atol 1e-5, the parameters after the steps (``read_full_params`` of the
  run's checkpoint) at 1e-4. The same on 2 ranks that each hold both
  stages (``pipe_local``, the one-card layout), under gpipe and 1f1b.
- ``generate(mesh=)`` at tensor 2 on ``tests/conftest.py``'s tiny Llama,
  float and int8 (quantized from the same weights): tokens equal to the
  one-process ``generate()`` and to the JAX ``generate(mesh=)`` on a
  tensor = 2 x data = 4 CPU mesh; the int8 model's leaves stay whole on
  both ranks and only its KV cache is split on the heads. ``ragged`` with
  a mesh raises, as in the JAX package. ``scripts/generate.py --tp 2``
  prints the one-process script's tokens.

Two ``torchrun`` gangs (4 and 2 ranks; nonce, world check, hard timeout)
run while the JAX runs go on.
"""

import json
import subprocess
import sys
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_nn_tpu.inference import generate as jgenerate
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.nn.quantized import (
    quantize_model_params as jquantize,
)
from pytorch_distributed_nn_tpu.runtime.mesh import MeshSpec as JMeshSpec
from pytorch_distributed_nn_tpu.runtime.mesh import make_mesh
from pytorch_distributed_nn_tpu.train.trainer import Trainer as JTrainer
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.inference.generate import generate
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.nn.quantized import quantize_state_dict
from pytorch_distributed_nn_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_nn_tpu_torch.train.checkpoint import read_full_params
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    llama_params_from_jax,
    params_from_jax,
)
from test_torch_sequence import _env

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300
LM = dict(num_layers=4, d_model=64, num_heads=4, mlp_dim=128,
          vocab_size=128, max_len=32)
LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             mlp_dim=128, vocab_size=97)
PROMPT = [[5, 17, 42], [96, 1, 3]]
NEW = 6
# name -> (ranks, schedule, pipe_chunks)
PIPE_RUNS = {"gpipe": (4, "gpipe", 1), "1f1b": (4, "1f1b", 1),
             "interleaved": (4, "interleaved", 2),
             "local_gpipe": (2, "gpipe", 1), "local_1f1b": (2, "1f1b", 1)}


def _overrides(**extra):
    return {"steps": "2", "log_every": "1", "data.prefetch": "0",
            "data.batch_size": "8", "data.seq_len": "16",
            "data.vocab_size": "128", "model.compute_dtype": "float32",
            "model.remat": "false", "model.extra": json.dumps(LM),
            "parallel.microbatches": "4", **extra}


def _pipe_overrides(schedule, chunks):
    return _overrides(**{"parallel.strategy": "pipeline", "mesh.pipe": "2",
                         "mesh.tensor": "2", "mesh.data": "1",
                         "parallel.pipeline_schedule": schedule,
                         "parallel.pipe_chunks": str(chunks)})


def _llama_cfg(quantized=False):
    return dict(name="llama3_8b", compute_dtype="float32", dtype="float32",
                extra=dict(LLAMA, quantized=quantized))


_WORKER = r"""
import contextlib, io, json, sys
import numpy as np
import torch
from pytorch_distributed_nn_tpu_torch.config import ModelConfig, get_config
from pytorch_distributed_nn_tpu_torch.inference.generate import generate
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.nn.quantized import quantize_state_dict
from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
from pytorch_distributed_nn_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_nn_tpu_torch.scripts import generate as script
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

out_dir, runs, nonce = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
proc = bootstrap.initialize("cpu")
ranks = [None] * proc.world_size
torch.distributed.all_gather_object(ranks, (proc.rank, nonce))
res = {"nonce": nonce, "world": proc.world_size, "gang": json.dumps(ranks)}
init = {k: torch.from_numpy(v)
        for k, v in np.load(f"{out_dir}/init_lm.npz").items()}
for name, ov in runs["pipe"].items():
    ov = dict(ov, checkpoint_dir=f"{out_dir}/ckpt_{name}",
              checkpoint_every="2")
    with Trainer(get_config("transformer_lm_pp", **ov), device="cpu",
                 params=init) as t:
        t.train()
        res[f"{name}/losses"] = np.array(t.losses())
        res[f"{name}/local"] = int(t.mesh.pipe_local)
        res[f"{name}/split"] = json.dumps(sorted(t.model.tensor_split))
if runs.get("generate"):
    llama = {k: torch.from_numpy(v)
             for k, v in np.load(f"{out_dir}/init_llama.npz").items()}
    mesh = MeshSpec(tensor=2, data=-1)
    prompt = np.asarray(runs["generate"]["prompt"], np.int32)
    for kind, cfg in runs["generate"]["models"].items():
        model = get_model(ModelConfig(**cfg), device="cpu")
        model.load_state_dict(llama if kind == "float"
                              else quantize_state_dict(llama, model))
        model.eval()
        res[f"gen_{kind}/tokens"] = generate(
            model, prompt, runs["generate"]["new"], mesh=mesh).numpy()
        res[f"gen_{kind}/cache_heads"] = model.init_cache(1, 4)[
            "layer0"]["cached_key"].shape[2]
        res[f"gen_{kind}/split"] = json.dumps(sorted(model.tensor_split))
        try:
            generate(model, prompt, 2, mesh=mesh, prompt_lengths=[2, 3])
        except ValueError as e:
            res[f"gen_{kind}/ragged"] = str(e)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = script.main(runs["generate"]["script"] + ["--tp", "2"])
    res["script/rc"] = rc
    res["script/out"] = out.getvalue()
np.savez(f"{out_dir}/rank{proc.rank}.npz", **res)
bootstrap.shutdown()
"""

SCRIPT_ARGV = ["--preset", "llama3_8b_zero", "--device", "cpu",
               "--prompt", "5 17 42", "--max-new", "4",
               "--model.compute_dtype", "float32", "--model.extra",
               json.dumps(LLAMA)]


class _Gang:
    def __init__(self, script, out_dir, runs, nproc):
        self.nonce, self.nproc = uuid.uuid4().hex, nproc
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), str(script), str(out_dir),
               json.dumps(runs), self.nonce]
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=_env(),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self._ranks = None

    def ranks(self):
        if self._ranks is None:
            try:
                out, err = self.proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, (out[-2000:], err[-4000:])
            ranks = [dict(np.load(self.out_dir / f"rank{r}.npz"))
                     for r in range(self.nproc)]
            want = [[r, self.nonce] for r in range(self.nproc)]
            for r in ranks:
                assert str(r["nonce"]) == self.nonce
                assert int(r["world"]) == self.nproc
                assert json.loads(str(r["gang"])) == want
            self._ranks = ranks
        return self._ranks


def _jax_lm_trainer():
    cfg = jconfig.get_config("transformer_lm_pp", **_overrides(
        **{"parallel.strategy": "single", "mesh.pipe": "1"}))
    return JTrainer(cfg, mesh=make_mesh(cfg.mesh.resolve(1),
                                        devices=jax.devices()[:1]))


def _jax_llama(quantized):
    model = jget_model(JModelConfig(**_llama_cfg(quantized)))
    tokens = jnp.zeros((1, 8), jnp.int32)
    params = jget_model(JModelConfig(**_llama_cfg())).init(
        jax.random.key(1), tokens, train=False)["params"]
    if quantized:
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.key(0), tokens, train=False))["params"]
        params = jquantize(dict(params), shapes)
    return model, params


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_pipe_gang")
    t = _jax_lm_trainer()
    init = jax.device_get(t.state.params)  # before its steps
    _, llama = _jax_llama(False)
    gangs = {}
    for nproc in (4, 2):
        sub = d / f"gang{nproc}"
        sub.mkdir()
        np.savez(sub / "init_lm.npz", **{
            k: v.numpy() for k, v in params_from_jax(init).items()})
        np.savez(sub / "init_llama.npz", **{
            k: v.numpy()
            for k, v in llama_params_from_jax(jax.device_get(llama)).items()})
        runs = {"pipe": {name: _pipe_overrides(sched, chunks)
                         for name, (n, sched, chunks) in PIPE_RUNS.items()
                         if n == nproc}}
        if nproc == 2:
            runs["generate"] = {
                "prompt": PROMPT, "new": NEW, "script": SCRIPT_ARGV,
                "models": {"float": _llama_cfg(), "int8": _llama_cfg(True)}}
        script = sub / "worker.py"
        script.write_text(_WORKER)
        gangs[nproc] = _Gang(script, sub, runs, nproc)
    return gangs, d, init, t


@pytest.fixture(scope="module")
def jax_runs(started):
    t = started[3]
    t.train()
    out = {"lm": (np.array(t.losses()), jax.device_get(t.state.params))}
    t.close()
    mesh = make_mesh(JMeshSpec(tensor=2, data=4).resolve(8))
    prompt = jnp.asarray(PROMPT, jnp.int32)
    for kind in ("float", "int8"):
        model, params = _jax_llama(kind == "int8")
        out[kind] = np.asarray(jgenerate(model, params, prompt, NEW,
                                         mesh=mesh))
    return out


@pytest.fixture(scope="module")
def gangs(started, jax_runs):
    handles, d, init, _ = started
    return {n: h.ranks() for n, h in handles.items()}, d, init


@pytest.mark.parametrize("name", list(PIPE_RUNS))
def test_pipeline_x_tensor_matches_the_jax_trainer(gangs, jax_runs, name):
    ranks, d, init = gangs
    nproc = PIPE_RUNS[name][0]
    j_losses, j_final = jax_runs["lm"]
    for r in ranks[nproc]:
        assert int(r[f"{name}/local"]) == (nproc == 2)
        split = json.loads(str(r[f"{name}/split"]))
        assert any("query.kernel" in k for k in split), split
        assert any("mlp_in.kernel" in k for k in split), split
        np.testing.assert_allclose(r[f"{name}/losses"], j_losses,
                                   rtol=2e-5, atol=1e-5)
    got = read_full_params(d / f"gang{nproc}" / f"ckpt_{name}")
    want, start = params_from_jax(j_final), params_from_jax(init)
    assert sorted(got) == sorted(want)
    for k, b in want.items():
        if k.endswith("attn.key.bias"):  # no gradient: rounding noise
            continue
        np.testing.assert_allclose(got[k].numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(b.numpy()).max(),
                                   err_msg=k)
    assert any(not torch.equal(got[k], start[k]) for k in want)


def _one_device(kind):
    cfg = ModelConfig(**_llama_cfg(kind == "int8"))
    model = get_model(cfg, device="cpu")
    _, llama = _jax_llama(False)
    sd = llama_params_from_jax(jax.device_get(llama))
    model.load_state_dict(sd if kind == "float"
                          else quantize_state_dict(sd, model))
    model.eval()
    return generate(model, np.asarray(PROMPT, np.int32), NEW).numpy()


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_generate_mesh_tokens_equal_one_device_and_jax(gangs, jax_runs,
                                                        kind):
    ranks = gangs[0][2]
    want = _one_device(kind)
    np.testing.assert_array_equal(want, jax_runs[kind])
    for r in ranks:
        np.testing.assert_array_equal(r[f"gen_{kind}/tokens"], want)
        # the KV cache holds each rank's key/value heads (2 / 2)
        assert int(r[f"gen_{kind}/cache_heads"]) == 1
        split = json.loads(str(r[f"gen_{kind}/split"]))
        if kind == "int8":  # kernel_q, embedding_q and scale stay whole
            assert split == []
        else:
            assert any("query.kernel" in k for k in split), split
        assert "mesh" in str(r[f"gen_{kind}/ragged"])


def test_generate_script_tp2_prints_the_one_process_tokens(gangs, capsys):
    from pytorch_distributed_nn_tpu_torch.scripts import generate as script

    ranks = gangs[0][2]
    assert script.main(list(SCRIPT_ARGV)) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(want.split()) == 3 + 4
    assert int(ranks[0]["script/rc"]) == 0
    assert str(ranks[0]["script/out"]).strip().splitlines()[-1] == want
    assert str(ranks[1]["script/out"]).strip() == ""  # rank 0 prints


def test_generate_ragged_with_a_mesh_raises_before_any_collective():
    model = get_model(ModelConfig(**_llama_cfg()), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        generate(model, np.ones((2, 4), np.int32), 2,
                 prompt_lengths=[2, 4], mesh=MeshSpec(tensor=2, data=-1))

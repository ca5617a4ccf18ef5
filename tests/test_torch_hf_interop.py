"""Port parity of the HF/torch weight bridge (``utils/torch_interop.py``,
this package's copy of the JAX package's module), on the CPU.

For every architecture a seeded HF-layout state_dict (numpy values in HF's
key names and shapes, no download) goes through the JAX module and the
port's: the flax-named trees are equal bit for bit (dtypes included).
Each of the five exporters round-trips (export of the import gives back
the state_dict; the port's export equals the JAX export), a missing key
or an unmapped extra key raises as in the JAX module, the tied-head rule
(``_maybe_untied_head``) omits a tied head and warns for an untied one,
and a bf16 state_dict reads as f32 exactly.
"""

import warnings

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.utils import torch_interop as jti
from pytorch_distributed_nn_tpu_torch.utils import torch_interop as tti


def _t(rng, *shape):
    return torch.from_numpy(
        (rng.standard_normal(shape) * 0.1).astype(np.float32))


def hf_llama(rng, L=2, D=64, H=4, Hkv=2, F=128, V=97, head=True):
    """``LlamaForCausalLM.state_dict()``'s keys and shapes."""
    dh = D // H
    sd = {"model.embed_tokens.weight": _t(rng, V, D)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": 1 + _t(rng, D),
            p + "self_attn.q_proj.weight": _t(rng, H * dh, D),
            p + "self_attn.k_proj.weight": _t(rng, Hkv * dh, D),
            p + "self_attn.v_proj.weight": _t(rng, Hkv * dh, D),
            p + "self_attn.o_proj.weight": _t(rng, D, H * dh),
            p + "post_attention_layernorm.weight": 1 + _t(rng, D),
            p + "mlp.gate_proj.weight": _t(rng, F, D),
            p + "mlp.up_proj.weight": _t(rng, F, D),
            p + "mlp.down_proj.weight": _t(rng, D, F),
        })
    sd["model.norm.weight"] = 1 + _t(rng, D)
    if head:
        sd["lm_head.weight"] = _t(rng, V, D)
    return sd


def _hf_encoder_layer(rng, sd, p, names, D, F):
    """BERT's and ViT's encoder layer: ``names`` maps the parts to their
    HF prefixes under ``p``."""
    for part in ("query", "key", "value"):
        sd[p + names[part] + ".weight"] = _t(rng, D, D)
        sd[p + names[part] + ".bias"] = _t(rng, D)
    for dense, shape in (("out", (D, D)), ("mlp_in", (F, D)),
                         ("mlp_out", (D, F))):
        sd[p + names[dense] + ".weight"] = _t(rng, *shape)
        sd[p + names[dense] + ".bias"] = _t(rng, shape[0])
    for ln in ("ln1", "ln2"):
        sd[p + names[ln] + ".weight"] = 1 + _t(rng, D)
        sd[p + names[ln] + ".bias"] = _t(rng, D)


def hf_bert(rng, L=2, D=32, H=4, F=64, V=97, P=32, pooler=True):
    """``BertForMaskedLM.state_dict()`` (plus a pooler, which is dropped)."""
    e = "bert.embeddings."
    sd = {e + "word_embeddings.weight": _t(rng, V, D),
          e + "position_embeddings.weight": _t(rng, P, D),
          e + "token_type_embeddings.weight": _t(rng, 2, D),
          e + "LayerNorm.weight": 1 + _t(rng, D),
          e + "LayerNorm.bias": _t(rng, D),
          e + "position_ids": torch.arange(P)[None]}
    names = dict(query="attention.self.query", key="attention.self.key",
                 value="attention.self.value",
                 out="attention.output.dense",
                 ln1="attention.output.LayerNorm",
                 mlp_in="intermediate.dense", mlp_out="output.dense",
                 ln2="output.LayerNorm")
    for i in range(L):
        _hf_encoder_layer(rng, sd, f"bert.encoder.layer.{i}.", names, D, F)
    c = "cls.predictions."
    sd.update({c + "transform.dense.weight": _t(rng, D, D),
               c + "transform.dense.bias": _t(rng, D),
               c + "transform.LayerNorm.weight": 1 + _t(rng, D),
               c + "transform.LayerNorm.bias": _t(rng, D),
               c + "decoder.weight": sd[e + "word_embeddings.weight"],
               c + "bias": _t(rng, V)})
    sd[c + "decoder.bias"] = sd[c + "bias"]
    if pooler:
        sd["bert.pooler.dense.weight"] = _t(rng, D, D)
        sd["bert.pooler.dense.bias"] = _t(rng, D)
    return sd


def hf_gpt2(rng, L=2, D=32, H=4, V=97, P=64, head=False):
    """``GPT2LMHeadModel.state_dict()``: Conv1D weights (in, out), the
    causal-mask buffers, and the head only when ``head`` (untied)."""
    sd = {"transformer.wte.weight": _t(rng, V, D),
          "transformer.wpe.weight": _t(rng, P, D)}
    for i in range(L):
        p = f"transformer.h.{i}."
        sd.update({
            p + "ln_1.weight": 1 + _t(rng, D), p + "ln_1.bias": _t(rng, D),
            p + "attn.c_attn.weight": _t(rng, D, 3 * D),
            p + "attn.c_attn.bias": _t(rng, 3 * D),
            p + "attn.c_proj.weight": _t(rng, D, D),
            p + "attn.c_proj.bias": _t(rng, D),
            p + "attn.bias": torch.ones(1, 1, P, P).tril(),
            p + "ln_2.weight": 1 + _t(rng, D), p + "ln_2.bias": _t(rng, D),
            p + "mlp.c_fc.weight": _t(rng, D, 4 * D),
            p + "mlp.c_fc.bias": _t(rng, 4 * D),
            p + "mlp.c_proj.weight": _t(rng, 4 * D, D),
            p + "mlp.c_proj.bias": _t(rng, D),
        })
    sd["transformer.ln_f.weight"] = 1 + _t(rng, D)
    sd["transformer.ln_f.bias"] = _t(rng, D)
    if head:
        sd["lm_head.weight"] = _t(rng, V, D)
    return sd


def hf_vit(rng, L=2, D=32, F=64, C=3, patch=4, image=16, classes=10):
    """``ViTForImageClassification.state_dict()``."""
    n = (image // patch) ** 2 + 1
    e = "vit.embeddings."
    sd = {e + "cls_token": _t(rng, 1, 1, D),
          e + "position_embeddings": _t(rng, 1, n, D),
          e + "patch_embeddings.projection.weight": _t(rng, D, C, patch,
                                                       patch),
          e + "patch_embeddings.projection.bias": _t(rng, D)}
    names = dict(query="attention.attention.query",
                 key="attention.attention.key",
                 value="attention.attention.value",
                 out="attention.output.dense", ln1="layernorm_before",
                 mlp_in="intermediate.dense", mlp_out="output.dense",
                 ln2="layernorm_after")
    for i in range(L):
        _hf_encoder_layer(rng, sd, f"vit.encoder.layer.{i}.", names, D, F)
    sd.update({"vit.layernorm.weight": 1 + _t(rng, D),
               "vit.layernorm.bias": _t(rng, D),
               "classifier.weight": _t(rng, classes, D),
               "classifier.bias": _t(rng, classes)})
    return sd


def _bn(rng, sd, p, c):
    sd.update({p + ".weight": 1 + _t(rng, c), p + ".bias": _t(rng, c),
               p + ".running_mean": _t(rng, c),
               p + ".running_var": 1 + _t(rng, c).abs(),
               p + ".num_batches_tracked": torch.tensor(7)})


def hf_resnet50(rng, stage_sizes=(1, 1, 1, 1), width=8, classes=10, C=3):
    """torchvision ``resnet50().state_dict()``'s layout at ``width`` (64
    in torchvision) and ``stage_sizes`` blocks a stage."""
    sd = {"conv1.weight": _t(rng, width, C, 7, 7)}
    _bn(rng, sd, "bn1", width)
    cin = width
    for s, n in enumerate(stage_sizes):
        f = width * 2 ** s
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            for j, (o, i, k) in enumerate(
                    ((f, cin, 1), (f, f, 3), (4 * f, f, 1)), start=1):
                sd[f"{p}.conv{j}.weight"] = _t(rng, o, i, k, k)
                _bn(rng, sd, f"{p}.bn{j}", o)
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = _t(rng, 4 * f, cin, 1, 1)
                _bn(rng, sd, f"{p}.downsample.1", 4 * f)
            cin = 4 * f
    sd["fc.weight"] = _t(rng, classes, cin)
    sd["fc.bias"] = _t(rng, classes)
    return sd


def hf_lenet(rng, C=3, classes=10, image=32):
    """The reference's LeNet: conv(6, 5, pad 2), pool, conv(16, 5), pool,
    fc 120 / 84 / classes."""
    side = ((image // 2) - 4) // 2
    return {"conv1.weight": _t(rng, 6, C, 5, 5), "conv1.bias": _t(rng, 6),
            "conv2.weight": _t(rng, 16, 6, 5, 5), "conv2.bias": _t(rng, 16),
            "fc1.weight": _t(rng, 120, 16 * side * side),
            "fc1.bias": _t(rng, 120),
            "fc2.weight": _t(rng, 84, 120), "fc2.bias": _t(rng, 84),
            "fc3.weight": _t(rng, classes, 84),
            "fc3.bias": _t(rng, classes)}


def hf_mlp(rng, dims=(784, 128, 10)):
    """The reference's ``Net``: a Sequential of Linears."""
    sd = {}
    for j, (i, o) in enumerate(zip(dims, dims[1:])):
        sd[f"net.{2 * j}.weight"] = _t(rng, o, i)
        sd[f"net.{2 * j}.bias"] = _t(rng, o)
    return sd


# arch -> (state_dict maker, importer keywords)
ARCHS = {
    "llama3": (hf_llama, dict(num_layers=2, num_heads=4, num_kv_heads=2)),
    "llama3_tied": (lambda r: hf_llama(r, head=False),
                    dict(num_layers=2, num_heads=4, num_kv_heads=2)),
    "bert": (hf_bert, dict(num_layers=2, num_heads=4)),
    "gpt2": (hf_gpt2, dict(num_layers=2, num_heads=4)),
    "gpt2_untied": (lambda r: hf_gpt2(r, head=True),
                    dict(num_layers=2, num_heads=4)),
    "resnet50": (hf_resnet50, dict(stage_sizes=(1, 1, 1, 1))),
    "resnet50_s2d": (hf_resnet50, dict(stage_sizes=(1, 1, 1, 1),
                                       stem="s2d")),
    "vit": (hf_vit, dict(num_layers=2, num_heads=4)),
    "lenet": (hf_lenet, {}),
    "mlp": (hf_mlp, {}),
}


def _importer(module, arch):
    name = arch.split("_")[0]
    return getattr(module, {"llama3": "llama"}.get(name, name)
                   + "_params_from_torch")


def _exporter(module, arch):
    name = arch.split("_")[0]
    return getattr(module, {"llama3": "llama"}.get(name, name)
                   + "_params_to_torch")


def assert_trees_equal(got, want, path=""):
    if isinstance(want, tuple):  # ResNet-50's (params, model_state)
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_import_matches_jax_bit_for_bit(arch):
    make, kw = ARCHS[arch]
    sd = make(np.random.default_rng(len(arch)))
    assert_trees_equal(_importer(tti, arch)(sd, **kw),
                       _importer(jti, arch)(sd, **kw))


@pytest.mark.parametrize("arch", ["llama3", "llama3_tied", "bert", "gpt2",
                                  "gpt2_untied", "resnet50", "resnet50_s2d",
                                  "vit"])
def test_exporter_round_trips_and_matches_jax(arch):
    make, kw = ARCHS[arch]
    sd = make(np.random.default_rng(len(arch) + 1))
    tree = _importer(tti, arch)(sd, **kw)
    args = (tree,)
    if arch.startswith("resnet50"):
        args = (*tree, )
        kw = dict(stage_sizes=kw["stage_sizes"])
    else:
        kw = {}
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        got = _exporter(tti, arch)(*args, **kw)
        want = _exporter(jti, arch)(*args, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    # the round trip: every exported tensor is the state_dict's (a tied
    # Llama's head is written whole, as the embedding)
    for k, t in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        want_t = sd.get(k, sd.get("model.embed_tokens.weight"))
        assert torch.equal(t, want_t.float()), k
    # and what the export leaves out is a buffer or a tied head
    left = set(sd) - set(got)
    assert all(k.endswith(("position_ids", "attn.bias"))
               or k.startswith("bert.pooler") or k == "lm_head.weight"
               or k == "cls.predictions.decoder.weight" for k in left), left


def _outcome(module, arch, sd, kw):
    try:
        return "ok", _importer(module, arch)(sd, **kw)
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_missing_or_extra_key_raises_as_jax(arch):
    """A state_dict with its first weight gone, or with an extra 4-D
    weight: the port does what the JAX module does (the converters of the
    HF layouts raise on both; LeNet's and the MLP's, which take the
    weights in registration order, raise where the JAX ones do)."""
    make, kw = ARCHS[arch]
    rng = np.random.default_rng(3)
    sd = make(rng)
    gone = dict(sd)
    del gone[next(k for k in sd if k.endswith("weight"))]
    extra = dict(sd, **{"mystery.layer.weight": _t(rng, 4, 4, 3, 3)})
    for broken in (gone, extra):
        got, want = (_outcome(m, arch, broken, kw) for m in (tti, jti))
        assert got[0] == want[0]
        if want[0] == "ok":
            assert_trees_equal(got[1], want[1])
        else:
            assert got[1] == want[1]
        if not arch.startswith(("lenet", "mlp")):
            assert want[0] != "ok"


def test_tied_head_is_omitted_and_untied_warns():
    rng = np.random.default_rng(4)
    tied = tti.gpt2_params_from_torch(hf_gpt2(rng), num_layers=2,
                                      num_heads=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert "lm_head.weight" not in tti.gpt2_params_to_torch(tied)
    untied = tti.gpt2_params_from_torch(hf_gpt2(rng, head=True),
                                        num_layers=2, num_heads=4)
    with pytest.warns(UserWarning, match="differs from the embedding"):
        assert "lm_head.weight" in tti.gpt2_params_to_torch(untied)


def test_bf16_state_dict_reads_as_f32_exactly():
    sd = hf_llama(np.random.default_rng(5))
    bf = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tree = tti.llama_params_from_torch(bf, num_layers=2, num_heads=4,
                                       num_kv_heads=2)
    want = jti.llama_params_from_torch(
        {k: v.float() for k, v in bf.items()}, num_layers=2, num_heads=4,
        num_kv_heads=2)
    assert_trees_equal(tree, want)
    back = tti.llama_params_to_torch(tree)
    for k, t in back.items():
        assert torch.equal(t.to(torch.bfloat16), bf[k]), k

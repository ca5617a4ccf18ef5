"""PyTorch/HF-layout state_dicts <-> the flax-named parameter trees.

This is this package's copy of the JAX package's ``utils/torch_interop.py``
(which imports only numpy, but the port imports nothing of the JAX
package). The name stays, as do every function's name and behaviour, so a
converter here and there is the same call. It moves weights between
torch/HF key layouts and the flax-named nested trees (numpy leaves) that
``utils/interop.py`` turns into this package's ``state_dict``
(``vision_params_from_jax``, ``params_from_jax``) and back
(``vision_params_to_jax``, ``params_to_jax``); ``scripts/convert.py`` here is
its user.

Conventions bridged:

- torch ``nn.Linear.weight`` is ``(out, in)``; flax ``Dense.kernel`` is
  ``(in, out)``: transposed.
- attention projections are ``DenseGeneral`` kernels shaped ``(d_model,
  heads, head_dim)`` (q/k/v) and ``(heads, head_dim, d_model)`` (out);
  torch/HF fuse heads into one matrix row dim.
- rotary halves: both sides use the split-half convention (HF
  ``rotate_half``; ``nn.attention.rotary_embedding``), so q/k need **no**
  permutation: weights map 1:1.

A bf16 tensor (an HF checkpoint in its shipping dtype) is read as f32,
which holds it exactly (numpy has no bfloat16); the JAX module reads only
types numpy has.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def to_numpy(x) -> np.ndarray:
    """torch tensor | numpy array → numpy (detached, CPU, contiguous; a
    bf16 tensor as f32, exactly)."""
    if hasattr(x, "detach"):  # torch tensor without importing torch
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        x = x.numpy()
    return np.ascontiguousarray(x)


def linear_kernel(weight) -> np.ndarray:
    """torch Linear weight (out, in) → flax Dense kernel (in, out)."""
    return to_numpy(weight).T


def _heads_in_kernel(weight, heads: int, head_dim: int) -> np.ndarray:
    """(H*Dh, D) q/k/v projection → DenseGeneral kernel (D, H, Dh)."""
    w = to_numpy(weight)
    d_model = w.shape[1]
    return w.T.reshape(d_model, heads, head_dim)


class _TrackingDict:
    """Read-through view of a state_dict that records consumed keys, so
    converters can fail loudly on tensors their layout never mapped."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = sd
        self.consumed: set[str] = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return self.sd[key]

    def get(self, key, default=None):
        if key in self.sd:
            return self[key]
        return default

    def check_consumed(self, ignorable: tuple[str, ...]) -> None:
        leftover = [k for k in self.sd if k not in self.consumed
                    and not any(frag in k for frag in ignorable)]
        if leftover:
            raise ValueError(
                f"state_dict tensors this layout does not map (model "
                f"variant mismatch?): {sorted(leftover)[:8]}"
            )


def _ln_leaf(sd, prefix: str) -> dict:
    """HF LayerNorm ``{prefix}.weight/.bias`` → flax {scale, bias}."""
    return {"scale": to_numpy(sd[prefix + ".weight"]),
            "bias": to_numpy(sd[prefix + ".bias"])}


def _dense_leaf(sd, prefix: str) -> dict:
    """HF Linear ``{prefix}.weight/.bias`` → flax Dense leaf."""
    return {"kernel": linear_kernel(sd[prefix + ".weight"]),
            "bias": to_numpy(sd[prefix + ".bias"])}


def _heads_in_leaf(sd, prefix: str, heads: int, head_dim: int) -> dict:
    """HF per-head input projection → DenseGeneral (D, H, Dh) leaf."""
    return {
        "kernel": _heads_in_kernel(sd[prefix + ".weight"], heads,
                                   head_dim),
        "bias": to_numpy(sd[prefix + ".bias"]).reshape(heads, head_dim),
    }


def _heads_out_kernel(weight, heads: int, head_dim: int) -> np.ndarray:
    """(D, H*Dh) out projection → DenseGeneral kernel (H, Dh, D)."""
    w = to_numpy(weight)
    d_model = w.shape[0]
    return w.T.reshape(heads, head_dim, d_model)


def llama_params_from_torch(
    state_dict: Mapping[str, Any],
    *,
    num_layers: int,
    num_heads: int,
    num_kv_heads: int,
) -> dict:
    """HF ``LlamaForCausalLM.state_dict()`` → params for models/llama.py.

    Key layout bridged (HF side): ``model.embed_tokens``, per layer
    ``model.layers.{i}.{input_layernorm, self_attn.{q,k,v,o}_proj,
    post_attention_layernorm, mlp.{gate,up,down}_proj}``, ``model.norm``,
    ``lm_head`` (untied, as Llama-3 ships). Raises KeyError on missing
    keys — a truncated checkpoint should fail loudly, not half-load.
    """
    tracked = _TrackingDict(state_dict)
    embed = to_numpy(tracked["model.embed_tokens.weight"])  # (V, D)
    d_model = embed.shape[1]
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
    head_dim = d_model // num_heads

    params: dict = {"tok_embed": {"embedding": embed}}
    for i in range(num_layers):
        p = f"model.layers.{i}."
        params[f"layer{i}"] = {
            "attn_norm": {"scale": to_numpy(
                tracked[p + "input_layernorm.weight"])},
            "attn": {
                "query": {"kernel": _heads_in_kernel(
                    tracked[p + "self_attn.q_proj.weight"], num_heads,
                    head_dim)},
                "key": {"kernel": _heads_in_kernel(
                    tracked[p + "self_attn.k_proj.weight"], num_kv_heads,
                    head_dim)},
                "value": {"kernel": _heads_in_kernel(
                    tracked[p + "self_attn.v_proj.weight"], num_kv_heads,
                    head_dim)},
                "out": {"kernel": _heads_out_kernel(
                    tracked[p + "self_attn.o_proj.weight"], num_heads,
                    head_dim)},
            },
            "mlp_norm": {"scale": to_numpy(
                tracked[p + "post_attention_layernorm.weight"])},
            "gate_proj": {"kernel": linear_kernel(
                tracked[p + "mlp.gate_proj.weight"])},
            "up_proj": {"kernel": linear_kernel(
                tracked[p + "mlp.up_proj.weight"])},
            "down_proj": {"kernel": linear_kernel(
                tracked[p + "mlp.down_proj.weight"])},
        }
    params["final_norm"] = {"scale": to_numpy(tracked["model.norm.weight"])}
    lm_head = tracked.get("lm_head.weight")
    if lm_head is None:  # tied-embedding checkpoints (llama-2 style)
        lm_head = embed
    params["lm_head"] = {"kernel": to_numpy(lm_head).T}

    # Fail loudly on anything the layout above didn't consume (e.g.
    # attention biases from a Qwen-style attention_bias=True checkpoint):
    # silently dropping learned tensors would produce wrong logits with
    # no error. Non-learned rotary buffers are the one known exception.
    tracked.check_consumed(ignorable=("rotary_emb",))
    return params


def llama_params_to_torch(params: Mapping[str, Any]) -> dict:
    """Inverse of :func:`llama_params_from_torch`: params →
    HF-layout state dict of torch tensors."""
    t = _tt  # shared copy=True/from_numpy helper

    out = {
        "model.embed_tokens.weight": t(params["tok_embed"]["embedding"]),
        "model.norm.weight": t(params["final_norm"]["scale"]),
        "lm_head.weight": t(np.asarray(params["lm_head"]["kernel"]).T),
    }
    i = 0
    while f"layer{i}" in params:
        layer = params[f"layer{i}"]
        p = f"model.layers.{i}."
        attn = layer["attn"]
        d_model = np.asarray(attn["query"]["kernel"]).shape[0]

        def fuse_in(kernel):  # (D, H, Dh) → (H*Dh, D)
            return t(np.asarray(kernel).reshape(d_model, -1).T)

        out[p + "input_layernorm.weight"] = t(layer["attn_norm"]["scale"])
        out[p + "self_attn.q_proj.weight"] = fuse_in(attn["query"]["kernel"])
        out[p + "self_attn.k_proj.weight"] = fuse_in(attn["key"]["kernel"])
        out[p + "self_attn.v_proj.weight"] = fuse_in(attn["value"]["kernel"])
        out[p + "self_attn.o_proj.weight"] = t(
            np.asarray(attn["out"]["kernel"]).reshape(-1, d_model).T
        )
        out[p + "post_attention_layernorm.weight"] = t(
            layer["mlp_norm"]["scale"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[p + f"mlp.{name}.weight"] = t(
                np.asarray(layer[name]["kernel"]).T)
        i += 1
    return out


def bert_params_from_torch(
    state_dict: Mapping[str, Any], *, num_layers: int, num_heads: int
) -> dict:
    """HF ``BertForMaskedLM.state_dict()`` → params for models/bert.py.

    Architectural note: models/bert.py uses flax's tanh-approximate gelu
    (the original TF-BERT activation) — HF checkpoints configured with
    ``hidden_act='gelu'`` (exact erf) convert fine but diverge at the
    ~1e-3 level; ``gelu_new``/``gelu_pytorch_tanh`` checkpoints match
    tightly. Set ``ModelConfig.extra['ln_eps']`` to the checkpoint's
    ``layer_norm_eps`` (HF default 1e-12) when building the model. The
    unused pooler head (when present) is dropped — it does not feed MLM
    logits.
    """
    sd = _TrackingDict(state_dict)
    e = "bert.embeddings."
    embed = to_numpy(sd[e + "word_embeddings.weight"])  # (V, D)
    d_model = embed.shape[1]
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
    head_dim = d_model // num_heads

    def ln(prefix):
        return _ln_leaf(sd, prefix)

    def dense(prefix):
        return _dense_leaf(sd, prefix)

    params: dict = {
        "tok_embed": {"embedding": embed},
        "pos_embed": {"embedding": to_numpy(
            sd[e + "position_embeddings.weight"])},
        "type_embed": {"embedding": to_numpy(
            sd[e + "token_type_embeddings.weight"])},
        "ln_embed": ln(e + "LayerNorm"),
    }
    for i in range(num_layers):
        p = f"bert.encoder.layer.{i}."

        def heads_in(prefix):
            return _heads_in_leaf(sd, prefix, num_heads, head_dim)

        params[f"layer{i}"] = {
            "attn": {
                "query": heads_in(p + "attention.self.query"),
                "key": heads_in(p + "attention.self.key"),
                "value": heads_in(p + "attention.self.value"),
                "out": {
                    "kernel": _heads_out_kernel(
                        sd[p + "attention.output.dense.weight"],
                        num_heads, head_dim),
                    "bias": to_numpy(
                        sd[p + "attention.output.dense.bias"]),
                },
            },
            "ln1": ln(p + "attention.output.LayerNorm"),
            "mlp_in": dense(p + "intermediate.dense"),
            "mlp_out": dense(p + "output.dense"),
            "ln2": ln(p + "output.LayerNorm"),
        }
    params["mlm_dense"] = dense("cls.predictions.transform.dense")
    params["mlm_ln"] = ln("cls.predictions.transform.LayerNorm")
    decoder = {"kernel": to_numpy(sd["cls.predictions.decoder.weight"]).T,
               "bias": to_numpy(sd["cls.predictions.bias"])}
    sd.get("cls.predictions.decoder.bias")  # alias of cls.predictions.bias
    params["mlm_decoder"] = decoder
    sd.check_consumed(ignorable=("position_ids", "pooler"))
    return params


def gpt2_params_from_torch(
    state_dict: Mapping[str, Any], *, num_layers: int, num_heads: int
) -> dict:
    """HF ``GPT2LMHeadModel.state_dict()`` → params for
    models/transformer_lm.py (the same architecture: pre-LN blocks,
    learned positions, tanh-approximate gelu, biased attention, tied LM
    head).

    HF GPT-2 uses ``Conv1D`` layers whose weights are stored ``(in,
    out)`` — the flax kernel layout already, so unlike ``nn.Linear``
    nothing transposes. The fused ``c_attn`` (D, 3D) splits into q/k/v;
    the causal-mask ``attn.bias`` buffers are non-learned and ignored.
    Set ``ModelConfig.extra['ln_eps']`` to the checkpoint's
    ``layer_norm_epsilon`` (1e-5 for stock GPT-2) when building the
    model.
    """
    sd = _TrackingDict(state_dict)
    embed = to_numpy(sd["transformer.wte.weight"])  # (V, D)
    d_model = embed.shape[1]
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
    head_dim = d_model // num_heads

    def ln(prefix: str) -> dict:
        return {"scale": to_numpy(sd[prefix + ".weight"]),
                "bias": to_numpy(sd[prefix + ".bias"])}

    def conv1d(prefix: str) -> dict:  # (in, out) — flax layout already
        return {"kernel": to_numpy(sd[prefix + ".weight"]),
                "bias": to_numpy(sd[prefix + ".bias"])}

    params: dict = {
        "tok_embed": {"embedding": embed},
        "pos_embed": {"embedding": to_numpy(
            sd["transformer.wpe.weight"])},
    }
    for i in range(num_layers):
        p = f"transformer.h.{i}."
        ca_w = to_numpy(sd[p + "attn.c_attn.weight"])  # (D, 3D)
        ca_b = to_numpy(sd[p + "attn.c_attn.bias"])    # (3D,)
        qkv_w = np.split(ca_w, 3, axis=1)
        qkv_b = np.split(ca_b, 3)
        heads = {
            name: {
                "kernel": w.reshape(d_model, num_heads, head_dim),
                "bias": b.reshape(num_heads, head_dim),
            }
            for name, w, b in zip(("query", "key", "value"), qkv_w, qkv_b)
        }
        proj = conv1d(p + "attn.c_proj")
        heads["out"] = {
            "kernel": proj["kernel"].reshape(num_heads, head_dim, d_model),
            "bias": proj["bias"],
        }
        params[f"block{i}"] = {
            "ln1": ln(p + "ln_1"),
            "attn": heads,
            "ln2": ln(p + "ln_2"),
            "mlp_in": conv1d(p + "mlp.c_fc"),
            "mlp_out": conv1d(p + "mlp.c_proj"),
        }
    params["ln_f"] = ln("transformer.ln_f")
    lm_head = sd.get("lm_head.weight")  # tied to wte in stock GPT-2
    params["lm_head"] = {
        "kernel": (to_numpy(lm_head) if lm_head is not None else embed).T
    }
    sd.check_consumed(ignorable=(".attn.bias", ".attn.masked_bias"))
    return params


def mlp_params_from_torch(state_dict: Mapping[str, Any]) -> dict:
    """torch ``nn.Sequential`` of Linears (the reference's
    ``Net(nn.Module)``, SURVEY.md §2a) → params for models/mlp.py.

    Linear layers are taken in state-dict order (torch preserves
    registration order), mapping the j-th Linear to ``Dense_j``. Only
    2-D weights qualify as Linear kernels; any other weight tensor
    (BatchNorm/LayerNorm scales are 1-D) means the module isn't the
    plain Linear stack models/mlp.py implements — raise rather than
    load garbage under shifted layer indices.
    """
    weights = [k for k in state_dict if k.endswith(".weight")]
    non_linear = [k for k in weights
                  if to_numpy(state_dict[k]).ndim != 2]
    if non_linear:
        raise ValueError(
            f"non-Linear weight tensors {non_linear} — models/mlp.py is a "
            "plain Linear stack; convert norm-bearing nets via a "
            "model-specific mapping instead"
        )
    params: dict = {}
    for j, wk in enumerate(weights):
        leaf = {"kernel": linear_kernel(state_dict[wk])}
        bk = wk[: -len(".weight")] + ".bias"
        if bk in state_dict:
            leaf["bias"] = to_numpy(state_dict[bk])
        params[f"Dense_{j}"] = leaf
    return params


def _conv_kernel(weight) -> np.ndarray:
    """torch Conv2d weight (O, I, kh, kw) → flax kernel (kh, kw, I, O)."""
    return to_numpy(weight).transpose(2, 3, 1, 0)


def _bn_from_torch(tracked, prefix: str) -> tuple[dict, dict]:
    """torch BatchNorm2d → (flax params {scale, bias},
    batch_stats {mean, var})."""
    params = {"scale": to_numpy(tracked[prefix + ".weight"]),
              "bias": to_numpy(tracked[prefix + ".bias"])}
    stats = {"mean": to_numpy(tracked[prefix + ".running_mean"]),
             "var": to_numpy(tracked[prefix + ".running_var"])}
    return params, stats


def resnet50_params_from_torch(
    state_dict: Mapping[str, Any],
    *,
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3),
    stem: str = "conv7",
) -> tuple[dict, dict]:
    """torchvision ``resnet50().state_dict()`` → (params, batch_stats)
    for models/resnet.py — the reference's config-2 model family, so a
    migrant's ImageNet checkpoint drops straight in.

    Key layout bridged (torchvision side): ``conv1``/``bn1`` stem,
    ``layer{1..4}.{b}.{conv1,bn1,conv2,bn2,conv3,bn3}`` bottlenecks
    with ``downsample.{0,1}`` projections on each stage's first block,
    ``fc`` head. Conv kernels transpose (O, I, kh, kw) → (kh, kw, I,
    O); BatchNorm running stats land in the ``batch_stats`` collection
    (our model's geometry matches torch's symmetric paddings, so
    converted weights are logit-equivalent in eval mode).
    """
    tracked = _TrackingDict(state_dict)
    k7 = _conv_kernel(tracked["conv1.weight"])
    if stem == "s2d":
        # the space-to-depth stem (models/resnet.py): the 7x7 kernel
        # rewrites EXACTLY to the 4x4/12-channel layout, so torchvision
        # checkpoints drop into s2d models logit-equivalently too
        import torch

        from pytorch_distributed_nn_tpu_torch.models.resnet import (
            conv7_to_s2d_kernel,
        )

        params: dict = {"conv_init_s2d": {
            "kernel": conv7_to_s2d_kernel(torch.from_numpy(k7)).numpy()}}
    elif stem == "conv7":
        params = {"conv_init": {"kernel": k7}}
    else:
        raise ValueError(f"unknown stem {stem!r}")
    stats: dict = {}
    params["bn_init"], stats["bn_init"] = _bn_from_torch(tracked, "bn1")

    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            src = f"layer{stage + 1}.{block}"
            dst = f"stage{stage}_block{block}"
            p: dict = {}
            s: dict = {}
            for j in (1, 2, 3):
                p[f"conv{j}"] = {"kernel": _conv_kernel(
                    tracked[f"{src}.conv{j}.weight"])}
                p[f"bn{j}"], s[f"bn{j}"] = _bn_from_torch(
                    tracked, f"{src}.bn{j}")
            if f"{src}.downsample.0.weight" in state_dict:
                p["conv_proj"] = {"kernel": _conv_kernel(
                    tracked[f"{src}.downsample.0.weight"])}
                p["bn_proj"], s["bn_proj"] = _bn_from_torch(
                    tracked, f"{src}.downsample.1")
            params[dst] = p
            stats[dst] = s

    params["head"] = {
        "kernel": to_numpy(tracked["fc.weight"]).T,
        "bias": to_numpy(tracked["fc.bias"]),
    }
    tracked.check_consumed(ignorable=("num_batches_tracked",))
    return params, {"batch_stats": stats}


def resnet50_params_to_torch(params: Mapping[str, Any],
                             model_state: Mapping[str, Any],
                             *,
                             stage_sizes: tuple[int, ...] = (3, 4, 6, 3),
                             ) -> dict:
    """Inverse of :func:`resnet50_params_from_torch` (torchvision key
    layout, torch tensors). ``model_state`` is the TrainState field
    that function returns — the {'batch_stats': ...} wrapper, exactly
    what ``state.model_state`` holds."""
    import torch

    sd: dict = {}

    def put_conv(key, kernel):
        sd[key + ".weight"] = torch.from_numpy(
            np.asarray(kernel, np.float32).transpose(3, 2, 0, 1).copy())

    def put_bn(key, p, s):
        sd[key + ".weight"] = torch.from_numpy(
            np.asarray(p["scale"], np.float32).copy())
        sd[key + ".bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
        sd[key + ".running_mean"] = torch.from_numpy(
            np.asarray(s["mean"], np.float32).copy())
        sd[key + ".running_var"] = torch.from_numpy(
            np.asarray(s["var"], np.float32).copy())
        sd[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    stats = model_state["batch_stats"]
    if "conv_init_s2d" in params:  # s2d stem: exact inverse rewrite
        from pytorch_distributed_nn_tpu_torch.models.resnet import (
            s2d_kernel_to_conv7,
        )

        put_conv("conv1", s2d_kernel_to_conv7(torch.from_numpy(np.asarray(
            params["conv_init_s2d"]["kernel"], np.float32))).numpy())
    else:
        put_conv("conv1", params["conv_init"]["kernel"])
    put_bn("bn1", params["bn_init"], stats["bn_init"])
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            src = f"stage{stage}_block{block}"
            dst = f"layer{stage + 1}.{block}"
            for j in (1, 2, 3):
                put_conv(f"{dst}.conv{j}",
                         params[src][f"conv{j}"]["kernel"])
                put_bn(f"{dst}.bn{j}", params[src][f"bn{j}"],
                       stats[src][f"bn{j}"])
            if "conv_proj" in params[src]:
                put_conv(f"{dst}.downsample.0",
                         params[src]["conv_proj"]["kernel"])
                put_bn(f"{dst}.downsample.1", params[src]["bn_proj"],
                       stats[src]["bn_proj"])
    sd["fc.weight"] = torch.from_numpy(
        np.asarray(params["head"]["kernel"], np.float32).T.copy())
    sd["fc.bias"] = torch.from_numpy(
        np.asarray(params["head"]["bias"], np.float32).copy())
    return sd


def lenet_params_from_torch(state_dict: Mapping[str, Any]) -> dict:
    """torch LeNet-style nets (the reference's classic small CNN:
    conv(6,5,pad 2) -> pool -> conv(16,5) -> pool -> fc 120/84/classes)
    → params for models/lenet.py.

    Layers are taken in registration order like
    :func:`mlp_params_from_torch`: 4-D weights become ``Conv_i``, 2-D
    weights ``Dense_i``. The first Linear after the flatten needs its
    input rows PERMUTED: torch flattens NCHW (channel-major,
    ``c*H*W + h*W + w``) while our NHWC model flattens channel-minor
    (``h*W*C + w*C + c``) — same features, different order.
    """
    convs = [k for k in state_dict
             if k.endswith(".weight")
             and to_numpy(state_dict[k]).ndim == 4]
    fcs = [k for k in state_dict
           if k.endswith(".weight")
           and to_numpy(state_dict[k]).ndim == 2]
    if not convs or not fcs:
        raise ValueError(
            "lenet mapping needs Conv2d and Linear weights; got "
            f"convs={convs}, linears={fcs}"
        )
    # fail loudly on anything this layout does not map (BatchNorm
    # scales/stats, etc.) — a silently-dropped tensor means silently
    # wrong logits
    mapped = set(convs) | set(fcs)
    mapped |= {k[: -len(".weight")] + ".bias" for k in mapped}
    unmapped = [k for k in state_dict if k not in mapped]
    if unmapped:
        raise ValueError(
            "tensors the lenet layout does not map (norm-bearing or "
            f"non-standard variant?): {sorted(unmapped)[:8]}"
        )
    params: dict = {}
    for i, key in enumerate(convs):
        leaf = {"kernel": _conv_kernel(state_dict[key])}
        bk = key[: -len(".weight")] + ".bias"
        if bk in state_dict:
            leaf["bias"] = to_numpy(state_dict[bk])
        params[f"Conv_{i}"] = leaf

    channels = to_numpy(state_dict[convs[-1]]).shape[0]  # last conv out
    for j, key in enumerate(fcs):
        w = to_numpy(state_dict[key])  # (out, in)
        if j == 0:
            n_in = w.shape[1]
            if n_in % channels:
                raise ValueError(
                    f"first Linear in_features {n_in} not divisible by "
                    f"final conv channels {channels}"
                )
            hw = n_in // channels
            side = int(round(hw ** 0.5))
            if side * side != hw:
                raise ValueError(
                    f"non-square feature map ({hw} spatial elements) — "
                    "pass through a model-specific mapping"
                )
            # torch index c*H*W + h*W + w  ->  flax h*W*C + w*C + c.
            # ASSUMES a square final feature map (models/lenet.py
            # geometry); a rectangular map with square area would
            # permute with the wrong (H, W) and cannot be detected
            # from the state_dict alone.
            perm = (np.arange(n_in)
                    .reshape(channels, side, side)  # (c, h, w)
                    .transpose(1, 2, 0)  # (h, w, c)
                    .reshape(-1))
            w = w[:, perm]
        leaf = {"kernel": linear_kernel(w)}
        bk = key[: -len(".weight")] + ".bias"
        if bk in state_dict:
            leaf["bias"] = to_numpy(state_dict[bk])
        params[f"Dense_{j}"] = leaf
    return params


def vit_params_from_torch(
    state_dict: Mapping[str, Any], *, num_layers: int, num_heads: int
) -> dict:
    """HF ``ViTForImageClassification.state_dict()`` → params for
    models/vit.py (both are pre-LN encoders with CLS token + learned
    positions, so the mapping is 1:1).

    Same activation note as BERT: models/vit.py uses flax's
    tanh-approximate gelu — ``hidden_act='gelu_pytorch_tanh'``
    checkpoints match tightly, plain ``'gelu'`` (erf) diverges at the
    ~1e-3 level. The unused pooler (when present) is dropped.
    """
    sd = _TrackingDict(state_dict)
    proj = to_numpy(sd["vit.embeddings.patch_embeddings.projection"
                       ".weight"])  # (D, C, p, p)
    d_model = proj.shape[0]
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
    head_dim = d_model // num_heads

    def ln(prefix):
        return _ln_leaf(sd, prefix)

    def dense(prefix):
        return _dense_leaf(sd, prefix)

    def heads_in(prefix):
        return _heads_in_leaf(sd, prefix, num_heads, head_dim)

    params: dict = {
        "patch_embed": {
            "kernel": _conv_kernel(proj),
            "bias": to_numpy(sd["vit.embeddings.patch_embeddings"
                                ".projection.bias"]),
        },
        "cls": to_numpy(sd["vit.embeddings.cls_token"]),
        "pos_embed": to_numpy(sd["vit.embeddings.position_embeddings"]),
        "ln_f": ln("vit.layernorm"),
        "head": dense("classifier"),
    }
    for i in range(num_layers):
        p = f"vit.encoder.layer.{i}."
        params[f"layer{i}"] = {
            "attn": {
                "query": heads_in(p + "attention.attention.query"),
                "key": heads_in(p + "attention.attention.key"),
                "value": heads_in(p + "attention.attention.value"),
                "out": {
                    "kernel": _heads_out_kernel(
                        sd[p + "attention.output.dense.weight"],
                        num_heads, head_dim),
                    "bias": to_numpy(
                        sd[p + "attention.output.dense.bias"]),
                },
            },
            "ln1": ln(p + "layernorm_before"),
            "ln2": ln(p + "layernorm_after"),
            "mlp_in": dense(p + "intermediate.dense"),
            "mlp_out": dense(p + "output.dense"),
        }
    sd.check_consumed(ignorable=("pooler",))
    return params


def _tt(x):
    # copy=True: a caller's non-writable or shared host buffer must not be
    # aliased by torch.from_numpy. Dtype is preserved.
    import torch

    return torch.from_numpy(np.array(x, copy=True))


def _ln_to_torch(sd: dict, prefix: str, leaf: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _tt(leaf["scale"])
    sd[prefix + ".bias"] = _tt(leaf["bias"])


def _dense_to_torch(sd: dict, prefix: str,
                    leaf: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _tt(np.asarray(leaf["kernel"]).T)
    if "bias" in leaf:
        sd[prefix + ".bias"] = _tt(leaf["bias"])


def _heads_in_to_torch(sd: dict, prefix: str,
                       leaf: Mapping[str, Any]) -> None:
    k = np.asarray(leaf["kernel"])  # (D, H, Dh)
    d = k.shape[0]
    sd[prefix + ".weight"] = _tt(k.reshape(d, -1).T)
    sd[prefix + ".bias"] = _tt(np.asarray(leaf["bias"]).reshape(-1))


def _heads_out_to_torch(sd: dict, prefix: str,
                        leaf: Mapping[str, Any]) -> None:
    k = np.asarray(leaf["kernel"])  # (H, Dh, D)
    d = k.shape[-1]
    sd[prefix + ".weight"] = _tt(k.reshape(-1, d).T)
    sd[prefix + ".bias"] = _tt(leaf["bias"])


def _layer_count(params: Mapping[str, Any], stem: str) -> int:
    n = len([k for k in params if k.startswith(stem)])
    if not n:
        raise ValueError(f"no {stem}* entries in params")
    return n


def _maybe_untied_head(sd: dict, key: str, head: np.ndarray,
                       embed: np.ndarray, tie_note: str) -> None:
    """Stock HF LM heads are TIED to the embedding table (shared
    storage), so a state_dict carrying both would let whichever loads
    last clobber the other. When the trained head still equals the
    embeddings, omit the head key — the tied model regenerates it.
    When training has untied them, keep it and warn: such a checkpoint
    must load into an untied config (tie_word_embeddings=False)."""
    if head.shape == embed.shape and np.array_equal(head, embed):
        return
    import warnings

    warnings.warn(
        f"exported head {key!r} differs from the embedding table; "
        f"{tie_note} by default, and loading this state_dict into a "
        "tied model would silently clobber the embeddings — use an "
        "untied config (tie_word_embeddings=False)", stacklevel=3)
    sd[key] = _tt(head)


def bert_params_to_torch(params: Mapping[str, Any]) -> dict:
    """Inverse of :func:`bert_params_from_torch` (HF ``BertForMaskedLM``
    key layout; the non-persistent ``position_ids`` buffer is omitted —
    load with ``strict=False`` on transformers versions that still
    register it)."""
    sd: dict = {}
    e = "bert.embeddings."
    sd[e + "word_embeddings.weight"] = _tt(
        params["tok_embed"]["embedding"])
    sd[e + "position_embeddings.weight"] = _tt(
        params["pos_embed"]["embedding"])
    sd[e + "token_type_embeddings.weight"] = _tt(
        params["type_embed"]["embedding"])
    _ln_to_torch(sd, e + "LayerNorm", params["ln_embed"])
    for i in range(_layer_count(params, "layer")):
        p = f"bert.encoder.layer.{i}."
        lp = params[f"layer{i}"]
        _heads_in_to_torch(sd, p + "attention.self.query",
                           lp["attn"]["query"])
        _heads_in_to_torch(sd, p + "attention.self.key",
                           lp["attn"]["key"])
        _heads_in_to_torch(sd, p + "attention.self.value",
                           lp["attn"]["value"])
        _heads_out_to_torch(sd, p + "attention.output.dense",
                            lp["attn"]["out"])
        _ln_to_torch(sd, p + "attention.output.LayerNorm", lp["ln1"])
        _dense_to_torch(sd, p + "intermediate.dense", lp["mlp_in"])
        _dense_to_torch(sd, p + "output.dense", lp["mlp_out"])
        _ln_to_torch(sd, p + "output.LayerNorm", lp["ln2"])
    _dense_to_torch(sd, "cls.predictions.transform.dense",
                    params["mlm_dense"])
    _ln_to_torch(sd, "cls.predictions.transform.LayerNorm",
                 params["mlm_ln"])
    _maybe_untied_head(
        sd, "cls.predictions.decoder.weight",
        np.asarray(params["mlm_decoder"]["kernel"]).T,
        np.asarray(params["tok_embed"]["embedding"]),
        "BertForMaskedLM ties cls.predictions.decoder to the word "
        "embeddings")
    sd["cls.predictions.bias"] = _tt(params["mlm_decoder"]["bias"])
    sd["cls.predictions.decoder.bias"] = sd["cls.predictions.bias"]
    return sd


def gpt2_params_to_torch(params: Mapping[str, Any]) -> dict:
    """Inverse of :func:`gpt2_params_from_torch` (HF ``GPT2LMHeadModel``
    layout: Conv1D weights stay (in, out), q/k/v re-fuse into
    ``c_attn``). ``lm_head.weight`` appears ONLY when training untied
    it from ``wte`` (see :func:`_maybe_untied_head`); stock tied
    checkpoints regenerate the head from the embeddings on load."""
    sd: dict = {}
    sd["transformer.wte.weight"] = _tt(params["tok_embed"]["embedding"])
    sd["transformer.wpe.weight"] = _tt(params["pos_embed"]["embedding"])

    def conv1d(prefix, leaf):
        sd[prefix + ".weight"] = _tt(leaf["kernel"])
        sd[prefix + ".bias"] = _tt(leaf["bias"])

    for i in range(_layer_count(params, "block")):
        p = f"transformer.h.{i}."
        bp = params[f"block{i}"]
        _ln_to_torch(sd, p + "ln_1", bp["ln1"])
        _ln_to_torch(sd, p + "ln_2", bp["ln2"])
        qkv = bp["attn"]
        d = np.asarray(qkv["query"]["kernel"]).shape[0]
        sd[p + "attn.c_attn.weight"] = _tt(np.concatenate(
            [np.asarray(qkv[n]["kernel"]).reshape(d, -1)
             for n in ("query", "key", "value")], axis=1))
        sd[p + "attn.c_attn.bias"] = _tt(np.concatenate(
            [np.asarray(qkv[n]["bias"]).reshape(-1)
             for n in ("query", "key", "value")]))
        out = qkv["out"]
        sd[p + "attn.c_proj.weight"] = _tt(
            np.asarray(out["kernel"]).reshape(-1, d))
        sd[p + "attn.c_proj.bias"] = _tt(out["bias"])
        conv1d(p + "mlp.c_fc", bp["mlp_in"])
        conv1d(p + "mlp.c_proj", bp["mlp_out"])
    _ln_to_torch(sd, "transformer.ln_f", params["ln_f"])
    _maybe_untied_head(
        sd, "lm_head.weight",
        np.asarray(params["lm_head"]["kernel"]).T,
        np.asarray(params["tok_embed"]["embedding"]),
        "GPT2LMHeadModel ties lm_head to transformer.wte")
    return sd


def vit_params_to_torch(params: Mapping[str, Any]) -> dict:
    """Inverse of :func:`vit_params_from_torch`
    (HF ``ViTForImageClassification`` layout)."""
    sd: dict = {}
    sd["vit.embeddings.cls_token"] = _tt(params["cls"])
    sd["vit.embeddings.position_embeddings"] = _tt(params["pos_embed"])
    sd["vit.embeddings.patch_embeddings.projection.weight"] = _tt(
        np.asarray(params["patch_embed"]["kernel"])
        .transpose(3, 2, 0, 1))
    sd["vit.embeddings.patch_embeddings.projection.bias"] = _tt(
        params["patch_embed"]["bias"])
    for i in range(_layer_count(params, "layer")):
        p = f"vit.encoder.layer.{i}."
        lp = params[f"layer{i}"]
        _heads_in_to_torch(sd, p + "attention.attention.query",
                           lp["attn"]["query"])
        _heads_in_to_torch(sd, p + "attention.attention.key",
                           lp["attn"]["key"])
        _heads_in_to_torch(sd, p + "attention.attention.value",
                           lp["attn"]["value"])
        _heads_out_to_torch(sd, p + "attention.output.dense",
                            lp["attn"]["out"])
        _ln_to_torch(sd, p + "layernorm_before", lp["ln1"])
        _ln_to_torch(sd, p + "layernorm_after", lp["ln2"])
        _dense_to_torch(sd, p + "intermediate.dense", lp["mlp_in"])
        _dense_to_torch(sd, p + "output.dense", lp["mlp_out"])
    _ln_to_torch(sd, "vit.layernorm", params["ln_f"])
    _dense_to_torch(sd, "classifier", params["head"])
    return sd

"""Port parity of the expert axis's functions (the training and the gang
are ``test_torch_moe.py``, whose dims and helpers this file uses), against
the JAX package on the CPU; seeded numpy inputs, the JAX init's weights.

- Routing: ``top_k_routing`` against the JAX function on random logits,
  on capacity overflow (k 1, capacity 3) and on tied probabilities:
  dispatch and the load-balance loss exactly, combine to 1e-6; the routing
  groups; the capacity formula; the expert ranks load the same rows.
- The layer: forward and gradients (inputs, router, experts, with the
  load-balance term in the loss) against ``jax.grad``, f32 to 1e-5
  (relative to each tensor's largest |value|), bf16 to 2e-2 (a few bf16
  steps: the products round to bf16 at other places); with ample
  capacity the layer equals each token's chosen experts applied directly.
- FLOPs: the closed form of one MoE layer against the JAX ``fwd_flops``
  (XLA's count adds the routing's and gelu's elementwise work).
- The model: ``moe_lm`` forward at ``moe_every`` 1 and 2 against the JAX
  model, f32 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import EXTRA, _close, _np

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.parallel import expert as jexpert
from pytorch_distributed_nn_tpu_torch.config import ModelConfig
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.parallel.expert import (
    MoEMLP,
    collect_aux_losses,
    expert_capacity,
    top_k_routing,
)
from pytorch_distributed_nn_tpu_torch.utils.interop import params_from_jax


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def _routing_pair(logits, k, capacity):
    want = jexpert.top_k_routing(jnp.asarray(logits), k=k,
                                 capacity=capacity)
    got = top_k_routing(torch.from_numpy(logits), k=k, capacity=capacity)
    return got, want


def _tied():
    # rows with two, three and four equal probabilities
    return np.array([[1.0, 1.0, 0.0, -1.0], [0.5, 0.5, 0.5, -2.0],
                     [0.0, 0.0, 0.0, 0.0], [-1.0, 2.0, 2.0, 2.0]] * 3,
                    np.float32)


@pytest.mark.parametrize("case", ["random", "overflow", "tied"])
def test_routing_matches_the_jax_function(case):
    rng = np.random.default_rng(0)
    if case == "random":
        logits, k, cap = rng.normal(size=(16, 4)).astype(np.float32), 2, 6
    elif case == "overflow":  # every token prefers expert 0: 3 survive
        logits, k, cap = np.tile(np.array([[5.0, -5.0]], np.float32),
                                 (10, 1)), 1, 3
    else:
        logits, k, cap = _tied(), 2, 4
    got, want = _routing_pair(logits, k, cap)
    np.testing.assert_array_equal(_np(got.dispatch),
                                  np.asarray(want.dispatch))
    np.testing.assert_allclose(_np(got.combine), np.asarray(want.combine),
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.aux_loss), np.asarray(want.aux_loss),
                               rtol=1e-6)
    assert float(got.fraction_dropped) == pytest.approx(
        float(want.fraction_dropped), abs=1e-7)
    if case == "overflow":
        assert float(got.fraction_dropped) == pytest.approx(0.7)


def test_routing_groups_are_the_vmapped_function():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 16, 8)).astype(np.float32)
    want = jax.vmap(lambda x: jexpert.top_k_routing(x, k=2, capacity=5))(
        jnp.asarray(logits))
    got = top_k_routing(torch.from_numpy(logits), k=2, capacity=5)
    np.testing.assert_array_equal(_np(got.dispatch),
                                  np.asarray(want.dispatch))
    np.testing.assert_allclose(_np(got.combine), np.asarray(want.combine),
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.fraction_dropped),
                               np.asarray(want.fraction_dropped), atol=1e-7)


def test_capacity_formula():
    for args in ((64, 8, 2, 1.0), (64, 8, 1, 1.25), (2, 8, 1, 1.0),
                 (1024, 8, 2, 1.25)):
        assert expert_capacity(*args) == jexpert.expert_capacity(*args)


def test_expert_ranks_load_the_same_rows():
    """Ranks that differ only in their expert coordinate get the same
    batch (the JAX ``batch_pspec``: data x fsdp); the data coordinates
    get the global batch's row blocks in order."""
    from pytorch_distributed_nn_tpu_torch.data import datasets as tdata
    from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
    from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
        AxisGroup,
        ProcessMesh,
        data_parallel,
    )
    from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
        MeshSpec as TMeshSpec,
    )

    spec = data_parallel(TMeshSpec(expert=-1, data=2), 4)
    ds = tdata.get_dataset("lm_synthetic", seed=3, batch_size=8,
                           seq_len=16, vocab_size=97)
    whole, _ = ds.batch(0)
    rows = []
    for rank in range(4):
        pm = ProcessMesh(spec, rank, AxisGroup(), data=AxisGroup(),
                         pipe=AxisGroup(), fsdp=AxisGroup(),
                         replica=AxisGroup())
        loader = DataLoader(ds, torch.device("cpu"),
                            data_index=pm.data_index,
                            data_degree=spec.data_degree(), prefetch=0)
        rows.append(loader.batch_at(0)[0].numpy())
    for rank in range(4):  # rank r: data r // 2, expert r % 2
        np.testing.assert_array_equal(rows[rank],
                                      rows[rank - rank % 2])
        np.testing.assert_array_equal(
            rows[rank], np.asarray(whole)[rank // 2 * 4:rank // 2 * 4 + 4])


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------

LAYER = dict(num_experts=4, mlp_dim=32, k=2, capacity_factor=1.0,
             group_size=8)


def _layer_pair(dtype):
    B, S, d = 2, 16, 16
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jlayer = jexpert.MoEMLP(**LAYER, dtype=jdt)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    cot = rng.normal(size=(B, S, d)).astype(np.float32)
    params = jax.device_get(jlayer.init(jax.random.key(0),
                                        jnp.asarray(x))["params"])
    layer = MoEMLP(d, dtype=dtype, device="cpu", **LAYER)
    layer.load_state_dict(params_from_jax(params))
    return jlayer, layer, params, x, cot


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_layer_forward_and_gradients_match_jax(dtype, tol):
    jlayer, layer, params, x, cot = _layer_pair(dtype)

    def jloss(p, xx):
        out, sown = jlayer.apply({"params": p}, xx, mutable=["losses"])
        aux = sum(jax.tree.leaves(sown))
        return jnp.sum(out.astype(jnp.float32) * cot) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    with collect_aux_losses(layer) as aux:
        out = layer(xt)
    assert list(aux) == [""]
    loss = (out.float() * torch.from_numpy(cot)).sum() + aux[""]
    loss.backward()
    _close(_np(out), np.asarray(jout, np.float32), tol, "out")
    assert float(aux[""].detach()) == pytest.approx(float(jaux), rel=1e-6)
    _close(_np(xt.grad), np.asarray(jgx, np.float32), tol, "dx")
    want = params_from_jax(jax.device_get(jgp))
    for name, p in layer.named_parameters():
        _close(_np(p.grad), want[name].float().numpy(), tol, name)


def test_layer_equals_dense_expert_application():
    """With ample capacity the dispatch/combine path equals each token's
    chosen experts applied directly (the JAX test's oracle)."""
    B, S, d, ff, E, k = 2, 8, 16, 32, 4, 2
    layer = MoEMLP(d, num_experts=E, mlp_dim=ff, k=k, capacity_factor=4.0,
                   device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    x = torch.randn((B, S, d), generator=g)
    out = layer(x).detach().double().reshape(-1, d).numpy()
    tokens = x.double().reshape(-1, d).numpy()
    router = tokens @ layer.router.kernel.double().detach().numpy()
    probs = np.exp(router - router.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    wi = layer.wi.double().detach().numpy()
    wo = layer.wo.double().detach().numpy()
    expected = np.zeros_like(tokens)
    for n in range(tokens.shape[0]):
        order = np.argsort(-probs[n], kind="stable")[:k]
        gates = probs[n, order] / probs[n, order].sum()
        for e, gate in zip(order, gates):
            h = torch.nn.functional.gelu(torch.from_numpy(tokens[n] @ wi[e]),
                                         approximate="tanh").numpy()
            expected[n] += gate * (h @ wo[e])
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-4)


def test_flops_of_one_layer_against_the_jax_count():
    """The closed form (router, dispatch, every slot's two products,
    combine) against XLA's count of the JAX layer, which adds the
    routing's and gelu's elementwise work: within 0.5% at moe_lm_ep's
    widths (one row of T 1024), within 4% at a small width."""
    from pytorch_distributed_nn_tpu.utils.flops import fwd_flops
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        moe_forward_flops_per_token,
    )

    for (B, S, d, ff, E, g, tol) in ((1, 1024, 768, 3072, 8, 1024, 5e-3),
                                     (2, 64, 64, 256, 4, 32, 4e-2)):
        kw = dict(num_experts=E, mlp_dim=ff, k=2, capacity_factor=1.25,
                  group_size=g)
        want = fwd_flops(jexpert.MoEMLP(**kw), (B, S, d), jnp.float32)
        with torch.device("meta"):
            layer = MoEMLP(d, **kw)
        got = moe_forward_flops_per_token(layer, d, S) * B * S
        assert got <= want
        assert (want - got) / want < tol, (got, want)


# --------------------------------------------------------------------------
# the model and one-process training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_lm_forward_matches_jax(moe_every):
    extra = dict(EXTRA, moe_every=moe_every)
    cfg = ModelConfig(name="moe_lm", compute_dtype="float32", extra=extra)
    jcfg = jconfig.ModelConfig(name="moe_lm", compute_dtype="float32",
                               extra=extra)
    jmodel = jget_model(jcfg)
    tokens = np.random.default_rng(3).integers(0, 128, (2, 16)).astype(
        np.int32)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(0), jnp.asarray(tokens))["params"])
    model = get_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    moe = sorted(n for n, m in model.named_modules() if isinstance(m, MoEMLP))
    assert moe == [f"block{i}.moe" for i in range(2)
                   if i % moe_every == moe_every - 1]
    got = model(torch.from_numpy(tokens).long())
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(tokens))
    _close(_np(got), np.asarray(want), 1e-5)
    with pytest.raises(ValueError, match="decode caching"):
        model(torch.from_numpy(tokens).long(), cache={})
    from pytorch_distributed_nn_tpu_torch.parallel.pipeline import (
        partition_for,
    )

    part = partition_for(model)  # the pipeline takes the MoE LM
    assert part.period == moe_every and part.block_names == ["block0",
                                                            "block1"]

"""Port parity for the optimizers (``train/optim.py``) against the JAX
package's optax chains (``make_optimizer`` of both packages on the same
config): ``adam``, ``adamw``, ``lamb``, ``lion`` and ``adafactor``, and the
existing ``sgd`` and ``momentum``, with ``decay_mask_norms`` and
``mu_dtype``, over 10 updates from the same parameters and gradients.

The parameter tree has a matrix and a 3-D tensor whose two largest dims
reach 128 (adafactor factors their second moments), a small matrix (kept
whole) and two 1-D tensors (what ``decay_mask_norms`` skips).

Tolerance: each parameter after every update to 1e-6 relative (atol 1e-6
of its largest |value|), adafactor to 1e-5: the same f32 operations in
optax's order, rounded in another order where a reduction sums. The
``mu_dtype`` cases run without clipping: the global norm sums in another
order, and a bf16 moment turns that last-bit difference into a whole bf16
step now and then (3 of 5e4 elements, 3e-5 relative, in a clipped run);
clipping is held at 1e-6 in the f32 cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.train import optim as joptim
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.train import optim as toptim

SHAPES = {"dense.kernel": (130, 140), "attn.kernel": (128, 3, 129),
          "small.kernel": (6, 5), "dense.bias": (140,), "ln.scale": (7,)}


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


CASES = [
    dict(name="adam", lr=1e-2, weight_decay=0.05),
    dict(name="adam", lr=1e-2, weight_decay=0.05, decay_mask_norms=True,
         mu_dtype="bfloat16"),
    dict(name="adamw", lr=1e-2, weight_decay=0.1, decay_mask_norms=True,
         grad_clip_norm=1.0),
    dict(name="adamw", lr=1e-2, weight_decay=0.1, mu_dtype="bfloat16"),
    dict(name="lamb", lr=1e-2, weight_decay=0.01),
    dict(name="lamb", lr=1e-2, weight_decay=0.01, decay_mask_norms=True),
    dict(name="lion", lr=1e-3, weight_decay=0.1),
    dict(name="lion", lr=1e-3, weight_decay=0.1, decay_mask_norms=True,
         mu_dtype="bfloat16"),
    dict(name="adafactor", lr=1e-2),
    dict(name="adafactor", lr=1e-2, weight_decay=1e-3,
         decay_mask_norms=True),
    dict(name="momentum", lr=1e-2, weight_decay=1e-3, mu_dtype="bfloat16",
         decay_mask_norms=True),
    dict(name="sgd", lr=1e-2, weight_decay=1e-3, decay_mask_norms=True),
]


def _id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items() if k != "lr")


@pytest.mark.parametrize("kw", CASES, ids=[_id(c) for c in CASES])
def test_ten_updates_match_optax(kw):
    kw = dict(kw, warmup_steps=2, schedule="cosine")
    total = 12
    params = _tree(0)
    tx = joptim.make_optimizer(jconfig.OptimConfig(**kw), total)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = toptim.make_optimizer(tconfig.OptimConfig(**kw), tp.values(),
                                total)
    rtol = 1e-5 if kw["name"] == "adafactor" else 1e-6
    for i in range(10):
        grads = _tree(10 + i, scale=0.5 + i % 3)
        upd, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        opt.zero_grad()
        for k, p in tp.items():
            want = np.asarray(jp[k])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(),
                                       err_msg=f"{k} after update {i}")
    assert opt.count == 10
    moved = max(np.abs(np.asarray(jp[k]) - params[k]).max() for k in params)
    assert moved > 1e-3
    if kw.get("mu_dtype"):
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)


@pytest.mark.parametrize("name", ["lamb", "sgd", "adafactor"])
def test_mu_dtype_is_refused_where_optax_has_no_moment_dtype(name):
    cfg = dict(name=name, mu_dtype="bfloat16")
    with pytest.raises(ValueError, match="mu_dtype is not supported"):
        joptim.make_optimizer(jconfig.OptimConfig(**cfg))
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="mu_dtype is not supported"):
        toptim.make_optimizer(tconfig.OptimConfig(**cfg), [p])
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer(tconfig.OptimConfig(name="rmsprop"), [p])

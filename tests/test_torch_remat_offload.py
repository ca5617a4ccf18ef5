"""``model.remat_offload`` in the port (``models/llama.py``): the block
inputs that remat saves for the backward are kept in host memory (pinned
on the card, ``tests/test_torch_cuda.py``), and the result is the remat
run's bit for bit. The flag's errors are the JAX package's
(``models/llama.py:161``, ``models/__init__.py:41``).

Tiny Llama (2 layers, d 64, 4/2 heads, MLP 128, vocab 512, T 256, chunked
loss 64, f32), from the same seeded weights and batches.
"""

import pytest
import torch

from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.parallel import dp
from pytorch_distributed_nn_tpu_torch.parallel.api import make_chunked_loss
from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

EXTRA = ('{"num_layers": 2, "d_model": 64, "num_heads": 4, '
         '"num_kv_heads": 2, "mlp_dim": 128, "vocab_size": 512}')
OV = {"model.extra": EXTRA, "model.compute_dtype": "float32",
      "data.vocab_size": "512", "data.seq_len": "256", "xent_chunk": "64",
      "steps": "2", "log_every": "1", "data.prefetch": "0"}


def _cfg(**ov):
    return tconfig.get_config("llama3_longcontext", **{**OV, **ov})


def test_offload_without_remat_raises():
    with pytest.raises(ValueError, match="needs model.remat=True"):
        get_model(_cfg(**{"model.remat_offload": "true",
                          "model.remat": "false"}).model, device="cpu")


def test_offload_for_another_model_raises():
    cfg = tconfig.get_config("transformer_lm_pp",
                             **{"model.remat_offload": "true"})
    assert cfg.model.remat
    with pytest.raises(ValueError, match="llama3_8b only"):
        get_model(cfg.model, device="cpu")


def test_offload_is_bitwise_the_remat_run():
    runs = {}
    for offload in (False, True):
        t = Trainer(_cfg(**{"model.remat_offload": str(offload)}),
                    device="cpu")
        x, y = t.loader.batch_at(0)
        # one step's loss and gradients, then two trained steps
        got = dp._loss_and_grads(t.state, x, y, make_chunked_loss(64))
        grads = {n: p.grad.clone() for n, p in t.model.named_parameters()}
        t.state.optimizer.zero_grad()
        t.train()
        runs[offload] = (got, grads, t.losses(), t.model.state_dict(),
                         dict(t.model.offloaded))
    (l0, g0, h0, p0, _), (l1, g1, h1, p1, off) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert h0 == h1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    # one saved boundary a block, (B, T, D) f32, moved to host memory
    assert off["tensors"] == 2 and off["bytes"] == 2 * 1 * 256 * 64 * 4

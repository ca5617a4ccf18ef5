"""The ring-attention block update: one ring step's online softmax against
a visiting K/V shard.

Counterpart of ``pytorch_distributed_nn_tpu/ops/pallas/ring_attention.py``
(``_ring_block_pallas``, dispatched by ``ring_block_update``). The kernel is
hand-written in ``csrc/ring_attention.cu`` (built by ``nvcc`` at first use,
see :mod:`ops.build`, bound with ctypes on the current stream);
:func:`ring_block_reference` beside it is the plain PyTorch version, which
follows the TPU package's oracle in f32 (q scaled by D^-0.5 before the
dot). On a CPU tensor :func:`ring_block_update` runs the plain version; on a
CUDA tensor it launches the kernel or raises; nothing falls back.

Layout, as the port's flash kernels (``ops/flash_attention.py``): q is
(B, Tq, H, D), k and v (B, Tk, Hkv, D), read by strides, so a row slice of
a longer sequence needs no copy; query head h reads K/V head h // (H //
Hkv), and K/V are never expanded. The carries are m and l, (B * H, Tq) f32
(the TPU's (BH, Tl, 8) lane broadcast is a Mosaic tiling artifact), and
acc, (B, Tq, H, D) f32. The offsets are the shards' global first
positions, host ints (the TPU's SMEM scalars).
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_distributed_nn_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _check_kernel_inputs,
    _grouped,
    _on_cpu,
    _stream,
    _strides,
)


def ring_block_reference(q, k, v, m, l, acc, q_off: int, k_off: int, *,
                         causal: bool):
    """Plain PyTorch version of :func:`ring_block_update`, in f32, as the
    TPU package's ``_ring_block_reference``: s = (q D^-0.5) k^T, masked to
    -1e30 where ``q_off + r < k_off + c`` when causal; m' = max(m,
    rowmax s), p = exp(s - m'), l' = l exp(m - m') + rowsum p, acc' = acc
    exp(m - m') + p v. Returns new (m', l', acc'); the inputs are left as
    they are."""
    B, Tq, H, D = q.shape
    hkv, Tk = k.shape[2], k.shape[1]
    qf = _grouped(q, hkv) * D ** -0.5
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    if causal:
        q_pos = q_off + torch.arange(Tq, device=q.device)
        k_pos = k_off + torch.arange(Tk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    m_in = m.reshape(B, hkv, H // hkv, Tq)
    m_new = torch.maximum(m_in, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_in - m_new)
    l_new = l.reshape(m_in.shape) * corr + p.sum(-1)
    pv = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    acc_new = (acc.reshape(B, Tq, hkv, H // hkv, D)
               * corr.permute(0, 3, 1, 2)[..., None] + pv)
    return (m_new.reshape(B * H, Tq), l_new.reshape(B * H, Tq),
            acc_new.reshape(B, Tq, H, D))


def ring_block_update(q, k, v, m, l, acc, q_off: int, k_off: int, *,
                      causal: bool):
    """Update the carries (m, l, acc) IN PLACE with the visiting shard
    (k, v) and return them. On CUDA every call launches the kernel and adds
    one to ``ring_block_update.launches``; a fully-future causal shard
    leaves the carries bit for bit as they were."""
    _check_shapes(q, k, v, m, l, acc)
    if _on_cpu(q, k, v, m, l, acc):
        for carry, new in zip((m, l, acc), ring_block_reference(
                q, k, v, m, l, acc, q_off, k_off, causal=causal)):
            carry.copy_(new)
        return m, l, acc
    _check_kernel_inputs(q, k, v)
    for t in (m, l, acc):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the ring carries m, l and acc must be "
                             "contiguous float32")
    B, Tq, H, D = q.shape
    lib = _lib()
    rc = lib.ring_block_update(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                               B, H, k.shape[2], Tq, k.shape[1], D,
                               _strides(q, k, v), int(q_off), int(k_off),
                               int(causal), _stream(q))
    if rc != 0:
        raise RuntimeError("ring_block_update kernel launch failed: "
                           + lib.ring_error_string(rc).decode())
    ring_block_update.launches += 1
    return m, l, acc


ring_block_update.launches = 0


def _check_shapes(q, k, v, m, l, acc) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"the ring block takes (B, Tq, H, D) q and (B, Tk, "
                         f"Hkv, D) k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (kv heads must divide q heads)")
    for name, t, want in (("m", m, (B * H, Tq)), ("l", l, (B * H, Tq)),
                          ("acc", acc, (B, Tq, H, D))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} != {want}")


def _lib() -> ctypes.CDLL:
    from pytorch_distributed_nn_tpu_torch.ops.build import load_library

    lib = load_library("ring_attention.cu")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_block_update.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), ll, ll, i, p]
        lib.ring_block_update.restype = ctypes.c_int
        lib.ring_error_string.argtypes = [ctypes.c_int]
        lib.ring_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib

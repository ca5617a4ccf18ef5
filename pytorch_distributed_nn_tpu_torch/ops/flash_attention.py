"""Flash attention: the kernels under long-context Llama training.

Counterpart of ``pytorch_distributed_nn_tpu/ops/pallas/flash_attention.py``.
Three kernels, hand-written in ``csrc/flash_attention.cu`` (built by
``nvcc`` at first use, see :mod:`ops.build`, bound with ctypes on the
current stream):

- :func:`flash_fwd` (the TPU's ``_flash_bhtd``): O and the per-row
  logsumexp;
- :func:`flash_bwd_dq` (``_flash_bwd_pallas``, dq pass): dq from p replayed
  as exp(s * scale - lse);
- :func:`flash_bwd_dkv` (``_flash_bwd_pallas``, dk/dv pass): dk and dv,
  summed over each K/V head's group of query heads in one accumulator.

Each has its plain PyTorch version beside it (``*_reference``), which
follows the TPU kernels' math in f32 (q scaled before the dot in the
forward, after it in the backward; f32 p) and computes the backward in
closed form from lse and delta, not through autograd. On a CPU tensor a
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises; nothing falls back. :class:`FlashAttention` is the
``torch.autograd.Function`` (the TPU package's ``_flash_diff``).

Layout: the JAX wrapper transposes (B, T, H, D) to (B * H, T, D). The
kernels here read the (B, T, H, D) tensors in place, by strides, and write
O, dq, dk and dv in that layout, so the projections feed them without a
copy. Query head h reads K/V head h // (H // Hkv), which is the JAX
package's row ``b * H + h`` reading K/V row ``(b * H + h) // G``. K and V
are never expanded to H heads. lse and delta are plain (B * H, T) f32 (the
TPU's (BH, nq, block_q) sublane grouping is a TPU artifact). The kernels
mask ragged tile tails, so every T >= 1 runs on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30  # the JAX package's finite mask value
KERNEL_HEAD_DIMS = (64, 128)  # the head_dims the kernels are built for
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _rows(n: int, rows: Optional[slice]) -> slice:
    return slice(*(rows or slice(None)).indices(n)[:2])


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, T, H, D) -> (B, T, Hkv, G, D) f32: head h = hk * G + g."""
    B, T, H, D = x.shape
    return x.float().reshape(B, T, hkv, H // hkv, D)


def _stat(x: torch.Tensor, B: int, hkv: int, rows: slice) -> torch.Tensor:
    """(B * H, T) -> (B, Hkv, G, rows) f32."""
    return x.float().reshape(B, hkv, -1, x.shape[-1])[..., rows]


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    return q_pos[:, None] >= k_pos[None, :]


def flash_forward_reference(q, k, v, causal: bool,
                            q_rows: Optional[slice] = None):
    """Plain PyTorch version of :func:`flash_fwd`, in f32: q scaled by
    D^-0.5 before the dot, masked logits -1e30, O = (p v) / max(l, 1e-30)
    and lse = m + log(max(l, 1e-30)). ``q_rows`` restricts the query rows
    (each still attends to every key it may see). Returns (O rows in q's
    dtype (B, rows, H, D), lse (B * H, rows) f32)."""
    B, T, H, D = q.shape
    hkv = k.shape[2]
    rows = _rows(T, q_rows)
    qf = _grouped(q[:, rows], hkv) * D ** -0.5
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    if causal:
        q_pos = torch.arange(rows.start, rows.stop, device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~_causal_mask(q_pos, k_pos), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].reshape(B * H, -1)
    return o.reshape(B, -1, H, D).to(q.dtype), lse


def _replay(q, k, v, do, lse, delta, causal, q_rows, k_rows):
    """p and ds of the backward for query rows x key rows, grouped:
    (B, Hkv, G, rows, keys) f32 each, with s scaled after the dot."""
    B, T, H, D = q.shape
    hkv = k.shape[2]
    scale = D ** -0.5
    qf = _grouped(q[:, q_rows], hkv)
    gf = _grouped(do[:, q_rows], hkv)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k[:, k_rows].float()) * scale
    if causal:
        q_pos = torch.arange(q_rows.start, q_rows.stop, device=q.device)
        k_pos = torch.arange(k_rows.start, k_rows.stop, device=q.device)
        s = s.masked_fill(~_causal_mask(q_pos, k_pos), NEG_INF)
    p = torch.exp(s - _stat(lse, B, hkv, q_rows)[..., None])
    dp = torch.einsum("btkgd,bskd->bkgts", gf, v[:, k_rows].float())
    ds = p * (dp - _stat(delta, B, hkv, q_rows)[..., None]) * scale
    return p, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool,
                           q_rows: Optional[slice] = None,
                           out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of :func:`flash_bwd_dq`, in f32, in closed
    form: p = exp(s * scale - lse), ds = p (dO v^T - delta) scale,
    dq = ds k. Returns dq for ``q_rows`` (B, rows, H, D)."""
    B, T, H, D = q.shape
    rows = _rows(T, q_rows)
    _, ds = _replay(q, k, v, do, lse, delta, causal, rows,
                    slice(0, k.shape[1]))
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float())
    return dq.reshape(B, -1, H, D).to(out_dtype or q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool,
                            k_rows: Optional[slice] = None,
                            out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of :func:`flash_bwd_dkv`, in f32, in closed
    form: dv = p^T dO and dk = ds^T q, summed over every query row and the
    K/V head's group of query heads. Returns (dk, dv) for ``k_rows``
    (B, rows, Hkv, D)."""
    B, T, H, D = q.shape
    hkv = k.shape[2]
    rows = _rows(k.shape[1], k_rows)
    p, ds = _replay(q, k, v, do, lse, delta, causal, slice(0, T), rows)
    dv = torch.einsum("bkgts,btkgd->bskd", p, _grouped(do, hkv))
    dk = torch.einsum("bkgts,btkgd->bskd", ds, _grouped(q, hkv))
    dt = out_dtype or k.dtype
    return dk.to(dt), dv.to(dt)


# --------------------------------------------------------------------------
# wrappers: the plain version on a CPU tensor, the kernel on a CUDA tensor
# --------------------------------------------------------------------------

def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"the attention kernels need every tensor on one cpu or "
                     f"cuda device, got {sorted(str(t.device) for t in ts)}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, T, H, D), k/v (B, T, Hkv, D) -> (O (B, T, H, D) in q's dtype,
    lse (B * H, T) f32). On CUDA every call launches the kernel and adds one
    to ``flash_fwd.launches``."""
    _check_shapes(q, k, v)
    if _on_cpu(q, k, v):
        return flash_forward_reference(q, k, v, causal)
    _check_kernel_inputs(q, k, v)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), lse.data_ptr(), B, H, k.shape[2], T, D,
                       _strides(q, k, v, o), int(causal), _stream(q))
    _raise_on(lib, rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dq (B, T, H, D) in ``out_dtype`` (default q's). ``do`` is like q;
    ``lse`` and ``delta = rowsum(dO * O)`` are (B * H, T) f32. On CUDA
    every call launches the kernel and adds one to
    ``flash_bwd_dq.launches``."""
    _check_shapes(q, k, v, do, lse, delta)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                      out_dtype=out_dtype)
    _check_kernel_inputs(q, k, v, do, lse=lse, delta=delta)
    out_dtype = _out_dtype(out_dtype, q.dtype)
    B, T, H, D = q.shape
    dq = torch.empty((B, T, H, D), dtype=out_dtype, device=q.device)
    lib = _lib()
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), B, H, k.shape[2], T, D,
                          _strides(q, k, v, do, dq), int(causal),
                          int(out_dtype == torch.float32), _stream(q))
    _raise_on(lib, rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool,
                  out_dtype: Optional[torch.dtype] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, T, Hkv, D) in ``out_dtype`` (default k's; f32 is
    what a ring of partial sums wants). Same inputs as :func:`flash_bwd_dq`.
    On CUDA every call launches the kernel and adds one to
    ``flash_bwd_dkv.launches``."""
    _check_shapes(q, k, v, do, lse, delta)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       out_dtype=out_dtype)
    _check_kernel_inputs(q, k, v, do, lse=lse, delta=delta)
    out_dtype = _out_dtype(out_dtype, k.dtype)
    B, T, hkv, D = k.shape
    dk = torch.empty((B, T, hkv, D), dtype=out_dtype, device=k.device)
    dv = torch.empty_like(dk)
    lib = _lib()
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), B, q.shape[2], hkv,
                           T, D, _strides(q, k, v, do, dk, dv), int(causal),
                           int(out_dtype == torch.float32), _stream(q))
    _raise_on(lib, rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _check_shapes(q, k, v, do=None, lse=None, delta=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, T, H, D) q and "
                         f"(B, T, Hkv, D) k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] != T:
        raise ValueError(
            f"flash attention is self-attention only (kv len {k.shape[1]} "
            f"!= q len {T}); use impl='xla' for cross-length")
    if H % k.shape[2]:
        raise ValueError(f"flash attention needs kv heads dividing q heads "
                         f"({k.shape[2]} vs {H})")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, st in (("lse", lse), ("delta", delta)):
        if st is not None and tuple(st.shape) != (B * H, T):
            raise ValueError(f"{name} {tuple(st.shape)} != {(B * H, T)}")


def _check_kernel_inputs(*ts: torch.Tensor, lse=None, delta=None) -> None:
    D = ts[0].shape[3]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels take head_dim "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernels take bfloat16, got "
                            f"{t.dtype}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                "the attention kernels need a contiguous head dim, strides "
                "that are multiples of 8 and 16-byte alignment, got "
                f"strides {t.stride()}")
    for st in (lse, delta):
        if st is not None and (st.dtype != torch.float32
                               or not st.is_contiguous()):
            raise ValueError("lse and delta must be contiguous float32")


def _out_dtype(want: Optional[torch.dtype],
               default: torch.dtype) -> torch.dtype:
    out = want or default
    if out not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}, got {out}")
    return out


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.flash_error_string(rc).decode())


def _lib() -> ctypes.CDLL:
    from pytorch_distributed_nn_tpu_torch.ops.build import load_library

    lib = load_library("flash_attention.cu")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, strides, i, p]
        lib.flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                     strides, i, i, p]
        lib.flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                      strides, i, i, p]
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, as (B * H, T): the backward's input
    that the JAX package also computes outside its kernels."""
    B, T, H, _ = o.shape
    delta = (o.float() * do.float()).sum(-1)  # (B, T, H)
    return delta.permute(0, 2, 1).reshape(B * H, T).contiguous()


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward saves q, k, v, O and
    lse; the backward computes delta = rowsum(dO * O) in f32 and runs the
    dq pass and the dk/dv pass, which return dk and dv grouped
    (B, T, Hkv, D). Neither direction builds the (T, T) scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = flash_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, T, H, D) attention with grouped K/V (B, T, Hkv, D), Hkv | H;
    differentiable through :class:`FlashAttention`."""
    _check_shapes(q, k, v)
    return FlashAttention.apply(q, k, v, causal)

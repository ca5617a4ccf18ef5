"""Stochastic int8 quantization for the compressed gradient all-reduce.

Counterpart of ``pytorch_distributed_nn_tpu/ops/pallas/quantize.py``. The
wire format is symmetric per-bucket int8: ``q = clip(floor(x / scale + u),
-127, 127)`` with ``u ~ U[0, 1)``, so ``q * scale`` is an unbiased estimate
of ``x``. ``ops/buckets.py`` sums the ``q`` of every rank exactly in int32
and dequantizes the sum.

On a CUDA tensor :func:`quantize_int8` launches the hand-written kernel in
``csrc/quantize.cu`` (built by ``nvcc`` at first use, see :mod:`ops.build`);
on a CPU tensor it runs :func:`quantize_int8_reference`. Both take ``u``
from the same counter-based hash of (seed, flat element index), so on the
card the kernel and the plain version agree bit for bit. The TPU's
hardware random bits cannot be reproduced: against the JAX package the
rounding agrees in distribution, and exactly wherever ``x / scale`` is an
integer.
"""

from __future__ import annotations

import ctypes

import torch

_MASK32 = 0xFFFFFFFF
_KEY_SALT = 0x9E3779B9
_MAX_BLOCKS = 132 * 8  # grid-stride: 8 blocks of 256 threads on each SM


def _fmix32_int(h: int) -> int:
    """murmur3's 32-bit finaliser on a Python int."""
    h &= _MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32), without int64
    overflow: h = hi * 2^16 + lo, and only the low 16 bits of hi * c
    survive the shift."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed_key(seed: int) -> int:
    """The hash key of a seed (any Python int; taken mod 2^32)."""
    return _fmix32_int((seed & _MASK32) ^ _KEY_SALT)


def uniform(n: int, seed: int, device=None) -> torch.Tensor:
    """The (n,) f32 ``u`` of flat elements 0..n-1 under ``seed``: the top
    24 bits of fmix32(lo ^ fmix32(key ^ hi)) for index = hi * 2^32 + lo,
    times 2^-24 (exact in f32)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi = _fmix32((idx >> 32) ^ seed_key(seed))
    h = _fmix32((idx & _MASK32) ^ hi)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def quantize_int8_reference(x: torch.Tensor, scale, *, seed: int
                            ) -> torch.Tensor:
    """Plain PyTorch stochastic rounding of f32 ``x / scale`` to int8, with
    the kernel's ``u``. ``scale`` is a float or a 0-d tensor."""
    flat = x.reshape(-1).to(torch.float32)
    # a device tensor, not a Python float: PyTorch divides by a CPU scalar
    # as a multiply by its reciprocal on CUDA, which rounds differently
    s = torch.as_tensor(scale, dtype=torch.float32, device=flat.device)
    u = uniform(flat.numel(), seed, flat.device)
    q = torch.floor(flat / s + u).clamp_(-127.0, 127.0).to(torch.int8)
    return q.reshape(x.shape)


def quantize_int8(x: torch.Tensor, scale, *, seed: int) -> torch.Tensor:
    """Stochastic-round ``x / scale`` to int8. ``x``: f32, any shape;
    ``scale``: a float or a 0-d f32 tensor on ``x``'s device; ``seed``: a
    Python int. On CUDA every call launches the kernel and adds one to
    ``quantize_int8.launches``."""
    if x.device.type == "cpu":
        return quantize_int8_reference(x, scale, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 runs on cpu or cuda, got {x.device}")
    out = _quantize_cuda(x, scale, seed)
    quantize_int8.launches += 1
    return out


quantize_int8.launches = 0


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _lib() -> ctypes.CDLL:
    from pytorch_distributed_nn_tpu_torch.ops.build import load_library

    lib = load_library("quantize.cu")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.quantize_int8.argtypes = [p, p, ctypes.c_uint32, ctypes.c_int64,
                                      p, ctypes.c_int, p]
        lib.quantize_int8.restype = ctypes.c_int
        lib.quantize_error_string.argtypes = [ctypes.c_int]
        lib.quantize_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _quantize_cuda(x: torch.Tensor, scale, seed: int) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_int8 takes float32, got {x.dtype}")
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if s.numel() != 1:
        raise ValueError(f"scale must be one value, got shape "
                         f"{tuple(s.shape)}")
    flat = x.reshape(-1)
    if flat.data_ptr() % 16:
        flat = flat.clone()  # the kernel's float4 loads
    out = torch.empty(flat.shape, dtype=torch.int8, device=x.device)
    n = flat.numel()
    if n == 0:
        return out.reshape(x.shape)
    blocks = max(1, min(-(-n // (256 * 4)), _MAX_BLOCKS))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    rc = lib.quantize_int8(flat.data_ptr(), s.data_ptr(), seed_key(seed), n,
                           out.data_ptr(), blocks, stream)
    if rc != 0:
        raise RuntimeError("quantize kernel launch failed: "
                           + lib.quantize_error_string(rc).decode())
    return out.reshape(x.shape)

"""BatchNorm statistics: the two per-channel reductions batch norm needs.

Counterpart of ``pytorch_distributed_nn_tpu/ops/pallas/bn_stats.py``:

- ``sum_and_sumsq(x)``   -> (sum x, sum x*x)   (forward moments)
- ``sum_and_dot(a, b)``  -> (sum a, sum a*b)   (backward sums)

Both reduce over every axis but the channel axis ``dim`` (the last one by
default, as in the JAX functions) and return (C,) f32 pairs. On a CUDA
tensor they launch the hand-written kernel in ``csrc/bn_stats.cu`` (built
by ``nvcc`` at first use, see :mod:`ops.build`); on a CPU tensor they run
the plain PyTorch versions, :func:`sum_and_sumsq_reference` and
:func:`sum_and_dot_reference`. Nothing falls back: a CUDA call either
launches the kernel or raises.

The kernel reads an (M, C) channels-minor matrix. An NCHW tensor in
``torch.channels_last`` memory (the port's convolution layout) is that
matrix already, so ``dim=1`` views it with no copy; any other layout is
copied first, and ``copies`` counts those copies.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_STRIPE = 1024  # 128 rows a thread (csrc/bn_stats.cu: 8 row lanes)
_TARGET_BLOCKS = 1056    # 8 blocks of 256 threads on each of 132 SMs
_MAX_STRIPES = 65535     # grid.y


def _reduce_dims(x: torch.Tensor, dim: int) -> list[int]:
    dim = dim % x.dim()
    return [d for d in range(x.dim()) if d != dim]


def sum_and_sumsq_reference(x: torch.Tensor, dim: int = -1
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (sum x, sum x*x) over all axes but ``dim``, in f32."""
    xf = x.float()
    dims = _reduce_dims(x, dim)
    return xf.sum(dims), (xf * xf).sum(dims)


def sum_and_dot_reference(a: torch.Tensor, b: torch.Tensor, dim: int = -1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (sum a, sum a*b) over all axes but ``dim``, in f32."""
    af = a.float()
    dims = _reduce_dims(a, dim)
    return af.sum(dims), (af * b.float()).sum(dims)


def sum_and_sumsq(x: torch.Tensor, dim: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x*x) over all axes but the channel axis ``dim``; f32
    (C,). On CUDA every call launches the kernel and adds one to
    ``sum_and_sumsq.launches``."""
    if x.device.type == "cpu":
        return sum_and_sumsq_reference(x, dim)
    out = _run(_rows(x, dim), None)
    sum_and_sumsq.launches += 1
    return out


def sum_and_dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum a, sum a*b) over all axes but the channel axis ``dim``; f32
    (C,). On CUDA every call launches the kernel and adds one to
    ``sum_and_dot.launches``."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return sum_and_dot_reference(a, b, dim)
    if a.dtype != b.dtype:
        raise TypeError(f"sum_and_dot needs one dtype, got {a.dtype} and "
                        f"{b.dtype}")
    out = _run(_rows(a, dim), _rows(b, dim))
    sum_and_dot.launches += 1
    return out


sum_and_sumsq.launches = 0
sum_and_dot.launches = 0
copies = 0  # inputs that were not channels-minor in memory and were copied


def _rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` as its (M, C) channels-minor matrix: a view when the channel
    axis is the innermost in memory (channels_last NCHW, or (..., C)
    contiguous), else a copy, counted in ``copies``."""
    global copies
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_stats takes float32 or bfloat16, got {x.dtype}")
    moved = x.movedim(dim, -1)
    if not moved.is_contiguous():
        moved = moved.contiguous()
        copies += 1
    return moved.view(-1, moved.shape[-1])


def launch_plan(m: int, c: int) -> tuple[int, int]:
    """(stripes, rows per stripe) of a call: stripes of about 1024 rows,
    more (down to 64 rows) where that leaves too few blocks to fill the
    card, never more than the grid allows."""
    col_tiles = -(-c // 64)
    stripes = max(-(-m // _ROWS_PER_STRIPE),
                  min(-(-m // 64), -(-_TARGET_BLOCKS // col_tiles)))
    stripes = max(1, min(stripes, _MAX_STRIPES))
    rows = -(-m // stripes)
    return -(-m // rows), rows


def _lib() -> ctypes.CDLL:
    from pytorch_distributed_nn_tpu_torch.ops.build import load_library

    lib = load_library("bn_stats.cu")
    if not getattr(lib, "_argtypes_set", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.bn_stats.argtypes = [p, p, i, i64, i, i, i, i, i64, p, p, p, p, p]
        lib.bn_stats.restype = ctypes.c_int
        lib.bn_stats_error_string.argtypes = [ctypes.c_int]
        lib.bn_stats_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _run(a: torch.Tensor, b: torch.Tensor | None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    m, c = a.shape
    dev = a.device
    out1 = torch.empty((c,), dtype=torch.float32, device=dev)
    out2 = torch.empty((c,), dtype=torch.float32, device=dev)
    if m == 0:
        return out1.zero_(), out2.zero_()
    stripes, rows = launch_plan(m, c)
    p1 = torch.empty((stripes, c), dtype=torch.float64, device=dev)
    p2 = torch.empty((stripes, c), dtype=torch.float64, device=dev)
    pair = 2 * a.element_size()
    vec = c % 2 == 0 and all(t.data_ptr() % pair == 0
                             for t in ((a,) if b is None else (a, b)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.bn_stats(a.data_ptr(), (a if b is None else b).data_ptr(),
                      _DTYPES[a.dtype], m, c, int(b is not None), int(vec),
                      stripes, rows, p1.data_ptr(), p2.data_ptr(),
                      out1.data_ptr(), out2.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("bn_stats kernel launch failed: "
                           + lib.bn_stats_error_string(rc).decode())
    return out1, out2

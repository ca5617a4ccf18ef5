"""Weight-only int8 matmul (W8A16): the kernel under the quantized Llama.

Counterpart of ``pytorch_distributed_nn_tpu/ops/pallas/int8_matmul.py``.
On a CUDA tensor :func:`int8_matmul` launches the hand-written kernel in
``csrc/int8_matmul.cu`` (built by ``nvcc`` at first use, see
:mod:`ops.build`); on a CPU tensor it runs :func:`int8_matmul_reference`,
the plain PyTorch version of the same arithmetic. Nothing falls back: a
CUDA call either launches the kernel or raises.

Storage contract (shared with the JAX package, so quantized checkpoints
cross between the two): ``q`` is (Kp, Np) int8 and ``s`` is (1, Np) f32,
pre-padded with zeros by :func:`padded_kn`. Activations are padded here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

# storage multiples: the persisted layout of quantized checkpoints
_STORE_BK = 2048
_STORE_BN = 1024

_SM_COUNT = 132  # H100 SXM
# the kernel's tiles (csrc/int8_matmul.cu kTileN, kTileK): a block owns 128
# output columns and streams K 64 rows a stage
_TILE_N = 128
_TILE_K = 64
_WAVE = 2 * _SM_COUNT  # the K split aims at one wave of two blocks per SM
_MIN_STAGES = 4  # K rows a split streams at least, in stages
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_kn(k: int, n: int) -> tuple[int, int]:
    """Storage shape (Kp, Np) for a logical (k, n) int8 weight: K pads to
    a multiple of 32 or of 2048 once it exceeds it, N to 128 or 1024."""
    kp = _round_up(k, min(_STORE_BK, _round_up(k, 32)))
    np_ = _round_up(n, min(_STORE_BN, _round_up(n, 128)))
    return kp, np_


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Round-to-nearest symmetric per-output-channel int8 quantization.

    w: (K, N) float. Returns (q (Kp, Np) int8, s (1, Np) f32), padded to
    the storage shape with zeros."""
    k, n = w.shape
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=0)  # (N,)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / s[None, :]), -127, 127).to(torch.int8)
    kp, np_ = padded_kn(k, n)
    q = F.pad(q, (0, np_ - n, 0, kp - k))
    s = F.pad(s, (0, np_ - n)).reshape(1, np_).to(torch.float32)
    return q, s


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Plain PyTorch W8A16: bf16 operands upcast to f32 (exact), an f32
    matmul, the per-column scale, then the cast. ``x`` is (M, Kp)."""
    acc = x.to(torch.bfloat16).to(torch.float32) @ q.to(torch.float32)
    return (acc * s).to(out_dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(M, K) @ dequant((Kp, Np) int8, (1, Np) scales) -> (M, Np).

    ``x`` may be narrower than Kp (zero-padded here); the caller slices
    the output's N padding. On CUDA every call launches the kernel and
    adds one to ``int8_matmul.launches``."""
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"need 2-D x and q, got {tuple(x.shape)} and "
                         f"{tuple(q.shape)}")
    kp = q.shape[0]
    if x.shape[1] < kp:
        x = F.pad(x, (0, kp - x.shape[1]))
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, s, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda, got {x.device}")
    out = _int8_matmul_cuda(x, q, s, out_dtype)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def _lib() -> ctypes.CDLL:
    from pytorch_distributed_nn_tpu_torch.ops.build import load_library

    lib = load_library("int8_matmul.cu")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w8a16_matmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     p]
        lib.w8a16_matmul.restype = ctypes.c_int
        lib.w8a16_error_string.argtypes = [ctypes.c_int]
        lib.w8a16_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


class Plan(NamedTuple):
    """How one call is launched (``launch_plan``)."""

    mt: int         # tokens a block: 8 per n-tile of the mma, 8..128
    kc: int         # K rows a split, a multiple of 64
    splits: int     # K splits; the last block of a column tile adds them
    blocks: int     # the grid: token tiles x column tiles x splits
    workspace: int  # f32 partial sums the splits write (0 without a split)


def launch_plan(m: int, kp: int, np_: int) -> Plan:
    """The launch of one call: M takes tiles of 8, 16, 32, 64 or 128 tokens
    (the smallest that holds M, at most 128); K is split until the column
    tiles make about one wave of two blocks per SM (never below 256 K rows
    a split). The split depends on (Kp, Np) only, so every output element
    is summed in the same order whatever M is: a row's result does not
    depend on the batch it shares a call with (the engine's bit-identity
    contract)."""
    nt = 1 if m <= 8 else min(16, 1 << (-(-m // 8) - 1).bit_length())
    mt = 8 * nt
    tiles = -(-np_ // _TILE_N)
    stages = -(-kp // _TILE_K)
    splits = max(1, min(_WAVE // tiles, stages // _MIN_STAGES))
    per = -(-stages // splits)
    splits = -(-stages // per)
    return Plan(mt=mt, kc=per * _TILE_K, splits=splits,
                blocks=-(-m // mt) * tiles * splits,
                workspace=splits * m * np_ if splits > 1 else 0)


# (device index, stream) -> int32 counters of the column tiles that say which
# block of a tile adds the K splits: zeroed once and left zeroed by every
# launch (the last block of a tile resets its own), so a call needs no
# memset kernel of its own
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _tile_counters(device: torch.device, stream: int, n: int
                   ) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _int8_matmul_cuda(x, q, s, out_dtype):
    m, kp = x.shape
    kp2, np_ = q.shape
    if kp != kp2:
        raise ValueError(f"x inner dim {kp} != stored weight rows {kp2}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"need int8 q and float32 s, got {q.dtype}, {s.dtype}")
    if tuple(s.shape) != (1, np_):
        raise ValueError(f"scale shape {tuple(s.shape)} != (1, {np_})")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    if np_ % _TILE_N or kp % 32:
        raise ValueError(f"stored (K, N) ({kp}, {np_}) is not a multiple "
                         f"of (32, {_TILE_N}): pad with padded_kn")
    if not (q.device == x.device == s.device):
        raise ValueError(f"tensors on different devices: x {x.device}, "
                         f"q {q.device}, s {s.device}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("q and s must be contiguous")
    x = x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, np_), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    plan = launch_plan(m, kp, np_)
    ws = (torch.empty((plan.workspace,), dtype=torch.float32,
                      device=x.device)
          if plan.workspace else out)  # no split: the kernel never reads it
    for t in (x, q, s, out, ws):
        if t.data_ptr() % 16:
            raise ValueError("int8_matmul needs 16-byte aligned tensors")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _tile_counters(x.device, stream,
                              plan.blocks // plan.splits)
    lib = _lib()
    rc = lib.w8a16_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), m, kp, np_, plan.mt, plan.kc,
        plan.splits, int(out_dtype == torch.float32), stream)
    if rc != 0:
        raise RuntimeError("int8_matmul kernel launch failed: "
                           + lib.w8a16_error_string(rc).decode())
    return out

"""Launching wrapper of the f32 tiled GEMM in ``csrc/matmul.cu``.

Replaces ``repro/kernels/matmul/kernel.py::matmul_call``.  The source note
in ``matmul.cu`` says what bounds the kernel and how its tiles cope with
decode's M = 1..4.  The library builds at first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, _P]
SMALL_M = 16            # rows up to which the 16-row tile and split-K apply
SM_COUNT = 132
MIN_K_CHUNK = 256


def _lib() -> ctypes.CDLL:
    lib = build.library("matmul")
    fn = lib.sol_matmul_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def split_k(m: int, n: int, k: int, sms: int = SM_COUNT) -> int:
    """K splits for a small-M product: enough blocks for two per SM, with
    at least MIN_K_CHUNK of K per split.  Large M gets one split."""
    if m > SMALL_M:
        return 1
    tiles = -(-n // 64) * -(-m // 16)
    return max(1, min(-(-2 * sms // tiles), k // MIN_K_CHUNK))


def matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) → (M, N), f32, on the card.  ``x`` must have a
    unit column stride; ``w`` may have any strides (a transposed (N, K)
    weight is read in place)."""
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("matmul_cuda wants x and w on one CUDA device")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"matmul_cuda takes float32, got {x.dtype}/{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_cuda wants (M,K) @ (K,N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("matmul_cuda wants x with unit column stride")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    splits = split_k(m, n, k)
    ws = (torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
          if splits > 1 else None)
    lib = _lib()
    err = lib.sol_matmul_f32(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k, x.stride(0),
        w.stride(0), w.stride(1), splits, int(m <= SMALL_M),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "sol_matmul_f32")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0

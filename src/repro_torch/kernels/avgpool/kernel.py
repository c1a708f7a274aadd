"""Launching wrapper of the average pooling in ``csrc/avgpool.cu``.

Replaces ``repro/kernels/avgpool/kernel.py::avgpool_call``.  The source
note in ``avgpool.cu`` says what bounds the kernel and how its threads map
to outputs.  The library builds at first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, dtypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P] + [_I] * 6 + [_P]


def avgpool_cuda(x: torch.Tensor, kh: int = 3, kw: int = 3) -> torch.Tensor:
    """Stride-1 VALID kh×kw mean.  x: (N, C, H, W) in float32, bfloat16
    or float16, contiguous, on a CUDA device → (N, C, H-kh+1, W-kw+1) in
    x's dtype; the sum is taken in f32, divided, then rounded once."""
    if not x.is_cuda:
        raise ValueError("avgpool_cuda wants x on a CUDA device")
    sfx = dtypes.suffix("avgpool_cuda", x)
    if x.dim() != 4:
        raise ValueError(f"avgpool_cuda wants (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("avgpool_cuda wants a contiguous x")
    n, c, h, w = x.shape
    if not (1 <= kh <= h and 1 <= kw <= w):
        raise ValueError(f"avgpool_cuda: window {kh}x{kw} does not fit "
                         f"{h}x{w}")
    y = torch.empty(n, c, h - kh + 1, w - kw + 1, dtype=x.dtype,
                    device=x.device)
    name = f"sol_avgpool_{sfx}"
    lib, fn = build.entry("avgpool", name, _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), n, c, h, w, kh, kw,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, name)
    avgpool_cuda.launches += 1
    return y


avgpool_cuda.launches = 0

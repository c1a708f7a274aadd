"""Plain PyTorch version of the matmul kernel (counterpart of
``repro.kernels.matmul.ref``)."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) with f32 accumulation, cast back to x's
    dtype.  On the card, a caller that wants full f32 turns TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)

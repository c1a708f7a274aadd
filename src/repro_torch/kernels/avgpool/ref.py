"""Plain PyTorch version of the Listing-3 AveragePooling kernel
(counterpart of ``repro.kernels.avgpool.ref``)."""
from __future__ import annotations

import torch


def avgpool_ref(x: torch.Tensor, kh: int = 3, kw: int = 3) -> torch.Tensor:
    """x: (N, C, H, W) → (N, C, H-kh+1, W-kw+1); stride 1, VALID.  The kh·kw
    taps are summed in f32 in the kernel's order (k1 outer, k2 inner), then
    divided by kh·kw and cast to x's dtype."""
    oh, ow = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    xf = x.float()
    acc = torch.zeros(x.shape[:2] + (oh, ow), dtype=torch.float32,
                      device=x.device)
    for k1 in range(kh):
        for k2 in range(kw):
            acc = acc + xf[:, :, k1:k1 + oh, k2:k2 + ow]
    return (acc / float(kh * kw)).to(x.dtype)

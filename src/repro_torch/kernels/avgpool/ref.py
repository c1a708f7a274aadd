"""Plain PyTorch versions of the Listing-3 AveragePooling kernel
(counterpart of ``repro.kernels.avgpool.ref``): the listing's sum, and the
band algorithm of ``csrc/avgpool.cu`` in the kernel's own order."""
from __future__ import annotations

import torch


def avgpool_ref(x: torch.Tensor, kh: int = 3, kw: int = 3) -> torch.Tensor:
    """x: (N, C, H, W) → (N, C, H-kh+1, W-kw+1); stride 1, VALID.  The kh·kw
    taps are summed in f32 in the listing's order (k1 outer, k2 inner),
    then divided by kh·kw and cast to x's dtype."""
    oh, ow = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    xf = x.float()
    acc = torch.zeros(x.shape[:2] + (oh, ow), dtype=torch.float32,
                      device=x.device)
    for k1 in range(kh):
        for k2 in range(kw):
            acc = acc + xf[:, :, k1:k1 + oh, k2:k2 + ow]
    return (acc / float(kh * kw)).to(x.dtype)


def avgpool_banded_ref(x: torch.Tensor, kh: int, kw: int, plan,
                       halo: bool = True) -> torch.Tensor:
    """The kernel's algorithm on x (N, C, H, W) under ``plan``
    (``kernel.avgpool_plan``): for each band of ``plan.rows`` output rows
    and tile of ``plan.cols`` output columns, the staged input (the band's
    rows plus kh − 1 halo rows, the tile's columns plus kw − 1) gets each
    row's kw-tap sum in f32 (k2 = 0, 1, ...), each output the sum of its kh
    row sums (k1 = 0, 1, ...), one IEEE division by a tensor of kh·kw (not
    a product with its reciprocal) and one rounding to x's dtype.
    ``halo=False`` stages the band without its halo rows, as zeros: the
    fault the tests' control must catch."""
    n, c, h, w = x.shape
    oh, ow = h - kh + 1, w - kw + 1
    y = torch.empty(n, c, oh, ow, dtype=x.dtype, device=x.device)
    for r0 in range(0, oh, plan.rows):
        rows = min(plan.rows, oh - r0)
        for c0 in range(0, ow, plan.cols):
            cols = min(plan.cols, ow - c0)
            band = x[:, :, r0:r0 + rows + kh - 1, c0:c0 + cols + kw - 1]
            band = band.float()
            if not halo:
                band = band.clone()
                band[:, :, rows:] = 0.0
            hs = band[..., 0:cols]
            for k2 in range(1, kw):
                hs = hs + band[..., k2:k2 + cols]
            acc = hs[:, :, 0:rows]
            for k1 in range(1, kh):
                acc = acc + hs[:, :, k1:k1 + rows]
            area = torch.full_like(acc, float(kh * kw))
            y[:, :, r0:r0 + rows, c0:c0 + cols] = (acc / area).to(x.dtype)
    return y

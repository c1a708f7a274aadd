"""Plain PyTorch version of the RG-LRU scan kernel (counterpart of
``repro.kernels.rglru_scan.ref``).

The JAX oracle runs an associative scan; PyTorch has none, so this walks T
with the state in f32.  A log-space cumulative product would underflow:
products of a_t in (0, 1) reach 0 long before T = 512."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t·h_{t-1} + b_t per channel.  a, b: (B, T, D); h0: (B, D)
    → (h (B, T, D), h_last (B, D)), both in a's dtype."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = torch.addcmul(bf[:, t], af[:, t], h)
        out[:, t] = h
    return out.to(a.dtype), h.to(a.dtype)

"""Plain PyTorch version of the flash-attention kernel: direct masked-softmax
GQA attention (counterpart of ``repro.kernels.flash_attention.ref``)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        cap: float = 0.0) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) → (B, H, S, hd)."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    qg = q.reshape(b, kv, g, s, hd).float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(hd))
    if cap:
        logits = torch.tanh(logits / cap) * cap
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(b, h, s, hd).to(q.dtype)

"""Plain PyTorch version of the decode-attention kernel: one query token
against a ragged KV cache plus the step's own (k, v) pair at position
``lens[b]`` (counterpart of ``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         lens: torch.Tensor, *, window: int = 0,
                         cap: float = 0.0) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, KV, S, hd); k_new, v_new: (B, KV, hd);
    lens: (B,) int32 → (B, H, hd)."""
    b, h, hd = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    logit_new = torch.einsum("bkgd,bkd->bkg", qg, k_new.float()) * scale
    if cap:
        logits = torch.tanh(logits / cap) * cap
        logit_new = torch.tanh(logit_new / cap) * cap
    pos = torch.arange(s, device=q.device)
    lens = lens.to(device=q.device, dtype=torch.int64)
    mask = pos[None, :] < lens[:, None]                  # valid cache rows
    if window:  # the query sits at position lens[b]
        mask &= (lens[:, None] - pos[None, :]) < window
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    w = torch.softmax(torch.cat([logits, logit_new[..., None]], dim=-1),
                      dim=-1)
    o = (torch.einsum("bkgs,bksd->bkgd", w[..., :s], v.float())
         + torch.einsum("bkg,bkd->bkgd", w[..., s], v_new.float()))
    return o.reshape(b, h, hd).to(q.dtype)

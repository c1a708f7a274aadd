"""Flash attention's forward for the backbone (counterpart of
``repro.models.flash``'s ``flash_mha``).

Two forms of one function.  Where ``models.layers.attention_route`` says
"kernel", it is the public entry of the flash kernel
(``kernels.flash_attention.ops.flash_attention``): a CUDA tensor launches
the hand-written kernel, a CPU tensor takes the kernel's plain version.
Otherwise it is the chunked online-softmax scan in plain torch, the
counterpart of ``fwd_scan`` in the JAX package's
``kernels/flash_attention/grad.py``.  The backward rule waits with the
backbone's training steps (ROADMAP §1 item 7).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def fwd_scan(qg: Tensor, k: Tensor, v: Tensor, *, causal: bool,
             window: int, cap: float, chunk: int):
    """Online-softmax forward over KV chunks.  qg: (B, Sq, KV, G, hd);
    k, v: (B, Skv, KV, hd) → (o (B, KV, G, Sq, hd) f32, lse (B, KV, G, Sq)
    f32).  Causal positions are the natural aranges."""
    b, sq, kvh, g, hd = qg.shape
    skv = k.shape[1]
    nc = (skv + chunk - 1) // chunk
    scale = 1.0 / math.sqrt(hd)
    dev = qg.device
    qp = torch.arange(sq, device=dev)[:, None]
    m = torch.full((b, kvh, g, sq), -math.inf, device=dev)
    l = torch.zeros((b, kvh, g, sq), device=dev)
    acc = torch.zeros((b, kvh, g, sq, hd), device=dev)
    qf = qg.float()
    for j in range(nc):
        kb = k[:, j * chunk:(j + 1) * chunk]
        vb = v[:, j * chunk:(j + 1) * chunk]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kb.float()) * scale
        if cap:
            logits = torch.tanh(logits / cap) * cap
        kp = j * chunk + torch.arange(kb.shape[1], device=dev)[None, :]
        msk = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            msk &= qp >= kp
        if window:
            msk &= qp - kp < window
        logits = torch.where(msk, logits, torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vb.dtype), vb).float()
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    return o, lse


def flash_mha(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
              window: int = 0, cap: float = 0.0, chunk: int = 1024, *,
              kernel: bool = False) -> Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) → (B, Sq, H, hd), causal
    positions the natural aranges (the prefill layout).  ``kernel``: the
    flash kernel's public entry (Sq == Skv), else the chunked plain
    scan in chunks of ``chunk`` keys."""
    if kernel:
        from ..kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    o, _ = fwd_scan(q.reshape(b, sq, kvh, h // kvh, hd), k, v,
                    causal=causal, window=window, cap=cap, chunk=chunk)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)

"""Flash attention for the backbone, with its backward rule (counterpart
of ``repro.models.flash``'s ``flash_mha``, a ``custom_vjp`` there).

:func:`flash_mha` is one ``torch.autograd.Function`` with two forwards.
Where ``models.layers.attention_route`` says "kernel", the forward is the
public entry of the flash kernel (``kernels.flash_attention.ops.
flash_attention``): a CUDA tensor launches the hand-written kernel, a CPU
tensor takes the kernel's plain version.  Otherwise it is the chunked
online-softmax scan in plain torch (:func:`fwd_scan`, the counterpart of
``fwd_scan`` in the JAX package's ``kernels/flash_attention/grad.py``).

The backward is explicit on both, and the same chunked math the dispatch
table's ``flash.attention_bwd`` runs (``kernels.flash_attention.grad.
bwd_scan``): D = Σ dO·O a row, then p, dv, ds chunk by chunk.  Only the
residuals differ, as the JAX module describes for its two paths: the
plain scan saves its f32 grouped output and the logsumexp rows; the
kernel saves no logsumexp, so its backward recomputes one with
``grad.lse_scan`` from (q, k) and takes D from the kernel's output.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor
# the backward's KV chunk is cut to the keys rounded up to this (a longer
# chunk only adds masked columns)
BWD_ROUND = 128


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


def _grouped_t(x: Tensor, kvh: int) -> Tensor:
    """(B, S, H, hd) → (B, KV, G, S, hd) f32."""
    b, s, h, hd = x.shape
    return x.reshape(b, s, kvh, h // kvh, hd).float().permute(0, 2, 3, 1, 4)


def row_dsum(dog: Tensor, og: Tensor) -> Tensor:
    """D = Σ dO·O over the head dim: (B, KV, G, Sq) f32."""
    return (dog * og).sum(-1)


class _FlashMHA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, chunk, kernel):
        b, sq, h, hd = q.shape
        kvh = k.shape[2]
        if kernel:
            from ..kernels.flash_attention.ops import flash_attention
            o = flash_attention(q, k, v, causal=causal, window=window,
                                cap=cap)
            ctx.save_for_backward(q, k, v, o)
        else:
            og, lse = fwd_scan(q.reshape(b, sq, kvh, h // kvh, hd), k, v,
                               causal=causal, window=window, cap=cap,
                               chunk=chunk)
            o = og.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
            ctx.save_for_backward(q, k, v, og, lse)
        ctx.attrs = (causal, window, cap, chunk, kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        from ..kernels.flash_attention.grad import bwd_scan, lse_scan
        causal, window, cap, chunk, kernel = ctx.attrs
        q, k, v, *res = ctx.saved_tensors
        b, sq, h, hd = q.shape
        kvh = k.shape[2]
        chunk = min(chunk, -(-k.shape[1] // BWD_ROUND) * BWD_ROUND)
        if kernel:
            (o,) = res
            og = _grouped_t(o, kvh)
            lse = lse_scan(q.reshape(b, sq, kvh, h // kvh, hd), k,
                           causal=causal, window=window, cap=cap,
                           chunk=chunk)
        else:
            og, lse = res
        dsum = row_dsum(_grouped_t(do, kvh), og)
        dq, dk, dv = bwd_scan(q, k, v, lse, dsum, do, causal=causal,
                              window=window, cap=cap, chunk=chunk)
        return dq, dk, dv, None, None, None, None, None


def flash_mha(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
              window: int = 0, cap: float = 0.0, chunk: int = 1024, *,
              kernel: bool = False) -> Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) → (B, Sq, H, hd), causal
    positions the natural aranges (the prefill layout).  ``kernel``: the
    flash kernel's public entry (Sq == Skv), else the chunked plain scan
    in chunks of ``chunk`` keys.  Differentiable on both, through the
    explicit backward above."""
    return _FlashMHA.apply(q, k, v, causal, window, cap, chunk, kernel)

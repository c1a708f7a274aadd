"""Flash-attention backward as torch ops (counterpart of
``repro.kernels.flash_attention.grad``, which is jnp code outside any
Pallas kernel).

``flash.attention_bwd`` keeps O(S) residuals, the default ones (q, k, v,
o): it recomputes the logsumexp rows with an m/l-only sweep over KV
chunks (``lse_scan``), then per chunk (``bwd_scan``)

  D = Σ do·o;  p = exp(softcap(qkᵀ) − L);
  dv = pᵀdo;  ds = p⊙(do vᵀ − D);  through the softcap's chain rule;
  dq accumulated, dk and dv emitted per chunk,

so no S×S matrix outlives its chunk.  Everything runs in f32 (TF32 off,
as the port's reference tier runs its products) and is cast back to the
primal dtypes.  It is shared with no capability needed, as in the JAX
package.  The KV-chunk length is its ``Tunable``
(``node.attrs['cuda_attn_block_bwd']``), elected apart from the forward's
block; without a pin the chunk is ``DEFAULT_CHUNK`` cut to the sequence
rounded up to 128 (a longer chunk only adds masked columns).
``ref.attention_bwd`` is autograd of the plain attention, which
materializes the S×S scores.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ...backends import registry
from ...core import executor
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from .ops import ATTR

Tensor = torch.Tensor
ATTR_BWD = ATTR + "_bwd"
DEFAULT_CHUNK = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def chunks(x: Tensor, nc: int, c: int) -> Tensor:
    """(B, nc·c, ...) → (nc, B, c, ...)."""
    return x.reshape(x.shape[0], nc, c, *x.shape[2:]).transpose(0, 1)


def mask_for(sq: int, c: int, j0: int, causal: bool, window: int,
             skv: int, device) -> Tensor:
    """(Sq, C) validity mask of the chunk starting at kv position j0."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = j0 + torch.arange(c, device=device)[None, :]
    m = kp < skv
    if causal:
        m = m & (qp >= kp)
    if window:
        m = m & (qp - kp < window)
    return m


def _pad_kv(k: Tensor, v: Tensor, nc: int, chunk: int):
    pad = nc * chunk - k.shape[1]
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v


def _logits(qg: Tensor, kb: Tensor, scale: float, cap: float) -> Tensor:
    """(B, KV, G, Sq, C) f32 scores of qg (B, Sq, KV, G, hd) f32 against
    one chunk kb (B, C, KV, hd), softcapped."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb.float()) * scale
    return torch.tanh(s / cap) * cap if cap else s


def lse_scan(qg: Tensor, k: Tensor, *, causal: bool, window: int,
             cap: float, chunk: int) -> Tensor:
    """The logsumexp rows (B, KV, G, Sq) f32 of qg (B, Sq, KV, G, hd)
    against k (B, Skv, KV, hd), one KV chunk at a time (no p·v)."""
    b, sq, kvh, g, hd = qg.shape
    skv = k.shape[1]
    nc = -(-skv // chunk)
    kc = chunks(_pad_kv(k, k, nc, chunk)[0], nc, chunk)
    scale = 1.0 / math.sqrt(hd)
    qf = qg.float()
    m = torch.full((b, kvh, g, sq), -math.inf, device=qg.device)
    l = torch.zeros((b, kvh, g, sq), device=qg.device)
    for j in range(nc):
        logits = _logits(qf, kc[j], scale, cap)
        msk = mask_for(sq, chunk, j * chunk, causal, window, skv, qg.device)
        logits = torch.where(msk, logits, torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[..., None]).sum(-1)
        m = m_new
    return m + torch.log(torch.clamp_min(l, 1e-30))


def bwd_scan(q: Tensor, k: Tensor, v: Tensor, lse: Tensor, dsum: Tensor,
             do: Tensor, *, causal: bool, window: int, cap: float,
             chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Chunked flash backward.  q, do: (B, Sq, H, hd); k, v: (B, Skv, KV,
    hd); lse, dsum: (B, KV, G, Sq) f32 → (dq, dk, dv) in the primal
    dtypes."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    skv = k.shape[1]
    nc = -(-skv // chunk)
    kp, vp = _pad_kv(k, v, nc, chunk)
    kc, vc = chunks(kp, nc, chunk), chunks(vp, nc, chunk)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, g, hd).float()
    dog = do.reshape(b, sq, kvh, g, hd).float().permute(0, 2, 3, 1, 4)
    dq = torch.zeros((b, sq, kvh, g, hd), device=q.device)
    dks: List[Tensor] = []
    dvs: List[Tensor] = []
    for j in range(nc):
        kb, vb = kc[j].float(), vc[j].float()
        capped = _logits(qg, kb, scale, cap)
        msk = mask_for(sq, chunk, j * chunk, causal, window, skv, q.device)
        capped = torch.where(msk, capped, torch.full_like(capped, -1e30))
        p = torch.exp(capped - lse[..., None])            # (B,KV,G,Sq,C)
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p, dog))
        dp = torch.einsum("bkgqd,bskd->bkgqs", dog, vb)
        ds = p * (dp - dsum[..., None])                   # d/d capped
        if cap:
            ds = ds * (1.0 - (capped / cap) ** 2)
        ds = torch.where(msk, ds, torch.zeros_like(ds))
        dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds, kb) * scale
        dks.append(torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale)
    dk = torch.cat(dks, 1)[:, :skv]
    dv = torch.cat(dvs, 1)[:, :skv]
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attn_bwd_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """KV-chunk lengths: powers of two from 128 to 1024, each cut to the
    sequence rounded up to 128, deduplicated."""
    cap_len = _round_up(n.spec.shape[1], 128)
    return [(c,) for c in sorted({min(c, cap_len)
                                  for c in (128, 256, 512, 1024)})]


def _attention_grad_impl(n: Node, res, ct: Tensor,
                         backend: "registry.Backend"):
    (q, k, v), o = res
    cfg = n.attrs.get(ATTR_BWD)
    chunk = int(cfg[0]) if cfg else min(DEFAULT_CHUNK,
                                        _round_up(k.shape[1], 128))
    causal = n.attrs.get("causal", True)
    window = n.attrs.get("window", 0)
    cap = n.attrs.get("cap", 0.0)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    lse = lse_scan(q.reshape(b, sq, kvh, g, hd), k, causal=causal,
                   window=window, cap=cap, chunk=chunk)
    og = o.reshape(b, sq, kvh, g, hd).float().permute(0, 2, 3, 1, 4)
    dog = ct.reshape(b, sq, kvh, g, hd).float().permute(0, 2, 3, 1, 4)
    dsum = (dog * og).sum(-1)                             # (B,KV,G,Sq)
    return bwd_scan(q, k, v, lse, dsum, ct, causal=causal, window=window,
                    cap=cap, chunk=chunk)


registry.register_shared_grad_impl(
    OpKind.ATTENTION, _attention_grad_impl, name="flash.attention_bwd",
    supports=lambda n: len(n.spec.shape) == 4,
    tunable=Tunable(ATTR_BWD, attn_bwd_tune_space))
registry.register_reference_grad_impl(
    OpKind.ATTENTION, executor.reference_vjp_grad,
    name="ref.attention_bwd", memory="roundtrip")

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


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, lens: torch.Tensor, *,
                               chunk: int, window: int = 0,
                               cap: float = 0.0) -> torch.Tensor:
    """The split-KV kernel's algorithm in plain torch, layouts as
    ``decode_attention_ref``.  Split s takes cache rows ``[s * chunk,
    (s + 1) * chunk)`` and leaves f32 partials: its visible rows' max m_s
    (-inf for a split with none), sum l_s and accumulator acc_s.  The
    combine takes the new pair's score x, M = max(x, m_s), weights
    w_s = exp(m_s - M) (0 for an empty split) and w_new = exp(x - M), and
    returns (sum_s w_s acc_s + w_new v_new) / (sum_s w_s l_s + w_new),
    splits in order, rounded once to q's dtype."""
    b, h, hd = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    splits = max(1, math.ceil(s / chunk))
    pad = splits * chunk - s
    qg = q.reshape(b, kv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    x = torch.einsum("bkgd,bkd->bkg", qg, k_new.float()) * scale
    if cap:
        logits = torch.tanh(logits / cap) * cap
        x = torch.tanh(x / cap) * cap
    pos = torch.arange(s, device=q.device)
    n = lens.to(device=q.device, dtype=torch.int64).clamp(0, s)[:, None]
    visible = pos[None, :] < n
    if window:
        visible &= (n - pos[None, :]) < window
    logits = torch.where(visible[:, None, None, :], logits,
                         torch.full_like(logits, -math.inf))
    logits = torch.nn.functional.pad(logits, (0, pad), value=-math.inf)
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    logits = logits.reshape(b, kv, g, splits, chunk)
    m = logits.amax(-1)                                  # (b, kv, g, splits)
    empty = m == -math.inf
    p = torch.exp(logits - torch.where(empty, 0.0, m)[..., None])
    l_s = p.sum(-1)
    acc = torch.einsum("bkgsc,bkscd->bkgsd", p,
                       vs.reshape(b, kv, splits, chunk, hd))
    big = torch.maximum(x, m.amax(-1))
    w = torch.where(empty, 0.0, torch.exp(m - big[..., None]))
    w_new = torch.exp(x - big)
    num, den = torch.zeros_like(acc[..., 0, :]), torch.zeros_like(x)
    for i in range(splits):                              # in split order
        num = num + w[..., i, None] * acc[..., i, :]
        den = den + w[..., i] * l_s[..., i]
    num = num + w_new[..., None] * v_new.float()[:, :, None, :]
    o = num / torch.clamp(den + w_new, min=1e-30)[..., None]
    return o.reshape(b, h, hd).to(q.dtype)

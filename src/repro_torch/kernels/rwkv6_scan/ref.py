"""Plain PyTorch version of the RWKV6 WKV scan kernel (counterpart of
``repro.kernels.rwkv6_scan.ref``): the per-step recurrence, in f32."""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, logw, u, s0):
    """r, k, v, logw: (B, T, H, hd) with logw ≤ 0; u: (H, hd); s0: (B, H,
    hd, hd) → (o (B, T, H, hd) in r's dtype, s_last (B, H, hd, hd) f32).

    Per step: o_t = r_t·(S + (u⊙k_t) v_tᵀ); S ← diag(exp w_t)·S + k_t v_tᵀ.
    The bonus term is taken as (r_t·(u⊙k_t))·v_t, the same sum as the
    oracle's, with one matrix-vector product per step."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, logw))
    uf = u.float()
    s = s0.float().clone()
    out = torch.empty_like(rf)
    for t in range(r.shape[1]):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]            # (B, H, hd)
        o = torch.matmul(rt.unsqueeze(-2), s).squeeze(-2)
        o = o + (rt * uf * kt).sum(-1, keepdim=True) * vt
        out[:, t] = o
        s = torch.exp(wf[:, t]).unsqueeze(-1) * s \
            + kt.unsqueeze(-1) * vt.unsqueeze(-2)
    return out.to(r.dtype), s

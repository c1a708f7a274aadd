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


def rwkv6_scan_chunked_ref(r, k, v, logw, u, s0, *, chunk: int,
                           carry: bool = True):
    """The chunked kernel's algorithm in plain torch, contract as
    ``rwkv6_scan_ref``.  T is cut into nc = ceil(T / chunk) chunks (the
    last one ragged).

    1. Each chunk c < nc - 1 walks its steps from a zero state with the
       step recurrence, giving its own state ΔS_c, and its decay
       D_c = ∏ exp(w_t) over its steps: the product of the f32 exps in
       step order, as the kernel takes it (not the exp of the summed log
       decay).
    2. The carry, in chunk order: S_in(0) = s0, S_in(c+1) = D_c ⊙_rows
       S_in(c) + ΔS_c.
    3. Each chunk walks its steps again from S_in(c) and writes o; the
       last chunk's final state is s_last.

    ``carry=False`` drops step 2 (every chunk walks from a zero state):
    the one fault the chunking can bring, which the tests must see."""
    bsz, t, h, hd = r.shape
    nc = max(1, -(-t // chunk))
    pad = nc * chunk - t

    def chunks(x, fill=0.0):        # (B, T, H, hd) → (chunk, B, nc, H, hd)
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad),
                                    value=fill)
        return x.reshape(bsz, nc, chunk, h, hd).permute(2, 0, 1, 3, 4)

    # padded steps: k = v = r = 0 and exp(w) = 1, so they leave S as it is
    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(logw)
    ec = torch.exp(wc)
    uf = u.float()
    kv = kc.unsqueeze(-1) * vc.unsqueeze(-2)        # (C, B, nc, H, hd, hd)
    d_s = torch.zeros(bsz, nc, h, hd, hd)
    dec = torch.ones(bsz, nc, h, hd)
    for i in range(chunk):
        d_s = ec[i].unsqueeze(-1) * d_s + kv[i]
        dec = dec * ec[i]
    s_in = torch.zeros(bsz, nc, h, hd, hd)
    s_in[:, 0] = s0.float()
    if carry:
        for c in range(nc - 1):
            s_in[:, c + 1] = dec[:, c].unsqueeze(-1) * s_in[:, c] + d_s[:, c]
    s = s_in
    bonus = (rc * uf * kc).sum(-1, keepdim=True)    # (C, B, nc, H, 1)
    out = torch.empty(chunk, bsz, nc, h, hd)
    for i in range(chunk):
        out[i] = torch.matmul(rc[i].unsqueeze(-2), s).squeeze(-2) \
            + bonus[i] * vc[i]
        s = ec[i].unsqueeze(-1) * s + kv[i]
    o = out.permute(1, 2, 0, 3, 4).reshape(bsz, nc * chunk, h, hd)[:, :t]
    return o.to(r.dtype), s[:, -1]

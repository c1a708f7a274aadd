"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin) and RWKV6 (Finch) —
the eager forwards of the port's ``RGLRU`` and ``RWKV6TimeMix`` modules
(counterpart of ``repro.models.recurrent``; the port keeps its own copy).

* RG-LRU: gates from two projections, then the linear recurrence
  h_t = a_t·h_{t-1} + b_t walked over T in f32 (``rglru_scan_ref``).
  PyTorch has no associative scan, and a log-space cumulative product of
  a_t would underflow over long T.
* RWKV6 time mix: data-dependent token-shift lerp with LoRA mixes, the WKV
  recurrence in its chunked parallel form (inter-chunk state scan plus an
  intra-chunk C×C attention-like product, decays in log space), per-head
  group norm, silu gate.

Parameters come as a dict of tensors named as in the JAX package: ``wa``,
``wx`` (in, out), ``lam``; ``mu_*``, ``lora_a_*`` (d, r), ``lora_b_*``
(r, d), ``w0``, ``u``, ``wr``/``wk``/``wv``/``wg``/``wo`` (in, out),
``gn_gain``, ``gn_bias``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan.ref import rglru_scan_ref

Tensor = torch.Tensor
Params = Dict[str, Tensor]

RGLRU_C = 8.0          # Griffin's fixed recurrence sharpness constant
RWKV_CHUNK = 32
GN_EPS = 64e-5         # RWKV6's per-head group-norm epsilon


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def rglru_gates(p: Params, u: Tensor) -> Tuple[Tensor, Tensor]:
    """(log a_t, b_t) from the branch input u: (B, S, dr), in f32."""
    r = torch.sigmoid((u @ p["wa"]).float())
    i = torch.sigmoid((u @ p["wx"]).float())
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i * u.float()
    return log_a, b


def rglru_seq(p: Params, u: Tensor, h0: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    """Sequence RG-LRU.  u: (B, S, dr) → (h (B, S, dr), h_last (B, dr)),
    both in u's dtype."""
    log_a, b = rglru_gates(p, u)
    a = torch.exp(log_a)
    if h0 is None:
        h0 = torch.zeros(u.shape[0], u.shape[2], device=u.device)
    h, h_last = rglru_scan_ref(a, b, h0.float())
    return h.to(u.dtype), h_last.to(u.dtype)


# ---------------------------------------------------------------------------
# RWKV6 time mix
# ---------------------------------------------------------------------------

def _lora(x: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.tanh(x @ a) @ b


def rwkv_shift(x: Tensor) -> Tensor:
    """Token shift: the previous token's features (zeros at the start)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rwkv_mix_inputs(p: Params, x: Tensor, xs: Tensor) -> Dict[str, Tensor]:
    """Data-dependent lerp (RWKV6): per-target mixes for r, k, v, w, g."""
    dx = xs - x
    xm = x + dx * p["mu_x"]
    outs = {}
    for t in ("r", "k", "v", "w", "g"):
        mix = p[f"mu_{t}"] + _lora(xm, p[f"lora_a_{t}"], p[f"lora_b_{t}"])
        outs[t] = x + dx * mix
    return outs


def rwkv_time_mix_seq(p: Params, x: Tensor, n_heads: int) -> Tensor:
    """RWKV6 time mix, chunked parallel form, from a zero state (the
    carried state of a decode step arrives with a decode slice).
    x: (B, S, D) → (B, S, D)."""
    bsz, s, d = x.shape
    hd = d // n_heads
    m = rwkv_mix_inputs(p, x, rwkv_shift(x))
    r = (m["r"] @ p["wr"]).reshape(bsz, s, n_heads, hd)
    k = (m["k"] @ p["wk"]).reshape(bsz, s, n_heads, hd)
    v = (m["v"] @ p["wv"]).reshape(bsz, s, n_heads, hd)
    g = F.silu(m["g"] @ p["wg"])
    logw = -torch.exp((p["w0"] + _lora(m["w"], p["lora_a_w"],
                                       p["lora_b_w"])).float())   # ≤ 0
    logw = logw.reshape(bsz, s, n_heads, hd)
    u = p["u"].reshape(n_heads, hd)

    o, _ = _wkv_chunked(r, k, v, logw, u, None)
    # per-head group norm, then gate
    og = o.float()
    mu = og.mean(-1, keepdim=True)
    var = ((og - mu) ** 2).mean(-1, keepdim=True)
    og = ((og - mu) * torch.rsqrt(var + GN_EPS)).reshape(bsz, s, d)
    og = og.to(x.dtype) * p["gn_gain"] + p["gn_bias"]
    return (og * g) @ p["wo"]


def _wkv_chunked(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                 s0: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Chunked WKV.  r, k, v, logw: (B, S, H, hd) with logw ≤ 0; u: (H, hd);
    state (B, H, hd_k, hd_v).  Returns (o (B, S, H, hd) f32, S_last)."""
    bsz, s, h, hd = r.shape
    c = min(RWKV_CHUNK, s)
    while s % c:          # largest divisor ≤ RWKV_CHUNK; exact at any chunk
        c -= 1
    nc = s // c

    def chunks(t: Tensor) -> Tensor:          # → (nc, B, H, C, hd)
        return t.reshape(bsz, nc, c, h, hd).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(logw)
    S = (torch.zeros(bsz, h, hd, hd, device=r.device) if s0 is None
         else s0.float())
    uf = u.float()
    idx = torch.arange(c, device=r.device)
    strict = (idx[:, None] > idx[None, :])[None, None, :, :, None]  # j < i
    outs = []
    for n in range(nc):
        rb, kb, vb, wb = rc[n], kc[n], vc[n], wc[n]          # (B, H, C, hd)
        cum = torch.cumsum(wb, dim=2)          # inclusive Σ logw
        p_i = cum - wb                         # exclusive (through i-1)
        # contribution of the carried state: (r_i ⊙ e^{p_i}) · S
        o_state = torch.einsum("bhck,bhkv->bhcv", rb * torch.exp(p_i), S)
        # intra-chunk: s_ij = Σ_d r_i k_j e^{p_i - cum_j}   (j < i); the
        # exponent is ≤ 0 on the valid triangle and -inf (exact 0) elsewhere
        dd = p_i[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,H,C,C,hd)
        dd = torch.where(strict, dd, torch.full_like(dd, -torch.inf))
        att = torch.einsum("bhck,bhcjk->bhcj", rb,
                           kb[:, :, None, :, :] * torch.exp(dd))
        # diagonal bonus term
        diag = torch.einsum("bhck,bhck->bhc", rb * uf[None, :, None, :], kb)
        o = o_state + torch.einsum("bhcj,bhjv->bhcv", att, vb) \
            + diag[..., None] * vb
        # state update: S' = e^{cum_C} ⊙_k S + Σ_j (k_j e^{cum_C - cum_j}) ⊗ v_j
        tot = cum[:, :, -1:, :]                # (B, H, 1, hd)
        kd = kb * torch.exp(tot - cum)
        S = torch.exp(tot[:, :, 0, :])[..., None] * S + \
            torch.einsum("bhjk,bhjv->bhkv", kd, vb)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(bsz, s, h, hd)
    return o, S

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

The backbone's blocks (``models.backbone``) add the Griffin block around
the RG-LRU (``w_in``, ``w_gate``, the causal conv ``conv_w``/``conv_b``,
``w_out``), RWKV6's channel mix (``mu_ck``, ``mu_cr``, ``ck``, ``cv``,
``cr``), their decode steps and carried states.  Their sequence forms take
the scan kernels' public entries (``kernel=True``: the hand-written kernel
on a CUDA tensor, its plain version on a CPU tensor) or the plain scans.
The entries are wrapped in ``torch.autograd.Function``s whose backwards
are explicit (:func:`rglru_scan_kernel`, :func:`rwkv6_scan_kernel`): the
RG-LRU's reverse-time recurrence runs on the same entry, RWKV6's is the
chunk-checkpointed walk, the math the dispatch table's backward impls
run (``kernels/*/grad.py``).

On a mesh of ranks (``models.layers``) the blocks run on this rank's
channels: the RG-LRU with ``d_rnn`` sharded on ``model`` (``w_in``,
``w_gate``, ``conv_w``, ``conv_b``, ``lam`` and the gates' output columns
``wa``, ``wx``, whose input is the branch all-gathered), RWKV6 on this
rank's heads (its state ``S`` (B, H, hd, hd) sharded on the heads) when
the axis divides them.  The scan kernels then run on the local channels or
heads; the output products are row-parallel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives as C
from ..kernels.rglru_scan.ref import rglru_scan_ref
from .layers import col_full, col_local, row

Tensor = torch.Tensor
Params = Dict[str, Tensor]

RGLRU_C = 8.0          # Griffin's fixed recurrence sharpness constant
RWKV_CHUNK = 32
GN_EPS = 64e-5         # RWKV6's per-head group-norm epsilon


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def rglru_gates(p: Params, u: Tensor) -> Tuple[Tensor, Tensor]:
    """(log a_t, b_t) from the branch input u: (B, S, dr), in f32.  On a
    mesh ``u`` is this rank's channels and the gates' products, whose
    weights hold this rank's output columns, read it all-gathered."""
    if p["wa"].shape[0] != u.shape[-1]:
        u_in = C.copy_model(C.gather_model(u, -1))
        r = torch.sigmoid((u_in @ p["wa"]).float())
        i = torch.sigmoid((u_in @ p["wx"]).float())
    else:
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


def _causal_conv1d(x: Tensor, w: Tensor, b: Tensor,
                   state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv of width W.  x: (B, S, D); w: (W, D); b: (D,);
    state: (B, W-1, D), the trailing inputs of the previous segment.
    Returns (y, new_state)."""
    bsz, s, d = x.shape
    width = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, width - 1, d), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return y + b, new_state


class _RGLRUScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, h0):
        from ..kernels.rglru_scan.ops import rglru_scan
        h, h_last = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.dtypes = (a.dtype, b.dtype, h0.dtype)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        from ..kernels.rglru_scan.grad import rglru_scan_vjp
        a, h0, h = ctx.saved_tensors
        ct = dh.float().clone()
        ct[:, -1] += dh_last.float()            # h_last is h's last row
        grads = rglru_scan_vjp(a, h0, h, ct)
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes))


def rglru_scan_kernel(a: Tensor, b: Tensor, h0: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """The RG-LRU scan's public entry, (h, h_last) of h_t = a_t·h_{t-1} +
    b_t, differentiable: its backward scans the cotangents in reverse
    time on the same entry."""
    return _RGLRUScan.apply(a, b, h0)


def rglru_step(p: Params, u: Tensor, h: Tensor) -> Tuple[Tensor, Tensor]:
    """One decode step.  u: (B, 1, dr); h: (B, dr)."""
    log_a, b = rglru_gates(p, u)
    a = torch.exp(log_a[:, 0])
    h_new = a * h.float() + b[:, 0]
    return h_new.to(u.dtype)[:, None], h_new.to(u.dtype)


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")       # JAX's default gelu


def _branch(p: Params, x: Tensor, width: Optional[int]):
    """The Griffin block's two input products (this rank's channels on a
    mesh, ``width`` the global d_rnn)."""
    if C.span("model") > 1:
        return col_local(x, p["w_in"], width), \
            col_local(x, p["w_gate"], width)
    return x @ p["w_in"], x @ p["w_gate"]


def _out(y: Tensor, w: Tensor, width: Optional[int]) -> Tensor:
    return row(y, w, width) if C.span("model") > 1 else y @ w


def rglru_block_seq(p: Params, x: Tensor,
                    state: Optional[Dict[str, Tensor]] = None, *,
                    kernel: bool = False, width: Optional[int] = None
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The Griffin recurrent block, sequence form.  x: (B, S, D) → (B, S,
    D), and the carry state {"h", "conv"} for a continuing segment.  The
    recurrence runs in f32 through the RG-LRU scan's entry (``kernel``)
    or its plain version.  ``width``: d_rnn (read on a mesh)."""
    u, g = _branch(p, x, width)
    conv_state = None if state is None else state["conv"]
    u, conv_state = _causal_conv1d(u, p["conv_w"], p["conv_b"], conv_state)
    log_a, b = rglru_gates(p, u)
    a = torch.exp(log_a)
    h0 = (torch.zeros(u.shape[0], u.shape[2], device=u.device)
          if state is None else state["h"].float())
    h, h_last = (rglru_scan_kernel if kernel else rglru_scan_ref)(a, b, h0)
    y = h.to(u.dtype) * _gelu(g)
    return _out(y, p["w_out"], width), {"h": h_last.to(u.dtype),
                                        "conv": conv_state}


def rglru_block_step(p: Params, x: Tensor, state: Dict[str, Tensor], *,
                     width: Optional[int] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step of the Griffin block.  x: (B, 1, D)."""
    u, g = _branch(p, x, width)
    u, conv_state = _causal_conv1d(u, p["conv_w"], p["conv_b"],
                                   state["conv"])
    h, h_last = rglru_step(p, u, state["h"])
    y = h * _gelu(g)
    return _out(y, p["w_out"], width), {"h": h_last, "conv": conv_state}


def rglru_init_state(bsz: int, dr: int, conv_width: int, dtype,
                     device=None) -> Dict[str, Tensor]:
    return {"h": torch.zeros((bsz, dr), dtype=dtype, device=device),
            "conv": torch.zeros((bsz, conv_width - 1, dr), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# RWKV6 time mix
# ---------------------------------------------------------------------------

def _lora(x: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.tanh(x @ a) @ b


def rwkv_shift(x: Tensor, last: Optional[Tensor] = None) -> Tensor:
    """Token shift: the previous token's features (zeros at the start, or
    ``last`` (B, D), carried from the previous segment)."""
    last = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([last, x[:, :-1]], dim=1)


def rwkv_mix_inputs(p: Params, x: Tensor, xs: Tensor) -> Dict[str, Tensor]:
    """Data-dependent lerp (RWKV6): per-target mixes for r, k, v, w, g."""
    dx = xs - x
    xm = x + dx * p["mu_x"]
    outs = {}
    for t in ("r", "k", "v", "w", "g"):
        mix = p[f"mu_{t}"] + _lora(xm, p[f"lora_a_{t}"], p[f"lora_b_{t}"])
        outs[t] = x + dx * mix
    return outs


def rwkv_time_mix_seq(p: Params, x: Tensor, n_heads: int,
                      state: Optional[Dict[str, Tensor]] = None, *,
                      return_state: bool = False, kernel: bool = False):
    """RWKV6 time mix.  x: (B, S, D) → (B, S, D), from ``state``
    ({"last_x", "S"}) or a zero state.  The WKV recurrence takes its
    chunked parallel form, or with ``kernel`` the RWKV6 scan's entry in
    f32.  ``return_state``: also the carry {"last_x", "S"}."""
    bsz, s, d = x.shape
    hd = d // n_heads
    last_x = None if state is None else state["last_x"]
    s0 = None if state is None else state["S"]
    m = rwkv_mix_inputs(p, x, rwkv_shift(x, last_x))
    proj, chan, n_heads = _rwkv_heads(d, n_heads)
    d_loc = n_heads * hd
    r = proj(m["r"], p["wr"]).reshape(bsz, s, n_heads, hd)
    k = proj(m["k"], p["wk"]).reshape(bsz, s, n_heads, hd)
    v = proj(m["v"], p["wv"]).reshape(bsz, s, n_heads, hd)
    g = F.silu(proj(m["g"], p["wg"]))
    logw = chan(-torch.exp((p["w0"] + _lora(m["w"], p["lora_a_w"],
                                            p["lora_b_w"])).float()))  # ≤ 0
    logw = logw.reshape(bsz, s, n_heads, hd)
    u = chan(p["u"]).reshape(n_heads, hd)

    if kernel:
        s0f = (torch.zeros(bsz, n_heads, hd, hd, device=x.device)
               if s0 is None else s0.float())
        o, s_last = rwkv6_scan_kernel(r.float(), k.float(), v.float(), logw,
                                      u.float(), s0f)
    else:
        o, s_last = _wkv_chunked(r, k, v, logw, u, s0)
    # per-head group norm, then gate
    out = (_group_norm(o, bsz, s, d_loc).to(x.dtype) * chan(p["gn_gain"])
           + chan(p["gn_bias"]))
    out = _out(out * g, p["wo"], d)
    if return_state:
        return out, {"last_x": x[:, -1], "S": s_last}
    return out


class _RWKV6Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        from ..kernels.rwkv6_scan.ops import rwkv6_scan
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return rwkv6_scan(r, k, v, logw, u, s0)

    @staticmethod
    def backward(ctx, do, ds_last):
        from ..kernels.rwkv6_scan.grad import rwkv6_scan_vjp
        ins = ctx.saved_tensors
        grads = rwkv6_scan_vjp(*ins, do, ds_last)
        return tuple(g.to(x.dtype) for g, x in zip(grads, ins))


def rwkv6_scan_kernel(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                      u: Tensor, s0: Tensor) -> Tuple[Tensor, Tensor]:
    """The RWKV6 scan's public entry, (o, s_last), differentiable: its
    backward is the chunk-checkpointed walk of the recurrence."""
    return _RWKV6Scan.apply(r, k, v, logw, u, s0)


def _rwkv_heads(d: int, n_heads: int):
    """(product, channel cut, heads here) of the RWKV6 time mix: on a mesh
    whose model axis divides the heads, this rank's heads (the products
    column-parallel, per-channel tensors cut to this rank's block); else
    every head (a column-sharded product's blocks all-gathered)."""
    m = C.span("model")
    if m == 1:
        return (lambda x, w: x @ w), (lambda t: t), n_heads
    if n_heads % m == 0:
        return ((lambda x, w: col_local(x, w, d)),
                (lambda t: C.scatter_model(t, -1)), n_heads // m)
    return (lambda x, w: col_full(x, w, d)), (lambda t: t), n_heads


def _group_norm(o: Tensor, *lead_and_d) -> Tensor:
    """RWKV6's per-head group norm of o (..., H, hd) in f32, reshaped to
    ``lead_and_d``."""
    og = o.float()
    mu = og.mean(-1, keepdim=True)
    var = ((og - mu) ** 2).mean(-1, keepdim=True)
    return ((og - mu) * torch.rsqrt(var + GN_EPS)).reshape(*lead_and_d)


def rwkv_time_mix_step(p: Params, x: Tensor, n_heads: int,
                       state: Dict[str, Tensor]
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step of the RWKV6 time mix.  x: (B, 1, D)."""
    bsz, _, d = x.shape
    hd = d // n_heads
    m = rwkv_mix_inputs(p, x, rwkv_shift(x, state["last_x"]))
    proj, chan, n_heads = _rwkv_heads(d, n_heads)
    d_loc = n_heads * hd
    r = proj(m["r"], p["wr"]).reshape(bsz, n_heads, hd)
    k = proj(m["k"], p["wk"]).reshape(bsz, n_heads, hd)
    v = proj(m["v"], p["wv"]).reshape(bsz, n_heads, hd)
    g = F.silu(proj(m["g"], p["wg"]))[:, 0]
    logw = chan(-torch.exp((p["w0"] + _lora(m["w"], p["lora_a_w"],
                                            p["lora_b_w"])).float()))[:, 0]
    logw = logw.reshape(bsz, n_heads, hd)
    u = chan(p["u"]).reshape(n_heads, hd).float()
    S = state["S"]
    rf, kf, vf = r.float(), k.float(), v.float()
    o = torch.einsum("bhk,bhkv->bhv", rf, S) + \
        torch.einsum("bhk,bhk,bhv->bhv", rf, u[None] * kf, vf)
    S_new = torch.exp(logw)[..., None] * S + \
        torch.einsum("bhk,bhv->bhkv", kf, vf)
    og = (_group_norm(o, bsz, d_loc).to(x.dtype) * chan(p["gn_gain"])
          + chan(p["gn_bias"]))
    out = _out(og * g, p["wo"], d)[:, None]
    return out, {"last_x": x[:, -1], "S": S_new}


def rwkv_channel_mix_seq(p: Params, x: Tensor,
                         last_x: Optional[Tensor] = None, *,
                         width: Optional[int] = None
                         ) -> Tuple[Tensor, Tensor]:
    """RWKV6's channel mix.  x: (B, S, D) → (out, the last token's x).
    ``width``: its hidden width d_ff (read on a mesh)."""
    dx = rwkv_shift(x, last_x) - x
    xk = x + dx * p["mu_ck"]
    xr = x + dx * p["mu_cr"]
    if C.span("model") > 1:
        kk = torch.square(torch.clamp_min(col_local(xk, p["ck"], width),
                                          0.0))
        rr = torch.sigmoid(col_full(xr, p["cr"], x.shape[-1]))
        return rr * row(kk, p["cv"], width), x[:, -1]
    kk = torch.square(torch.clamp_min(xk @ p["ck"], 0.0))
    rr = torch.sigmoid(xr @ p["cr"])
    return rr * (kk @ p["cv"]), x[:, -1]


def rwkv_init_state(bsz: int, d: int, n_heads: int, dtype,
                    device=None) -> Dict[str, Tensor]:
    hd = d // n_heads
    return {"last_x": torch.zeros((bsz, d), dtype=dtype, device=device),
            "S": torch.zeros((bsz, n_heads, hd, hd), dtype=torch.float32,
                             device=device),
            "last_xc": torch.zeros((bsz, d), dtype=dtype, device=device)}


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

"""Model layers of the backbone (counterpart of ``repro.models.layers``).

Pure functions over dicts of tensors named as in the JAX package; the
einsums of the JAX layers are plain products here (``@``,
``torch.einsum``), as they are plain products outside any Pallas kernel
there.  Attention has two routes, chosen before any call by
:func:`attention_route` from the kernels' declared contracts: "kernel"
takes the flash or decode kernel's public entry (the hand-written kernel on
a CUDA tensor, its plain version on a CPU tensor), "plain" the
materialized or chunked attention below, the counterpart of the JAX
package's jnp attention.

The MoE's dispatch gather and combine scatter are
``torch.autograd.Function``s whose backwards are each other's forwards
(JAX's custom VJPs), carrying the same sharding constraints
(``distributed.ctx.constrain``).

Under a mesh of ranks (``distributed.ctx.use_mesh`` with a
``launch.mesh.Mesh``) every function here runs this rank's part of the
program on this rank's parameter blocks (``distributed.sharding.
param_specs``), with the collectives of ``distributed.collectives``:
column-parallel products (:func:`col_local`, :func:`col_full`) and
row-parallel ones ending in one all-reduce over ``model`` (:func:`row`).
Attention runs on this rank's heads when the model axis divides the
query heads, on its KV heads when it divides those too, and otherwise
gathers q, k or v whole first (recurrentgemma's single KV head, whose
``wk``/``wv`` are split inside the head).  With experts that the model
axis divides, the MoE is :func:`_moe_apply_ep`, the counterpart of JAX's
``_moe_apply_shard_map``.  With one process each collective is the
identity and every function is the single-device one.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..distributed import collectives as C
from ..distributed.ctx import constrain
from ..kernels.decode_attention.kernel import HEAD_DIMS as DECODE_HEAD_DIMS
from ..kernels.decode_attention.kernel import MAX_GROUP
from ..kernels.dtypes import FLOAT_DTYPES
from ..kernels.flash_attention.kernel import HEAD_DIMS as FLASH_HEAD_DIMS

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# attention chunk size for the flash-style scan (queries keep full length,
# keys/values stream in chunks; online softmax carries m/l/acc)
ATTN_CHUNK = 2048
# use the chunked path when kv length exceeds this
ATTN_CHUNK_THRESHOLD = 2048


# ---------------------------------------------------------------------------
# norms / elementwise
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, gain: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gain


def layernorm(x: Tensor, gain: Tensor, bias: Tensor,
              eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gain + bias


def apply_norm(kind: str, x: Tensor, p: Params) -> Tensor:
    if kind == "layernorm":
        return layernorm(x, p["gain"], p["bias"])
    return rmsnorm(x, p["gain"])


def softcap(x: Tensor, cap: float) -> Tensor:
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions: (S,) or broadcastable (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions.float()[..., :, None] * freqs            # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# the route: kernel or plain
# ---------------------------------------------------------------------------

def _dtype_name(dtype: Union[str, torch.dtype]) -> str:
    return str(dtype).replace("torch.", "")


def attention_route(cfg, kind: str, mode: str,
                    dtype: Union[str, torch.dtype], *,
                    cache_len: Optional[int] = None) -> str:
    """``"kernel"`` or ``"plain"`` for one attention of the backbone, from
    the kernels' declared contracts alone.

    ``kind``: ``"attn"`` (causal, global), ``"local"`` (causal, within
    ``cfg.window``), ``"enc"`` (the encoder's non-causal self-attention)
    or ``"cross"`` (decoder queries over the encoder's keys).  ``mode``:
    ``"prefill"`` (a forward over whole sequences) or ``"decode"`` (one
    token over a KV cache of ``cache_len`` rows).

    * Both kernels take float32, bfloat16 and float16 and head dims in
      ``HEAD_DIMS`` (16-128); any other config is plain (gemma2-9b's and
      recurrentgemma's hd 256, stablelm-3b's hd 80).
    * Cross attention is plain: the flash kernel attends a sequence to
      itself (keys as long as queries), the decode kernel one query to a
      cache.
    * The flash kernel masks as the JAX attention does: causal, the
      window ``q - k < window``, the softcap on the scaled scores.  The
      encoder runs it with ``causal=False``.
    * The decode kernel attends rows ``[0, lens)`` of the cache and the
      step's own (k, v) at position ``lens``, within ``lens - row <
      window``.  With ``lens = pos`` and the cache as it stood before the
      step's write, that is JAX's ``kv_pos <= pos`` and ``pos - kv_pos <
      window``, exactly.  A ring cache (a local layer whose cache holds
      exactly ``window`` rows, written at ``pos % window``) has no such
      layout once it wraps: the slot the step overwrites would still be
      read.  So a local layer's decode is plain unless its cache is
      shorter than the window (not a ring); ``cache_len`` None counts as
      a ring.  The decode kernel also takes at most ``MAX_GROUP`` query
      heads per KV head.
    """
    if kind not in ("attn", "local", "enc", "cross"):
        raise ValueError(f"attention_route: no attention of kind {kind!r}")
    if mode not in ("prefill", "decode"):
        raise ValueError(f"attention_route: mode {mode!r}")
    if kind == "cross" or _dtype_name(dtype) not in FLOAT_DTYPES:
        return "plain"
    hd = cfg.hd
    if mode == "prefill":
        return "kernel" if hd in FLASH_HEAD_DIMS else "plain"
    if kind == "enc":
        raise ValueError("attention_route: the encoder does not decode")
    if hd not in DECODE_HEAD_DIMS or cfg.n_heads // cfg.n_kv > MAX_GROUP:
        return "plain"
    if kind == "local" and cfg.window and (cache_len is None
                                           or cache_len >= cfg.window):
        return "plain"
    return "kernel"


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _grouped(q: Tensor, kv: int) -> Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd): GQA without materializing the
    KV broadcast."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv, h // kv, hd)


def _direct_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: int, cap: float, q_pos: Tensor,
                      kv_pos: Tensor) -> Tensor:
    """Materialized-logits attention.  q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd).
    The scores are f32; the softmax weights are rounded to q's dtype before
    the product with v, as in JAX."""
    kvh = k.shape[2]
    qg = _grouped(q, kvh)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if cap:
        logits = softcap(logits, cap)
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    b, sq = q.shape[0], q.shape[1]
    return o.reshape(b, sq, -1, q.shape[-1])


def _chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                       window: int, cap: float, q_pos: Tensor,
                       kv_pos: Tensor, chunk: int = ATTN_CHUNK) -> Tensor:
    """Flash-style online-softmax scan over KV chunks at arbitrary
    positions (memory O(Sq·chunk) instead of O(Sq·Skv))."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    skv = k.shape[1]
    nc = (skv + chunk - 1) // chunk
    scale = 1.0 / math.sqrt(hd)
    qg = _grouped(q, kvh).float()
    m = torch.full((b, kvh, g, sq), -math.inf, device=q.device)
    l = torch.zeros((b, kvh, g, sq), device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), device=q.device)
    for j in range(nc):
        kb = k[:, j * chunk:(j + 1) * chunk]
        vb = v[:, j * chunk:(j + 1) * chunk]
        pb = kv_pos[j * chunk:(j + 1) * chunk]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kb.float()) * scale
        if cap:
            logits = softcap(logits, cap)
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= pb[None, :]
        if window:
            mask &= q_pos[:, None] - pb[None, :] < window
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]        # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def multihead_attention(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0,
                        cap: float = 0.0, q_pos: Optional[Tensor] = None,
                        kv_pos: Optional[Tensor] = None,
                        route: str = "plain") -> Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) with KV | H (GQA).  ``route``
    "kernel" (natural positions, Sq == Skv) takes the flash kernel's
    entry; "plain" the materialized attention, or past
    ``ATTN_CHUNK_THRESHOLD`` keys the chunked scan."""
    from .flash import flash_mha
    sq, skv = q.shape[1], k.shape[1]
    natural = q_pos is None and kv_pos is None and sq == skv
    if route == "kernel":
        if not natural:
            raise ValueError("the flash kernel attends a sequence to itself "
                             "at its natural positions")
        return flash_mha(q, k, v, causal, window, cap, kernel=True)
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    if skv > ATTN_CHUNK_THRESHOLD and sq > 1:
        if natural:
            return flash_mha(q, k, v, causal, window, cap, ATTN_CHUNK)
        return _chunked_attention(q, k, v, causal=causal, window=window,
                                  cap=cap, q_pos=q_pos, kv_pos=kv_pos)
    return _direct_attention(q, k, v, causal=causal, window=window, cap=cap,
                             q_pos=q_pos, kv_pos=kv_pos)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     pos: Union[int, Tensor], *, window: int = 0,
                     cap: float = 0.0) -> Tensor:
    """Single-token decode, plain.  q: (B,1,H,hd); caches (B,S,KV,hd)
    holding the step's own row at ``pos``; ``pos``: the current position
    (the index of the token just written)."""
    kvh = k_cache.shape[2]
    qg = _grouped(q, kvh)                                    # (B,1,KV,G,hd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k_cache.float()) * scale
    if cap:
        logits = softcap(logits, cap)
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kv_pos <= pos                                    # (S,)
    if window:
        valid &= (pos - kv_pos) < window
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache)
    return o.reshape(q.shape[0], 1, -1, q.shape[-1])


def decode_attention_kernel(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                            k_new: Tensor, v_new: Tensor, pos: int, *,
                            window: int = 0, cap: float = 0.0) -> Tensor:
    """Single-token decode through the decode kernel's entry: q
    (B,1,H,hd), the caches as they stood before this step's write, the
    step's own k_new, v_new (B,1,KV,hd) at position ``pos``
    (``attention_route`` says where this equals :func:`decode_attention`
    after the write)."""
    from ..kernels.decode_attention.ops import decode_attention as entry
    lens = torch.full((q.shape[0],), int(pos), dtype=torch.int32,
                      device=q.device)
    return entry(q, k_cache, v_cache, k_new, v_new, lens, window=window,
                 cap=cap)


# ---------------------------------------------------------------------------
# attention block (projections + rope + residual), parameterized
# ---------------------------------------------------------------------------

def attn_proj_qkv(p: Params, x: Tensor, cfg, *, pre: str = "",
                  kv_x: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """q (B, S, H, hd) and k, v (B, Skv, KV, hd) from ``x`` (k and v from
    ``kv_x`` when given: cross attention, weights ``pre + "wq"`` ...).
    On a mesh q holds this rank's heads when the model axis divides H (else
    all), and k, v this rank's KV heads when it divides KV (else all: the
    cache's layout); :func:`local_kv` then fits k, v to q's heads."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    bias = cfg.qkv_bias and not pre
    hd, m = cfg.hd, C.span("model")
    if m == 1:
        q = x @ p[pre + "wq"]
        k = kv_x @ p[pre + "wk"]
        v = kv_x @ p[pre + "wv"]
        if bias:
            q = q + p["bq"]
            k = k + p["bk"]
            v = v + p["bv"]
        return (q.reshape(b, s, cfg.n_heads, hd),
                k.reshape(b, kv_x.shape[1], cfg.n_kv, hd),
                v.reshape(b, kv_x.shape[1], cfg.n_kv, hd))

    def proj(src, name, heads):
        w, bv = p[pre + "w" + name], p["b" + name] if bias else None
        if heads % m == 0:            # whole heads here (w column-sharded)
            y = C.copy_model(src) @ w
            y = y if bv is None else y + bv
            n = heads // m
        else:
            y, n = col_full(src, w, heads * hd, bv), heads
        return y.reshape(b, src.shape[1], n, hd)
    return (proj(x, "q", cfg.n_heads), proj(kv_x, "k", cfg.n_kv),
            proj(kv_x, "v", cfg.n_kv))


def local_kv(k: Tensor, v: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """k, v (B, S, KV', hd) as :func:`attn_proj_qkv` or the cache holds
    them, fitted to the query heads this rank holds: as they are with one
    process, when the model axis divides KV (this rank's KV heads) or not
    H (every head here); else the KV heads this rank's query heads read,
    in a group size GQA takes (each head apart where none fits)."""
    h, kv, m = cfg.n_heads, cfg.n_kv, C.span("model")
    if m == 1 or kv % m == 0 or h % m:
        return k, v
    hl, g, c = h // m, h // kv, C.coord("model")
    ids = [(c * hl + i) // g for i in range(hl)]
    lo, n = ids[0], ids[-1] - ids[0] + 1
    k, v = C.copy_model(k), C.copy_model(v)
    if hl % n == 0 and ids == [lo + i // (hl // n) for i in range(hl)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.tensor(ids, device=k.device)
    return k[:, :, idx], v[:, :, idx]


def _reduce_attn(y: Tensor) -> Tensor:
    """The all-reduce after the attention's row-parallel output
    product."""
    return C.reduce_model(y)


def attn_out(p: Params, o: Tensor, cfg=None, *, pre: str = "") -> Tensor:
    """The output product of attention ``o`` (B, S, H', hd); on a mesh
    row-parallel over the heads (``cfg`` gives their global count)."""
    b, s = o.shape[:2]
    w = p[pre + "wo"]
    if C.span("model") == 1:
        y = o.reshape(b, s, -1) @ w
    else:
        y = row(o.reshape(b, s, -1), w, cfg.n_heads * cfg.hd, _reduce_attn)
    if "bo" in p and not pre:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# products on a mesh: column- and row-parallel
# ---------------------------------------------------------------------------

def col_local(x: Tensor, w: Tensor, full: int) -> Tensor:
    """``x`` (replicated over ``model``) times ``w`` of ``full`` output
    features, this rank's block of them when ``w`` is column-sharded."""
    if w.shape[-1] == full:
        return x @ w
    return C.copy_model(x) @ w


def col_full(x: Tensor, w: Tensor, full: int,
             bias: Optional[Tensor] = None) -> Tensor:
    """``x @ w (+ bias)`` whole on every rank: a column-sharded product's
    blocks all-gathered."""
    if w.shape[-1] == full:
        y = x @ w
        return y if bias is None else y + bias
    y = C.copy_model(x) @ w
    return C.gather_model(y if bias is None else y + bias, -1)


def row(h: Tensor, w: Tensor, full: int, reduce=None) -> Tensor:
    """``h @ w`` over a contraction dim of ``full``: when ``w`` holds this
    rank's rows, ``h`` this rank's block of that dim (cut here when whole)
    and the partial sums all-reduced over ``model`` (``reduce``)."""
    if w.shape[0] == full:
        return h @ w
    if h.shape[-1] == full:
        h = C.scatter_model(h, -1)
    return (reduce or C.reduce_model)(h @ w)


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------

def ffn_apply(p: Params, x: Tensor, kind: str,
              width: Optional[int] = None) -> Tensor:
    """The FFN of hidden width ``width`` (its global size: on a mesh the
    hidden dim may be this rank's block)."""
    if C.span("model") > 1:
        if kind == "swiglu":
            h = F.silu(col_local(x, p["wg"], width)) * \
                col_local(x, p["wu"], width)
            return row(h, p["wd"], width)
        h = F.gelu(col_local(x, p["w1"], width) + p["b1"],
                   approximate="tanh")
        return row(h, p["w2"], width) + p["b2"]
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
        return h @ p["wd"]
    # gelu MLP (JAX's default gelu: the tanh form)
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]


def moe_apply(p: Params, x: Tensor, moe_cfg, *,
              plain: bool = False) -> Tuple[Tensor, Tensor]:
    """Top-k MoE: expert-parallel (:func:`_moe_apply_ep`) on a mesh whose
    model axis (above 1) divides the experts, as JAX's ``moe_apply``
    routes to ``_moe_apply_shard_map``; else ``_moe_apply_dense``.
    ``plain`` lets autograd differentiate the dispatch and combine
    instead of their explicit backwards (the comparison route)."""
    m = C.span("model")
    if m > 1 and moe_cfg.n_experts % m == 0:
        return _moe_apply_ep(p, x, moe_cfg)
    return _moe_apply_dense(p, x, moe_cfg, plain=plain)


def _slot_tables(topi: Tensor, topw: Tensor, ng: int, gs: int, k: int,
                 e: int, cap: int) -> Tuple[Tensor, Tensor]:
    """(G, E, cap) token-id and weight tables from top-k routing: each
    expert's tokens in token order, ``gs`` (the pad row) in unused slots,
    a token past an expert's capacity dropped."""
    dev = topi.device
    flat_e = topi.reshape(ng, gs * k)
    flat_w = topw.reshape(ng, gs * k)
    flat_t = torch.arange(gs, device=dev)[:, None].expand(gs, k).reshape(-1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    sorted_t = flat_t[order]
    sorted_w = torch.gather(flat_w, -1, order)
    seg_start = torch.cat([
        torch.zeros((ng, 1), dtype=torch.bool, device=dev),
        sorted_e[:, 1:] != sorted_e[:, :-1]], dim=-1)
    pos_all = torch.arange(gs * k, device=dev)[None, :].expand_as(sorted_e)
    run_first = torch.where(seg_start, pos_all, torch.zeros_like(pos_all))
    run_first = torch.cummax(run_first, dim=-1).values
    slot = pos_all - run_first
    keep = slot < cap
    gidx = torch.arange(ng, device=dev)[:, None].expand_as(sorted_e)
    slot_tok = torch.full((ng, e, cap), gs, dtype=torch.int64, device=dev)
    slot_w = torch.zeros((ng, e, cap), dtype=torch.float32, device=dev)
    idx = (gidx[keep], sorted_e[keep], slot[keep])
    slot_tok[idx] = sorted_t[keep]
    slot_w[idx] = sorted_w[keep].float()
    return slot_tok, slot_w


def moe_routing(p: Params, x: Tensor, moe_cfg) -> Tuple[Tensor, Tensor,
                                                        Tensor]:
    """The router: (gates (G, gs, E) f32, top-k weights renormalized,
    top-k expert ids), tokens cut into groups of ``group_size``."""
    b, s, d = x.shape
    t = b * s
    gs = min(moe_cfg.group_size, t)
    xg = x.reshape(t // gs, gs, d)
    gates = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    topw, topi = torch.topk(gates, moe_cfg.top_k, dim=-1)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return gates, topw, topi


def _moe_apply_dense(p: Params, x: Tensor, moe_cfg, *,
                     plain: bool = False) -> Tuple[Tensor, Tensor]:
    """Gather-based top-k MoE with per-group capacity: the chosen tokens
    are gathered into (G, E, cap, D), run through each expert's SwiGLU and
    scatter-added back, weighted; with ``plain`` the gather and the
    scatter-add are the direct indexing that autograd differentiates."""
    b, s, d = x.shape
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    gs = min(moe_cfg.group_size, b * s)
    ng = (b * s) // gs
    xg = x.reshape(ng, gs, d)
    gates, topw, topi = moe_routing(p, x, moe_cfg)

    # load-balancing auxiliary loss (Switch-style); on a data-sharded
    # mesh over the whole batch, as GSPMD computes it
    me, ce = _balance(gates, topi, e, ng * gs * k)
    aux = e * torch.sum(C.mean_data(me) * C.mean_data(ce))

    cap = _capacity(gs, k, e, moe_cfg.capacity_factor)
    slot_tok, slot_w = _slot_tables(topi, topw, ng, gs, k, e, cap)

    xg_pad = torch.cat([xg, torch.zeros((ng, 1, d), dtype=xg.dtype,
                                        device=x.device)], dim=1)
    xin = (_gather(xg_pad, slot_tok) if plain
           else moe_gather(xg_pad, slot_tok))               # (G,E,cap,D)
    g = torch.einsum("gecd,edf->gecf", xin, p["wg"])
    u = torch.einsum("gecd,edf->gecf", xin, p["wu"])
    y = torch.einsum("gecf,efd->gecd", F.silu(g) * u, p["wd"])
    yw = y * slot_w[..., None].to(y.dtype)
    out = (_scatter_add(yw, slot_tok, gs + 1) if plain
           else moe_scatter(yw, slot_tok, gs))
    return out[:, :gs].reshape(b, s, d), aux


def _balance(gates: Tensor, topi: Tensor, e: int,
             n: int) -> Tuple[Tensor, Tensor]:
    """The balance loss's factors: the mean gate and the routed share of
    each expert."""
    me = gates.mean(dim=(0, 1))
    ce = torch.zeros((e,), dtype=torch.float32,
                     device=gates.device).index_add_(
        0, topi.reshape(-1),
        torch.full((topi.numel(),), 1.0 / n, device=gates.device))
    return me, ce


def _capacity(gs: int, k: int, e: int, factor: float) -> int:
    cap = int(math.ceil(gs * k / e * factor))
    return max(8, ((cap + 7) // 8) * 8)


def _moe_combine(out: Tensor) -> Tensor:
    """The expert-parallel combine: the ranks' partial scatters summed
    over ``model``."""
    return C.reduce_model(out)


def _moe_apply_ep(p: Params, x: Tensor, moe_cfg) -> Tuple[Tensor, Tensor]:
    """Expert parallelism as JAX's ``_moe_apply_shard_map`` writes it, on
    this rank's experts ``p["wg"]`` ... (E / model of them): the router
    and the slot tables over this rank's data shard (replicated over
    ``model``), this rank's expert block ``e0 = coord(model)·E_loc`` of
    the tables, the gather, experts and scatter on the local block, ONE
    all-reduce over ``model`` for the combine, and the balance loss of
    each data shard averaged over ``data``.  The dispatch and combine on
    the local block are the direct indexing on both routes: no collective
    sits inside them, so autograd's backward is theirs."""
    b, s, d = x.shape
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    e_loc = p["wg"].shape[0]
    gs = min(moe_cfg.group_size, b * s)
    ng = (b * s) // gs
    xg = x.reshape(ng, gs, d)
    gates, topw, topi = moe_routing(p, x, moe_cfg)
    me, ce = _balance(gates, topi, e, ng * gs * k)
    aux = C.mean_data(e * torch.sum(me * ce))

    cap = _capacity(gs, k, e, moe_cfg.capacity_factor)
    slot_tok, slot_w = _slot_tables(topi, topw, ng, gs, k, e, cap)
    e0 = C.coord("model") * e_loc
    st = slot_tok[:, e0:e0 + e_loc].contiguous()
    sw = C.scatter_model(slot_w, 1)
    xg_pad = C.copy_model(torch.cat(
        [xg, torch.zeros((ng, 1, d), dtype=xg.dtype, device=x.device)], 1))
    xin = _gather(xg_pad, st)
    g = torch.einsum("gecd,edf->gecf", xin, p["wg"])
    u = torch.einsum("gecd,edf->gecf", xin, p["wu"])
    y = torch.einsum("gecf,efd->gecd", F.silu(g) * u, p["wd"])
    yw = y.to(x.dtype) * sw[..., None].to(x.dtype)
    out = _scatter_add(yw, st, gs + 1)
    out = _moe_combine(out)
    return out[:, :gs].reshape(b, s, d), aux


# dispatch and combine with explicit backwards: the gather's is the
# scatter-add and the scatter's the gather, each under the token-local
# constraints of its direction

def _slot_index(slot_tok: Tensor) -> Tuple[Tensor, Tensor]:
    gidx = torch.arange(slot_tok.shape[0], device=slot_tok.device)
    return gidx[:, None, None].expand_as(slot_tok), slot_tok


def _scatter_add(vals: Tensor, slot_tok: Tensor, rows: int) -> Tensor:
    """(G, E, cap, D) values added into (G, rows, D) at their slots' token
    rows."""
    ng, _, _, d = vals.shape
    out = constrain(torch.zeros((ng, rows, d), dtype=vals.dtype,
                                device=vals.device), ("dp", None, None))
    out.index_put_(_slot_index(slot_tok), vals, accumulate=True)
    return constrain(out, ("dp", None, None))


def _gather(x: Tensor, slot_tok: Tensor) -> Tensor:
    """(G, rows, D) read at every slot's token row: (G, E, cap, D)."""
    return constrain(x[_slot_index(slot_tok)], ("dp", "model", None, None))


class _MoEGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xg_pad, slot_tok):
        ctx.save_for_backward(slot_tok)
        ctx.rows = xg_pad.shape[1]
        return _gather(xg_pad, slot_tok)

    @staticmethod
    def backward(ctx, ct):
        (slot_tok,) = ctx.saved_tensors
        ct = constrain(ct, ("dp", "model", None, None))
        return _scatter_add(ct, slot_tok, ctx.rows), None


class _MoEScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, yw, slot_tok, gs):
        ctx.save_for_backward(slot_tok)
        return _scatter_add(yw, slot_tok, gs + 1)

    @staticmethod
    def backward(ctx, ct):
        (slot_tok,) = ctx.saved_tensors
        ct = constrain(ct, ("dp", None, None))
        return _gather(ct, slot_tok), None, None


def moe_gather(xg_pad: Tensor, slot_tok: Tensor) -> Tensor:
    """The dispatch: xg_pad (G, gs + 1, D), its last row zeros, read at
    each slot's token id (G, E, cap) → (G, E, cap, D)."""
    return _MoEGather.apply(xg_pad, slot_tok)


def moe_scatter(yw: Tensor, slot_tok: Tensor, gs: int) -> Tensor:
    """The combine: yw (G, E, cap, D) added at each slot's token row of a
    zero (G, gs + 1, D); the pad row gs collects the unused slots."""
    return _MoEScatter.apply(yw, slot_tok, gs)

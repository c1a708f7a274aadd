"""The unified LM backbone covering the 10 assigned architectures
(counterpart of ``repro.models.backbone``).

Layers repeat in ``cfg.layer_pattern`` (period p).  The parameter and cache
trees keep the JAX package's nesting: ``head`` (leading layers whose
parameters differ from the body: Kimi K2's dense layer 0), ``macro``
(``pos{i}`` of the pattern, every leaf stacked over the macro blocks) and
``tail`` (the trailing partial period), each layer ``layer{i}``.  Where JAX
scans over the stacked leading dim, the port loops over it in Python.

Pure functions over dicts of tensors.  Attention takes the flash and decode
kernels' entries where ``layers.attention_route`` says "kernel", and the
RG-LRU and RWKV6 blocks the scan kernels' entries, each differentiable
through an explicit backward, as are the MoE's dispatch and combine;
``plain=True`` forces every one of them onto plain torch that autograd
differentiates (the comparison route).  :func:`loss_fn` trains on both
routes (``distributed.steps.
make_train_step``).  With ``remat`` each macro block runs under
``torch.utils.checkpoint``: its activations are recomputed in the
backward, where JAX's scan body saves its products' outputs
(``dots_with_no_batch_dims_saveable``); the values are the same, the
memory is not.

Under a mesh of ranks (``distributed.ctx.use_mesh`` with a
``launch.mesh.Mesh``, as ``distributed.steps`` enters it) every function
runs this rank's part of the program on its blocks of the parameter
tree and its rows of the batch (``models.layers``): the embedding is
vocab-sharded (masked rows, one all-reduce), the logits are all-gathered
over the vocab, and a decode cache follows ``sharding.cache_specs``: KV
heads on ``model`` where the axis divides them, else the sequence, whose
blocks a decode step all-gathers (``specs``: the cache's spec tree).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import collectives as C
from ..distributed import ctx as DC
from ..frontends.offload import DeviceLike, resolve_device
from . import layers as L
from . import recurrent as R
from .config import ArchConfig

Tensor = torch.Tensor
CONV_WIDTH = 4     # RG-LRU depthwise conv width
LORA_R = 32        # RWKV6 data-dependent-lerp LoRA rank


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over every leaf of a tree of dicts, tuples and lists, and
    the entries at the same place in each tree of ``rest`` (whatever they
    hold there is passed whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists; a path
    holds the dict keys and sequence indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_leaves(tree, prefix: Tuple = (), *,
                leaf: Optional[type] = None) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in key order, a path the keys and indices down to
    the leaf; an instance of ``leaf`` (a tuple type: a spec) is a leaf."""
    if leaf is not None and isinstance(tree, leaf):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                tree_leaves(tree[k], prefix + (k,), leaf=leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in
                tree_leaves(v, prefix + (i,), leaf=leaf)]
    return [(prefix, tree)]


def _stack(trees: List[Any]):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Init:
    """Where and how parameters are drawn: N(0, scale²) in f32 from
    ``gen`` on ``device`` (JAX's scales, not its values), each shape led
    by ``lead`` (the macro stack); on the meta device nothing is drawn."""
    gen: Optional[torch.Generator]
    device: torch.device
    lead: Tuple[int, ...] = ()

    def dense(self, shape, dtype, scale: Optional[float] = None) -> Tensor:
        scale = scale or 1.0 / math.sqrt(shape[0])
        full = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(full, dtype=dtype, device="meta")
        x = torch.randn(full, generator=self.gen, device=self.device)
        return (x * scale).to(dtype)

    def uniform(self, shape, lo: float, hi: float) -> Tensor:
        full = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(full, device="meta")
        return torch.rand(full, generator=self.gen,
                          device=self.device) * (hi - lo) + lo

    def full(self, shape, value: float, dtype) -> Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype,
                          device=self.device)


def _dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _norm_params(cfg: ArchConfig, d: int, ini: _Init) -> Dict[str, Tensor]:
    dt = _dt(cfg)
    if cfg.norm == "layernorm":
        return {"gain": ini.full((d,), 1.0, dt), "bias": ini.full((d,), 0.0, dt)}
    return {"gain": ini.full((d,), 1.0, dt)}


def _attn_params(cfg: ArchConfig, ini: _Init,
                 cross: bool = False) -> Dict[str, Tensor]:
    dt = _dt(cfg)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    pre = "x" if cross else ""
    p = {pre + "wq": ini.dense((D, H * hd), dt),
         pre + "wk": ini.dense((D, KV * hd), dt),
         pre + "wv": ini.dense((D, KV * hd), dt),
         pre + "wo": ini.dense((H * hd, D), dt)}
    if cfg.qkv_bias and not cross:
        p["bq"] = ini.full((H * hd,), 0.0, dt)
        p["bk"] = ini.full((KV * hd,), 0.0, dt)
        p["bv"] = ini.full((KV * hd,), 0.0, dt)
    if cfg.attn_out_bias and not cross:
        p["bo"] = ini.full((D,), 0.0, dt)
    return p


def _ffn_params(cfg: ArchConfig, ini: _Init, d_ff: int) -> Dict[str, Tensor]:
    dt = _dt(cfg)
    D = cfg.d_model
    if cfg.ffn == "swiglu":
        return {"wg": ini.dense((D, d_ff), dt), "wu": ini.dense((D, d_ff), dt),
                "wd": ini.dense((d_ff, D), dt)}
    return {"w1": ini.dense((D, d_ff), dt), "b1": ini.full((d_ff,), 0.0, dt),
            "w2": ini.dense((d_ff, D), dt), "b2": ini.full((D,), 0.0, dt)}


def _moe_params(cfg: ArchConfig, ini: _Init) -> Dict[str, Tensor]:
    dt = _dt(cfg)
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    return {"router": ini.dense((D, E), torch.float32),
            "wg": ini.dense((E, D, F), dt),
            "wu": ini.dense((E, D, F), dt),
            "wd": ini.dense((E, F, D), dt)}


def _rglru_params(cfg: ArchConfig, ini: _Init) -> Dict[str, Tensor]:
    dt = _dt(cfg)
    D, dr = cfg.d_model, cfg.drnn
    return {"w_in": ini.dense((D, dr), dt),
            "w_gate": ini.dense((D, dr), dt),
            "w_out": ini.dense((dr, D), dt),
            "conv_w": ini.dense((CONV_WIDTH, dr), dt, scale=0.3),
            "conv_b": ini.full((dr,), 0.0, dt),
            "wa": ini.dense((dr, dr), dt),
            "wx": ini.dense((dr, dr), dt),
            "lam": ini.uniform((dr,), 0.5, 4.0)}


def _rwkv_params(cfg: ArchConfig, ini: _Init) -> Dict[str, Tensor]:
    dt = _dt(cfg)
    D = cfg.d_model
    p: Dict[str, Tensor] = {"mu_x": ini.full((D,), 0.5, dt)}
    for t in ("r", "k", "v", "w", "g"):
        p[f"mu_{t}"] = ini.full((D,), 0.5, dt)
        p[f"lora_a_{t}"] = ini.dense((D, LORA_R), dt)
        p[f"lora_b_{t}"] = ini.dense((LORA_R, D), dt, scale=0.01)
    for t in ("r", "k", "v", "g", "o"):
        p[f"w{t}"] = ini.dense((D, D), dt)
    p["w0"] = ini.full((D,), -1.0, dt)       # resting decay ≈ exp(-e^{-1})
    p["u"] = ini.dense((D,), torch.float32, scale=0.3)
    p["gn_gain"] = ini.full((D,), 1.0, dt)
    p["gn_bias"] = ini.full((D,), 0.0, dt)
    # channel mix
    p["mu_ck"] = ini.full((D,), 0.5, dt)
    p["mu_cr"] = ini.full((D,), 0.5, dt)
    p["ck"] = ini.dense((D, cfg.d_ff), dt)
    p["cv"] = ini.dense((cfg.d_ff, D), dt)
    p["cr"] = ini.dense((D, D), dt)
    return p


def _block_params(cfg: ArchConfig, kind: str, layer_idx: int, ini: _Init,
                  decoder: bool = True) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": _norm_params(cfg, cfg.d_model, ini)}
    if kind == "rwkv":
        p.update(_rwkv_params(cfg, ini))
        p["ln2"] = _norm_params(cfg, cfg.d_model, ini)
        return p
    if kind == "rglru":
        p.update(_rglru_params(cfg, ini))
    else:
        p.update(_attn_params(cfg, ini))
    if cfg.enc_dec is not None and decoder and kind in ("attn", "local"):
        p["lnx"] = _norm_params(cfg, cfg.d_model, ini)
        p.update(_attn_params(cfg, ini, cross=True))
    if not cfg.parallel_block:
        p["ln2"] = _norm_params(cfg, cfg.d_model, ini)
    if cfg.post_norms:
        p["ln1p"] = _norm_params(cfg, cfg.d_model, ini)
        p["ln2p"] = _norm_params(cfg, cfg.d_model, ini)
    if cfg.moe is not None and layer_idx >= cfg.moe.n_dense_layers:
        p["moe"] = _moe_params(cfg, ini)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and layer_idx < cfg.moe.n_dense_layers:
            d_ff = cfg.moe.d_ff_dense or cfg.d_ff
        p["ffn"] = _ffn_params(cfg, ini, d_ff)
    return p


def layer_kinds(cfg: ArchConfig) -> List[str]:
    p = len(cfg.layer_pattern)
    return [cfg.layer_pattern[i % p] for i in range(cfg.n_layers)]


def macro_split(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_head, n_macro, n_tail): leading layers whose parameters differ
    from the body (MoE models' leading dense layers), repetitions of the
    full pattern, and the trailing partial period."""
    n_head = cfg.moe.n_dense_layers if cfg.moe is not None else 0
    p = len(cfg.layer_pattern)
    rem = cfg.n_layers - n_head
    return n_head, rem // p, rem % p


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator],
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters in the JAX tree's nesting and shapes, drawn from
    ``generator`` on ``device`` (the card unless asked otherwise; the meta
    device draws nothing) with JAX's scales, in ``cfg.dtype``."""
    dev = resolve_device(device)
    ini = _Init(generator, dev)
    dt = _dt(cfg)
    V, D = cfg.vocab_padded, cfg.d_model
    params: Dict[str, Any] = {"embed": ini.dense((V, D), dt, scale=0.02),
                              "ln_f": _norm_params(cfg, D, ini)}
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.dense((D, V), dt)
    n_head, n_macro, n_tail = macro_split(cfg)
    period = cfg.layer_pattern
    kinds = layer_kinds(cfg)
    params["head"] = {f"layer{i}": _block_params(cfg, kinds[i], i, ini)
                      for i in range(n_head)}
    if n_macro:
        stacked = _Init(generator, dev, (n_macro,))
        params["macro"] = {f"pos{i}": _block_params(cfg, kind, n_head + i,
                                                     stacked)
                           for i, kind in enumerate(period)}
    params["tail"] = {
        f"layer{i}": _block_params(
            cfg, period[i], n_head + n_macro * len(period) + i, ini)
        for i in range(n_tail)}
    if cfg.enc_dec is not None:
        enc_cfg = dataclasses.replace(cfg, moe=None, parallel_block=False)
        params["encoder"] = {
            f"layer{i}": _block_params(enc_cfg, "attn", i, ini,
                                       decoder=False)
            for i in range(cfg.enc_dec.n_enc_layers)}
        params["enc_ln_f"] = _norm_params(cfg, D, ini)
        params["enc_pos"] = ini.dense((cfg.enc_dec.enc_seq, D), dt,
                                      scale=0.02)
    return params


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree on the meta device: shapes and dtypes, nothing
    allocated (JAX's ``ShapeDtypeStruct`` tree)."""
    return init_params(cfg, None, "meta")


param_shapes = param_specs


def count_params(cfg: ArchConfig) -> int:
    return sum(leaf.numel() for _, leaf in tree_leaves(param_shapes(cfg)))


def count_active_params(cfg: ArchConfig) -> int:
    """Per-token active params: MoE counts top_k of n_experts expert
    params."""
    leaves = tree_leaves(param_shapes(cfg))
    total = sum(leaf.numel() for _, leaf in leaves)
    if cfg.moe is None:
        return total
    expert = sum(leaf.numel() for path, leaf in leaves
                 if "moe" in path and path[-1] != "router")
    return total - expert + int(expert * cfg.moe.top_k / cfg.moe.n_experts)


# ---------------------------------------------------------------------------
# block application (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------

def _maybe_post(cfg, p, key, y):
    return L.apply_norm(cfg.norm, y, p[key]) if cfg.post_norms else y


def _route(cfg: ArchConfig, kind: str, mode: str, dtype, plain: bool,
           cache_len: Optional[int] = None) -> str:
    if plain:
        return "plain"
    return L.attention_route(cfg, kind, mode, dtype, cache_len=cache_len)


def _seq_sharded(cfg: ArchConfig, spec) -> bool:
    """Whether a KV cache holds this rank's rows of every KV head (its
    spec, JAX's ``cache_specs``, shards the sequence on ``model``): only
    on a mesh whose model axis does not divide the KV heads."""
    m = C.span("model")
    if m == 1 or cfg.n_kv % m == 0:
        return False
    if spec is None:
        raise ValueError(
            f"{cfg.name}: a decode cache on a model axis of {m} that does "
            f"not divide {cfg.n_kv} KV heads needs its specs "
            f"(sharding.cache_specs) to read its layout")
    return spec[0][1] == "model"


def _attn_sublayer(cfg: ArchConfig, p, h, kind: str, positions,
                   kv_cache=None, decode_pos: Optional[int] = None,
                   plain: bool = False, spec=None):
    """Returns (out, new_kv): new_kv is the updated cache in decode, the
    prompt's (k, v) when ``kv_cache`` is "collect", else None.  On a mesh
    the cache is this rank's block (``spec``: its specs); a
    sequence-sharded one is all-gathered for the step and cut back."""
    window = cfg.window if kind == "local" else 0
    q, k, v = L.attn_proj_qkv(p, h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    new_kv = None
    if kv_cache is not None and decode_pos is not None \
            and not isinstance(kv_cache, str):
        kc, vc = kv_cache
        seq = _seq_sharded(cfg, spec)
        if seq:
            kc, vc = C.gather_model(kc, 1), C.gather_model(vc, 1)
        cache_len = kc.shape[1]
        ring = bool(window) and cache_len == window
        write_pos = decode_pos % window if ring else decode_pos
        route = _route(cfg, kind, "decode", q.dtype, plain, cache_len)
        if route == "kernel":
            # the kernel reads the cache before this step's write
            o = L.decode_attention_kernel(q, *L.local_kv(kc, vc, cfg),
                                          *L.local_kv(k, v, cfg),
                                          decode_pos, window=window,
                                          cap=cfg.softcap_attn)
        kc, vc = kc.clone(), vc.clone()
        kc[:, write_pos] = k[:, 0]
        vc[:, write_pos] = v[:, 0]
        if route == "plain":
            # ring caches hold exactly the last `window` tokens → no
            # distance mask; slots past decode_pos stay masked while the
            # ring fills
            o = L.decode_attention(q, *L.local_kv(kc, vc, cfg), decode_pos,
                                   window=0 if ring else window,
                                   cap=cfg.softcap_attn)
        if seq:
            kc, vc = C.scatter_model(kc, 1), C.scatter_model(vc, 1)
        new_kv = (kc, vc)
    else:
        o = L.multihead_attention(
            q, *L.local_kv(k, v, cfg), causal=True, window=window,
            cap=cfg.softcap_attn,
            route=_route(cfg, kind, "prefill", q.dtype, plain))
        if kv_cache == "collect":
            new_kv = (k, v)
    return L.attn_out(p, o, cfg), new_kv


def _cross_sublayer(cfg: ArchConfig, p, h, enc_out):
    q, ek, ev = L.attn_proj_qkv(p, h, cfg, pre="x", kv_x=enc_out)
    o = L.multihead_attention(q, *L.local_kv(ek, ev, cfg), causal=False)
    return L.attn_out(p, o, cfg, pre="x")


def _ffn_width(cfg: ArchConfig, layer_is_moe: bool) -> int:
    """The global hidden width of a layer's FFN: a MoE config's dense
    layers take ``d_ff_dense``."""
    if cfg.moe is not None and not layer_is_moe:
        return cfg.moe.d_ff_dense or cfg.d_ff
    return cfg.d_ff


def _ffn_sublayer(cfg: ArchConfig, p, h, layer_is_moe: bool,
                  plain: bool = False):
    if layer_is_moe:
        return L.moe_apply(p["moe"], h, cfg.moe, plain=plain)
    return L.ffn_apply(p["ffn"], h, cfg.ffn,
                       _ffn_width(cfg, layer_is_moe)), 0.0


def apply_block(cfg: ArchConfig, kind: str, p, h, positions, *,
                is_moe: bool, state=None, decode_pos: Optional[int] = None,
                enc_kv=None, mode: str = "train", plain: bool = False,
                spec=None):
    """One full block.  ``mode``: "train" (a forward), "prefill_cached" (a
    forward that also returns the layer's state: the prompt's (k, v), or
    the recurrent carry from ``state``) or "decode" (one token from
    ``state``; ``spec``: its specs, read on a mesh).  Returns (h,
    aux_loss, new_state)."""
    new_state: Any = None
    if kind == "rwkv":
        hn = L.apply_norm(cfg.norm, h, p["ln1"])
        n_heads = cfg.d_model // cfg.rwkv_head_dim
        if mode == "decode":
            o, st = R.rwkv_time_mix_step(p, hn, n_heads, state)
        else:
            o, st = R.rwkv_time_mix_seq(
                p, hn, n_heads, state if mode == "prefill_cached" else None,
                return_state=True, kernel=not plain)
        h = h + o
        hn = L.apply_norm(cfg.norm, h, p["ln2"])
        lastc = state["last_xc"] if (state is not None and mode == "decode") \
            else None
        o, last_xc = R.rwkv_channel_mix_seq(p, hn, lastc, width=cfg.d_ff)
        h = h + o
        if mode in ("decode", "prefill_cached"):
            new_state = {**st, "last_xc": last_xc}
        return h, 0.0, new_state

    hn = L.apply_norm(cfg.norm, h, p["ln1"])
    if kind == "rglru":
        if mode == "decode":
            o, new_state = R.rglru_block_step(p, hn, state, width=cfg.drnn)
        else:
            o, new_state = R.rglru_block_seq(
                p, hn, state if mode == "prefill_cached" else None,
                kernel=not plain, width=cfg.drnn)
            if mode != "prefill_cached":
                new_state = None
        attn_out = _maybe_post(cfg, p, "ln1p", o)
    else:
        kv_cache = None
        if mode == "decode":
            kv_cache = state
        elif mode == "prefill_cached":
            kv_cache = "collect"
        o, new_state = _attn_sublayer(cfg, p, hn, kind, positions,
                                      kv_cache=kv_cache,
                                      decode_pos=decode_pos, plain=plain,
                                      spec=spec)
        attn_out = _maybe_post(cfg, p, "ln1p", o)

    if cfg.parallel_block:
        f, aux = _ffn_sublayer(cfg, p, hn, is_moe, plain)
        return h + attn_out + f, aux, new_state

    h = h + attn_out
    if enc_kv is not None and "xwq" in p:
        hx = L.apply_norm(cfg.norm, h, p["lnx"])
        h = h + _cross_sublayer(cfg, p, hx, enc_kv)
    hn2 = L.apply_norm(cfg.norm, h, p["ln2"])
    f, aux = _ffn_sublayer(cfg, p, hn2, is_moe, plain)
    h = h + _maybe_post(cfg, p, "ln2p", f)
    return h, aux, new_state


# ---------------------------------------------------------------------------
# embedding / head / encoder / frontends
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params, tokens: Tensor) -> Tensor:
    """Token embeddings; with this rank's rows of a vocab-sharded table,
    the rows it holds (others zero) summed over ``model``."""
    emb = params["embed"]
    v_loc = emb.shape[0]
    if v_loc == cfg.vocab_padded:
        h = emb[tokens] * math.sqrt(cfg.d_model)
    else:
        idx = tokens - C.coord("model") * v_loc
        hit = ((idx >= 0) & (idx < v_loc)).to(emb.dtype)
        rows = emb[idx.clamp(0, v_loc - 1)] * hit[..., None]
        h = C.reduce_model(rows) * math.sqrt(cfg.d_model)
    return h.to(_dt(cfg))


def lm_logits(cfg: ArchConfig, params, h: Tensor) -> Tensor:
    """f32 logits over the whole vocab (a vocab-sharded head's blocks
    all-gathered)."""
    h = L.apply_norm(cfg.norm, h, params["ln_f"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.col_full(h, w, cfg.vocab_padded).float()
    if cfg.softcap_final:
        logits = L.softcap(logits, cfg.softcap_final)
    return logits


def _is_moe_layer(cfg: ArchConfig, layer_idx: int, kind: str) -> bool:
    return (cfg.moe is not None and layer_idx >= cfg.moe.n_dense_layers
            and kind not in ("rglru", "rwkv"))


def run_encoder(cfg: ArchConfig, params, frames: Tensor, *,
                plain: bool = False) -> Tensor:
    """The audio encoder over precomputed frame embeddings (the conv
    frontend is a stub: the inputs supply the embeddings)."""
    h = frames.to(_dt(cfg)) + params["enc_pos"]
    positions = torch.arange(h.shape[1], device=h.device)
    route = _route(cfg, "enc", "prefill", h.dtype, plain)
    for i in range(cfg.enc_dec.n_enc_layers):
        p = params["encoder"][f"layer{i}"]
        hn = L.apply_norm(cfg.norm, h, p["ln1"])
        q, k, v = L.attn_proj_qkv(p, hn, cfg)
        k, v = L.local_kv(k, v, cfg)
        if route == "kernel":
            o = L.multihead_attention(q, k, v, causal=False, route=route)
        else:
            o = L.multihead_attention(q, k, v, causal=False, q_pos=positions,
                                      kv_pos=positions)
        h = h + L.attn_out(p, o, cfg)
        hn = L.apply_norm(cfg.norm, h, p["ln2"])
        f, _ = _ffn_sublayer(cfg, p, hn, False)
        h = h + f
    return L.apply_norm(cfg.norm, h, params["enc_ln_f"])


# ---------------------------------------------------------------------------
# full-model paths: forward / prefill / decode
# ---------------------------------------------------------------------------

def _stack_inputs(cfg: ArchConfig, params, batch: Dict[str, Tensor],
                  plain: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """Token embedding + modality stubs.  Returns (h, enc_out)."""
    h = embed_tokens(cfg, params, batch["tokens"])
    enc_out = None
    if cfg.frontend == "vision" and "patches" in batch:
        patches = batch["patches"].to(h.dtype)       # (B, n_patches, D)
        h = torch.cat([patches, h], dim=1)
    if cfg.frontend == "audio" and "frames" in batch:
        enc_out = run_encoder(cfg, params, batch["frames"], plain=plain)
    return h, enc_out


def _index(tree, m: int):
    return tree_map(lambda x: x[m], tree)


def _unstack_specs(specs):
    """A macro spec tree without its stack dim (the lead entry)."""
    from ..distributed.sharding import P
    if specs is None:
        return None
    if isinstance(specs, P):
        return P(*specs[1:])
    if isinstance(specs, dict):
        return {k: _unstack_specs(v) for k, v in specs.items()}
    return type(specs)(_unstack_specs(v) for v in specs)


def _macro_block(cfg: ArchConfig, period, h: Tensor, aux: Tensor, p_m,
                 positions: Tensor, enc_out: Optional[Tensor], first: int,
                 plain: bool, mesh=None) -> Tuple[Tensor, Tensor]:
    """One macro block of a training forward: every position of the
    pattern in turn, on ``mesh`` (a recompute under remat runs on
    autograd's thread, which has no active mesh of its own).  Returns
    (h, aux)."""
    with DC.use_mesh(mesh):
        for i, kind in enumerate(period):
            h, a, _ = apply_block(cfg, kind, p_m[f"pos{i}"], h, positions,
                                  is_moe=_is_moe_layer(cfg, first + i, kind),
                                  enc_kv=enc_out, plain=plain)
            aux = aux + a
    return h, aux


def _run_layers(cfg: ArchConfig, params, h: Tensor, positions: Tensor,
                enc_out: Optional[Tensor], *, mode: str = "train",
                cache=None, decode_pos: Optional[int] = None,
                plain: bool = False, remat: bool = False, specs=None):
    """Every layer in order: head, the macro blocks (each pattern position
    in turn), tail.  Returns (h, aux_loss, new_cache); new_cache holds the
    layers' states (None outside "prefill_cached" and "decode").  With
    ``remat`` (mode "train") each macro block is recomputed in the
    backward.  ``specs``: the cache's spec tree (on a mesh)."""
    n_head, n_macro, n_tail = macro_split(cfg)
    period = cfg.layer_pattern
    kinds = layer_kinds(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    new_cache: Dict[str, Any] = {"head": {}, "tail": {}}

    def block(kind, p, st, idx, spec=None):
        nonlocal h, aux_total
        h, aux, new = apply_block(
            cfg, kind, p, h, positions, is_moe=_is_moe_layer(cfg, idx, kind),
            state=st, decode_pos=decode_pos, enc_kv=enc_out, mode=mode,
            plain=plain, spec=spec)
        aux_total = aux_total + aux
        return new

    def state(part: str, key: str):
        return None if cache is None else cache[part][key]

    def spec_of(part: str, key: str):
        return None if specs is None else specs[part][key]

    macro_specs = None if specs is None or "macro" not in specs \
        else _unstack_specs(specs["macro"])
    for i in range(n_head):
        new_cache["head"][f"layer{i}"] = block(
            kinds[i], params["head"][f"layer{i}"],
            state("head", f"layer{i}"), i, spec_of("head", f"layer{i}"))
    if n_macro:
        per_pos: Dict[str, List[Any]] = {f"pos{i}": [] for i in
                                          range(len(period))}
        for m in range(n_macro):
            p_m = _index(params["macro"], m)
            if remat and mode == "train":
                h, aux_total = checkpoint(
                    _macro_block, cfg, period, h, aux_total, p_m, positions,
                    enc_out, n_head + m * len(period), plain, DC._mesh(),
                    use_reentrant=False)
                continue
            c_m = None if cache is None else _index(cache["macro"], m)
            for i, kind in enumerate(period):
                per_pos[f"pos{i}"].append(block(
                    kind, p_m[f"pos{i}"],
                    None if c_m is None else c_m[f"pos{i}"],
                    n_head + m * len(period) + i,
                    None if macro_specs is None else macro_specs[f"pos{i}"]))
        if mode in ("decode", "prefill_cached"):
            new_cache["macro"] = {k: _stack(v) for k, v in per_pos.items()}
    base = n_head + n_macro * len(period)
    for i in range(n_tail):
        new_cache["tail"][f"layer{i}"] = block(
            period[i], params["tail"][f"layer{i}"],
            state("tail", f"layer{i}"), base + i,
            spec_of("tail", f"layer{i}"))
    return h, aux_total, new_cache


def forward(cfg: ArchConfig, params, batch: Dict[str, Tensor], *,
            remat: bool = False, plain: bool = False
            ) -> Tuple[Tensor, Tensor]:
    """Training/eval forward.  Returns (logits (B, S, V) f32, aux_loss)."""
    h, enc_out = _stack_inputs(cfg, params, batch, plain)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux, _ = _run_layers(cfg, params, h, positions, enc_out, plain=plain,
                            remat=remat)
    return lm_logits(cfg, params, h), aux


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, Tensor], *,
            remat: bool = False, aux_weight: float = 0.01,
            plain: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token cross-entropy in f32 over the labels ``>= 0`` (the
    vision patches' positions carry none), plus ``aux_weight`` times the
    MoE balance loss.  Returns (total, {"ce", "aux"})."""
    logits, aux = forward(cfg, params, batch, remat=remat, plain=plain)
    labels = batch["labels"]
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).float()
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    ce = ((lse - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# -- caches -------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Decode cache tree mirroring the head/macro/tail parameter tree:
    (k, v) of (B, S, KV, hd) for an attention layer (S = min(max_seq,
    window) for a local one: a ring when it holds exactly the window),
    the recurrent carry for RG-LRU and RWKV6 layers.  Zeros, on the card
    unless asked otherwise."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    n_head, n_macro, n_tail = macro_split(cfg)
    period = cfg.layer_pattern

    def one(kind: str, lead: Tuple[int, ...] = ()):
        if kind == "rglru":
            st = R.rglru_init_state(batch, cfg.drnn, CONV_WIDTH, dt, dev)
        elif kind == "rwkv":
            st = R.rwkv_init_state(batch, cfg.d_model,
                                   cfg.d_model // cfg.rwkv_head_dim, dt, dev)
        else:
            # local layers still get a full-length cache when window >=
            # max_seq
            s = min(max_seq, cfg.window) if kind == "local" and cfg.window \
                else max_seq
            st = tuple(torch.zeros((batch, s, cfg.n_kv, cfg.hd), dtype=dt,
                                   device=dev) for _ in range(2))
        return tree_map(lambda a: a.expand(lead + a.shape).contiguous(), st)

    kinds = layer_kinds(cfg)
    cache: Dict[str, Any] = {
        "head": {f"layer{i}": one(kinds[i]) for i in range(n_head)},
        "tail": {f"layer{i}": one(period[i]) for i in range(n_tail)},
    }
    if n_macro:
        cache["macro"] = {f"pos{i}": one(k, (n_macro,))
                          for i, k in enumerate(period)}
    return cache


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int
                ) -> Dict[str, Any]:
    """The decode cache tree on the meta device (JAX's
    ``ShapeDtypeStruct`` tree)."""
    return init_cache(cfg, batch, max_seq, device="meta")


def _fill_kv(cfg: ArchConfig, kind: str, old, new, spec=None):
    """A layer's cache with the prompt's (k, v) written at their
    positions: rows [0, S), or, in a ring of ``window`` slots, the last
    ``window`` positions t at slot t % window.  A sequence-sharded cache
    (on a mesh) is filled whole and cut back to this rank's rows."""
    if _seq_sharded(cfg, spec):
        whole = tuple(C.gather_model(t, 1) for t in old)
        return tuple(C.scatter_model(t, 1)
                     for t in _write_prompt(cfg, kind, whole, new))
    return _write_prompt(cfg, kind, old, new)


def _write_prompt(cfg: ArchConfig, kind: str, old, new):
    kc, vc = (t.clone() for t in old)
    k, v = new
    s, cache_len = k.shape[1], kc.shape[1]
    window = cfg.window if kind == "local" else 0
    if bool(window) and cache_len == window:
        t = torch.arange(max(0, s - window), s, device=k.device)
        kc[:, t % window] = k[:, t]
        vc[:, t % window] = v[:, t]
    elif s > cache_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{cache_len} rows")
    else:
        kc[:, :s] = k
        vc[:, :s] = v
    return kc, vc


def decode_step(cfg: ArchConfig, params, cache, tokens: Tensor,
                pos: Union[int, Tensor], enc_out: Optional[Tensor] = None,
                *, plain: bool = False, specs=None
                ) -> Tuple[Tensor, Dict[str, Any]]:
    """One token for the whole batch.  tokens: (B, 1); ``pos``: the
    position of that token.  Returns (logits (B, 1, V), the new cache);
    the cache given is not written.  On a mesh ``specs`` is the cache's
    spec tree (``sharding.cache_specs``)."""
    pos = int(pos)
    h = embed_tokens(cfg, params, tokens)
    positions = torch.tensor([pos], device=h.device)
    h, _, new_cache = _run_layers(cfg, params, h, positions, enc_out,
                                  mode="decode", cache=cache, decode_pos=pos,
                                  plain=plain, specs=specs)
    return lm_logits(cfg, params, h), new_cache


def prefill(cfg: ArchConfig, params, batch: Dict[str, Tensor], cache=None,
            *, plain: bool = False, specs=None):
    """Prefill forward.  With no ``cache``: (full-sequence logits,
    aux_loss), as JAX's ``prefill``.  With a fresh cache (``init_cache``):
    (logits, the cache filled from the same activations: every attention
    layer's (k, v) at the prompt's positions, every recurrent layer's
    carry), ready for ``decode_step`` at position S.  On a mesh
    ``specs`` is the cache's spec tree."""
    if cache is None:
        return forward(cfg, params, batch, plain=plain)
    h, enc_out = _stack_inputs(cfg, params, batch, plain)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _, states = _run_layers(cfg, params, h, positions, enc_out,
                               mode="prefill_cached", cache=cache,
                               plain=plain)
    n_head, n_macro, _ = macro_split(cfg)
    period, kinds = cfg.layer_pattern, layer_kinds(cfg)

    def merged(kind, old, new, spec, stacked=False):
        if kind in ("rglru", "rwkv"):
            return new
        if stacked:
            return _stack([_fill_kv(cfg, kind, _index(old, m),
                                    _index(new, m), spec)
                           for m in range(n_macro)])
        return _fill_kv(cfg, kind, old, new, spec)

    def spec_of(part, key):
        if specs is None:
            return None
        if part == "macro":
            return _unstack_specs(specs["macro"])[key]
        return specs[part][key]

    out: Dict[str, Any] = {
        part: {f"layer{i}": merged(kind_of(i), cache[part][f"layer{i}"],
                                   states[part][f"layer{i}"],
                                   spec_of(part, f"layer{i}"))
               for i in range(len(cache[part]))}
        for part, kind_of in (("head", lambda i: kinds[i]),
                              ("tail", lambda i: period[i]))}
    if n_macro:
        out["macro"] = {f"pos{i}": merged(kind, cache["macro"][f"pos{i}"],
                                          states["macro"][f"pos{i}"],
                                          spec_of("macro", f"pos{i}"), True)
                        for i, kind in enumerate(period)}
    return lm_logits(cfg, params, h), out

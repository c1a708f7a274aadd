"""Graph extraction: ``torch.nn`` modules → SOL IR (paper Sec. III-A;
counterpart of ``repro.frontends.extract``).

Extraction is driven by an emitter registry keyed on module types, looked up
by exact type then MRO, so new layer kinds plug in without touching the
walk.  Emitters key on torch's own classes (``torch.nn.Linear`` ...), so a
plain torch module extracts as well as the port's subclasses.  Containers
(``Sequential``, ``Residual``) recurse, so transformer and recurrent blocks
extract as genuine multi-input graphs.  A torch module that computes more
than the IR op (a padded pool, a dilated conv) raises
:class:`UnsupportedModuleError` instead of extracting as something else.

Parameters are registered under their dotted ``named_parameters`` names, so
the SolModel reads the framework's own parameter storage (paper Listing 2).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Type

import numpy as np
from torch import nn as tnn

from ..core import ir
from ..core.ir import Graph, Node, OpKind, TensorSpec
from . import nn


class UnsupportedModuleError(TypeError):
    """No emitter is registered for a module type (or the module computes
    something the IR op does not)."""


# fn(module, ctx, x: Node, path: str) -> Node  (path is the dotted prefix of
# the module in the tree, '' for the root)
EmitterFn = Callable[[tnn.Module, "EmitContext", Node, str], Node]

_EMITTERS: Dict[Type[tnn.Module], EmitterFn] = {}
# decode-mode overrides (MultiHeadAttention → DECODE_ATTENTION), looked up
# before _EMITTERS when ctx.mode == 'decode'
_DECODE_EMITTERS: Dict[Type[tnn.Module], EmitterFn] = {}
# modules that mix information across positions: decode extraction refuses
# them unless they have a decode emitter
_SEQUENCE_MODULES: set = set()


def register_emitter(*module_types: Type[tnn.Module]
                     ) -> Callable[[EmitterFn], EmitterFn]:
    """Register an extraction emitter for one or more module types."""
    def deco(fn: EmitterFn) -> EmitterFn:
        for t in module_types:
            _EMITTERS[t] = fn
        return fn
    return deco


def register_decode_emitter(*module_types: Type[tnn.Module]
                            ) -> Callable[[EmitterFn], EmitterFn]:
    """Register a single-token decode emitter (implies the module is
    sequence-dependent)."""
    def deco(fn: EmitterFn) -> EmitterFn:
        for t in module_types:
            _DECODE_EMITTERS[t] = fn
            _SEQUENCE_MODULES.add(t)
        return fn
    return deco


def mark_sequence_module(*module_types: Type[tnn.Module]) -> None:
    """Declare module types position-dependent without a decode emitter:
    decode extraction refuses them instead of reusing the forward emitter,
    which would silently drop history in a one-token step."""
    _SEQUENCE_MODULES.update(module_types)


def registered_emitters() -> List[str]:
    return sorted(t.__name__ for t in _EMITTERS)


def _emitter_for(m: tnn.Module) -> EmitterFn | None:
    for t in type(m).__mro__:
        if t in _EMITTERS:
            return _EMITTERS[t]
    return None


def _where(path: str) -> str:
    return path.rstrip(".") or "<root>"


class EmitContext:
    """Per-extraction state: the parameter table plus node builders.

    ``mode`` is ``'forward'``, ``'prefill'`` (attention layers also record
    their (k, v) projections in ``kv_outputs``) or ``'decode'`` (attention
    layers read a cache input and emit ``DECODE_ATTENTION``)."""

    def __init__(self, dtype: str = "float32", mode: str = "forward",
                 max_seq: int = 0):
        self.dtype = dtype
        self.mode = mode
        self.max_seq = max_seq
        self.params: Dict[str, Node] = {}
        self.kv_inputs: List[Node] = []
        self.kv_outputs: List[Node] = []
        self.lens: Node | None = None

    def emit(self, m: tnn.Module, x: Node, path: str = "") -> Node:
        if self.mode == "decode":
            for t in type(m).__mro__:
                if t in _DECODE_EMITTERS:
                    return _DECODE_EMITTERS[t](m, self, x, path)
            if any(t in _SEQUENCE_MODULES for t in type(m).__mro__):
                raise UnsupportedModuleError(
                    f"{type(m).__name__} at {_where(path)} mixes information "
                    f"across sequence positions and has no decode emitter; "
                    f"serve this model with decode=False.")
        fn = _emitter_for(m)
        if fn is None:
            raise UnsupportedModuleError(
                f"no emitter registered for {type(m).__name__} at "
                f"{_where(path)}; registered emitters: "
                f"{', '.join(registered_emitters())}.  Add one with "
                f"frontends.extract.register_emitter({type(m).__name__}).")
        return fn(m, self, x, path)

    def kv_input(self, shape: Tuple[int, ...], name: str) -> Node:
        n = ir.input_node(shape, self.dtype, name=name)
        self.kv_inputs.append(n)
        return n

    def param(self, name: str, tensor) -> Node:
        if name in self.params:        # same framework storage → same node
            return self.params[name]
        n = ir.param_node(tuple(tensor.shape), self.dtype, name=name)
        self.params[name] = n
        return n

    def const(self, shape: Tuple[int, ...], fill: float = 0.0) -> Node:
        return ir.const_node(shape, fill, self.dtype)

    def matmul(self, x: Node, w: Node) -> Node:
        """x @ w with w in (in, out) layout."""
        shape = x.spec.shape[:-1] + (w.spec.shape[-1],)
        return Node(OpKind.MATMUL, [x, w], TensorSpec(shape, self.dtype))

    def reshape(self, x: Node, shape: Tuple[int, ...]) -> Node:
        return Node(OpKind.RESHAPE, [x], TensorSpec(tuple(shape), self.dtype),
                    attrs={"shape": tuple(shape)})

    def unary(self, op: OpKind, x: Node, **attrs) -> Node:
        return Node(op, [x], TensorSpec(x.spec.shape, self.dtype),
                    attrs=attrs)

    def binary(self, op: OpKind, a: Node, b: Node) -> Node:
        shape = np.broadcast_shapes(a.spec.shape, b.spec.shape)
        return Node(op, [a, b], TensorSpec(tuple(shape), self.dtype))


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@register_emitter(tnn.Sequential)
def _emit_sequential(m: tnn.Sequential, ctx: EmitContext, x: Node,
                     path: str) -> Node:
    cur = x
    for name, child in m.named_children():
        cur = ctx.emit(child, cur, f"{path}{name}.")
    return cur


@register_emitter(nn.Residual)
def _emit_residual(m: nn.Residual, ctx: EmitContext, x: Node,
                   path: str) -> Node:
    return ctx.binary(OpKind.ADD, x, _emit_sequential(m, ctx, x, path))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@register_emitter(tnn.Linear)
def _emit_linear(m: tnn.Linear, ctx: EmitContext, x: Node,
                 path: str) -> Node:
    w = ctx.param(path + "weight", m.weight)
    shape = x.spec.shape[:-1] + (m.out_features,)
    cur = Node(OpKind.LINEAR, [x, w], TensorSpec(shape, ctx.dtype),
               attrs={"out_features": m.out_features})
    if m.bias is not None:
        b = ctx.param(path + "bias", m.bias)
        cur = Node(OpKind.BIAS_ADD, [cur, b], TensorSpec(shape, ctx.dtype),
                   attrs={"axis": -1})
    return cur


@register_emitter(tnn.ReLU)
def _emit_relu(m, ctx, x, path):
    return ctx.unary(OpKind.RELU, x)


@register_emitter(tnn.GELU)
def _emit_gelu(m: tnn.GELU, ctx, x, path):
    if m.approximate != "tanh":
        raise UnsupportedModuleError(
            f"GELU at {_where(path)} is the erf form; the IR's GELU is the "
            f"tanh form (frontends.nn.GELU)")
    return ctx.unary(OpKind.GELU, x)


@register_emitter(tnn.LayerNorm)
def _emit_layernorm(m: tnn.LayerNorm, ctx, x, path):
    if len(m.normalized_shape) != 1 or m.weight is None or m.bias is None:
        raise UnsupportedModuleError(
            f"LayerNorm at {_where(path)}: only an affine norm over the "
            f"last dim extracts")
    g = ctx.param(path + "weight", m.weight)
    b = ctx.param(path + "bias", m.bias)
    return Node(OpKind.LAYERNORM, [x, g, b],
                TensorSpec(x.spec.shape, ctx.dtype), attrs={"eps": m.eps})


@register_emitter(tnn.Dropout)
def _emit_dropout(m: tnn.Dropout, ctx, x, path):
    return ctx.unary(OpKind.DROPOUT, x, p=m.p)


# ---------------------------------------------------------------------------
# the paper's CNN layers: CONV2D, pools, BATCHNORM, FLATTEN
# ---------------------------------------------------------------------------

def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _attr(p: Tuple[int, int]):
    """An (h, w) pair as the JAX frontend's int when square, else the
    pair."""
    return p[0] if p[0] == p[1] else p


def _out_shape_conv(x: Tuple[int, ...], out_ch: int, k: Tuple[int, int],
                    s: Tuple[int, int], p: Tuple[int, int]
                    ) -> Tuple[int, ...]:
    return (x[0], out_ch, (x[2] + 2 * p[0] - k[0]) // s[0] + 1,
            (x[3] + 2 * p[1] - k[1]) // s[1] + 1)


def _out_shape_pool(x: Tuple[int, ...], k: Tuple[int, int],
                    s: Tuple[int, int]) -> Tuple[int, ...]:
    return (x[0], x[1], (x[2] - k[0]) // s[0] + 1, (x[3] - k[1]) // s[1] + 1)


@register_emitter(tnn.Conv2d)
def _emit_conv2d(m: tnn.Conv2d, ctx: EmitContext, x: Node,
                 path: str) -> Node:
    """CONV2D (NCHW input, OIHW weight) plus a BIAS_ADD over axis 1."""
    if isinstance(m.padding, str):
        if m.padding != "valid":
            raise UnsupportedModuleError(
                f"Conv2d at {_where(path)}: padding {m.padding!r}; give the "
                f"padding as numbers")
        pad = (0, 0)
    else:
        pad = _pair(m.padding)
    if _pair(m.dilation) != (1, 1) or m.padding_mode != "zeros":
        raise UnsupportedModuleError(
            f"Conv2d at {_where(path)}: dilation {m.dilation} and padding "
            f"mode {m.padding_mode!r}; the IR's CONV2D has dilation 1 and "
            f"zero padding")
    stride = _pair(m.stride)
    w = ctx.param(path + "weight", m.weight)
    shape = _out_shape_conv(x.spec.shape, m.out_channels,
                            _pair(m.kernel_size), stride, pad)
    cur = Node(OpKind.CONV2D, [x, w], TensorSpec(shape, ctx.dtype),
               attrs={"stride": _attr(stride), "padding": _attr(pad),
                      "groups": m.groups, "out_channels": m.out_channels})
    if m.bias is not None:
        b = ctx.param(path + "bias", m.bias)
        cur = Node(OpKind.BIAS_ADD, [cur, b], TensorSpec(shape, ctx.dtype),
                   attrs={"axis": 1})
    return cur


def _pool_window(m, path: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(kernel, stride) of a torch pool that the IR's VALID pool computes;
    raises for what the JAX modules lack."""
    what = []
    if _pair(m.padding) != (0, 0):
        what.append(f"padding {m.padding}")
    if m.ceil_mode:
        what.append("ceil_mode")
    if _pair(getattr(m, "dilation", 1)) != (1, 1):
        what.append(f"dilation {m.dilation}")
    if getattr(m, "return_indices", False):
        what.append("return_indices")
    if getattr(m, "divisor_override", None) is not None:
        what.append(f"divisor_override {m.divisor_override}")
    if what:
        raise UnsupportedModuleError(
            f"{type(m).__name__} at {_where(path)}: {', '.join(what)}; the "
            f"IR's pools are VALID windows")
    k = _pair(m.kernel_size)
    return k, _pair(m.stride if m.stride is not None else m.kernel_size)


@register_emitter(tnn.MaxPool2d)
def _emit_maxpool(m: tnn.MaxPool2d, ctx, x, path):
    k, s = _pool_window(m, path)
    return Node(OpKind.MAXPOOL, [x],
                TensorSpec(_out_shape_pool(x.spec.shape, k, s), ctx.dtype),
                attrs={"kernel": _attr(k), "stride": _attr(s)})


@register_emitter(tnn.AvgPool2d)
def _emit_avgpool(m: tnn.AvgPool2d, ctx, x, path):
    k, s = _pool_window(m, path)
    return Node(OpKind.AVGPOOL, [x],
                TensorSpec(_out_shape_pool(x.spec.shape, k, s), ctx.dtype),
                attrs={"kernel": _attr(k), "stride": _attr(s)})


@register_emitter(nn.GlobalAvgPool)
def _emit_globalpool(m, ctx, x, path):
    return Node(OpKind.GLOBALPOOL, [x],
                TensorSpec(x.spec.shape[:2], ctx.dtype))


@register_emitter(tnn.Flatten)
def _emit_flatten(m: tnn.Flatten, ctx, x, path):
    rank = len(x.spec.shape)
    if m.start_dim % rank != 1 or m.end_dim % rank != rank - 1:
        raise UnsupportedModuleError(
            f"Flatten at {_where(path)}: dims ({m.start_dim}, {m.end_dim}); "
            f"the IR's FLATTEN keeps dim 0 and flattens the rest")
    flat = 1
    for d in x.spec.shape[1:]:
        flat *= d
    return Node(OpKind.FLATTEN, [x],
                TensorSpec((x.spec.shape[0], flat), ctx.dtype))


@register_emitter(tnn.BatchNorm2d)
def _emit_batchnorm(m: tnn.BatchNorm2d, ctx, x, path):
    """Inference batch norm over axis 1 with the running stats, as the JAX
    module always computes."""
    if not m.affine or m.running_mean is None:
        raise UnsupportedModuleError(
            f"BatchNorm2d at {_where(path)}: only an affine norm with "
            f"running stats extracts")
    ps = [ctx.param(path + n, getattr(m, n)) for n in
          ("weight", "bias", "running_mean", "running_var")]
    return Node(OpKind.BATCHNORM, [x] + ps,
                TensorSpec(x.spec.shape, ctx.dtype), attrs={"eps": m.eps})


# ---------------------------------------------------------------------------
# attention: ATTENTION (forward, prefill) and DECODE_ATTENTION (decode)
# ---------------------------------------------------------------------------

def _qkv(m: nn.MultiHeadAttention, ctx: EmitContext, x: Node, path: str,
         s: int) -> Tuple[Node, Node, Node]:
    b = x.spec.shape[0]
    hd = m.head_dim
    q = ctx.reshape(ctx.matmul(x, ctx.param(path + "wq", m.wq)),
                    (b, s, m.n_heads, hd))
    k = ctx.reshape(ctx.matmul(x, ctx.param(path + "wk", m.wk)),
                    (b, s, m.n_kv_heads, hd))
    v = ctx.reshape(ctx.matmul(x, ctx.param(path + "wv", m.wv)),
                    (b, s, m.n_kv_heads, hd))
    return q, k, v


@register_emitter(nn.MultiHeadAttention)
def _emit_attention(m: nn.MultiHeadAttention, ctx: EmitContext, x: Node,
                    path: str) -> Node:
    b, s, _ = x.spec.shape
    q, k, v = _qkv(m, ctx, x, path, s)
    att = Node(OpKind.ATTENTION, [q, k, v],
               TensorSpec((b, s, m.n_heads, m.head_dim), ctx.dtype),
               attrs={"causal": m.causal, "window": m.window, "cap": m.cap})
    if ctx.mode == "prefill":       # expose this layer's cache rows
        ctx.kv_outputs += [k, v]
    o = ctx.reshape(att, (b, s, m.n_heads * m.head_dim))
    return ctx.matmul(o, ctx.param(path + "wo", m.wo))


@register_decode_emitter(nn.MultiHeadAttention)
def _emit_attention_decode(m: nn.MultiHeadAttention, ctx: EmitContext,
                           x: Node, path: str) -> Node:
    """Single-token step: project q/k/v for the new position, attend the
    query against this layer's cache input plus the new (k, v) pair, and
    record the pair in ``kv_outputs`` for the server to append at
    ``lens[b]``."""
    if not m.causal:
        raise UnsupportedModuleError(
            f"MultiHeadAttention at {_where(path)} is non-causal and cannot "
            f"be decoded incrementally; serve with decode=False.")
    b, s, _ = x.spec.shape
    if s != 1:
        raise ValueError(f"decode extraction expects a single-token step, "
                         f"got sequence length {s}")
    q, k_new, v_new = _qkv(m, ctx, x, path, 1)
    cshape = (b, ctx.max_seq, m.n_kv_heads, m.head_dim)
    k_cache = ctx.kv_input(cshape, name=f"{path}k_cache")
    v_cache = ctx.kv_input(cshape, name=f"{path}v_cache")
    att = Node(OpKind.DECODE_ATTENTION,
               [q, k_cache, v_cache, k_new, v_new, ctx.lens],
               TensorSpec((b, 1, m.n_heads, m.head_dim), ctx.dtype),
               attrs={"window": m.window, "cap": m.cap})
    ctx.kv_outputs += [k_new, v_new]
    o = ctx.reshape(att, (b, 1, m.n_heads * m.head_dim))
    return ctx.matmul(o, ctx.param(path + "wo", m.wo))


# ---------------------------------------------------------------------------
# recurrent layers: RGLRU_SCAN and RWKV6_SCAN (forward and prefill only)
# ---------------------------------------------------------------------------

@register_emitter(nn.RGLRU)
def _emit_rglru(m: nn.RGLRU, ctx: EmitContext, x: Node, path: str) -> Node:
    """models.recurrent.rglru_gates + the RGLRU_SCAN kernel node:
    a = exp(-c·softplus(λ)·sigmoid(x·wa)); b = √(1-a²)·sigmoid(x·wx)·x."""
    from ..models.recurrent import RGLRU_C
    bsz, s, d = x.spec.shape
    wa = ctx.param(path + "wa", m.wa)
    wx = ctx.param(path + "wx", m.wx)
    lam = ctx.param(path + "lam", m.lam)
    r = ctx.unary(OpKind.SIGMOID, ctx.matmul(x, wa))
    i = ctx.unary(OpKind.SIGMOID, ctx.matmul(x, wx))
    decay = ctx.unary(OpKind.SCALE, ctx.unary(OpKind.SOFTPLUS, lam),
                      value=-RGLRU_C)
    a = ctx.unary(OpKind.EXP, ctx.binary(OpKind.MUL, r, decay))
    one_minus_a2 = ctx.binary(OpKind.SUB, ctx.const((1,), 1.0),
                              ctx.binary(OpKind.MUL, a, a))
    gate = ctx.unary(OpKind.SQRT, one_minus_a2, min=1e-12)
    bb = ctx.binary(OpKind.MUL, ctx.binary(OpKind.MUL, gate, i), x)
    h0 = ctx.const((bsz, d), 0.0)
    return Node(OpKind.RGLRU_SCAN, [a, bb, h0],
                TensorSpec((bsz, s, d), ctx.dtype))


@register_emitter(nn.RWKV6TimeMix)
def _emit_rwkv6(m: nn.RWKV6TimeMix, ctx: EmitContext, x: Node,
                path: str) -> Node:
    """models.recurrent.rwkv_time_mix_seq as a graph: token-shift lerp with
    per-target LoRA mixes → r/k/v/decay projections → RWKV6_SCAN → per-head
    group norm → silu gate → output projection."""
    from ..models.recurrent import GN_EPS
    bsz, s, d = x.spec.shape
    h, hd = m.n_heads, d // m.n_heads

    def P(name: str) -> Node:
        return ctx.param(path + name, getattr(m, name))

    xs = ctx.unary(OpKind.TIME_SHIFT, x)
    dx = ctx.binary(OpKind.SUB, xs, x)
    xm = ctx.binary(OpKind.ADD, x, ctx.binary(OpKind.MUL, dx, P("mu_x")))

    def lora(src: Node, t: str) -> Node:
        inner = ctx.unary(OpKind.TANH, ctx.matmul(src, P(f"lora_a_{t}")))
        return ctx.matmul(inner, P(f"lora_b_{t}"))

    def mixed(t: str) -> Node:
        mix = ctx.binary(OpKind.ADD, P(f"mu_{t}"), lora(xm, t))
        return ctx.binary(OpKind.ADD, x, ctx.binary(OpKind.MUL, dx, mix))

    r = ctx.reshape(ctx.matmul(mixed("r"), P("wr")), (bsz, s, h, hd))
    k = ctx.reshape(ctx.matmul(mixed("k"), P("wk")), (bsz, s, h, hd))
    v = ctx.reshape(ctx.matmul(mixed("v"), P("wv")), (bsz, s, h, hd))
    g = ctx.unary(OpKind.SILU, ctx.matmul(mixed("g"), P("wg")))
    # decay: logw = -exp(w0 + lora_w(m_w)) ≤ 0
    wsum = ctx.binary(OpKind.ADD, P("w0"), lora(mixed("w"), "w"))
    logw = ctx.reshape(ctx.unary(OpKind.SCALE, ctx.unary(OpKind.EXP, wsum),
                                 value=-1.0), (bsz, s, h, hd))
    u = ctx.reshape(P("u"), (h, hd))
    s0 = ctx.const((bsz, h, hd, hd), 0.0)
    o = Node(OpKind.RWKV6_SCAN, [r, k, v, logw, u, s0],
             TensorSpec((bsz, s, h, hd), ctx.dtype))
    # per-head group norm == layernorm over the trailing head dim
    gn = Node(OpKind.LAYERNORM, [o, ctx.const((hd,), 1.0),
                                 ctx.const((hd,), 0.0)],
              TensorSpec((bsz, s, h, hd), ctx.dtype), attrs={"eps": GN_EPS})
    flat = ctx.reshape(gn, (bsz, s, d))
    scaled = ctx.binary(OpKind.ADD,
                        ctx.binary(OpKind.MUL, flat, P("gn_gain")),
                        P("gn_bias"))
    return ctx.matmul(ctx.binary(OpKind.MUL, scaled, g), P("wo"))


# the recurrent layers have no decode emitter (their state would need its
# own arena region): decode extraction refuses them loudly
mark_sequence_module(nn.RGLRU, nn.RWKV6TimeMix)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def extract(model: tnn.Module, input_shape: Tuple[int, ...],
            dtype: str = "float32") -> Graph:
    dims = {4: ir.NCHW(), 3: ir.BSD(), 2: ir.NF()}.get(len(input_shape), ())
    x = ir.input_node(input_shape, dtype, dims, name="input")
    ctx = EmitContext(dtype)
    out = ctx.emit(model, x, "")
    g = Graph(inputs=[x], outputs=[out], params=ctx.params)
    g.validate()
    return g


def extract_prefill(model: tnn.Module, input_shape: Tuple[int, ...],
                    dtype: str = "float32") -> Graph:
    """The serving prefill program: ``outputs = [logits, k_0, v_0, k_1, ...]``
    so one prompt forward produces next-token logits and seeds the KV
    cache."""
    x = ir.input_node(input_shape, dtype, ir.BSD(), name="input")
    ctx = EmitContext(dtype, mode="prefill")
    out = ctx.emit(model, x, "")
    g = Graph(inputs=[x], outputs=[out] + ctx.kv_outputs, params=ctx.params)
    g.validate()
    return g


def extract_decode(model: tnn.Module, batch: int, max_seq: int,
                   d_model: int, dtype: str = "float32") -> Graph:
    """The serving decode program: one token per resident sequence.

    ``inputs  = [x (B, 1, D), lens (B,) int32, k_cache_0, v_cache_0, ...]``
    ``outputs = [logits (B, 1, V), k_new_0, v_new_0, ...]``"""
    x = ir.input_node((batch, 1, d_model), dtype, ir.BSD(), name="step")
    lens = ir.input_node((batch,), "int32", name="lens")
    ctx = EmitContext(dtype, mode="decode", max_seq=max_seq)
    ctx.lens = lens
    out = ctx.emit(model, x, "")
    g = Graph(inputs=[x, lens] + ctx.kv_inputs,
              outputs=[out] + ctx.kv_outputs, params=ctx.params)
    g.validate()
    return g

"""SOL execution (counterpart of ``repro.core.executor``).

``lower_graph`` turns an elected graph into a Python function over tensors:
each node runs the impl the election pass annotated on ``node.impl`` (or the
first admissible one in the fallback chain backend kernel → shared kernel →
the PyTorch reference lowerings below).  This module registers the
**reference tier** for every op it can lower, forward and backward; it
knows nothing about which backends exist.  PyTorch runs eagerly, so the
lowered function is the compiled program: there is no tracing step.

``lower_graph(..., differentiable=True)`` wraps every node whose op has a
backward impl in a ``torch.autograd.Function`` (:class:`_NodeFunction`)
that pairs the elected forward with the elected backward (``node.impl`` and
``node.impl_bwd``); autograd of the lowered function then runs the elected
kernels in both directions.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..backends import registry
from .ir import Graph, Node, OpKind

Tensor = torch.Tensor

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32,
                "int64": torch.int64, "float64": torch.float64}


# ---------------------------------------------------------------------------
# individual op lowerings (the reference tier)
# ---------------------------------------------------------------------------

def linear_weight_kn(n: Node, w: Tensor) -> Tensor:
    """A Linear weight in the (K=in, N=out) contraction orientation, as a
    view (no copy).  Params are stored (out,in) framework-style; the single
    home of the orientation heuristic, shared with the CUDA matmul impl."""
    return w.T if w.shape[0] == n.attrs["out_features"] else w


def _lower_linear(n: Node, x: Tensor, w: Tensor, b: Tensor | None,
                  backend: "registry.Backend") -> Tensor:
    # 'io' contracts against the (in,out) view; 'oi' keeps (out,in) and
    # contracts on the last dim of both (F.linear)
    if n.layout == "io":
        y = torch.matmul(x, linear_weight_kn(n, w))
    else:
        wt = w if w.shape[0] == n.attrs["out_features"] else w.T
        y = F.linear(x, wt)
    if b is not None:
        y = y + b
    return y


def _lower_conv2d(n: Node, x: Tensor, w: Tensor) -> Tensor:
    """NCHW × OIHW in full f32: cuDNN would run an f32 conv in TF32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(x, w, stride=n.attrs.get("stride", 1),
                        padding=n.attrs.get("padding", 0),
                        groups=n.attrs.get("groups", 1))
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _window(n: Node):
    k = n.attrs.get("kernel", 2)
    return k, n.attrs.get("stride", k)


def _layernorm(x: Tensor, g: Tensor, b: Tensor, eps: float) -> Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


_ELEMENTWISE: Dict[OpKind, Callable[..., Tensor]] = {
    OpKind.RELU: lambda x: torch.clamp_min(x, 0.0),
    OpKind.GELU: lambda x: F.gelu(x, approximate="tanh"),
    OpKind.SILU: F.silu,
    OpKind.SIGMOID: torch.sigmoid,
    OpKind.TANH: torch.tanh,
    OpKind.EXP: torch.exp,
    OpKind.SOFTPLUS: F.softplus,
    OpKind.IDENTITY: lambda x: x,
}


def _lower_node(n: Node, vals: List[Tensor], backend: "registry.Backend"
                ) -> Tensor:
    op = n.op
    if op in _ELEMENTWISE:
        return _ELEMENTWISE[op](vals[0])
    if op is OpKind.ADD:
        return vals[0] + vals[1]
    if op is OpKind.SUB:
        return vals[0] - vals[1]
    if op is OpKind.MUL:
        return vals[0] * vals[1]
    if op is OpKind.DIV:
        return vals[0] / vals[1]
    if op is OpKind.BIAS_ADD:
        x, b = vals
        shape = [1] * x.dim()
        shape[n.attrs.get("axis", -1)] = b.shape[0]
        return x + b.reshape(shape)
    if op is OpKind.SCALE:
        return vals[0] * n.attrs["value"]
    if op is OpKind.SQRT:
        mv = n.attrs.get("min")
        return torch.sqrt(vals[0] if mv is None else torch.clamp_min(
            vals[0], mv))
    if op is OpKind.TIME_SHIFT:
        x = vals[0]
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    if op is OpKind.SOFTCAP:
        c = n.attrs["cap"]
        return torch.tanh(vals[0] / c) * c
    if op is OpKind.MAXPOOL:
        y = F.max_pool2d(vals[0], *_window(n))
        mv = n.attrs.get("min_value")
        return y if mv is None else torch.clamp_min(y, mv)   # folded ReLU
    if op is OpKind.AVGPOOL:
        return F.avg_pool2d(vals[0], *_window(n))
    if op is OpKind.GLOBALPOOL:
        return vals[0].mean(dim=(2, 3))
    if op is OpKind.LAYERNORM:
        x, g, b = vals
        return _layernorm(x, g, b, n.attrs.get("eps", 1e-5))
    if op is OpKind.BATCHNORM:
        x, g, b, m, v = vals
        shape = [1, -1] + [1] * (x.dim() - 2)
        inv = torch.rsqrt(v + n.attrs.get("eps", 1e-5)) * g
        return (x - m.reshape(shape)) * inv.reshape(shape) + b.reshape(shape)
    if op is OpKind.RMSNORM:
        x, g = vals
        ms = (x.float() ** 2).mean(-1, keepdim=True)
        return (x * torch.rsqrt(ms + n.attrs.get("eps", 1e-6)).to(x.dtype)) * g
    if op is OpKind.DROPOUT:
        return vals[0]
    if op is OpKind.FLATTEN:
        return vals[0].reshape(vals[0].shape[0], -1)
    if op is OpKind.RESHAPE:
        return vals[0].reshape(n.attrs["shape"])
    if op is OpKind.LINEAR:
        return _lower_linear(n, vals[0], vals[1],
                             vals[2] if len(vals) > 2 else None, backend)
    if op is OpKind.MATMUL:
        return torch.matmul(vals[0], vals[1])
    if op is OpKind.CONV2D:
        return _lower_conv2d(n, vals[0], vals[1])
    raise NotImplementedError(f"lowering for {op}")


# ---------------------------------------------------------------------------
# DFP fusion-group reference: compose op-at-a-time
# ---------------------------------------------------------------------------

def compose_fused(n: Node, vals: Sequence[Tensor],
                  backend: "registry.Backend") -> Tensor:
    """Lower a FUSED node op-at-a-time; vals are the group's side inputs in
    node.inputs order.  Body ops resolve through the dispatch table too, so a
    backend's tier-0 override of a fusable op still applies."""
    local: Dict[int, Tensor] = {id(i): v for i, v in zip(n.inputs, vals)}
    out = None
    for b in n.body:
        out = _impl_for(b, backend).fn(b, [local[id(i)] for i in b.inputs],
                                       backend)
        local[id(b)] = out
    return out


# what the transformer, recurrent and CNN emitters produce, plus every op a
# DFP program covers (so ``ref.compose`` can run any group).  CONV2D stays
# on this tier, as it stays with XLA in the JAX package.  RGLRU_SCAN and
# RWKV6_SCAN register their reference impls in their kernel packages'
# ops.py, as in the JAX package.
_REFERENCE_OPS = (
    list(_ELEMENTWISE)
    + [OpKind.ADD, OpKind.SUB, OpKind.MUL, OpKind.DIV, OpKind.BIAS_ADD,
       OpKind.SCALE, OpKind.SQRT, OpKind.TIME_SHIFT, OpKind.SOFTCAP,
       OpKind.MAXPOOL, OpKind.AVGPOOL, OpKind.GLOBALPOOL,
       OpKind.LAYERNORM, OpKind.RMSNORM, OpKind.BATCHNORM,
       OpKind.DROPOUT, OpKind.FLATTEN, OpKind.RESHAPE, OpKind.LINEAR,
       OpKind.MATMUL, OpKind.CONV2D]
)


def vjp(fn: Callable[..., Tensor], vals: Sequence[Any], ct: Tensor
        ) -> List[Any]:
    """Autograd of ``fn(*vals)`` against the output cotangent ``ct``,
    recomputed from the primals: one cotangent per value, None for an
    integer value or one the output does not depend on.  It runs in
    backward, where grad mode is off, so it records on detached leaf copies
    under ``torch.enable_grad()``."""
    diff = [i for i, v in enumerate(vals)
            if isinstance(v, Tensor) and v.is_floating_point()]
    with torch.enable_grad():
        full = list(vals)
        for i in diff:
            full[i] = vals[i].detach().requires_grad_(True)
        out = fn(*full)
        cts = torch.autograd.grad(out, [full[i] for i in diff], ct,
                                  allow_unused=True)
    grads: List[Any] = [None] * len(vals)
    for i, c in zip(diff, cts):
        grads[i] = c
    return grads


def reference_vjp_grad(n: Node, res, ct: Tensor,
                       backend: "registry.Backend") -> List[Any]:
    """The universal tier-2 backward: autograd of the op's reference
    forward, recomputed from the saved primals (no residual beyond the
    default ``(inputs, output)`` pair).  Works for any op with a reference
    forward, FUSED groups included."""
    vals, _out = res
    ref = registry._REFERENCE_IMPLS[n.op]
    return vjp(lambda *xs: ref.fn(n, list(xs), backend), vals, ct)


# Ops whose elected forward can be a hand-written kernel (no autograd of
# its own) must carry a registered backward; these join with the reference
# backward so theirs can be elected and swept.  Elementwise and norm ops
# differentiate through their torch lowerings.
_GRAD_REFERENCE_OPS = (OpKind.LINEAR, OpKind.MATMUL, OpKind.CONV2D,
                       OpKind.AVGPOOL, OpKind.FUSED)


def _register_reference_impls() -> None:
    """Invoked by ``registry._load_entry_points`` (not at import), so the
    executor↔registry import cycle stays one-directional."""
    # the library's products and convs run in the graph's dtype: bf16/f16
    # on the tensor cores, f32 outside them (TF32 off); the rest is SIMT
    products = (OpKind.LINEAR, OpKind.MATMUL, OpKind.CONV2D)
    for _op in _REFERENCE_OPS:
        registry.register_reference_impl(
            _op, _lower_node,
            unit=registry.library_unit if _op in products else None)
    registry.register_reference_impl(OpKind.FUSED, compose_fused,
                                     name="ref.compose", memory="roundtrip")
    for _op in _GRAD_REFERENCE_OPS:
        registry.register_reference_grad_impl(_op, reference_vjp_grad)


# ---------------------------------------------------------------------------
# graph → callable
# ---------------------------------------------------------------------------

def _impl_for(n: Node, backend: "registry.Backend") -> registry.Impl:
    """Honour the election's annotation when it is still admissible for this
    backend, else resolve through the fallback chain."""
    if n.impl:
        impl = registry.get_impl(n.impl)
        if impl is not None and impl.op is n.op \
                and impl.admissible(backend, n):
            return impl
    return registry.resolve(backend, n)


def _grad_impl_for(n: Node, backend: "registry.Backend"
                   ) -> registry.Impl | None:
    """Honour the backward election's annotation when it is still
    admissible, else the first admissible backward in the chain; None when
    the op registers no backward (autograd differentiates its forward
    impl's torch ops)."""
    if n.impl_bwd:
        impl = registry.get_grad_impl(n.impl_bwd)
        if impl is not None and impl.op is n.op \
                and impl.admissible(backend, n):
            return impl
    return registry.resolve_grad(backend, n)


class _NodeFunction(torch.autograd.Function):
    """One node of a differentiable lowering: its elected forward impl, and
    its elected backward impl on the default residuals, the node's inputs
    and its output.  The backward's cotangents are checked for count; an
    integer input (decode ``lens``) gets None, a None cotangent of a float
    input zeros, and every other is cast to its input's dtype."""

    @staticmethod
    def forward(ctx, node: Node, impl: registry.Impl,
                grad_impl: registry.Impl, backend: "registry.Backend",
                *vals: Tensor) -> Tensor:
        out = impl.fn(node, list(vals), backend)
        ctx.node, ctx.grad_impl, ctx.backend = node, grad_impl, backend
        ctx.save_for_backward(*vals, out)
        return out

    @staticmethod
    def backward(ctx, ct: Tensor):
        *vals, out = ctx.saved_tensors
        n, grad_impl = ctx.node, ctx.grad_impl
        cts = grad_impl.fn(n, (vals, out), ct, ctx.backend)
        cts = tuple(cts) if isinstance(cts, (tuple, list)) else (cts,)
        if len(cts) != len(vals):
            raise ValueError(
                f"{grad_impl.name} returned {len(cts)} cotangents for "
                f"{len(vals)} inputs of {n}")
        fixed = []
        for v, c in zip(vals, cts):
            if not v.is_floating_point():
                fixed.append(None)
            elif c is None:
                fixed.append(torch.zeros_like(v))
            else:
                fixed.append(c.to(v.dtype))
        return (None, None, None, None, *fixed)


def lower_graph(g: Graph, backend: "registry.Backend", *,
                differentiable: bool = False) -> Callable[..., Any]:
    """Return fn(params: dict, *inputs) -> outputs evaluating the graph.
    CONST sources are materialized once per device, on the device of the
    first input, outside ``inference_mode``.  With ``differentiable=True``
    every node whose op has a backward impl runs through
    :class:`_NodeFunction`, its impls bound once here.

    A sharded graph (``distributed.sharding.shard_graph``) runs one rank's
    shard: a row-parallel product marked with ``psum_axes`` yields partial
    sums, and their all-reduce over the mesh's groups of those axes
    (``collectives.reduce_over``, whose backward is the identity) lowers
    right after the node, outside its ``_NodeFunction``, before any
    downstream bias add (BIAS_ADD is its own node).  Differentiable, each
    input of the column-parallel products (``sharding.column_parallel``)
    reaches them through one ``collectives.copy_over`` per input and call,
    whose backward all-reduces the partial gradient that products leave:
    one all-reduce where a replicated tensor enters a sharded region, not
    one per product."""
    order = g.topo()
    mesh = getattr(g, "mesh", None)
    psum = {id(n): tuple(n.attrs["psum_axes"]) for n in order
            if n.attrs.get("psum_axes")}
    copy: Dict[int, tuple] = {}
    if mesh is not None and differentiable:
        from ..distributed.sharding import column_parallel
        copy = column_parallel(g)
    if (psum or copy) and not hasattr(mesh, "all_reduce"):
        raise ValueError(
            f"{len(psum)} row-parallel and {len(copy)} column-parallel "
            f"products need a mesh with process groups (launch.mesh."
            f"make_debug_mesh), not {mesh!r}")
    if psum or copy:
        from ..distributed import collectives
    input_ids = [id(i) for i in g.inputs]
    param_items = sorted(g.params.items())
    impls: Dict[int, registry.Impl] = {
        id(n): _impl_for(n, backend) for n in order
        if n.op not in (OpKind.INPUT, OpKind.PARAM, OpKind.CONST,
                        OpKind.OUTPUT)
    }
    calls: Dict[int, Callable[..., Any]] = {}
    if differentiable:
        for n in order:
            if id(n) not in impls:
                continue
            gi = _grad_impl_for(n, backend)
            if gi is not None:
                calls[id(n)] = functools.partial(
                    _NodeFunction.apply, n, impls[id(n)], gi, backend)
    consts = [n for n in order if n.op is OpKind.CONST]
    const_cache: Dict[torch.device, Dict[int, Tensor]] = {}

    def fn(params: Dict[str, Tensor], *inputs: Tensor):
        dev = inputs[0].device if inputs else torch.device("cpu")
        if dev not in const_cache:
            # normal tensors even when the first call runs under
            # inference_mode: a later differentiated call saves them
            with torch.inference_mode(False):
                const_cache[dev] = {
                    id(n): torch.full(n.spec.shape,
                                      n.attrs.get("fill", 0.0),
                                      dtype=TORCH_DTYPES[n.spec.dtype],
                                      device=dev) for n in consts}
        env: Dict[int, Tensor] = dict(const_cache[dev])
        copied: Dict[tuple, Tensor] = {}
        for nid, x in zip(input_ids, inputs):
            env[nid] = x
        for name, node in param_items:
            env[id(node)] = params[name]
        for n in order:
            if id(n) in env:
                continue
            if n.op in (OpKind.INPUT, OpKind.PARAM):
                raise ValueError(f"unbound source node {n}")
            vals = [env[id(i)] for i in n.inputs]
            if id(n) in copy:
                key = (id(n.inputs[0]), copy[id(n)])
                if key not in copied:
                    copied[key] = collectives.copy_over(vals[0], mesh,
                                                        copy[id(n)])
                vals[0] = copied[key]
            call = calls.get(id(n))
            env[id(n)] = (call(*vals) if call is not None
                          else impls[id(n)].fn(n, vals, backend))
            if id(n) in psum:
                env[id(n)] = collectives.reduce_over(env[id(n)], mesh,
                                                     psum[id(n)])
        outs = tuple(env[id(o)] for o in g.outputs)
        return outs[0] if len(outs) == 1 else outs

    return fn

"""SOL execution (counterpart of ``repro.core.executor``, forward only).

``lower_graph`` turns an elected graph into a Python function over tensors:
each node runs the impl the election pass annotated on ``node.impl`` (or the
first admissible one in the fallback chain backend kernel → shared kernel →
the PyTorch reference lowerings below).  This module registers the
**reference tier** for every op it can lower; it knows nothing about which
backends exist.  PyTorch runs eagerly, so the lowered function is the
compiled program: there is no tracing step.
"""
from __future__ import annotations

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


def lower_graph(g: Graph, backend: "registry.Backend"
                ) -> Callable[..., Any]:
    """Return fn(params: dict, *inputs) -> outputs evaluating the graph.
    CONST sources are materialized once per device, on the device of the
    first input."""
    order = g.topo()
    input_ids = [id(i) for i in g.inputs]
    param_items = sorted(g.params.items())
    impls: Dict[int, registry.Impl] = {
        id(n): _impl_for(n, backend) for n in order
        if n.op not in (OpKind.INPUT, OpKind.PARAM, OpKind.CONST,
                        OpKind.OUTPUT)
    }
    consts = [n for n in order if n.op is OpKind.CONST]
    const_cache: Dict[torch.device, Dict[int, Tensor]] = {}

    def fn(params: Dict[str, Tensor], *inputs: Tensor):
        dev = inputs[0].device if inputs else torch.device("cpu")
        if dev not in const_cache:
            const_cache[dev] = {
                id(n): torch.full(n.spec.shape, n.attrs.get("fill", 0.0),
                                  dtype=TORCH_DTYPES[n.spec.dtype],
                                  device=dev) for n in consts}
        env: Dict[int, Tensor] = dict(const_cache[dev])
        for nid, x in zip(input_ids, inputs):
            env[nid] = x
        for name, node in param_items:
            env[id(node)] = params[name]
        for n in order:
            if id(n) in env:
                continue
            if n.op in (OpKind.INPUT, OpKind.PARAM):
                raise ValueError(f"unbound source node {n}")
            env[id(n)] = impls[id(n)].fn(n, [env[id(i)] for i in n.inputs],
                                         backend)
        outs = tuple(env[id(o)] for o in g.outputs)
        return outs[0] if len(outs) == 1 else outs

    return fn

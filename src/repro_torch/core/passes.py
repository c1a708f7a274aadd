"""SOL compiler passes (paper Sec. III-A; counterpart of
``repro.core.passes``).

  1. ``simplify``          — ReLU⊕MaxPool folding, transpose cancellation,
                             identity/dropout removal.
  2. ``assign_modules``    — Convolution, Linear and the sequence kernels →
                             DNN module; everything else → DFP (depthwise
                             convolutions → DFP as WeightedPooling).
  3. ``form_fusion_groups``— maximal single-consumer chains of fusable DFP
                             nodes collapse into FUSED nodes, lowered to one
                             depth-first kernel.
  4. ``assign_layouts``    — per-backend layout election, counting the
                             REORDERs a materialization would need.
  5. ``elect_implementations`` — each node's admissible impls are costed
                             with measured timings when the autotune cache
                             has them, else with the backend's roofline; the
                             cheapest wins (ties break toward the more
                             specific tier) and lands on ``node.impl``.
  6. ``elect_grad_implementations`` — with ``training``, the same over the
                             backward impls, onto ``node.impl_bwd``.

The decisions are framework-neutral: for the same graph they equal the JAX
package's, with ``cuda.*`` impls where it elects ``pallas.*``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .ir import (DFP_FUSABLE, SEQUENCE_OPS, SOURCE_OPS, Graph, Module, Node,
                 OpKind)


# ----------------------------------------------------------------------------
# 1. high-level mathematical simplifications
# ----------------------------------------------------------------------------

def _fold_relu_maxpool(g: Graph) -> int:
    """max(maxpool(x), 0) == maxpool(max(x, 0)) == maxpool_{min=0}(x)."""
    folded = 0
    cons = g.consumers()
    for n in list(g.topo()):
        if n.op is OpKind.RELU:
            src = n.inputs[0]
            users = cons.get(n, [])
            if len(users) == 1 and users[0].op is OpKind.MAXPOOL:
                pool = users[0]
                pool.attrs["min_value"] = 0.0
                g.replace(n, src)
                pool.inputs = [src if i is n else i for i in pool.inputs]
                folded += 1
            elif src.op is OpKind.MAXPOOL and len(cons.get(src, [])) == 1:
                src.attrs["min_value"] = 0.0
                g.replace(n, src)
                folded += 1
    return folded


def _cancel_transposes(g: Graph) -> int:
    """transpose(transpose(x, p), p⁻¹) → x."""
    cancelled = 0
    for n in list(g.topo()):
        if n.op is OpKind.TRANSPOSE and n.inputs[0].op is OpKind.TRANSPOSE:
            inner = n.inputs[0]
            p_out = n.attrs.get("perm")
            p_in = inner.attrs.get("perm")
            if p_out and p_in:
                comp = tuple(p_in[i] for i in p_out)
                if comp == tuple(range(len(comp))):
                    g.replace(n, inner.inputs[0])
                    cancelled += 1
    return cancelled


def _drop_identities(g: Graph) -> int:
    dropped = 0
    for n in list(g.topo()):
        if n.op in (OpKind.IDENTITY, OpKind.DROPOUT) and \
                not n.attrs.get("training", False):
            g.replace(n, n.inputs[0])
            dropped += 1
    return dropped


def simplify(g: Graph) -> Graph:
    g.attrs_log = getattr(g, "attrs_log", [])
    g.attrs_log.append({
        "relu_maxpool_folded": _fold_relu_maxpool(g),
        "transposes_cancelled": _cancel_transposes(g),
        "identities_dropped": _drop_identities(g),
    })
    g.validate()
    return g


# ----------------------------------------------------------------------------
# 2. optimizing-module assignment (DFP vs DNN)
# ----------------------------------------------------------------------------

def assign_modules(g: Graph) -> Graph:
    for n in g.topo():
        if n.op in SOURCE_OPS or n.op is OpKind.OUTPUT:
            continue
        if n.op in (OpKind.LINEAR, OpKind.MATMUL) or n.op in SEQUENCE_OPS:
            n.module = Module.DNN
        elif n.op is OpKind.CONV2D:
            groups = n.attrs.get("groups", 1)
            if groups > 1 and groups == n.attrs.get("out_channels"):
                n.module = Module.DFP
                n.attrs["as_weighted_pool"] = True
            else:
                n.module = Module.DNN
        else:
            n.module = Module.DFP
    return g


# ----------------------------------------------------------------------------
# 3. DFP fusion-group formation
# ----------------------------------------------------------------------------

def form_fusion_groups(g: Graph) -> Graph:
    """Collapse maximal single-consumer chains of fusable DFP nodes into FUSED
    nodes: inside a group, intermediates never round-trip to device memory."""
    cons = g.consumers()

    def fusable(n: Node) -> bool:
        return (n.module is Module.DFP and n.op in DFP_FUSABLE
                and n.op not in SEQUENCE_OPS and n.op is not OpKind.FUSED)

    visited: set = set()
    for n in g.topo():
        if id(n) in visited or not fusable(n):
            continue
        chain: List[Node] = [n]
        visited.add(id(n))
        cur = n
        while True:
            users = [u for u in cons.get(cur, []) if u.op is not OpKind.OUTPUT]
            if len(users) == 1 and fusable(users[0]) \
                    and id(users[0]) not in visited:
                cur = users[0]
                chain.append(cur)
                visited.add(id(cur))
            else:
                break
        if len(chain) < 2:
            continue
        in_chain = {id(c) for c in chain}
        side_inputs: List[Node] = []
        for c in chain:
            for i in c.inputs:
                if id(i) not in in_chain and i not in side_inputs:
                    side_inputs.append(i)
        fused = Node(OpKind.FUSED, side_inputs, chain[-1].spec,
                     attrs={"length": len(chain)},
                     name=f"fused[{'+'.join(c.op.value for c in chain)}]",
                     body=chain)
        fused.module = Module.DFP
        g.replace(chain[-1], fused)
        cons = g.consumers()
    g.validate()
    return g


# ----------------------------------------------------------------------------
# 4. layout assignment
# ----------------------------------------------------------------------------

def assign_layouts(g: Graph, backend: "object") -> Graph:
    """Tag each node with the backend's preferred layout and count the
    reorders between disagreeing neighbours."""
    prev_layout: Dict[int, str] = {}
    reorders = 0
    for n in g.topo():
        if n.op in SOURCE_OPS:
            continue
        want = backend.preferred_layout(n)
        n.layout = want
        for i in n.inputs:
            have = prev_layout.get(id(i))
            if have is not None and have != want:
                reorders += 1
        prev_layout[id(n)] = want
    g.layout_reorders = reorders
    return g


# ----------------------------------------------------------------------------
# 5. implementation election
# ----------------------------------------------------------------------------

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
                "int8": 1, "float64": 8}

# FLOPs per element for the memory-bound DFP ops; only relative magnitudes
# matter to the election
_EW_FLOPS = 5.0


def _node_cost_terms(n: Node) -> Tuple[float, float, float]:
    """Roofline terms for one node: (flops, streamed_bytes, roundtrip_bytes).
    'streamed' charges inputs and the output once (a depth-first kernel);
    'roundtrip' also charges every intermediate of a fusion group a write
    and a read (op-at-a-time composition)."""
    eltsize = _DTYPE_BYTES.get(n.spec.dtype, 4)
    in_bytes = sum(i.spec.size for i in n.inputs) * eltsize
    out_bytes = n.spec.size * eltsize
    streamed = float(in_bytes + out_bytes)

    if n.op in (OpKind.LINEAR, OpKind.MATMUL):
        k = n.inputs[0].spec.shape[-1] if n.inputs[0].spec.shape else 1
        return 2.0 * n.spec.size * k, streamed, streamed
    if n.op is OpKind.CONV2D:
        w = n.inputs[1].spec
        out_c = n.attrs.get("out_channels") or (w.shape[0] if w.shape else 1)
        taps = w.size / max(out_c, 1)
        return 2.0 * n.spec.size * taps, streamed, streamed
    if n.op is OpKind.FUSED:
        flops = sum(b.spec.size for b in n.body) * _EW_FLOPS
        roundtrip = float(in_bytes) + sum(
            2.0 * b.spec.size * eltsize for b in n.body)
        return flops, streamed, roundtrip
    if n.op is OpKind.ATTENTION:
        # (B, S, H, hd): q·kᵀ and p·v → 4·B·H·S²·hd FLOPs; a roundtrip impl
        # also writes and reads the f32 S×S score matrix per head
        b, s, h, hd = n.spec.shape
        flops = 4.0 * b * h * s * s * hd
        score_bytes = 2.0 * b * h * s * s * 4.0
        return flops, streamed, streamed + score_bytes
    if n.op is OpKind.DECODE_ATTENTION:
        # one query row against an S-row cache: 4·B·H·(S+1)·hd FLOPs
        b, _one, h, hd = n.spec.shape
        s = n.inputs[1].spec.shape[1] if len(n.inputs) > 1 else 1
        flops = 4.0 * b * h * (s + 1) * hd
        score_bytes = 2.0 * b * h * s * 4.0
        return flops, streamed, streamed + score_bytes
    if n.op is OpKind.RGLRU_SCAN:
        return 2.0 * n.spec.size, streamed, streamed
    if n.op is OpKind.RWKV6_SCAN:
        b, s, h, hd = n.spec.shape
        flops = 4.0 * b * s * h * hd * hd
        state_bytes = 2.0 * b * s * h * hd * hd * 4.0
        return flops, streamed, streamed + state_bytes
    return n.spec.size * _EW_FLOPS, streamed, streamed


def node_roofline_terms(n: Node, hw: "object",
                        memory: str = "streamed",
                        unit: str = "tensor16"
                        ) -> Tuple[float, float, float]:
    """The node's (flops, nbytes, bound_s) under the given impl memory mode:
    the election's own counts, with the bound from the same
    ``HardwareSpec.roofline_s`` it costs with, its FLOPs at the peak of
    ``unit`` (by default the bf16 peak, as the election takes them)."""
    flops, streamed, roundtrip = _node_cost_terms(n)
    nbytes = roundtrip if memory == "roundtrip" else streamed
    return flops, nbytes, hw.roofline_s(flops, nbytes, unit=unit)


def _elect(g: Graph, backend: "object", candidates, tunables_for,
           op_key, cost_scale: float, attr: str, fresh: bool) -> Graph:
    """One election pass over ``g``'s nodes: each node's admissible impls
    (``candidates(backend, n)``; a node with none keeps ``attr`` None) are
    elected from the autotune cache's measurements under ``op_key(n)``
    when it has them (``'measured'``, the winner's config pinned through
    its ``Tunable`` after every tunable of ``tunables_for(n.op)`` is
    cleared), else by the roofline of the node's cost terms times
    ``cost_scale``, scaled by calibrated coefficients where the cache has
    them (``'calibrated'``, else ``'analytical'``), ties breaking toward
    the more specific tier.  The winner lands on ``n.<attr>``; elections,
    provenance and pins are kept per ``op_key``, anew with ``fresh`` or
    merged into the graph's."""
    from . import autotune

    cache = autotune.get_cache()

    def kept(name: str):
        return {} if fresh else (getattr(g, name, {}) or {})
    elections: Dict[str, int] = kept("elections")
    by_op: Dict[str, Dict[str, int]] = kept("elections_by_op")
    provenance: Dict[str, Dict[str, int]] = kept("election_provenance")
    pinned: Dict[str, List[Tuple[int, ...]]] = kept("election_pinned")
    for n in g.topo():
        if n.op in SOURCE_OPS or n.op is OpKind.OUTPUT:
            continue
        cands = candidates(backend, n)
        if not cands:
            setattr(n, attr, None)
            continue
        key = op_key(n)
        flops, streamed, roundtrip = (cost_scale * t
                                      for t in _node_cost_terms(n))
        by_name = {c.name: c for c in cands}
        measured = {name: m for name, m in cache.lookup(
            key, autotune.node_shape(n), n.spec.dtype,
            backend.cache_name).items() if name in by_name}

        cfg = None
        if measured:
            best_name = min(measured,
                            key=lambda nm: (measured[nm].us,
                                            by_name[nm].tier))
            best = by_name[best_name]
            cfg = measured[best_name].config
            source = "measured"
        else:
            cal = cache.calibration(backend.cache_name, key)

            def cost(impl) -> Tuple[float, int]:
                nbytes = roundtrip if impl.memory == "roundtrip" else streamed
                if cal:
                    t = cal["s_per_flop"] * flops + cal["s_per_byte"] * nbytes
                else:
                    t = backend.hw.roofline_s(flops, nbytes)
                return (t, impl.tier)

            best = min(cands, key=cost)
            source = "calibrated" if cal else "analytical"
        for t in tunables_for(n.op):
            t.bind_config(n, None)
        if cfg and best.tunable is not None:
            best.tunable.bind_config(n, tuple(cfg))
            pinned.setdefault(best.name, []).append(tuple(cfg))
        setattr(n, attr, best.name)
        elections[best.name] = elections.get(best.name, 0) + 1
        per = by_op.setdefault(key, {})
        per[best.name] = per.get(best.name, 0) + 1
        src = provenance.setdefault(best.name, {})
        src[source] = src.get(source, 0) + 1
    g.elections = elections
    g.elections_by_op = by_op
    g.election_provenance = provenance
    g.election_pinned = pinned
    return g


def elect_implementations(g: Graph, backend: "object") -> Graph:
    """Cost-based per-node impl election over the backend dispatch table.

    Measured timings from the autotune cache win when present
    (``'measured'`` provenance, with the winner's tuned config pinned through
    its ``Tunable``); otherwise every admissible impl is costed with the
    backend's roofline — scaled by calibrated coefficients when the cache
    has them (``'calibrated'``, else ``'analytical'``) — and the cheapest
    wins, ties breaking toward the more specific tier."""
    from ..backends import registry as R

    def candidates(backend, n):
        cands = R.candidates(backend, n)
        if not cands:
            raise NotImplementedError(
                f"no implementation of {n.op} for backend {backend.name!r}")
        return cands
    return _elect(g, backend, candidates, R.tunables_for,
                  lambda n: n.op.value, 1.0, "impl", fresh=True)


def elect_grad_implementations(g: Graph, backend: "object") -> Graph:
    """Backward election, the mirror of :func:`elect_implementations` over
    the grad tables (``registry.grad_candidates``).

    Measured timings come from the autotune cache under the ``_bwd`` op key
    (``registry.grad_cache_op``); without them a backward is costed as two
    forward-sized programs (dX and dW, dKV and dQ), calibrated or on the
    roofline.  The winner lands on ``node.impl_bwd`` and its measured
    config pins through its own ``Tunable`` (attrs ending ``_bwd``, so
    clearing them never drops a forward pin).  Elections and provenance
    merge into the graph's election dicts under the ``_bwd`` op key, so
    ``impl_report`` and ``check_provenance`` see the backward as they see
    the forward.  A node with no backward impl keeps ``impl_bwd`` None:
    autograd differentiates its forward's torch ops."""
    from ..backends import registry as R
    return _elect(g, backend, R.grad_candidates, R.grad_tunables_for,
                  lambda n: R.grad_cache_op(n.op), 2.0, "impl_bwd",
                  fresh=False)


# ----------------------------------------------------------------------------
# pipeline
# ----------------------------------------------------------------------------

def run_pipeline(g: Graph, backend: "object",
                 training: bool = False) -> Graph:
    """The passes in order; dropout follows ``training`` (an inference
    identity without it), and ``training`` adds the backward election."""
    for n in g.topo():
        if n.op is OpKind.DROPOUT:
            n.attrs["training"] = training
    g = simplify(g)
    g = assign_modules(g)
    g = form_fusion_groups(g)
    g = assign_layouts(g, backend)
    g = elect_implementations(g, backend)
    if training:
        g = elect_grad_implementations(g, backend)
    return g

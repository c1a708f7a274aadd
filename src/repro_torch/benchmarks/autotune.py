"""Autotune driver (counterpart of ``benchmarks/autotune.py``): fills the
persistent timing cache the election pass prefers over the roofline model
(``core.autotune``).

For each (op, shape) of the sweep it times every impl the dispatch table
admits on the chosen backend through ``core.measure.sweep_node``; an impl
that declares a ``Tunable`` (each of the seven kernel families does) has
its config space swept, and the winning config is recorded beside its
time, so a later election pins it on the node.  ``SHAPES`` are the port's
path shapes: the served transformer's products at its prefill (4 × 128
rows) and decode (4 rows) buckets, its attention and decode attention
(12 query and 2 kv heads of 128), a DFP chain on the served MLP's rows,
the Griffin and RWKV6 scans and the Listing-3 pools.

    PYTHONPATH=src python -m repro_torch.benchmarks.autotune \\
        --tiny --device cpu --cache results/autotune_cache.json --verify

``--verify`` reloads the cache from disk and elects fresh graphs under it,
failing unless every tuned (backend, op) shows 'measured' provenance, and
proves that a cached attention measurement flips an election with its
block config pinned (``attention_flip_proof``).  On the CPU every kernel
impl runs its plain version, so the times say nothing about the card; the
run checks the write → read → election round trip.

The JAX driver's gap-driven ``refine_plan`` and its ``sol_rows`` table
wait for the port's ``core/sol.py``; the backward sweep
(``sweep_node_grad``) waits for the port's grad tables.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import autotune as AT
from ..frontends.offload import DeviceLike, resolve_device

# (M, K, N) for the products, the output shape for the rest; attention and
# decode attention take (B, S, H, KV, hd) (their cache key drops KV), a
# 4-tuple meaning KV = H
SHAPES: Dict[str, List[Tuple[int, ...]]] = {
    "matmul": [(512, 1536, 1536), (512, 1536, 256), (4, 1536, 1536),
               (4, 1536, 256)],
    "linear": [(512, 1536, 6144), (512, 6144, 1536), (512, 1536, 151936),
               (4, 1536, 6144), (4, 6144, 1536), (4, 1536, 151936)],
    "attention": [(4, 128, 12, 2, 128)],
    "decode_attention": [(4, 128, 12, 2, 128)],
    "fused": [(512, 6144)],
    "rglru_scan": [(4, 512, 4096)],
    "rwkv6_scan": [(4, 512, 32, 64)],
    "avgpool": [(64, 32, 222, 222), (64, 64, 109, 109)],
}
TINY_SHAPES: Dict[str, List[Tuple[int, ...]]] = {
    "matmul": [(32, 32, 32), (16, 48, 24)],
    "linear": [(8, 64, 32)],
    "attention": [(1, 64, 2, 16)],
    "decode_attention": [(2, 16, 4, 2, 16)],
    "fused": [(64, 32)],
    "rglru_scan": [(1, 16, 32)],
    "rwkv6_scan": [(1, 16, 2, 8)],
    "avgpool": [(1, 8, 10, 10)],
}
DEFAULT_OPS = ("matmul", "linear", "attention", "decode_attention", "fused",
               "rglru_scan", "rwkv6_scan", "avgpool")


def _heads(shape: Tuple[int, ...]) -> Tuple[int, int, int, int, int]:
    """(B, S, H, KV, hd) of an attention problem."""
    if len(shape) == 5:
        return tuple(shape)
    b, s, h, hd = shape
    return b, s, h, h, hd


def _node(op: str, shape: Tuple[int, ...], dtype: str = "float32"):
    """One dispatchable node for an (op, shape) problem; ``verify_cache``
    rebuilds a node from a cache bucket with it."""
    from ..core import ir
    from ..core.ir import Node, OpKind, TensorSpec

    def inp(shp, name="x", dt=dtype):
        return ir.input_node(shp, dt, name=name)

    if op == "matmul":
        m, k, n = shape
        return Node(OpKind.MATMUL, [inp((m, k)), inp((k, n), "w")],
                    TensorSpec((m, n), dtype))
    if op == "linear":
        m, k, n = shape
        return Node(OpKind.LINEAR,
                    [inp((m, k)), ir.param_node((n, k), dtype, name="w")],
                    TensorSpec((m, n), dtype), attrs={"out_features": n})
    if op == "attention":
        b, s, h, kv, hd = _heads(shape)
        return Node(OpKind.ATTENTION,
                    [inp((b, s, h, hd), "q"), inp((b, s, kv, hd), "k"),
                     inp((b, s, kv, hd), "v")],
                    TensorSpec((b, s, h, hd), dtype),
                    attrs={"causal": True, "window": 0, "cap": 0.0})
    if op == "decode_attention":
        b, s, h, kv, hd = _heads(shape)
        return Node(OpKind.DECODE_ATTENTION,
                    [inp((b, 1, h, hd), "q"), inp((b, s, kv, hd), "k_cache"),
                     inp((b, s, kv, hd), "v_cache"),
                     inp((b, 1, kv, hd), "k_new"),
                     inp((b, 1, kv, hd), "v_new"),
                     inp((b,), "lens", "int32")],
                    TensorSpec((b, 1, h, hd), dtype),
                    attrs={"window": 0, "cap": 0.0})
    if op == "rglru_scan":
        b, t, d = shape
        return Node(OpKind.RGLRU_SCAN,
                    [inp((b, t, d), "a"), inp((b, t, d), "b"),
                     inp((b, d), "h0")], TensorSpec((b, t, d), dtype))
    if op == "fused":
        # a representative DFP chain: gelu → residual add → tanh → scale
        rows, d = shape
        x = inp((rows, d))
        spec = TensorSpec((rows, d), dtype)
        g = Node(OpKind.GELU, [x], spec)
        a = Node(OpKind.ADD, [g, x], spec)
        t = Node(OpKind.TANH, [a], spec)
        sc = Node(OpKind.SCALE, [t], spec, attrs={"value": 1.3})
        return Node(OpKind.FUSED, [x], spec, attrs={"length": 4},
                    name="fused[gelu+add+tanh+scale]", body=[g, a, t, sc])
    if op == "rwkv6_scan":
        b, t, h, hd = shape
        ins = ([inp((b, t, h, hd), nm) for nm in "rkvw"]
               + [inp((h, hd), "u"), inp((b, h, hd, hd), "s0")])
        return Node(OpKind.RWKV6_SCAN, ins, TensorSpec((b, t, h, hd), dtype))
    if op == "avgpool":
        # shape is the pooled OUTPUT (what the cache keys on); 3x3 VALID
        n, c, oh, ow = shape
        return Node(OpKind.AVGPOOL, [inp((n, c, oh + 2, ow + 2))],
                    TensorSpec((n, c, oh, ow), dtype),
                    attrs={"kernel": 3, "stride": 1})
    raise KeyError(f"unknown autotune op {op!r}")


def _build(op: str, shape: Tuple[int, ...], dtype: str = "float32",
           device: DeviceLike = None):
    """The node plus operands to time it with, drawn from a seeded
    generator on ``device`` (the card unless the CPU is asked for)."""
    from ..core.executor import TORCH_DTYPES
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    tdt = TORCH_DTYPES[dtype]
    node = _node(op, shape, dtype)

    def arr(shp, scale=1.0):
        return (torch.randn(shp, generator=gen, device=dev) * scale).to(tdt)

    if op in ("matmul", "linear"):
        m, k, n = shape
        w_shape = (k, n) if op == "matmul" else (n, k)  # linear stores (o,i)
        return node, [arr((m, k)), arr(w_shape, k ** -0.5)]
    if op == "attention":
        return node, [arr(tuple(i.spec.shape)) for i in node.inputs]
    if op == "decode_attention":
        s = node.inputs[1].spec.shape[1]
        lens = torch.full((node.spec.shape[0],), s, dtype=torch.int32,
                          device=dev)
        return node, [arr(tuple(i.spec.shape)) for i in node.inputs[:5]] \
            + [lens]
    if op == "rglru_scan":
        b, t, d = shape
        a = (torch.rand((b, t, d), generator=gen, device=dev) * 0.5
             + 0.5).to(tdt)
        return node, [a, arr((b, t, d), 0.1), arr((b, d), 0.1)]
    if op == "fused":
        return node, [arr(shape)]
    if op == "rwkv6_scan":
        b, t, h, hd = shape
        logw = (-torch.exp(torch.randn((b, t, h, hd), generator=gen,
                                       device=dev) * 0.5)).to(tdt)
        return node, [arr((b, t, h, hd), 0.5), arr((b, t, h, hd), 0.5),
                      arr((b, t, h, hd), 0.5), logw, arr((h, hd), 0.3),
                      torch.zeros((b, h, hd, hd), dtype=tdt, device=dev)]
    if op == "avgpool":
        n, c, oh, ow = shape
        return node, [arr((n, c, oh + 2, ow + 2))]
    raise KeyError(f"unknown autotune op {op!r}")


def tune(backend_name: str = "h100", ops: Sequence[str] = DEFAULT_OPS, *,
         tiny: bool = False, warmup: int = 2, iters: int = 5, cache=None,
         dtype: str = "float32", device: DeviceLike = None,
         shapes: Optional[Dict[str, List[Tuple[int, ...]]]] = None
         ) -> List[Tuple[str, float, str]]:
    """Measure every admissible impl of each (op, shape) through the
    dispatch table, each impl's ``Tunable`` space swept, and record best
    times (with winning configs) into ``cache``.  ``shapes`` replaces the
    sweep's shapes (``SHAPES``, or ``TINY_SHAPES`` with ``tiny``).  Returns
    (name, µs, derived) rows."""
    from ..backends import get_backend
    from ..core.measure import sweep_node

    backend = get_backend(backend_name)
    cache = cache if cache is not None else AT.get_cache()
    table = shapes or (TINY_SHAPES if tiny else SHAPES)
    rows: List[Tuple[str, float, str]] = []
    for op in ops:
        for shape in table.get(op, ()):
            node, vals = _build(op, shape, dtype, device)
            tag = "x".join(str(d) for d in shape)
            for m in sweep_node(node, vals, backend, cache, warmup=warmup,
                                iters=iters):
                derived = f"configs={m.n_configs};mean_us={m.mean_us:.3f}"
                if m.config is not None:
                    derived += ";best=" + "x".join(str(d) for d in m.config)
                rows.append((f"autotune_{backend_name}_{dtype}_{op}_{tag}_"
                             f"{m.impl}", m.us, derived))
    return rows


def csv_rows(device: DeviceLike = None) -> List[Tuple[str, float, str]]:
    """A tiny sweep of every op on the ``h100`` and ``torch_ref``
    backends into a cache of its own (the process-wide one is left
    alone)."""
    cache = AT.AutotuneCache()
    rows = []
    for backend in ("h100", "torch_ref"):
        rows += tune(backend, tiny=True, cache=cache, device=device)
    return rows


def _doctored(cache, key, bucket: Tuple[int, ...], impl_name: str,
              us: float):
    """A copy of ``cache`` (rebuilt through the public record API) with
    ``impl_name``'s measurement in (key, bucket) forced to ``us``."""
    out = AT.AutotuneCache()
    for k2, b2, nm, m in cache.entries():
        t = us if (k2 == key and b2 == bucket and nm == impl_name) else m.us
        op, dtype, backend_name = k2
        out.record(op, b2, dtype, backend_name, nm, t, config=m.config,
                   flops=m.flops, nbytes=m.nbytes, mean_us=m.mean_us)
    return out


def attention_flip_proof(cache, device: DeviceLike = None) -> int:
    """A cached attention measurement flips an election: a
    ``MultiHeadAttention`` model is elected under two doctored caches, one
    where the tuned flash-attention measurement loses and one where it
    wins; the elected impl must change, and the winning election must pin
    the measured block config on the node and show it in
    ``impl_report(provenance=True)``."""
    from ..core.ir import OpKind
    from ..frontends import nn
    from ..frontends.optimize import optimize

    target = None
    for key, bucket, nm, m in cache.entries():
        op, dtype, _backend = key
        if op == "attention" and dtype == "float32" and m.config:
            others = [m2.us for k2, b2, nm2, m2 in cache.entries()
                      if k2 == key and b2 == bucket and nm2 != nm]
            if others:
                target = (key, bucket, nm, min(others))
                break
    if target is None:
        print("[autotune] no attention bucket holds a tuned config plus a "
              "competitor to flip against", file=sys.stderr)
        return 1
    key, bucket, tuned_impl, best_other_us = target
    _op, _dtype, backend_name = key
    b, s, h, hd = bucket
    dev = resolve_device(device)

    def elect(c):
        prev = AT.get_cache()
        AT.set_cache(c)
        try:
            sol = optimize(nn.MultiHeadAttention(h * hd, h, device=dev),
                           (b, s, h * hd), backend=backend_name, device=dev)
        finally:
            AT.set_cache(prev)
        return sol, sol.graph.nodes_of(OpKind.ATTENTION)[0]

    _, node_l = elect(_doctored(cache, key, bucket, tuned_impl,
                                2.0 * best_other_us))
    sol_w, node_w = elect(_doctored(cache, key, bucket, tuned_impl,
                                    0.5 * best_other_us))
    rep = sol_w.impl_report(provenance=True)
    from ..backends import registry as R
    attr = R.get_impl(tuned_impl).tunable.attr
    pinned = rep.get(tuned_impl, {}).get("pinned", [])
    cfg = node_w.attrs.get(attr)
    ok = (node_l.impl != tuned_impl and node_w.impl == tuned_impl
          and rep.get(tuned_impl, {}).get("sources", {}).get("measured", 0)
          and cfg is not None and tuple(cfg) in {tuple(p) for p in pinned})
    print(f"[autotune] attention flip on {backend_name} "
          f"{'x'.join(str(d) for d in bucket)}: slow measurement elects "
          f"{node_l.impl}, fast measurement flips to {node_w.impl} with "
          f"pinned {attr}={cfg}; impl_report(provenance=True) → {rep}")
    if not ok:
        print("[autotune] attention flip proof FAILED", file=sys.stderr)
        return 1
    return 0


def verify_cache(path: str, device: DeviceLike = None) -> int:
    """Reload ``path`` from disk, install it, and prove each tuned
    (backend, op) in the file yields a measured election on a fresh graph,
    then the attention flip proof."""
    from ..backends import get_backend
    from ..backends import registry as R
    from ..core import passes
    from ..core.ir import Graph, OpKind

    cache = AT.AutotuneCache.load(path)
    if cache.stale:
        print(f"[autotune] {path} has a stale schema", file=sys.stderr)
        return 1
    if not len(cache):
        print(f"[autotune] {path} holds no measurements", file=sys.stderr)
        return 1
    groups = {}                                  # (op, dtype, backend) → bucket
    for key, bucket, _impl, _m in cache.entries():
        groups.setdefault(key, bucket)
    prev = AT.get_cache()                        # restore, don't reset: None
    AT.set_cache(cache)                          # would re-read the env var
    measured, cold = [], []
    try:
        for (op, dtype, backend_name), bucket in sorted(groups.items()):
            try:
                backend = get_backend(backend_name)
                node = _node(op, bucket, dtype)
            except (KeyError, ValueError):       # foreign backend / op kind
                continue
            ins = [i for i in node.inputs if i.op is OpKind.INPUT]
            params = {i.name: i for i in node.inputs
                      if i.op is OpKind.PARAM}
            g = Graph(ins, [node], params)
            passes.elect_implementations(g, backend)
            elected = node.impl
            impl = R.get_impl(elected)
            tag = f"{backend_name}:{dtype}:{op}→{elected}"
            if impl is not None and impl.tunable is not None:
                cfg = node.attrs.get(impl.tunable.attr)
                if cfg:
                    tag += f"[{impl.tunable.attr}="
                    tag += "x".join(str(d) for d in cfg) + "]"
            if elected and "measured" in g.election_provenance.get(
                    elected, {}):
                measured.append(tag)
            else:
                cold.append(tag)
    finally:
        AT.set_cache(prev)
    print(f"[autotune] verified {path}: {len(cache)} measurements, "
          f"measured elections: {measured}")
    if cold or not measured:
        print(f"[autotune] elections that ignored the cache: {cold}",
              file=sys.stderr)
        return 1
    return attention_flip_proof(cache, device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", action="append",
                    help="backend(s) to tune (default: h100)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"))
    ap.add_argument("--ops", nargs="*", default=list(DEFAULT_OPS))
    ap.add_argument("--cache", default="results/autotune_cache.json")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny shapes (the CPU round-trip check)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--verify", action="store_true",
                    help="after saving, reload the cache from disk and "
                         "check measured elections and the attention flip")
    args = ap.parse_args(argv)

    cache = AT.AutotuneCache.load(args.cache)   # merge into prior runs
    rows: List[Tuple[str, float, str]] = []
    for backend in args.backend or ["h100"]:
        rows += tune(backend, args.ops, tiny=args.tiny, warmup=args.warmup,
                     iters=args.iters, cache=cache, dtype=args.dtype,
                     device=args.device)
    cache.save(args.cache)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    print(f"[autotune] wrote {len(cache)} measurements to {args.cache} "
          f"({resolve_device(args.device)})", file=sys.stderr)
    if args.verify:
        return verify_cache(args.cache, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

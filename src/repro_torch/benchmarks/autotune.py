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

``refine_plan`` is the gap-driven planner: it ranks the cache's cells by
their SOL ratio (``core.sol``) and probes each worst cell's
``Tunable.refine_space``; ``sol_rows`` (the ``sol`` table of
``repro_torch.benchmarks.run``) tunes the tiny shapes, plans and ranks, and
``matmul_rows`` (the ``matmul`` table) holds the matmul kernel to
``torch.matmul``.  The CLI also sweeps each node's backward impls
(``tune(grads=True)``: ``sweep_node_grad``, under the ``_bwd`` cache
keys), and ``--verify`` checks their round trip through the backward
election as well.
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
         shapes: Optional[Dict[str, List[Tuple[int, ...]]]] = None,
         grads: bool = False) -> List[Tuple[str, float, str]]:
    """Measure every admissible impl of each (op, shape) through the
    dispatch table, each impl's ``Tunable`` space swept, and record best
    times (with winning configs) into ``cache``; with ``grads`` each
    node's backward impls too, under the ``_bwd`` keys (rows named
    ``..._<op>_bwd_...``).  ``shapes`` replaces the sweep's shapes
    (``SHAPES``, or ``TINY_SHAPES`` with ``tiny``).  Returns (name, µs,
    derived) rows."""
    from ..backends import for_device, get_backend
    from ..core.measure import sweep_node, sweep_node_grad

    device = resolve_device(device)
    backend = for_device(get_backend(backend_name), device)
    cache = cache if cache is not None else AT.get_cache()
    table = shapes or (TINY_SHAPES if tiny else SHAPES)
    rows: List[Tuple[str, float, str]] = []
    for op in ops:
        for shape in table.get(op, ()):
            node, vals = _build(op, shape, dtype, device)
            tag = "x".join(str(d) for d in shape)
            sweeps = [("", sweep_node)] + ([("_bwd", sweep_node_grad)]
                                           if grads else [])
            for sfx, sweep in sweeps:
                for m in sweep(node, vals, backend, cache, warmup=warmup,
                               iters=iters):
                    derived = f"configs={m.n_configs};mean_us={m.mean_us:.3f}"
                    if m.config is not None:
                        derived += ";best=" + "x".join(str(d)
                                                       for d in m.config)
                    rows.append((f"autotune_{backend_name}_{dtype}_{op}{sfx}_"
                                 f"{tag}_{m.impl}", m.us, derived))
    return rows


def refine_plan(cache, backend_name: str, *, top_k: int = 4,
                rounds: int = 3, budget: int = 32, min_gain: float = 0.05,
                rewrite_ratio: float = 10.0, warmup: int = 1,
                iters: int = 3, measure=None, device: DeviceLike = None
                ) -> List[dict]:
    """Gap-driven tuning planner: rank the cache's (op, bucket, dtype,
    backend) cells by SOL ratio (``core.sol``) and spend the measurement
    ``budget`` where the gap is worst.

    For each of the ``top_k`` worst cells, the fastest impl that declares a
    ``Tunable`` and holds a tuned config there (the winner, or the tunable
    family a reference impl beats) has its ``refine_space`` probed around
    its config for up to ``rounds`` rounds, re-centring on each improvement
    and stopping when a round closes the gap by less than ``min_gain``
    (relative).  Each improvement is recorded into ``cache`` (its config
    also in the report's ``recorded``), so a later election pins it.  A cell
    whose ratio stays above ``rewrite_ratio``, or that has nothing to
    tune, is a ``rewrite_candidate``: no config in the family's
    neighbourhood reaches the hardware, the kernel or its host path needs
    work.

    Probes run on a node rebuilt at the cell's bucket (``_build``), in the
    cell's dtype, on ``device`` (the card unless the CPU is asked for).
    The bucket is the served shape rounded to the nearest power of two, so
    it may do less or more work than the shape the cache's time was taken
    at: each round measures the incumbent config in the same call as its
    probes, a probe wins only against that reading, and the cell's cached
    time is scaled by the winner's relative gain before it is recorded
    (with the cell's own roofline terms).
    ``measure(node, vals, backend, impl, configs)`` is injectable for
    tests; the default measures through ``core.measure.measure_impl_configs``
    with per-config errors skipped.  Returns one report dict per cell."""
    from ..backends import for_device, get_backend
    from ..backends import registry as R
    from ..core import sol as SOL
    from ..core.measure import measure_impl_configs

    dev = resolve_device(device)
    backend = for_device(get_backend(backend_name), dev)
    hw = backend.hw

    if measure is None:
        def measure(node, vals, bk, impl, configs):
            return measure_impl_configs(node, vals, bk, impl, configs,
                                        warmup=warmup, iters=iters,
                                        skip_errors=True)

    cells = [r for r in SOL.rank(SOL.cache_rows(
        cache, backends=[backend_name], best_only=True, device=dev))
        if r.ratio > 0.0]
    reports: List[dict] = []
    for row in cells[:top_k]:
        rep = {"op": row.op, "bucket": row.bucket, "dtype": row.dtype,
               "backend": row.backend, "impl": row.impl,
               "before_us": row.us, "before_ratio": row.ratio,
               "after_us": row.us, "after_ratio": row.ratio,
               "bound_us": row.bound_us, "rounds": 0,
               "configs_measured": 0, "config": row.config,
               "refined_impl": None, "outside_space": False,
               "rewrite_candidate": False, "recorded": [], "note": ""}
        reports.append(rep)
        target_impl, target_m = None, None
        for impl_name, m in cache.lookup(row.op, row.bucket, row.dtype,
                                         backend_name).items():
            impl = R.get_impl(impl_name)
            if impl is None or impl.tunable is None or m.config is None:
                continue
            if target_m is None or m.us < target_m.us:
                target_impl, target_m = impl, m
        if target_impl is None:
            rep["note"] = "nothing to refine (no impl with a tuned config)"
            rep["rewrite_candidate"] = row.ratio > rewrite_ratio
            continue
        try:
            node, vals = _build(row.op, row.bucket, row.dtype, dev)
        except KeyError:
            rep["note"] = f"no synthetic builder for op {row.op!r}"
            rep["rewrite_candidate"] = row.ratio > rewrite_ratio
            continue
        rep["refined_impl"] = target_impl.name
        tun = target_impl.tunable
        flops, nbytes = target_m.flops, target_m.nbytes
        initial_space = set(tun.tune_space(node, hw))
        seen = initial_space | {tuple(target_m.config)}
        cur_us, cur_cfg = target_m.us, tuple(target_m.config)
        cur_mean = target_m.mean_us
        for _round in range(rounds):
            if budget <= 0:
                rep["note"] = "budget exhausted"
                break
            cfgs = [c for c in tun.refine_space(node, hw, cur_cfg)
                    if c not in seen][:budget]
            if not cfgs:
                rep["note"] = rep["note"] or "neighbourhood exhausted"
                break
            budget -= len(cfgs)
            seen |= set(cfgs)
            results = [r for r in measure(node, vals, backend, target_impl,
                                          [cur_cfg] + cfgs)
                       if r.error is None]
            rep["configs_measured"] += len(cfgs)
            rep["rounds"] += 1
            inc = next((r for r in results if tuple(r.config) == cur_cfg),
                       None)
            probes = [r for r in results if tuple(r.config) != cur_cfg]
            if inc is None or not probes:
                if inc is None:
                    rep["note"] = "the incumbent config failed to measure"
                break
            best = min(probes, key=lambda r: r.us)
            if best.us < inc.us * (1.0 - min_gain):
                cur_us *= best.us / inc.us
                if inc.mean_us > 0.0:
                    cur_mean *= best.mean_us / inc.mean_us
                cur_cfg = tuple(best.config)
                cache.record(row.op, row.bucket, row.dtype, backend_name,
                             target_impl.name, cur_us, config=cur_cfg,
                             flops=flops, nbytes=nbytes, mean_us=cur_mean)
                rep["recorded"].append(cur_cfg)
            else:
                break                     # the gap stopped closing
        rep["config"] = cur_cfg
        # the cell's election after refinement: the refined family takes
        # it only where it now beats the previous winner, and then the
        # cell's bound is its own (its unit's peak)
        bound = row.bound_us
        if cur_us < row.us:
            rep["impl"] = target_impl.name
            bound, _ = SOL.sol_bound_us(
                hw, flops, nbytes, target_impl.unit_at(row.bucket, row.dtype))
        rep["after_us"] = min(cur_us, row.us)
        rep["after_ratio"] = SOL.sol_ratio(rep["after_us"], bound)
        rep["outside_space"] = cur_cfg not in initial_space
        rep["rewrite_candidate"] = rep["after_ratio"] > rewrite_ratio
    return reports


def _plan_row(rep: dict) -> Tuple[str, float, str]:
    bucket = "x".join(str(d) for d in rep["bucket"])
    cfg = "x".join(str(d) for d in rep["config"]) if rep["config"] else "-"
    derived = (f"ratio={rep['before_ratio']:.2f}->{rep['after_ratio']:.2f};"
               f"cfg={cfg};outside_space={rep['outside_space']};"
               f"rewrite={rep['rewrite_candidate']};rounds={rep['rounds']};"
               f"measured={rep['configs_measured']}")
    if rep["note"]:
        derived += f";note={rep['note']}"
    return (f"sol_refine_{rep['backend']}_{rep['dtype']}_{rep['op']}_"
            f"{bucket}", rep["after_us"], derived)


def sol_rows(backends: Sequence[str] = ("h100",), device: DeviceLike = None
             ) -> List[Tuple[str, float, str]]:
    """The ``sol`` table: tune every op at the tiny shapes into a cache of
    its own, run the gap-driven planner on each backend's worst cells, then
    rank every cell's fastest impl by measured ÷ bound.  Renders the ranked
    table to stderr and returns the rows (SOL cells first, then one
    ``sol_refine_*`` row per planned cell)."""
    from ..core import sol as SOL

    dev = resolve_device(device)
    cache = AT.AutotuneCache()
    for backend in backends:
        tune(backend, tiny=True, cache=cache, device=dev)
    plan_reports = []
    for backend in backends:
        plan_reports += refine_plan(cache, backend, top_k=3, rounds=2,
                                    budget=24, iters=3, device=dev)
    ranked = SOL.rank(SOL.cache_rows(cache, best_only=True, device=dev))
    print(SOL.render(ranked), file=sys.stderr)
    rows: List[Tuple[str, float, str]] = []
    for r in ranked:
        bucket = "x".join(str(d) for d in r.bucket)
        cfg = "x".join(str(d) for d in r.config) if r.config else "-"
        rows.append((f"sol_{r.backend}_{r.dtype}_{r.op}_{bucket}_{r.impl}",
                     r.us, f"bound_us={r.bound_us:.4f};ratio={r.ratio:.2f};"
                     f"unit={r.unit};bneck={r.bottleneck};"
                     f"conf={r.confidence};src={r.source};cfg={cfg}"))
    rows += [_plan_row(rep) for rep in plan_reports]
    wins = [rep for rep in plan_reports
            if rep["outside_space"] and rep["after_us"] < rep["before_us"]]
    print(f"[sol] {dev}: the planner refined {len(wins)} cell(s) to a "
          f"config outside the declared tune_space; "
          f"{sum(r['rewrite_candidate'] for r in plan_reports)} rewrite "
          f"candidate(s)", file=sys.stderr)
    return rows


MATMUL_SHAPES = ((128, 128, 128), (96, 80, 56), (64, 256, 128))


def matmul_rows(device: DeviceLike = None) -> List[Tuple[str, float, str]]:
    """The ``matmul`` table: the matmul kernel's wrapper against
    ``torch.matmul`` (TF32 off) on aligned and ragged shapes, each
    ``core.measure`` time (CUDA events on the card), with the kernel's max
    |Δ| from ``torch.matmul`` in the derived column.  On the CPU the
    wrapper runs its plain version."""
    from ..core.measure import full_f32, time_call_stats
    from ..kernels.matmul.ops import matmul

    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    rows: List[Tuple[str, float, str]] = []
    for m, k, n in MATMUL_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev)
        with full_f32():
            t_ref = time_call_stats(lambda: torch.matmul(x, w), 2, 5, dev)
            t_ker = time_call_stats(lambda: matmul(x, w), 2, 5, dev)
            err = float((matmul(x, w) - torch.matmul(x, w)).abs().max())
        tag = f"matmul_{m}x{k}x{n}"
        rows.append((f"{tag}_ref_torch_matmul", t_ref.min_us,
                     f"mean_us={t_ref.mean_us:.3f};{dev.type}"))
        rows.append((f"{tag}_cuda_matmul", t_ker.min_us,
                     f"mean_us={t_ker.mean_us:.3f};{dev.type};"
                     f"max_abs_err={err:.2e}"))
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
    (backend, op) in the file yields a measured election on a fresh graph
    (a ``_bwd`` op through the backward election of its forward node),
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
            is_bwd = op.endswith(R.GRAD_SUFFIX)
            try:
                backend = get_backend(backend_name)
                node = _node(op.removesuffix(R.GRAD_SUFFIX), bucket, dtype)
            except (KeyError, ValueError):       # foreign backend / op kind
                continue
            ins = [i for i in node.inputs if i.op is OpKind.INPUT]
            params = {i.name: i for i in node.inputs
                      if i.op is OpKind.PARAM}
            g = Graph(ins, [node], params)
            passes.elect_implementations(g, backend)
            if is_bwd:
                passes.elect_grad_implementations(g, backend)
                elected = node.impl_bwd
                impl = R.get_grad_impl(elected) if elected else None
            else:
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
                         "check measured elections (forward and backward) "
                         "and the attention flip")
    args = ap.parse_args(argv)

    cache = AT.AutotuneCache.load(args.cache)   # merge into prior runs
    rows: List[Tuple[str, float, str]] = []
    for backend in args.backend or ["h100"]:
        rows += tune(backend, args.ops, tiny=args.tiny, warmup=args.warmup,
                     iters=args.iters, cache=cache, dtype=args.dtype,
                     device=args.device, grads=True)
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

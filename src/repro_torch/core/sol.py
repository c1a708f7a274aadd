"""Speed-of-light (SOL) gap analysis (counterpart of ``repro.core.sol``):
how far each kernel sits from what the card allows, and where tuning
effort should go next.

Every autotune measurement carries the roofline terms of the node it
timed (``flops`` and ``nbytes``, recorded by ``core.measure.sweep_node``
from ``passes._node_cost_terms``, the election's own counts).  Dividing
the measured time by the bound those terms imply

    bound_us = HardwareSpec.roofline_s(flops, nbytes, unit) · 1e6
    ratio    = measured_us / bound_us          (1.0 = at the hardware limit)

ranks every kernel by the headroom it leaves.  The bound uses the election's
cost model (``passes.node_roofline_terms`` / ``HardwareSpec.roofline_s``)
with one difference from the JAX package: its FLOPs run at the peak of the
unit that runs them (``Impl.unit_at``: SIMT f32, 3xTF32 or the 16-bit
tensor cores), where the election, like JAX, takes every FLOP at the bf16
peak.  An f32 product on SIMT is thus held to 67 TFLOP/s, not to 989.

Every row carries provenance, so an estimate never passes for a
measurement:

* ``confidence``: ``"exact"`` (the shape's own pow2 bucket was measured)
  or ``"nearest"`` (resolved by nearest-bucket lookup, an estimate);
* ``source``: ``"measured"`` (a timing from the cache), ``"calibrated"``
  (from the fitted per-(backend, op) coefficients) or ``"analytical"``
  (neither: no time at all).

Consumers: ``SolModel.impl_report(sol=True)``, the ``sol`` table of
``repro_torch.benchmarks.run`` and the gap-driven refinement planner
``repro_torch.benchmarks.autotune.refine_plan``.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .ir import SOURCE_OPS, OpKind


@dataclasses.dataclass
class SolRow:
    """One (op, bucket, dtype, backend, impl) cell of the SOL report."""

    op: str
    bucket: Tuple[int, ...]
    dtype: str
    backend: str
    impl: str
    us: float                       # measured (or calibrated-estimate) time
    bound_us: float                 # roofline bound for the recorded terms
    ratio: float                    # us / bound_us; 0.0 when no bound exists
    bottleneck: str                 # 'compute' | 'memory' | '' (no terms)
    confidence: str                 # 'exact' | 'nearest'
    source: str                     # 'measured' | 'calibrated' | 'analytical'
    config: Optional[Tuple[int, ...]] = None
    flops: float = 0.0
    nbytes: float = 0.0
    node: str = ""                  # node name for graph-scoped reports
    unit: str = ""                  # the unit whose peak bounds the FLOPs

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["bucket"] = list(self.bucket)
        if self.config is not None:
            d["config"] = list(self.config)
        return d


def sol_bound_us(hw, flops: float, nbytes: float,
                 unit: str = "tensor16") -> Tuple[float, str]:
    """Roofline bound in µs, FLOPs at the peak of ``unit`` (by default the
    bf16 peak), and the dominant term.  Degenerate terms yield (0.0, ''):
    the caller reports the cell as having no bound rather than dividing by
    zero."""
    bound_s = hw.roofline_s(flops, nbytes, unit=unit)
    if not (bound_s > 0.0) or not math.isfinite(bound_s):
        return 0.0, ""
    dom = ("compute" if hw.compute_s(flops, unit) >= hw.memory_s(nbytes)
           else "memory")
    return bound_s * 1e6, dom


def sol_ratio(us: float, bound_us: float) -> float:
    """measured ÷ bound, finite and ≥ 0 for any pair of floats: a missing
    bound (0.0) or a non-finite or negative time gives 0.0 (no known gap),
    and a quotient that overflows (a huge time over a subnormal bound)
    saturates at ``sys.float_info.max`` where the JAX package returns
    ``inf``."""
    if bound_us <= 0.0 or not math.isfinite(bound_us):
        return 0.0
    if us < 0.0 or not math.isfinite(us):
        return 0.0
    r = us / bound_us
    return r if math.isfinite(r) else sys.float_info.max


def _unit(impl_name: str, shape, dtype: str) -> str:
    """The unit an impl, forward or backward, declares at a key shape and
    dtype; the bf16 peak's (the election's) for an impl this process does
    not know."""
    from ..backends import registry as R
    impl = R.get_impl(impl_name) or R.get_grad_impl(impl_name)
    return impl.unit_at(shape, dtype) if impl is not None else "tensor16"


def cache_rows(cache, *, backends: Optional[Sequence[str]] = None,
               best_only: bool = False, device=None) -> List[SolRow]:
    """SOL rows for every measurement in an ``AutotuneCache`` (each entry
    is its own bucket's measurement: ``"exact"``).  ``best_only`` keeps the
    fastest impl per (op, bucket, dtype, backend) cell: the elected
    kernel's row.  Backends unknown to the registry are skipped.  Each
    bound takes the entry's impl's unit at its bucket and dtype, on the
    backend's spec, or, given a CUDA ``device``, on that card's spec
    (``registry.for_device``)."""
    import torch

    from ..backends.registry import available_backends, for_device

    known = available_backends()
    dev = torch.device(device) if device is not None else None
    rows: List[SolRow] = []
    cells: Dict[Tuple[str, str, str, Tuple[int, ...]], SolRow] = {}
    for (op, dtype, backend), bucket, impl, m in cache.entries():
        if backends is not None and backend not in backends:
            continue
        bk = known.get(backend)
        if bk is None:
            continue
        hw = for_device(bk, dev).hw if dev is not None else bk.hw
        unit = _unit(impl, bucket, dtype)
        bound, dom = sol_bound_us(hw, m.flops, m.nbytes, unit)
        row = SolRow(op=op, bucket=bucket, dtype=dtype, backend=backend,
                     impl=impl, us=m.us, bound_us=bound,
                     ratio=sol_ratio(m.us, bound), bottleneck=dom,
                     confidence="exact", source="measured",
                     config=m.config, flops=m.flops, nbytes=m.nbytes,
                     unit=unit)
        rows.append(row)
        cell = (op, dtype, backend, bucket)
        if cell not in cells or row.us < cells[cell].us:
            cells[cell] = row
    return list(cells.values()) if best_only else rows


def node_rows(graph, backend, cache) -> List[SolRow]:
    """Per-elected-node SOL rows of a live graph (the
    ``SolModel.impl_report(sol=True)`` view).  The bound comes from the
    node's own cost terms under the elected impl's memory mode and unit
    (``passes.node_roofline_terms``); the time from the cache under the
    node's bucket, ``exact`` or ``nearest`` by where the lookup resolved.
    A node whose impl has no cached timing takes the calibrated estimate
    where one is fit (``source="calibrated"``), else reports
    ``source="analytical"`` with no ratio."""
    from ..backends import registry as R
    from . import autotune
    from .passes import node_roofline_terms

    rows: List[SolRow] = []
    for n in graph.topo():
        if n.op in SOURCE_OPS or n.op is OpKind.OUTPUT:
            continue
        impl_name = getattr(n, "impl", None)
        if not impl_name:
            continue
        impl = R.get_impl(impl_name)
        memory = impl.memory if impl is not None else "streamed"
        unit = impl.unit_of(n) if impl is not None else "tensor16"
        flops, nbytes, _ = node_roofline_terms(n, backend.hw, memory, unit)
        bound, dom = sol_bound_us(backend.hw, flops, nbytes, unit)
        shape = autotune.node_shape(n)
        hits, conf = cache.lookup_with_confidence(
            n.op.value, shape, n.spec.dtype, backend.cache_name)
        m = hits.get(impl_name)
        if m is not None:
            us, source, cfg = m.us, "measured", m.config
        else:
            cal = cache.calibration(backend.cache_name, n.op.value)
            if cal:
                us = (cal["s_per_flop"] * flops
                      + cal["s_per_byte"] * nbytes) * 1e6
                source, conf, cfg = "calibrated", "", None
            else:
                us, source, conf, cfg = 0.0, "analytical", "", None
        rows.append(SolRow(
            op=n.op.value, bucket=autotune.bucket_shape(shape or ()),
            dtype=n.spec.dtype, backend=backend.cache_name, impl=impl_name,
            us=us, bound_us=bound,
            ratio=sol_ratio(us, bound) if source != "analytical" else 0.0,
            bottleneck=dom, confidence=conf, source=source, config=cfg,
            flops=flops, nbytes=nbytes, node=n.name or n.op.value,
            unit=unit))
    return rows


def rank(rows: Sequence[SolRow]) -> List[SolRow]:
    """Worst gap first.  Exact-bucket measurements rank ahead of
    nearest-bucket estimates and calibrated guesses, whatever their
    ratio."""
    def key(r: SolRow):
        exact_measured = (r.confidence == "exact" and r.source == "measured")
        return (0 if exact_measured else 1, -r.ratio)
    return sorted(rows, key=key)


def render(rows: Sequence[SolRow], limit: int = 0) -> str:
    """The ranked SOL table the ``sol`` benchmark prints."""
    hdr = (f"{'backend':17s} {'op':16s} {'dtype':8s} {'bucket':>18s} "
           f"{'impl':22s} {'us':>9s} {'bound_us':>9s} {'ratio':>7s} "
           f"{'unit':>8s} {'bneck':>7s} {'conf':>8s} {'src':>10s}")
    out = [hdr, "-" * len(hdr)]
    for r in (rows[:limit] if limit else rows):
        bucket = "x".join(str(d) for d in r.bucket)
        out.append(
            f"{r.backend:17s} {r.op:16s} {r.dtype:8s} {bucket:>18s} "
            f"{r.impl:22s} {r.us:9.1f} {r.bound_us:9.3f} {r.ratio:7.2f} "
            f"{r.unit:>8s} {r.bottleneck:>7s} {r.confidence:>8s} "
            f"{r.source:>10s}")
    return "\n".join(out)

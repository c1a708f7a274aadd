"""Calibrate the election cost model from measured autotune data
(counterpart of ``benchmarks/calibrate.py``).

``passes._node_cost_terms`` gives analytic (flops, bytes) per node, and a
cold election costs impls with the nominal ``HardwareSpec`` roofline.  This
tool regresses the autotune cache's measurements onto those terms: for each
(backend, op) it fits

    time_s  ≈  s_per_flop · flops  +  s_per_byte · nbytes

by non-negative least squares over every recorded (impl, shape bucket)
measurement, nbytes already following each impl's memory mode (streamed or
roundtrip).  The reciprocals are the backend's effective FLOP/s and bytes/s
for that op.  ``--apply`` writes the coefficients into the cache file's
``calibration`` section; the election then costs an (op, shape) that has no
measurement with them ('calibrated' provenance).

    PYTHONPATH=src python -m repro_torch.benchmarks.calibrate \\
        --cache results/autotune_cache.json --apply
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import autotune as AT


def fit(cache) -> Dict[Tuple[str, str], Dict[str, float]]:
    """Per-(backend, op) non-negative least squares of measured seconds onto
    (flops, nbytes).  The 2×2 normal equations are solved directly; a
    negative coefficient is clamped to zero and the remaining 1-D fit
    re-solved through the origin."""
    samples: Dict[Tuple[str, str], List[Tuple[float, float, float]]] = {}
    for (op, _dtype, backend), _bucket, _impl, m in cache.entries():
        if m.us <= 0 or (m.flops <= 0 and m.nbytes <= 0):
            continue
        samples.setdefault((backend, op), []).append(
            (m.flops, m.nbytes, m.us * 1e-6))

    out: Dict[Tuple[str, str], Dict[str, float]] = {}
    for key, rows in samples.items():
        sff = sum(f * f for f, _, _ in rows)
        sbb = sum(b * b for _, b, _ in rows)
        sfb = sum(f * b for f, b, _ in rows)
        sft = sum(f * t for f, _, t in rows)
        sbt = sum(b * t for _, b, t in rows)
        det = sff * sbb - sfb * sfb
        if det > 0:
            a = (sft * sbb - sbt * sfb) / det
            b = (sbt * sff - sft * sfb) / det
        else:
            a = b = -1.0
        if a < 0 or b < 0:                     # clamp + re-solve 1-D
            a_only = sft / sff if sff else 0.0
            b_only = sbt / sbb if sbb else 0.0

            def sse(aa: float, bb: float) -> float:
                return sum((t - aa * f - bb * nb) ** 2
                           for f, nb, t in rows)

            a, b = min(((a_only, 0.0), (0.0, b_only)),
                       key=lambda ab: sse(*ab))
        out[key] = {"s_per_flop": a, "s_per_byte": b, "n": float(len(rows))}
    return out


def csv_rows(cache) -> List[Tuple[str, float, str]]:
    rows = []
    for (backend, op), c in sorted(fit(cache).items()):
        eff_flops = 1.0 / c["s_per_flop"] if c["s_per_flop"] else 0.0
        eff_bw = 1.0 / c["s_per_byte"] if c["s_per_byte"] else 0.0
        rows.append((f"calibrate_{backend}_{op}", c["n"],
                     f"eff_gflops={eff_flops / 1e9:.2f};"
                     f"eff_gbps={eff_bw / 1e9:.2f}"))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cache", default="results/autotune_cache.json")
    ap.add_argument("--apply", action="store_true",
                    help="write fitted coefficients into the cache file's "
                         "calibration section")
    args = ap.parse_args(argv)

    cache = AT.AutotuneCache.load(args.cache)
    if cache.stale or not len(cache):
        print(f"[calibrate] {args.cache} is empty or stale; run "
              "repro_torch.benchmarks.autotune first", file=sys.stderr)
        return 1
    coeffs = fit(cache)
    print("name,us_per_call,derived")
    for name, n, derived in csv_rows(cache):
        print(f"{name},{n:.1f},{derived}")
    if args.apply:
        for (backend, op), c in coeffs.items():
            cache.set_calibration(backend, op, c)
        cache.save(args.cache)
        print(f"[calibrate] wrote {len(coeffs)} coefficient sets to "
              f"{args.cache}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

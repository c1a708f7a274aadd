"""Benchmark harness of the port (counterpart of ``benchmarks/run.py``):
one function per table, printed as ``name,us_per_call,derived`` CSV.

  effort      the paper's programming-effort table (Sec. VI-A): lines of
              the port's packages, its CUDA sources counted beside its .py
  inference   the paper's Fig. 3 left: B=1, the eager module against
              ``optimize(..., backend="h100")``, outputs held together
              before any time counts
  layouts     oi/io Linear and NCHW/NHWC conv timings with torch ops
  matmul      the matmul kernel against ``torch.matmul``, with max |Δ|
  autotune    a tiny sweep of every op on ``h100`` and ``torch_ref``
  serving     ``SolServer`` under strict provenance (step, latency p50/p99,
              TTFT), decode against re-forward, decode flatness
  sol         speed-of-light gap analysis: every tuned cell ranked by
              measured ÷ bound at its unit's peak, plus the gap-driven
              planner's per-cell outcomes
  training    the paper's Fig. 3 right: a training step's gradients by
              eager autograd against ``optimize(..., training=True)``,
              gradients held together before any time counts
  train       fwd and fwd+bwd through each zoo family's training program,
              with their ratio

``roofline`` waits for a later slice of the port: asking for it fails
that table, as an unknown table does.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [table ...] \\
        [--json PATH] [--device cpu|cuda]

Tables run on the CUDA card unless ``--device cpu`` is given (there every
kernel runs its plain version, so the times say nothing of the card).
``--json PATH`` also writes the rows as a JSON document (its directory
made if missing); whenever the ``matmul``, ``serving``, ``sol`` or
``train`` table ran, a side file with its rows alone
(``BENCH_torch_matmul.json``, ``BENCH_torch_serve.json``,
``BENCH_torch_sol.json``, ``BENCH_torch_train.json``) goes to the JSON's
directory (else the current one), named apart from the JAX package's ``BENCH_*.json`` series;
``tools/bench_diff.py`` diffs any two of them.  Exits 1 if any requested
table raised.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import List, Optional, Sequence, Tuple

Row = Tuple[str, float, str]

DEFAULT_TABLES = ("effort", "inference", "layouts", "matmul", "autotune",
                  "serving")
# tables of the JAX harness whose modules are not ported yet, and the
# ROADMAP §1 item each waits for
LATER = {"roofline": "the dry run's results/dryrun.jsonl (ROADMAP §1 "
                     "item 7.3)"}
SIDE_FILES = (("matmul", "BENCH_torch_matmul.json"),
              ("serving", "BENCH_torch_serve.json"),
              ("sol", "BENCH_torch_sol.json"),
              ("train", "BENCH_torch_train.json"))


def table_rows(name: str, device=None) -> List[Row]:
    if name == "effort":
        from . import paper_tables
        return paper_tables.effort_table()
    if name == "inference":
        from . import paper_tables
        return paper_tables.inference_fig3(device)
    if name == "training":
        from . import paper_tables
        return paper_tables.training_fig3(device)
    if name == "train":
        from . import train_bench
        return train_bench.csv_rows(device)
    if name == "layouts":
        from . import layouts
        return layouts.csv_rows(device)
    if name == "matmul":
        from . import autotune
        return autotune.matmul_rows(device)
    if name == "autotune":
        from . import autotune
        return autotune.csv_rows(device)
    if name == "serving":
        from . import serving
        return serving.csv_rows(device)
    if name == "sol":
        from . import autotune
        return autotune.sol_rows(device=device)
    if name in LATER:
        raise NotImplementedError(f"the {name!r} table waits for "
                                  f"{LATER[name]}")
    raise KeyError(f"unknown table {name!r}")


def _write(path: str, tables: Sequence[str], rows: List[Row],
           failed: Sequence[str] = ()) -> None:
    doc = {"tables": list(tables), "failed": list(failed),
           "rows": [{"name": n, "us_per_call": float(us), "derived": d}
                    for n, us, d in rows]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"[benchmarks] wrote {path}", file=sys.stderr)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's benchmark tables as name,us_per_call,"
                    "derived CSV")
    ap.add_argument("tables", nargs="*", default=list(DEFAULT_TABLES))
    ap.add_argument("--json", help="also write the rows to this JSON file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    rows: List[Row] = []
    failed: List[str] = []
    per_table = {}
    for name in args.tables:
        try:
            table = table_rows(name, args.device)
        except Exception:
            failed.append(name)
            print(f"[benchmarks] table {name!r} FAILED:", file=sys.stderr)
            traceback.print_exc()
            continue
        per_table[name] = table
        rows += table
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    out_dir = os.path.dirname(args.json) if args.json else ""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if args.json:
        _write(args.json, args.tables, rows, failed)
    for table, fname in SIDE_FILES:
        if per_table.get(table):
            _write(os.path.join(out_dir or ".", fname), [table],
                   per_table[table])
    if failed:
        print(f"[benchmarks] failed tables: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving benchmark table (counterpart of ``benchmarks/serving.py``):
continuous batching through the SOL pipeline.

The table drives ``repro_torch.launch.serve.SolServer``: requests are
admitted into the KV-slot arena, padded to the autotune pow2 buckets,
staged with one packed copy per forward and served by bucket models whose
every LINEAR/MATMUL/ATTENTION/DECODE_ATTENTION election is measured (the
run warms a private autotune cache first and serves with
``strict_provenance``).

Rows (``name,us_per_call,derived``):

  serve_<backend>_step           mean wall time per scheduler step
  serve_<backend>_latency_p50    request latency percentiles (µs)
  serve_<backend>_latency_p99
  serve_<backend>_ttft_p50       time to first token (µs)
  serve_<backend>_decode_tok     µs/token with the decode program; derived
                                 carries tokens/s and the speedup over the
                                 re-forward on the same weights and work
  serve_<backend>_reforward_tok  µs/token with the full re-forward
  decode_step_cache<T>           one decode-program forward at resident
                                 cache length T
  reforward_step_T<T>            one full forward over a T-token context

Times are host wall clock around work that ends on the host (a served
token is copied back), on the card unless ``device="cpu"``; each server
serves its workload once to open (compile) its buckets before the timed
pass.  The mesh
scaling rows, the fleet replay and the per-architecture backbone decode
rows wait for later slices of the port (``NotImplementedError``).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..frontends.offload import DeviceLike, resolve_device

Row = Tuple[str, float, str]


def serve_rows(backend: str = "h100", *, requests: int = 6, gen: int = 6,
               cfg=None, model=None,
               workload: Optional[Sequence[Tuple[np.ndarray, int]]] = None,
               device: DeviceLike = None) -> List[Row]:
    """The workload through a strict measured-provenance server with a
    private cache: ``warm_autotune`` over the buckets it can open, a first
    pass that opens (compiles) them, then the step, latency and TTFT rows
    of a second pass on the warm server, each request timed from its
    submission.  ``cfg`` defaults to the JAX table's tiny config;
    ``model`` serves given weights (else ``build_lm(cfg)``); ``workload``
    ((prompt, new tokens) pairs) replaces ``requests`` requests of ``gen``
    tokens from ``smoke_workload``."""
    from ..core import autotune as AT
    from ..launch.serve import ServeConfig, SolServer, smoke_workload

    if cfg is None:
        cfg = ServeConfig(d_model=32, n_heads=2, n_layers=1, vocab=64,
                          max_seq=32, max_batch=4, slots=4, backend=backend)
    if workload is None:
        workload = smoke_workload(cfg, requests, gen)
    prev = AT.get_cache()
    AT.set_cache(AT.AutotuneCache())      # private cache: measure, don't leak
    try:
        server = SolServer(cfg, model, device=device,
                           strict_provenance=True)
        for prompt, g in workload:
            server.submit(prompt, g)
        server.warm_autotune(warmup=1, iters=3)
        server.run()                      # opens the buckets
        before = dict(server.stats)
        t0 = time.perf_counter()
        reqs = [server.submit(p, g) for p, g in workload]
        server.run()
        wall = time.perf_counter() - t0
        server.close()
    finally:
        AT.set_cache(prev)

    def grew(key: str) -> int:
        return server.stats[key] - before[key]

    tokens = sum(len(r.generated) for r in reqs)
    lat = [1e6 * (r.finished_time - r.submitted) for r in reqs]
    ttft = [1e6 * (r.first_token_time - r.submitted) for r in reqs]
    buckets = "/".join(f"{k}:{v}" for k, v in
                       sorted(server.stats["buckets"].items()))
    tag = cfg.backend
    return [
        (f"serve_{tag}_step", 1e6 * wall / max(grew("steps"), 1),
         f"{tokens / wall:.1f}tok/s;dmas={grew('dmas')};"
         f"buckets={buckets};{server.device}"),
        (f"serve_{tag}_latency_p50", float(np.percentile(lat, 50)),
         f"{len(reqs)}req"),
        (f"serve_{tag}_latency_p99", float(np.percentile(lat, 99)), ""),
        (f"serve_{tag}_ttft_p50", float(np.percentile(ttft, 50)),
         f"prefills={grew('prefills')};decodes={grew('decodes')}"),
    ]


def decode_vs_reforward(backend: str = "h100", *, requests: int = 4,
                        gen: int = 120, device: DeviceLike = None
                        ) -> List[Row]:
    """A decode-heavy workload (short prompts, long generations) served
    twice on the same weights: through the decode program and through the
    full re-forward.  Each server's first pass compiles its buckets; the
    timed pass replays the workload on the warm server."""
    from ..core import autotune as AT
    from ..launch.serve import ServeConfig, SolServer, build_lm

    dev = resolve_device(device)
    base = ServeConfig(d_model=128, n_heads=4, n_layers=2, vocab=128,
                       max_seq=256, max_batch=4, slots=4, backend=backend)
    model = build_lm(base, device=dev)
    rng = np.random.default_rng(3)
    workload = [(rng.integers(0, base.vocab, int(rng.integers(4, 8)),
                              dtype=np.int32), gen)
                for _ in range(requests)]
    prev = AT.get_cache()
    AT.set_cache(AT.AutotuneCache())
    tps = {}
    try:
        for decode in (False, True):
            cfg = dataclasses.replace(base, decode=decode)
            server = SolServer(cfg, model, device=dev)
            for p, g in workload:          # compile pass: builds buckets
                server.submit(p, g)
            server.run()
            toks0 = server.stats["tokens"]
            t0 = time.perf_counter()
            for p, g in workload:          # timed pass: warm buckets only
                server.submit(p, g)
            server.run()
            dt = time.perf_counter() - t0
            tps[decode] = (server.stats["tokens"] - toks0) / dt
            server.close()
    finally:
        AT.set_cache(prev)
    ratio = tps[True] / tps[False] if tps[False] else 0.0
    return [
        (f"serve_{backend}_decode_tok", 1e6 / tps[True],
         f"{tps[True]:.1f}tok/s;x{ratio:.2f}_vs_reforward;{dev.type}"),
        (f"serve_{backend}_reforward_tok", 1e6 / tps[False],
         f"{tps[False]:.1f}tok/s;baseline;{dev.type}"),
    ]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_flatness(backend: str = "h100", lengths=(128, 1024),
                    iters: int = 20, device: DeviceLike = None
                    ) -> List[Row]:
    """One decode-program forward at resident cache length T beside one
    full forward over a T-token context: the decode step's cost should be
    near flat in T while the re-forward grows with it."""
    from ..frontends.extract import extract_decode
    from ..frontends.optimize import compile_graph, optimize
    from ..launch.serve import ServeConfig, build_lm

    dev = resolve_device(device)
    cfg = ServeConfig(d_model=64, n_heads=4, n_layers=2, vocab=128,
                      max_seq=max(lengths), backend=backend)
    model = build_lm(cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    rows: List[Row] = []
    decode_us = {}
    for t_len in lengths:
        sol = compile_graph(model, extract_decode(model, 1, t_len,
                                                  cfg.d_model),
                            backend, device=dev)
        vals = []
        for inp in sol.graph.inputs:
            if inp.spec.dtype.startswith("int"):
                vals.append(torch.full(inp.spec.shape, t_len - 1,
                                       dtype=torch.int32, device=dev))
            else:
                vals.append(torch.randn(inp.spec.shape, generator=gen,
                                        device=dev))
        sol(*vals)                                     # load + warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            sol(*vals)
        _sync(dev)
        decode_us[t_len] = (time.perf_counter() - t0) / iters * 1e6
    for t_len in lengths:
        ratio = decode_us[t_len] / decode_us[lengths[0]]
        rows.append((f"decode_step_cache{t_len}", decode_us[t_len],
                     f"x{ratio:.2f}_vs_cache{lengths[0]};{dev.type}"))
    for t_len in lengths:
        sol = optimize(model, (1, t_len, cfg.d_model), backend=backend,
                       device=dev)
        x = torch.randn((1, t_len, cfg.d_model), generator=gen, device=dev)
        sol(x)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            sol(x)
        _sync(dev)
        us = (time.perf_counter() - t0) / iters * 1e6
        rows.append((f"reforward_step_T{t_len}", us,
                     f"x{us / decode_us[t_len]:.2f}_vs_decode_step;"
                     f"{dev.type}"))
    return rows


def mesh_scaling_rows(*args, **kwargs) -> List[Row]:
    raise NotImplementedError(
        "the mesh scaling rows wait for the sharded-serving slice of the "
        "port (ROADMAP §1 item 5)")


def fleet_rows(*args, **kwargs) -> List[Row]:
    raise NotImplementedError(
        "the fleet replay waits for the fleet slice of the port (ROADMAP "
        "§1 item 6)")


def decode_bench(*args, **kwargs) -> List[Row]:
    raise NotImplementedError(
        "the per-architecture decode rows wait for models/backbone and the "
        "configs (ROADMAP §1 item 7)")


def csv_rows(device: DeviceLike = None) -> List[Row]:
    return (serve_rows("h100", device=device)
            + decode_vs_reforward("h100", device=device)
            + decode_flatness("h100", device=device))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The serving rows alone (``serve``); ``--json`` writes or merges them
    into a BENCH-schema file, keeping its rows of other names.  The
    ``fleet`` mode and a mesh other than 1,1 wait for later slices."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("mode", nargs="?", default="serve",
                    choices=["serve", "fleet"])
    ap.add_argument("--backend", default="h100")
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", help="write/merge rows into this BENCH file")
    args = ap.parse_args(argv)
    mesh = tuple(int(a) for a in args.mesh.split(","))
    if len(mesh) != 2:
        print("--mesh wants 'data,model'", file=sys.stderr)
        return 2
    if args.mode == "fleet":
        rows = fleet_rows(args.backend)
    elif mesh != (1, 1):
        rows = mesh_scaling_rows(args.backend, mesh)
    else:
        rows = serve_rows(args.backend, device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    if args.json:
        doc = {"tables": ["serving"], "rows": []}
        if os.path.exists(args.json):
            try:
                with open(args.json) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                pass
        fresh = {n for n, _, _ in rows}
        doc["rows"] = ([r for r in doc.get("rows", [])
                        if r.get("name") not in fresh]
                       + [{"name": n, "us_per_call": us, "derived": d}
                          for n, us, d in rows])
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"[serving] wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
pass.

  serve_<backend>_mesh1x1_tok    decode µs/token on one device, and on a
  serve_<backend>_mesh<D>x<M>_tok  (data, model) mesh of spawned ranks
  serve_<backend>_fleet<R>_*     an open-loop replay through a SolFleet of
                                 R replicas with one injected kill

  decode_<arch>_smoke             one backbone decode step of a reduced
                                 config (``decode_bench``), with tokens/s

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


def _mesh_scaling_rank(mesh, backend: str, cfg_kw: dict, workload
                       ) -> Tuple[float, float]:
    """One rank of ``mesh_scaling_rows``: rank 0 serves on its own device
    (the others wait), then every rank serves the mesh; each server's
    compile pass opens its buckets, the second pass is timed.  One private
    autotune cache holds both servers' measurements, the mesh's under its
    tagged backend key."""
    from ..core import autotune as AT
    from ..launch.serve import ServeConfig, SolServer, build_lm

    AT.set_cache(AT.AutotuneCache())
    base = ServeConfig(backend=backend, **cfg_kw)
    model = build_lm(base, device=mesh.device)

    def tokens_per_s(cfg) -> float:
        server = SolServer(cfg, model, device=mesh.device,
                           strict_provenance=True)
        for p, g in workload:          # compile pass: builds the buckets
            server.submit(p, g)
        server.warm_autotune(warmup=1, iters=3)
        server.run()
        toks0 = server.stats["tokens"]
        t0 = time.perf_counter()
        for p, g in workload:          # timed pass: warm buckets only
            server.submit(p, g)
        server.run()
        dt = time.perf_counter() - t0
        server.close()
        return (server.stats["tokens"] - toks0) / dt

    single = tokens_per_s(base) if mesh.rank == 0 else 0.0
    mesh.barrier()
    return single, tokens_per_s(
        dataclasses.replace(base, mesh=tuple(mesh.sizes)))


def mesh_scaling_rows(backend: str = "h100", mesh: Tuple[int, int] = (2, 2),
                      *, requests: int = 8, gen: int = 24,
                      device: DeviceLike = None) -> List[Row]:
    """Decode tokens/s on one device against a (data, model) mesh, on the
    same weights and requests: ``data·model`` ranks started here
    (``launch.mesh.run_on_mesh``), rank 0's times.  Where the ranks share
    one card (every rank of this machine's run does), the rows are no
    scaling measurement: the ranks split one card's time."""
    from ..launch.mesh import run_on_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels import build
        build.build_all()
    cfg_kw = dict(d_model=128, n_heads=4, n_layers=2, vocab=128,
                  max_seq=128, max_batch=8, slots=8)
    rng = np.random.default_rng(7)
    workload = [(rng.integers(0, cfg_kw["vocab"], int(rng.integers(4, 8)),
                              dtype=np.int32), gen)
                for _ in range(requests)]
    need = int(mesh[0]) * int(mesh[1])
    # gloo: the CPU, and ranks sharing one card
    (single, sharded), *_ = run_on_mesh(
        _mesh_scaling_rank, *mesh, device=dev.type, dist_backend="gloo",
        timeout_s=900, args=(backend, cfg_kw, workload))
    speedup = sharded / single if single else 0.0
    return [
        (f"serve_{backend}_mesh1x1_tok", 1e6 / single if single else 0.0,
         f"{single:.1f}tok/s;devices=1;{dev.type}"),
        (f"serve_{backend}_mesh{mesh[0]}x{mesh[1]}_tok",
         1e6 / sharded if sharded else 0.0,
         f"{sharded:.1f}tok/s;x{speedup:.2f}_vs_single;ranks={need};"
         f"{dev.type}"),
    ]


def fleet_rows(backend: str = "h100", *, replicas: int = 3,
               requests: int = 1000, gen: int = 4, rate: int = 3,
               kill_at_tick: Optional[int] = None, verify: bool = True,
               device: DeviceLike = None) -> List[Row]:
    """Open-loop traffic replay against a ``launch/fleet.SolFleet`` with ONE
    injected replica kill mid-replay (``fleet.kill_replay``; by default
    halfway through the arrivals): ``rate`` requests arrive per watcher
    tick whatever completes (queueing delay shows in the latency rows).
    Every request must complete with zero drops, and with ``verify`` the
    tokens must equal an undisturbed one-replica run's on the same weights
    and seeds.  Rows: ``serve_<backend>_fleet<R>_{tok, latency_p50,
    latency_p99, ttft_p50, recovery}`` (µs; recovery: the kill to the
    respawn that replaced it)."""
    from ..core import autotune as AT
    from ..launch.fleet import kill_replay
    from ..launch.serve import SamplingParams, ServeConfig, build_lm

    dev = resolve_device(device)
    cfg = ServeConfig(d_model=32, n_heads=2, n_layers=1, vocab=64,
                      max_seq=32, max_batch=8, slots=16, backend=backend)
    model = build_lm(cfg, device=dev)
    rng = np.random.default_rng(11)
    workload = [(rng.integers(0, cfg.vocab, int(rng.integers(4, 12)),
                              dtype=np.int32), gen,
                 SamplingParams(temperature=0.8, seed=10_000 + i))
                for i in range(requests)]
    if kill_at_tick is None:
        kill_at_tick = -(-requests // rate) // 2
    prev = AT.get_cache()
    AT.set_cache(AT.AutotuneCache())   # private cache: measure, don't leak
    try:
        s = kill_replay(cfg, model, workload, replicas=replicas,
                        kill_at_tick=kill_at_tick, rate=rate, verify=verify,
                        device=dev)
    finally:
        AT.set_cache(prev)
    if s["dropped"]:
        raise RuntimeError(f"fleet replay dropped requests {s['dropped']} "
                           f"after the injected kill")
    if s["diverged"]:
        raise RuntimeError(f"fleet replay tokens diverged from the "
                           f"undisturbed same-seed run for {s['diverged']}")
    ident = ";identical=yes" if verify else ""
    tag = f"fleet{replicas}"
    tok_us = (1e6 / s["tokens_per_s"]) if s["tokens_per_s"] else 0.0
    return [
        (f"serve_{backend}_{tag}_tok", tok_us,
         f"{s['tokens_per_s']:.1f}tok/s;requests={s['requests']};"
         f"requeued={s['requeued']}{ident};{dev.type}"),
        (f"serve_{backend}_{tag}_latency_p50",
         s["latency_ms"]["p50"] * 1e3, f"open_loop_rate={rate}/tick"),
        (f"serve_{backend}_{tag}_latency_p99",
         s["latency_ms"]["p99"] * 1e3, ""),
        (f"serve_{backend}_{tag}_ttft_p50", s["ttft_ms"]["p50"] * 1e3,
         f"replicas={replicas}"),
        (f"serve_{backend}_{tag}_recovery", s["recovery_s"]["max"] * 1e6,
         f"killed_replica={s['killed']};kill_tick={kill_at_tick};"
         f"respawns={s['respawns']}"),
    ]


def decode_bench(archs=("qwen2-1.5b", "rwkv6-1.6b", "recurrentgemma-9b"),
                 batch: int = 2, steps: int = 8,
                 device: DeviceLike = None) -> List[Row]:
    """Per-architecture backbone decode-step timings of the reduced
    configs (``make_decode_step`` on a one-process mesh, a cache of 32
    positions): one warm step, then ``steps`` timed ones; the attention,
    RWKV6 and RG-LRU caches beside the ``SolServer`` rows."""
    from ..configs import get_smoke
    from ..distributed.steps import make_decode_step
    from ..launch.mesh import make_debug_mesh
    from ..models import backbone as B
    dev = resolve_device(device)
    rows = []
    for arch in archs:
        cfg = get_smoke(arch)
        params = B.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        cache = B.init_cache(cfg, batch, 32, dev)
        toks = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        decode = make_decode_step(make_debug_mesh(1, 1, device=dev), cfg)
        logits, cache = decode(params, cache, toks, 0)
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(1, steps + 1):
            logits, cache = decode(params, cache, toks, t)
        _sync(dev)
        us = (time.perf_counter() - t0) / steps * 1e6
        rows.append((f"decode_{arch}_smoke", us,
                     f"{batch * 1e6 / us:.0f}tok/s"))
    return rows


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def csv_rows(device: DeviceLike = None) -> List[Row]:
    return (serve_rows("h100", device=device)
            + decode_vs_reforward("h100", device=device)
            + decode_flatness("h100", device=device))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The serving rows (``serve``), the mesh scaling rows (``--mesh`` other
    than 1,1) or the fleet replay (``fleet``); ``--json`` writes or merges
    them into a BENCH-schema file, keeping its rows of other names."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("mode", nargs="?", default="serve",
                    choices=["serve", "fleet"])
    ap.add_argument("--backend", default="h100")
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests of the fleet replay or the mesh rows")
    ap.add_argument("--json", help="write/merge rows into this BENCH file")
    args = ap.parse_args(argv)
    mesh = tuple(int(a) for a in args.mesh.split(","))
    if len(mesh) != 2:
        print("--mesh wants 'data,model'", file=sys.stderr)
        return 2
    more = {} if args.requests is None else {"requests": args.requests}
    if args.mode == "fleet":
        rows = fleet_rows(args.backend, device=args.device, **more)
    elif mesh != (1, 1):
        rows = mesh_scaling_rows(args.backend, mesh, device=args.device,
                                 **more)
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

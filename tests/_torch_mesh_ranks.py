"""Rank functions for ``tests/test_torch_mesh.py``: each runs inside a
process that ``repro_torch.launch.mesh.run_on_mesh`` spawned, so it imports
the port and torch alone and returns picklable numpy results."""
import torch
from torch import nn as tnn

from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as AT
from repro_torch.core.ir import OpKind
from repro_torch.frontends import nn
from repro_torch.frontends.extract import extract_decode, extract_prefill
from repro_torch.frontends.optimize import compile_graph, optimize
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_debug_mesh


def lm(sd, d, heads, kv, layers, vocab):
    m = tnn.Sequential(*[nn.transformer_block(d, heads, kv, device="cpu")
                         for _ in range(layers)],
                       nn.Linear(d, vocab, device="cpu"))
    return load_numpy_state_dict(m, sd)


def _np(out):
    return ([o.numpy() for o in out] if isinstance(out, tuple)
            else [out.numpy()])


def programs(mesh, sd, dims, x, xd, lens, caches):
    """The full, prefill and decode programs on ``mesh``; every rank
    returns the whole (gathered) outputs."""
    AT.set_cache(AT.AutotuneCache())
    m = lm(sd, *dims)
    d = dims[0]
    out = {"full": _np(optimize(m, x.shape, device="cpu", mesh=mesh)(x))}
    out["prefill"] = _np(compile_graph(
        m, extract_prefill(m, x.shape), "h100", device="cpu",
        mesh=mesh)(x))
    b, s = caches[0].shape[:2]
    out["decode"] = _np(compile_graph(
        m, extract_decode(m, b, s, d), "h100", device="cpu",
        mesh=mesh)(xd, lens, *caches))
    return out


def serve(mesh, sd, dims, cfg_kw, prompts, gen):
    """A (data, model) server on the same requests, cold and then strict
    after ``warm_autotune``; what the tests read of both."""
    m = lm(sd, *dims)
    cfg = tserve.ServeConfig(mesh=tuple(mesh.sizes), **cfg_kw)
    rec = {"coords": dict(mesh.coords), "rank": mesh.rank}
    AT.set_cache(AT.AutotuneCache())
    cold = tserve.SolServer(cfg, model=m, device="cpu")
    reqs = [cold.submit(p, gen) for p in prompts]
    s = cold.run()
    rec["cold"] = {"tokens": [r.generated for r in reqs],
                   "logits": [r.last_logits for r in reqs],
                   "summary": {k: s[k] for k in ("mesh", "dmas", "forwards",
                                                 "tokens")},
                   "buckets": sorted(cold._models)}
    try:
        cold.export_artifacts()
        rec["export"] = ""
    except RuntimeError as e:
        rec["export"] = str(e)
    cold.close()

    AT.set_cache(AT.AutotuneCache())
    strict = tserve.SolServer(cfg, model=m, device="cpu",
                              strict_provenance=True)
    reqs = [strict.submit(p, gen) for p in prompts]
    counts = strict.warm_autotune()
    strict.run()
    served = {k.value for k in tserve.SERVED_KINDS}
    models = {}
    for key, sol in strict._models.items():
        prov = sol.impl_report(provenance=True)
        srcs = {name: prov[name]["sources"]
                for kind, impls in sol.impl_report(by_kind=True).items()
                if kind in served for name in impls}
        models[key] = {
            "cache_name": sol.backend.cache_name,
            "sources": srcs,
            "violations": strict._exact_bucket_violations(sol),
            "matmul_out": [n.spec.shape[-1] for n in sol.graph.topo()
                           if n.op is OpKind.MATMUL],
            "decode_batch": [n.spec.shape[0] for n in sol.graph.topo()
                             if n.op is OpKind.DECODE_ATTENTION],
            "psum": sum(1 for n in sol.graph.topo()
                        if n.attrs.get("psum_axes")),
        }
    # per-shard keys never serve a single-device lookup: nothing the mesh
    # server measured is visible under the untagged backend name
    cache = AT.get_cache()
    untagged = strict.backend.name
    rec["strict"] = {
        "counts": counts, "tokens": [r.generated for r in reqs],
        "models": models,
        "global_hits": sum(
            1 for (op, dt, bk), b, impl, _ in cache.entries()
            if bk == untagged),
        "cache_backends": sorted({bk for (op, dt, bk), *_ in
                                  cache.entries()})}
    strict.close()
    try:
        make_debug_mesh(2, 4)
        rec["too_few"] = ""
    except RuntimeError as e:
        rec["too_few"] = str(e)
    return rec


def collectives(mesh):
    """The all-reduce and all-gather of each axis on a rank-valued tensor."""
    t = torch.full((2, 3), float(mesh.rank))
    return {"coords": dict(mesh.coords),
            "sum_model": mesh.all_reduce(t, "model").tolist(),
            "sum_all": mesh.all_reduce(t, ("data", "model")).tolist(),
            "gather_data": mesh.all_gather(t, "data", 0).tolist()}


def job(mesh, sd, dims, prog_args, serve_args):
    """The module's one (2, 2) job: the collectives, the programs, then
    the servers."""
    return {"collectives": collectives(mesh),
            "programs": programs(mesh, sd, dims, *prog_args),
            "serve": serve(mesh, sd, dims, *serve_args)}


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()          # rank 0 waits on a rank that is gone


def card_serve(mesh, cfg_kw, prompts, gen):
    """A small model built from its seed on this rank's device (the card),
    served on the mesh; the tokens and this rank's kernel launches."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    counters = {"matmul": matmul_cuda, "flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda}
    for c in counters.values():
        c.launches = 0
    cfg = tserve.ServeConfig(mesh=tuple(mesh.sizes), **cfg_kw)
    server = tserve.SolServer(cfg, model=tserve.build_lm(
        cfg, device=mesh.device))
    reqs = [server.submit(p, gen) for p in prompts]
    server.run()
    server.close()
    return {"tokens": [r.generated for r in reqs],
            "launches": {k: c.launches for k, c in counters.items()}}

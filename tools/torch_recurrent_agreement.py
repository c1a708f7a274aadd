#!/usr/bin/env python3
"""How far the recurrent stacks' ``h100`` output may lie from ``torch_ref``'s.

A study beside ``chip_smoke.py``, on one CUDA card, from the repo root:

    python3 tools/torch_recurrent_agreement.py [--seeds N] [--floor-draws K]
                                               [--stacks rwkv6 griffin]

For each of ``chip_smoke.py``'s full-width stacks (24 RWKV6 blocks at d
2048, 26 Griffin blocks at d 4096, input (4, 512, d), f32) and for N
weight seeds (``chip_smoke.py``'s own seed first), it reads three numbers,
each relative to the output's scale (max |y|):

- ``err``: the ``h100`` output against ``torch_ref``'s on the same weights;
- ``floor``: how far ``torch_ref``'s own output moves when its input moves
  by f32 rounding (each element × (1 + 2⁻²³·n), n standard normal), the
  largest of K draws: what two correct f32 paths may differ by;
- ``faults``: on the first seed only, ``err`` with a deliberately wrong
  scan kernel patched in at run time (the last step's output left unset,
  the decays rounded to bfloat16, and for RWKV6 the bonus term ``u``
  dropped), each beside the per-layer reading ``chip_smoke.py`` gates at
  1e-4: what a broken kernel reads.

The end-to-end limits in ``chip_smoke.py`` (``REC_STACK_RTOL``) are chosen
from these readings; ``PERF.md`` gives them.  The record goes to
``chiprun_out/recurrent_agreement.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def f32_floor(torch, ref, x, want, draws: int) -> list:
    gen = torch.Generator(x.device).manual_seed(7)
    out = []
    for _ in range(draws):
        xp = x * (1 + 2.0 ** -23 * torch.randn(*x.shape, device=x.device,
                                               generator=gen))
        out.append(cs.rel_err(ref(xp), want))
    return out


def faults(torch, name: str):
    """(label, module, wrong kernel) for the stack's scan: each calls the
    real kernel and makes one mistake a scan kernel could make."""
    if name == "rwkv6":
        from repro_torch.kernels.rwkv6_scan import ops
        real = ops.rwkv6_scan_cuda

        def last_unset(r, k, v, logw, u, s0, **kw):
            o, s = real(r, k, v, logw, u, s0, **kw)
            o[:, -1] = 0
            return o, s

        def decay_bf16(r, k, v, logw, u, s0, **kw):
            return real(r, k, v, logw.bfloat16().float().contiguous(), u, s0,
                        **kw)

        def no_bonus(r, k, v, logw, u, s0, **kw):
            o, s = real(r, k, v, logw, u, s0, **kw)
            return o - (r * u * k).sum(-1, keepdim=True) * v, s

        return ops, "rwkv6_scan_cuda", [("last step unset", last_unset),
                                        ("decay in bf16", decay_bf16),
                                        ("bonus u dropped", no_bonus)]
    from repro_torch.kernels.rglru_scan import ops
    real = ops.rglru_scan_cuda

    def last_unset(a, b, h0, **kw):
        h, hl = real(a, b, h0, **kw)
        h[:, -1] = 0
        return h, hl

    def decay_bf16(a, b, h0, **kw):
        return real(a.bfloat16().float().contiguous(), b, h0, **kw)

    return ops, "rglru_scan_cuda", [("last step unset", last_unset),
                                    ("decay in bf16", decay_bf16)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--floor-draws", type=int, default=2)
    ap.add_argument("--stacks", nargs="+", default=[n for n, _ in cs.STACKS],
                    choices=[n for n, _ in cs.STACKS])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.frontends.optimize import optimize
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}")
    build.build_all(force=True)
    dev = torch.device("cuda")
    record = {"nvidia_smi": smi, "floor_draws": args.floor_draws,
              "stacks": {}}
    for i, (name, cfg) in enumerate(cs.STACKS):
        if name not in args.stacks:
            continue
        shape = cs.REC_SHAPE_BT + (cfg["d_model"],)
        rows = []
        for s in range(args.seeds):
            seed = 100 + i + 10 * s     # s = 0 is chip_smoke.py's seed
            gen = torch.Generator(dev).manual_seed(seed)
            model = cs._build_stack(name, cfg, dev, gen)
            x = torch.randn(*shape, device=dev, generator=gen)
            sol = optimize(model, shape, backend="h100")
            ref = optimize(model, shape, backend="torch_ref")
            want = ref(x)
            draws = f32_floor(torch, ref, x, want, args.floor_draws)
            row = {"seed": seed, "err": cs.rel_err(sol(x), want),
                   "floor": max(draws), "floor_draws": draws,
                   "scale": float(want.abs().max())}
            if s == 0:
                mod, attr, wrong = faults(torch, name)
                real = getattr(mod, attr)
                row["faults"] = {}
                for label, fn in wrong:
                    setattr(mod, attr, fn)
                    try:
                        row["faults"][label] = {
                            "err": cs.rel_err(sol(x), want),
                            "worst_layer": max(cs.per_layer_errors(
                                torch, model, shape, x, optimize))}
                    finally:
                        setattr(mod, attr, real)
            rows.append(row)
            cs.log(f"[{name}] {json.dumps(row)}")
            del model, sol, ref, x, want
            gc.collect()
            torch.cuda.empty_cache()
        errs = [r["err"] for r in rows]
        floors = [r["floor"] for r in rows]
        fault_errs = [f["err"] for r in rows for f in r.get("faults",
                                                            {}).values()]
        summary = {"err_min": min(errs), "err_max": max(errs),
                   "floor_min": min(floors), "floor_max": max(floors),
                   "fault_err_min": min(fault_errs)}
        record["stacks"][name] = {"config": cfg, "shape": shape,
                                  "rows": rows, "summary": summary}
        cs.log(f"[{name}] summary over {len(rows)} seeds: "
               f"{json.dumps(summary)}")
    record["seconds"] = time.perf_counter() - t_start
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "recurrent_agreement.json").write_text(
        json.dumps(record, indent=1))
    cs.log(f"[done] {record['seconds']:.1f} s; {cs.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

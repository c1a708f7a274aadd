"""Training through the SOL pipeline (counterpart of ``repro.launch.train``'s
``--sol`` path):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --sol \\
        [--sol-model transformer|griffin|rwkv6] [--device cpu]

builds a model-zoo block (d 64 with ``--smoke``, else 256), compiles it
through ``optimize(training=True)``, measures every forward and backward
impl of every unique (op, bucket, dtype) of its graph into the process's
autotune cache (``_warm_autotune``), compiles it again under the
measurements, and then requires (gate 1) that the heavy kinds elect no
``ref.*`` backward and (gate 2) that every forward and backward election
of the heavy kinds is measured, before it trains on seeded data through
``make_sol_train_step`` and requires the loss to fall.  Each backward
election is printed with its provenance.  It runs on the CUDA card unless
``--device cpu`` is given (every kernel then runs its plain version).

Without ``--sol`` it exits with an error: the backbone trainer (data
pipeline, ZeRO, checkpoints, a mesh) waits for ROADMAP §1 item 7.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

_SOL_HEAVY_KINDS = ("linear", "matmul", "attention", "rglru_scan",
                    "rwkv6_scan")


def _sol_zoo_model(name: str, d_model: int, device):
    """The model-zoo block ``name`` at width ``d_model``, its weights from a
    seeded generator on ``device``."""
    from ..frontends import nn
    kw = dict(device=device,
              generator=torch.Generator(device).manual_seed(0))
    builders = {"transformer": lambda: nn.transformer_block(d_model, **kw),
                "griffin": lambda: nn.griffin_block(d_model, **kw),
                "rwkv6": lambda: nn.rwkv6_block(d_model, **kw)}
    if name not in builders:
        raise SystemExit(f"--sol-model must be one of {sorted(builders)}")
    return builders[name]()


def _node_vals(node, rng, device):
    """Synthetic operands for one graph node (float inputs only: the zoo
    training graphs carry no integer operand)."""
    from ..core.executor import TORCH_DTYPES
    return [torch.from_numpy(rng.standard_normal(i.spec.shape).astype(
        np.float32)).to(device=device, dtype=TORCH_DTYPES[i.spec.dtype])
        for i in node.inputs]


def _warm_autotune(graph, backend, device, *, warmup: int = 1,
                   iters: int = 3) -> int:
    """Measure the forward and backward impls of every unique (op, bucket,
    dtype) node of the training graph into the process's autotune cache
    (backward ones under the ``_bwd`` keys); returns the nodes swept."""
    from ..core import autotune as AT
    from ..core import measure as M
    from ..core.ir import SOURCE_OPS, OpKind

    cache = AT.get_cache()
    rng = np.random.default_rng(0)
    seen = set()
    for n in graph.topo():
        if n.op in SOURCE_OPS or n.op is OpKind.OUTPUT:
            continue
        key = (n.op.value, AT.node_shape(n), n.spec.dtype)
        if key in seen:
            continue
        seen.add(key)
        vals = _node_vals(n, rng, device)
        M.sweep_node(n, vals, backend, cache, warmup=warmup, iters=iters)
        M.sweep_node_grad(n, vals, backend, cache, warmup=warmup,
                          iters=iters)
    return len(seen)


def _sol_main(args) -> None:
    from ..distributed.steps import StepOptions, make_sol_train_step
    from ..frontends.offload import resolve_device
    from ..frontends.optimize import optimize

    dev = resolve_device(args.device)
    d_model = 64 if args.smoke else 256
    seq = min(args.seq, 128) if args.smoke else args.seq
    batch = min(args.batch, 4) if args.smoke else args.batch
    model = _sol_zoo_model(args.sol_model, d_model, dev)
    shape = (batch, seq, d_model)

    # cold compile → measure the graph's nodes → compile under them
    sm = optimize(model, shape, backend=args.sol_backend, training=True,
                  device=dev)
    swept = _warm_autotune(sm.graph, sm.backend, dev)
    sm = optimize(model, shape, backend=args.sol_backend, training=True,
                  device=dev)
    by_kind = sm.impl_report(by_kind=True)
    prov = sm.impl_report(provenance=True)
    print(f"[train --sol] {args.sol_model} d {d_model} on {dev}: warmed "
          f"{swept} node buckets; elections:")
    for kind, impls in sorted(by_kind.items()):
        print(f"  {kind:>20}: {impls}")
    for kind in sorted(k for k in by_kind if k.endswith("_bwd")):
        for name in sorted(by_kind[kind]):
            print(f"[train --sol] {kind} → {name}: "
                  f"{prov[name]['sources']}"
                  + (f" pinned {prov[name]['pinned']}"
                     if prov[name].get("pinned") else ""))

    # gate 1: the heavy kinds elect no reference backward
    for kind in _SOL_HEAVY_KINDS:
        ref_only = [name for name in by_kind.get(f"{kind}_bwd", ())
                    if name.startswith("ref.")]
        if ref_only:
            raise SystemExit(
                f"[train --sol] FAIL: {kind}_bwd elected reference "
                f"backward(s) {ref_only}; expected a registered backward "
                f"kernel after the warm-up")

    # gate 2: strict measured provenance, forward and backward
    kinds = tuple(k for k in by_kind
                  if k.removesuffix("_bwd") in _SOL_HEAVY_KINDS)
    violations = sm.check_provenance(kinds=kinds, require=("measured",))
    if violations:
        raise SystemExit("[train --sol] FAIL: provenance violations:\n  "
                         + "\n  ".join(violations))
    print(f"[train --sol] strict provenance clean over {sorted(kinds)}")

    # train: forward and backward through the elected graph
    opts = StepOptions(lr=args.lr, warmup=max(args.steps // 10, 1),
                       total_steps=args.steps)
    step_fn, init_state = make_sol_train_step(sm, opts)
    state = init_state()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    losses = []
    for step in range(args.steps):
        state, metrics = step_fn(state, {"x": x, "y": y})
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train --sol] step {step:4d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
    first, last = losses[0], losses[-1]
    if not last < first:
        raise SystemExit(f"[train --sol] FAIL: loss did not improve "
                         f"({first:.4f} -> {last:.4f})")
    print(f"[train --sol] done: loss {first:.4f} -> {last:.4f} (improved), "
          f"forward and backward on elected impls")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="d 64, at most 4 sequences of 128 (CPU-runnable)")
    ap.add_argument("--sol", action="store_true",
                    help="train through the SOL pipeline: optimize("
                         "training=True), the warm-up and both gates")
    ap.add_argument("--sol-model", default="transformer",
                    help="model-zoo block (transformer|griffin|rwkv6)")
    ap.add_argument("--sol-backend", default="h100")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if not args.sol:
        raise SystemExit(
            "repro_torch.launch.train: only --sol is ported; the backbone "
            "trainer (data pipeline, ZeRO, checkpoints, a mesh) waits for "
            "ROADMAP §1 item 7")
    _sol_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

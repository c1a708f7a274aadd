"""Training drivers (counterpart of ``repro.launch.train``).

The backbone trainer:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

runs the JAX driver's path: the synthetic data pipeline
(``data.SyntheticTokenDataset`` behind a prefetching ``DataLoader``) →
``distributed.steps.make_train_step`` (rematerialization, microbatches,
gradient compression and ZeRO specs as the flags say) → asynchronous
checkpoints (``CheckpointManager``; a run resumes from the latest one in
``--ckpt-dir``) → the straggler monitor.  It prints the JAX driver's
``[train]`` lines and its closing verdict, "improved" when the mean of
the last five losses is below the first five's.  ``--smoke`` takes the
reduced config.  ``--production-mesh`` trains on the (data 16, model 16)
pod of ``launch.mesh.make_production_mesh``, which needs a process group
of world size 256 (it raises ``RuntimeError`` naming it otherwise); each
rank then holds its blocks of the state and its rows of each batch, and
a checkpoint holds the global arrays (gathered, written by rank 0).

The SOL-pipeline path (``--sol``):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --sol \
        [--sol-model transformer|griffin|rwkv6] [--device cpu]

builds a model-zoo block (d 64 with ``--smoke``, else 256), compiles it
through ``optimize(training=True)``, measures every forward and backward
impl of every unique (op, bucket, dtype) of its graph into the process's
autotune cache (``_warm_autotune``), compiles it again under the
measurements, and then requires (gate 1) that the heavy kinds elect no
``ref.*`` backward and (gate 2) that every forward and backward election
of the heavy kinds is measured, before it trains on seeded data through
``make_sol_train_step`` and requires the loss to fall.  Each backward
election is printed with its provenance.

Both run on the CUDA card unless ``--device cpu`` is given (every kernel
then runs its plain version).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

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


def _backbone_main(args) -> Dict[str, Any]:
    """The backbone trainer; returns {"start", "steps", "losses"}."""
    from ..checkpoint import CheckpointManager
    from ..configs import get_config, get_smoke
    from ..data import DataConfig, DataLoader, SyntheticTokenDataset
    from ..distributed import sharding as S
    from ..distributed.steps import (StepOptions, init_train_state,
                                     make_train_step, train_state_shapes)
    from ..frontends.offload import resolve_device
    from ..models import backbone as B
    from ..runtime.straggler import StragglerMonitor
    from .mesh import make_debug_mesh, make_production_mesh

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    mesh = make_production_mesh(device=dev) if args.production_mesh \
        else make_debug_mesh(1, 1, device=dev)
    sharded = mesh.size > 1
    opts = StepOptions(remat=not args.no_remat, microbatch=args.microbatch,
                       grad_compression=args.grad_compression,
                       zero=not args.no_zero, lr=args.lr,
                       warmup=max(args.steps // 10, 1),
                       total_steps=args.steps)

    print(f"[train] {cfg.name}: {B.count_params(cfg):,} params, "
          f"mesh {dict(mesh.shape)} on {dev}")
    step_fn, specs = make_train_step(mesh, cfg, opts)
    state = init_train_state(cfg, opts,
                             torch.Generator(dev).manual_seed(0), dev)
    if sharded:
        state = S.shard_tree(mesh, state, specs)
    dataset = SyntheticTokenDataset(DataConfig(
        seed=0, vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
    monitor = StragglerMonitor(n_hosts=1)

    placed = S.named(mesh, specs)
    start = 0
    restored_step, restored = ckpt.restore_latest(
        train_state_shapes(cfg, opts), shardings=placed)
    if restored is not None:
        state, start = restored, restored_step
        print(f"[train] resumed from step {start}")

    loader = DataLoader(dataset, start_step=start)
    losses = []
    try:
        t0 = time.time()
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v) for k, v in next(loader).items()}
            if sharded:
                batch = S.shard_tree(mesh, batch,
                                     S.batch_specs(mesh, cfg, batch))
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            monitor.record_step({0: time.time() - t0})
            t0 = time.time()
            ckpt.maybe_save(step + 1, state, shardings=placed)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
    finally:
        ckpt.wait()
        loader.close()
    if not losses:
        print(f"[train] done: resumed at step {start}, nothing left to "
              f"train")
    else:
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        last = np.mean(losses[-5:])
        print(f"[train] done: loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return {"start": start, "steps": args.steps, "losses": losses}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(
        description="Train the model-zoo backbone, or with --sol a "
                    "model-zoo block through the SOL pipeline.")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (with --sol: d 64, at most 4 "
                         "sequences of 128); CPU-runnable")
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
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16"])
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> Optional[Dict[str, Any]]:
    """Parse ``argv`` and train: the backbone's record
    (``_backbone_main``), or None after the ``--sol`` path."""
    args = parse_args(argv)
    if args.sol:
        _sol_main(args)
        return None
    return _backbone_main(args)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

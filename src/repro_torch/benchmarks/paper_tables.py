"""The paper's own tables, in the port (counterpart of
``benchmarks/paper_tables.py``).

  * ``effort_table``   'Programming effort' (Sec. VI-A): lines of the
                       port's packages, its CUDA sources beside its .py.
  * ``inference_fig3`` Fig. 3 left: B=1 inference, the eager ``nn.Module``
                       forward against ``optimize(..., backend="h100")``,
                       on the card unless ``device="cpu"``.
  * ``training_fig3``  Fig. 3 right: a training step's gradients, eager
                       autograd of the module against autograd through
                       ``optimize(..., training=True)``, B=64 MLP and
                       B=16 CNN.

The paper's speedups are its devices'; what a run here shows is the
direction on this card, where the port's wrappers and its Python dispatch
stand beside the eager framework's own.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import torch

from ..frontends.offload import DeviceLike, resolve_device

Row = Tuple[str, float, str]

# README's conformance rows (rtol, atol) in float32: the rest, and the
# RG-LRU scan's
F32_TOL = (1e-5, 1e-5)
RGLRU_F32_TOL = (1e-4, 1e-5)


def effort_table() -> List[Row]:
    import repro_torch
    root = Path(repro_torch.__file__).parent

    def loc(sub: str, *patterns: str) -> int:
        return sum(len(p.read_text().splitlines())
                   for pat in patterns or ("*.py",)
                   for p in (root / sub).rglob(pat))

    return [
        ("loc_backend_registry", loc("backends"), "paper: <=3000/backend"),
        ("loc_kernels_all", loc("kernels", "*.py", "*.cu", "*.cuh"),
         "7 hand-written kernels: wrappers, plans, plain versions, CUDA"),
        ("loc_kernels_cuda", loc("kernels", "*.cu", "*.cuh"),
         "csrc/*.cu and *.cuh"),
        ("loc_frontend", loc("frontends"), "paper: ~2400/frontend"),
        ("loc_core_compiler", loc("core"), "IR+passes+executor+sol"),
        ("loc_serving_runtime", loc("launch") + loc("runtime"),
         "beyond-paper: SolServer, arena, staging"),
        ("loc_models", loc("models"), "beyond-paper (recurrent blocks)"),
    ]


def _cases(dev: torch.device):
    """The JAX table's five B=1 cases, with weights from a seeded
    generator on ``dev``, in eval mode."""
    from ..frontends import nn
    gen = torch.Generator(dev).manual_seed(0)
    kw = dict(device=dev, generator=gen)
    return [
        ("mlp_B1", nn.mlp_8192(3, 2048, 2048, 1000, **kw), (1, 2048),
         F32_TOL),
        ("small_cnn_B1", nn.small_cnn(**kw), (1, 3, 64, 64), F32_TOL),
        ("depthwise_cnn_B1", nn.depthwise_cnn(**kw), (1, 3, 64, 64),
         F32_TOL),
        ("transformer_B1", nn.transformer_block(64, 4, **kw), (1, 64, 64),
         F32_TOL),
        ("griffin_B1", nn.griffin_block(64, **kw), (1, 64, 64),
         RGLRU_F32_TOL),
    ]


def inference_fig3(device: DeviceLike = None) -> List[Row]:
    """Each case's eager forward and its ``h100`` SOL model on one seeded
    input: the outputs must agree within README's f32 row (elementwise
    rtol, atol) before any time counts; then ``core.measure`` times both
    (CUDA events on the card; the min of 10 calls, the mean beside it).
    PyTorch's own products and convs run in full f32 (TF32 off), as the
    port's reference tier does."""
    from ..core.measure import full_f32, time_call_stats
    from ..frontends.optimize import optimize

    dev = resolve_device(device)
    rows: List[Row] = []
    with full_f32():
        for name, model, shape, (rtol, atol) in _cases(dev):
            model = model.eval()
            x = torch.randn(shape, generator=torch.Generator(
                dev).manual_seed(1), device=dev)
            sol = optimize(model, shape, backend="h100", device=dev)
            with torch.inference_mode():
                want, got = model(x), sol(x)
            if not torch.allclose(got, want, rtol=rtol, atol=atol):
                err = float((got - want).abs().max())
                raise RuntimeError(
                    f"inference {name}: the h100 SOL model differs from the "
                    f"eager forward by max |Δ| {err:.3g} (rtol {rtol}, "
                    f"atol {atol})")
            ref = time_call_stats(lambda: model(x), 3, 10, dev)
            opt = time_call_stats(lambda: sol(x), 3, 10, dev)
            err = float((got - want).abs().max())
            rows.append((f"infer_{name}_reference", ref.min_us,
                         f"mean_us={ref.mean_us:.3f};{dev.type}"))
            rows.append((f"infer_{name}_sol", opt.min_us,
                         f"speedup={ref.min_us / opt.min_us:.2f}x;"
                         f"mean_us={opt.mean_us:.3f};max_abs_err={err:.2e};"
                         f"{dev.type}"))
    return rows


def training_fig3(device: DeviceLike = None) -> List[Row]:
    """The JAX table's two cases: d(mean(y²))/d(params) by eager autograd
    of the module (in eval mode) and by autograd through its ``h100``
    training program, on one seeded input.  The losses and every
    parameter's gradient must agree within README's f32 row before any
    time counts; then ``core.measure`` times both (outside
    ``inference_mode``; the min of 5 calls, the mean beside it)."""
    from ..core.measure import full_f32, time_call_stats
    from ..frontends import nn
    from ..frontends.optimize import optimize

    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    kw = dict(device=dev, generator=gen)
    cases = [("mlp_B64", nn.mlp_8192(3, 1024, 1024, 256, **kw), (64, 1024)),
             ("small_cnn_B16", nn.small_cnn(**kw), (16, 3, 32, 32))]
    rows: List[Row] = []
    rtol, atol = F32_TOL
    with full_f32():
        for name, model, shape in cases:
            model = model.eval()
            x = torch.randn(shape, generator=torch.Generator(
                dev).manual_seed(1), device=dev)
            sol = optimize(model, shape, backend="h100", training=True,
                           device=dev)
            params = sol._params_for_call()
            named = dict(model.named_parameters())
            keys = sorted(k for k in params if k in named)   # no buffers
            eager_p = [named[k] for k in keys]

            def sol_grad():
                leaves = [params[k].detach().requires_grad_(True)
                          for k in keys]
                loss = (sol._fn({**params, **dict(zip(keys, leaves))}, x)
                        ** 2).mean()
                return loss, torch.autograd.grad(loss, leaves)

            def eager_grad():
                loss = (model(x) ** 2).mean()
                return loss, torch.autograd.grad(loss, eager_p)

            (l_s, g_s), (l_e, g_e) = sol_grad(), eager_grad()
            err = max(float((a - b).detach().abs().max())
                      for a, b in zip((l_s, *g_s), (l_e, *g_e)))
            if not all(torch.allclose(a, b, rtol=rtol, atol=atol)
                       for a, b in zip((l_s, *g_s), (l_e, *g_e))):
                raise RuntimeError(
                    f"training {name}: the h100 SOL gradients differ from "
                    f"eager autograd by max |Δ| {err:.3g} (rtol {rtol}, "
                    f"atol {atol})")
            ref = time_call_stats(eager_grad, 1, 5, dev, inference=False)
            opt = time_call_stats(sol_grad, 1, 5, dev, inference=False)
            rows.append((f"train_{name}_reference", ref.min_us,
                         f"mean_us={ref.mean_us:.3f};{dev.type}"))
            rows.append((f"train_{name}_sol", opt.min_us,
                         f"speedup={ref.min_us / opt.min_us:.2f}x;"
                         f"mean_us={opt.mean_us:.3f};max_abs_err={err:.2e};"
                         f"{dev.type}"))
    return rows

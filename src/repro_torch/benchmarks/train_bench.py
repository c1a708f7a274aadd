"""Training-step benchmark: fwd-only against fwd+bwd through elected graphs
(counterpart of ``benchmarks/train_bench.py``).

One row pair per model-zoo family: the forward of the
``optimize(training=True)`` program, and the forward plus
``torch.autograd.grad`` of an MSE loss through the same program (every
node with a backward impl runs its elected backward through its
``torch.autograd.Function``).  The ``ratio`` column (fwd+bwd ÷ fwd) is the
number to watch: a backward regression moves it while the forward stays.

    PYTHONPATH=src python -m repro_torch.benchmarks.run train [--device cpu]

Rows land in ``BENCH_torch_train.json`` beside the run's JSON; they run on
the card unless ``--device cpu`` is given.  ``step_fns`` gives the two
timed calls, for a caller that times them its own way (``chip_smoke.py``
at full width).
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from ..frontends.offload import DeviceLike, resolve_device

B, S, D = 2, 32, 64
BACKEND = "h100"


def families(d: int = D, device=None, generator=None):
    """(name, module) of each zoo family at width ``d``."""
    from ..frontends import nn
    kw = dict(device=device, generator=generator)
    return [("transformer", nn.transformer_block(d, 4, **kw)),
            ("griffin", nn.griffin_block(d, **kw)),
            ("rwkv6", nn.rwkv6_block(d, **kw))]


def step_fns(sm, x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[Callable[[], object], Callable[[], object]]:
    """(forward, forward + backward) of a ``training=True`` SOL model on
    ``x`` against ``y``: the second returns the loss and the gradient of
    every parameter."""
    params = sm._params_for_call()
    keys = sorted(params)

    def fwd():
        with torch.no_grad():
            return sm._fn(params, x)

    def fwd_bwd():
        leaves = [params[k].detach().requires_grad_(True) for k in keys]
        loss = ((sm._fn(dict(zip(keys, leaves)), x).float() - y) ** 2) \
            .mean()
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)

    return fwd, fwd_bwd


def bwd_nodes(sm) -> int:
    """The nodes that run an elected backward impl."""
    return sum(count for kind, impls in sm.impl_report(by_kind=True).items()
               if kind.endswith("_bwd") for count in impls.values())


def csv_rows(device: DeviceLike = None, warmup: int = 2, iters: int = 5
             ) -> List[Tuple[str, float, str]]:
    """Each family's fwd and fwd+bwd rows (min µs, ``core.measure``: CUDA
    events on the card), with seeded weights and data."""
    from ..core.measure import full_f32, time_call_stats
    from ..frontends.optimize import optimize

    dev = resolve_device(device)
    b, s, d = B, S, D
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((b, s, d), generator=gen, device=dev)
    y = torch.randn((b, s, d), generator=gen, device=dev)
    rows: List[Tuple[str, float, str]] = []
    with full_f32():
        for name, model in families(d, dev, gen):
            sm = optimize(model, (b, s, d), backend=BACKEND, training=True,
                          device=dev)
            fwd, fwd_bwd = step_fns(sm, x, y)
            t_f = time_call_stats(fwd, warmup, iters, dev)
            t_b = time_call_stats(fwd_bwd, warmup, iters, dev,
                                  inference=False)
            rows.append((f"train_{name}_fwd", t_f.min_us,
                         f"bwd_nodes={bwd_nodes(sm)};"
                         f"mean_us={t_f.mean_us:.3f};{dev.type}"))
            rows.append((f"train_{name}_fwdbwd", t_b.min_us,
                         f"ratio={t_b.min_us / max(t_f.min_us, 1e-9):.2f};"
                         f"mean_us={t_b.mean_us:.3f};{dev.type}"))
    return rows

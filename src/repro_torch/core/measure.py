"""Shared impl-sweep measurement (counterpart of ``repro.core.measure``).

``sweep_node`` times every admissible impl of ONE node through the dispatch
table, sweeping each impl's declared :class:`~repro_torch.core.autotune.Tunable`
config space and restoring the node's attrs afterwards, and records the
best time (with the winning config and the impl's roofline terms) into an
:class:`~repro_torch.core.autotune.AutotuneCache`.  The offline driver
``repro_torch.benchmarks.autotune`` and ``SolServer.warm_autotune`` both
measure through it, so the two paths cannot drift.

``sweep_node_grad`` does the same for the node's backward impls, each
called on the residuals ``(vals, out)`` and the cotangent
``ones_like(out)``, and records under the ``_bwd`` cache key
(``registry.grad_cache_op``) that the backward election reads.

What the number is.  Each call of ``impl.fn(node, vals, backend)`` runs
under ``torch.inference_mode()`` (a backward impl's outside it: some
record autograd graphs of their own) and is timed on its own:

* on the card, a ``torch.cuda.Event`` pair is recorded on the current
  stream around the call and the host synchronizes after it.  The time is
  the span from when the stream reaches the first event to when it
  reaches the second: the kernels' device time, plus the host's cost of
  launching them (the Python dispatch and a ctypes wrapper) wherever that
  cost exceeds the time the device takes, since the stream then waits on
  the host.  L2 is not flushed, so operands that fit the 50 MB L2 are
  warm.  These are not ``chip_smoke.py``'s kernel-table times (cold L2,
  the host far ahead of the device); the two are never one figure;
* on the CPU, ``time.perf_counter`` around the call.

Min for elections, mean for figures: both statistics are kept
(:class:`Timing`).  The cache's ``Measurement.us`` is the min over the
individually timed calls (a hiccup inflates a mean, never a min) and
``Measurement.mean_us`` the mean.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Timing:
    min_us: float                          # election-grade estimate
    mean_us: float                         # user-experienced average


@dataclasses.dataclass(frozen=True)
class ConfigMeasurement:
    config: Optional[Tuple[int, ...]]      # the swept tunable config
    us: float                              # min time
    mean_us: float                         # mean time
    error: Optional[str] = None            # impl raised for this config


@dataclasses.dataclass(frozen=True)
class ImplMeasurement:
    impl: str                              # impl name, as cache-recorded
    us: float                              # best measured (min) time
    config: Optional[Tuple[int, ...]]      # winning tunable config (or None)
    n_configs: int                         # size of the swept config space
    mean_us: float = 0.0                   # mean time of the winning config


def _timer(device: Optional[torch.device]) -> Callable[[Callable], float]:
    """A function that runs ``fn`` once and returns its time in µs: CUDA
    events on ``device``'s current stream, else ``perf_counter``."""
    if device is not None and device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(device)

        def once(fn) -> float:
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end) * 1e3
        return once

    def once(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e6
    return once


def time_call_stats(fn: Callable[[], object], warmup: int = 2,
                    iters: int = 5,
                    device: Optional[torch.device] = None,
                    inference: bool = True) -> Timing:
    """Time ``fn`` per call (µs) after ``warmup`` calls and return the min
    and the mean over ``iters`` calls, each timed on its own (module
    docstring); ``device`` is where ``fn`` runs.  ``inference=False``
    times outside ``torch.inference_mode()``, for a ``fn`` that records
    autograd graphs (a backward, or a forward to differentiate)."""
    once = _timer(device)
    with (torch.inference_mode() if inference
          else contextlib.nullcontext()):
        for _ in range(max(warmup, 1)):
            fn()
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        samples = [once(fn) for _ in range(max(iters, 1))]
    return Timing(min_us=min(samples), mean_us=sum(samples) / len(samples))


def time_call(fn: Callable[[], object], warmup: int = 2, iters: int = 5,
              device: Optional[torch.device] = None) -> float:
    """Election-grade time of ``fn`` in µs: the min over ``iters``
    individually timed calls after warmup."""
    return time_call_stats(fn, warmup, iters, device).min_us


@contextlib.contextmanager
def full_f32():
    """PyTorch's own f32 products and convolutions in full f32 (TF32 off,
    as the port's reference tier runs them) for the block; the flags are
    restored after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _device_of(vals: Sequence[object]) -> Optional[torch.device]:
    return next((v.device for v in vals if isinstance(v, torch.Tensor)),
                None)


def _measure_configs(node, impl, configs, call, dev, inference: bool,
                     warmup: int, iters: int, skip_errors: bool
                     ) -> List[ConfigMeasurement]:
    """Time ``call()`` once per config of ``impl`` pinned on ``node``; the
    node's tunable attr is cleared in a ``try/finally``, and a raising
    config, with ``skip_errors``, yields a ``ConfigMeasurement`` with
    ``error`` set."""
    tun = impl.tunable
    out: List[ConfigMeasurement] = []
    try:
        for cfg in configs:
            if tun is not None:
                tun.bind_config(node, cfg)
            try:
                t = time_call_stats(call, warmup, iters, dev, inference)
            except Exception as e:
                if not skip_errors:
                    raise
                out.append(ConfigMeasurement(cfg, float("inf"), float("inf"),
                                             error=f"{type(e).__name__}: {e}"))
                continue
            out.append(ConfigMeasurement(cfg, t.min_us, t.mean_us))
    finally:
        if tun is not None:
            tun.bind_config(node, None)    # never leave a sweep's pin behind
    return out


def measure_impl_configs(node, vals: Sequence[object], backend, impl,
                         configs: Sequence[Optional[Tuple[int, ...]]], *,
                         warmup: int = 2, iters: int = 5,
                         skip_errors: bool = False
                         ) -> List[ConfigMeasurement]:
    """Time ``impl`` on ``node`` once per config in ``configs`` (``None``
    is the impl's default).  The node's tunable attr is cleared in a
    ``try/finally``: an impl raising mid-measurement never leaves a swept
    config pinned on the node.  With ``skip_errors=True`` a raising config
    yields a ``ConfigMeasurement`` with ``error`` set instead of
    propagating."""
    return _measure_configs(
        node, impl, configs, lambda: impl.fn(node, list(vals), backend),
        _device_of(vals), True, warmup, iters, skip_errors)


def measure_grad_impl_configs(node, res, ct, backend, impl,
                              configs: Sequence[Optional[Tuple[int, ...]]],
                              *, warmup: int = 2, iters: int = 5,
                              skip_errors: bool = False
                              ) -> List[ConfigMeasurement]:
    """The backward mirror of :func:`measure_impl_configs`: times a grad
    impl (``fn(node, res, ct, backend)``) once per config, outside
    ``inference_mode``.  ``res`` is the residual pair ``(inputs,
    output)`` and ``ct`` the output's cotangent."""
    return _measure_configs(
        node, impl, configs, lambda: impl.fn(node, res, ct, backend),
        _device_of(res[0]), False, warmup, iters, skip_errors)


def _sweep(node, impls, measure, backend, cache, op_key: str,
           cost_scale: float) -> List[ImplMeasurement]:
    """Sweep each impl's ``Tunable`` space through ``measure(impl,
    configs)`` and record its best under ``op_key``, with the node's
    roofline terms times ``cost_scale``."""
    from . import autotune as AT
    from .passes import _node_cost_terms

    flops, streamed, roundtrip = (cost_scale * t
                                  for t in _node_cost_terms(node))
    out: List[ImplMeasurement] = []
    for impl in impls:
        tun = impl.tunable
        configs: List[Optional[Tuple[int, ...]]] = [None]
        if tun is not None:
            space = tun.tune_space(node, backend.hw)
            if space:
                configs = list(space)
        results = measure(impl, configs)
        best = min(results, key=lambda r: r.us)
        nbytes = roundtrip if impl.memory == "roundtrip" else streamed
        cache.record(op_key, AT.node_shape(node), node.spec.dtype,
                     backend.cache_name, impl.name, best.us,
                     config=best.config,
                     flops=flops, nbytes=nbytes, mean_us=best.mean_us)
        out.append(ImplMeasurement(impl.name, best.us, best.config,
                                   len(configs), mean_us=best.mean_us))
    return out


def sweep_node_grad(node, vals: Sequence[object], backend, cache, *,
                    warmup: int = 2, iters: int = 5
                    ) -> List[ImplMeasurement]:
    """Measure every admissible backward impl of ``node`` (each one's own
    ``Tunable`` space swept, as the forwards are) on the residuals of the
    reference forward at ``vals`` and the cotangent ``ones_like(out)``,
    and record each impl's best time under the ``_bwd`` op key, with
    twice the forward's roofline terms.  Returns the per-impl results."""
    from ..backends import registry as R

    grads = R.grad_candidates(backend, node)
    if not grads:
        return []
    ref = R._REFERENCE_IMPLS[node.op]
    with torch.no_grad():
        out = ref.fn(node, list(vals), backend)
    res = (tuple(vals), out)
    ct = torch.ones_like(out)
    return _sweep(node, grads, lambda impl, configs: measure_grad_impl_configs(
        node, res, ct, backend, impl, configs, warmup=warmup, iters=iters),
        backend, cache, R.grad_cache_op(node.op), 2.0)


def sweep_node(node, vals: Sequence[object], backend, cache, *,
               warmup: int = 2, iters: int = 5) -> List[ImplMeasurement]:
    """Measure every admissible impl of ``node`` on ``backend`` on the
    operands ``vals`` (in ``node.inputs`` order) and record each impl's best
    time into ``cache`` under the node's autotune bucket.  Returns the
    per-impl results for reporting."""
    from ..backends import registry as R

    return _sweep(node, R.candidates(backend, node),
                  lambda impl, configs: measure_impl_configs(
                      node, vals, backend, impl, configs, warmup=warmup,
                      iters=iters),
                  backend, cache, node.op.value, 1.0)

"""Shared impl-sweep measurement (counterpart of ``repro.core.measure``).

``sweep_node`` times every admissible impl of ONE node through the dispatch
table, sweeping each impl's declared :class:`~repro_torch.core.autotune.Tunable`
config space and restoring the node's attrs afterwards, and records the
best time (with the winning config and the impl's roofline terms) into an
:class:`~repro_torch.core.autotune.AutotuneCache`.  The offline driver
``repro_torch.benchmarks.autotune`` and ``SolServer.warm_autotune`` both
measure through it, so the two paths cannot drift.

What the number is.  Each call of ``impl.fn(node, vals, backend)`` runs
under ``torch.inference_mode()`` and is timed on its own:

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
                    device: Optional[torch.device] = None) -> Timing:
    """Time ``fn`` per call (µs) after ``warmup`` calls and return the min
    and the mean over ``iters`` calls, each timed on its own (module
    docstring); ``device`` is where ``fn`` runs."""
    once = _timer(device)
    with torch.inference_mode():
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


def _device_of(vals: Sequence[object]) -> Optional[torch.device]:
    return next((v.device for v in vals if isinstance(v, torch.Tensor)),
                None)


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
    tun = impl.tunable
    dev = _device_of(vals)
    out: List[ConfigMeasurement] = []
    try:
        for cfg in configs:
            if tun is not None:
                tun.bind_config(node, cfg)
            try:
                t = time_call_stats(lambda: impl.fn(node, list(vals), backend),
                                    warmup, iters, dev)
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


def sweep_node(node, vals: Sequence[object], backend, cache, *,
               warmup: int = 2, iters: int = 5) -> List[ImplMeasurement]:
    """Measure every admissible impl of ``node`` on ``backend`` on the
    operands ``vals`` (in ``node.inputs`` order) and record each impl's best
    time into ``cache`` under the node's autotune bucket.  Returns the
    per-impl results for reporting."""
    from ..backends import registry as R
    from . import autotune as AT
    from .passes import _node_cost_terms

    flops, streamed, roundtrip = _node_cost_terms(node)
    out: List[ImplMeasurement] = []
    for impl in R.candidates(backend, node):
        tun = impl.tunable
        configs: List[Optional[Tuple[int, ...]]] = [None]
        if tun is not None:
            space = tun.tune_space(node, backend.hw)
            if space:
                configs = list(space)
        results = measure_impl_configs(node, vals, backend, impl, configs,
                                       warmup=warmup, iters=iters)
        best = min(results, key=lambda r: r.us)
        nbytes = roundtrip if impl.memory == "roundtrip" else streamed
        cache.record(node.op.value, AT.node_shape(node), node.spec.dtype,
                     backend.cache_name, impl.name, best.us, config=best.config,
                     flops=flops, nbytes=nbytes, mean_us=best.mean_us)
        out.append(ImplMeasurement(impl.name, best.us, best.config,
                                   len(configs), mean_us=best.mean_us))
    return out

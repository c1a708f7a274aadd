"""The port's speed-of-light gap analysis on the CPU, held against the JAX
package's ``core/sol.py``: the bound is the election's roofline model with
its FLOPs at the peak of the unit that runs each impl (SIMT f32, 3xTF32,
the 16-bit tensor cores), ratios stay finite and non-negative for any
floats (hypothesis, valid strategies, and the two overflows the JAX
property found pinned), nearest-bucket and calibrated rows never pass for
exact measurements, ``impl_report(sol=True)``, the gap-driven planner over
the port's own Tunables with an injected measure, and, on a cold cache, the
same counts, tensor16 bounds and rank order as the JAX package for the
served LM, a Griffin block, an RWKV6 block and ``small_cnn``.  The kernel
table's bounds (``PERF.md``) come out of the port's ``sol`` unchanged."""
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
from _hypo import hypothesis, st  # real hypothesis, or skip-stubs when absent
import pytest

from repro.backends import get_backend as j_backend
from repro.core import passes as jpasses
from repro.core import sol as jsol
from repro.core.autotune import AutotuneCache as JCache
from repro.frontends import nn as jnn
from repro.frontends.optimize import optimize as j_optimize
from repro.launch.serve import ServeConfig as JServeConfig
from repro.launch.serve import build_lm as j_build_lm
from repro_torch.backends import get_backend
from repro_torch.backends import registry as R
from repro_torch.backends.registry import H100_PCIE, H100_SXM, UNITS
from repro_torch.benchmarks.autotune import _node, refine_plan
from repro_torch.core import autotune, ir, passes, sol
from repro_torch.core.autotune import AutotuneCache, Tunable
from repro_torch.core.ir import Graph, Node, OpKind, TensorSpec
from repro_torch.core.measure import ConfigMeasurement
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize
from repro_torch.launch.serve import ServeConfig, build_lm

from test_torch_cnn import IMPL_MAP as CNN_IMPL_MAP
from test_torch_pipeline import IMPL_MAP as LM_IMPL_MAP
from test_torch_recurrent import IMPL_MAP as REC_IMPL_MAP

HW = get_backend("h100").hw
# the port's kernel impls and the JAX package's Pallas impls, one for one
IMPL_MAP = {**LM_IMPL_MAP, **REC_IMPL_MAP, **CNN_IMPL_MAP}
# the planner's cases: a product whose K leaves the matmul's plan room to
# split, so its refine space reaches past its tune space
PLAN_SHAPE = (64, 8192, 64)
PLAN_TERMS = dict(flops=2.0 * 64 * 8192 * 64,
                  nbytes=4.0 * (64 * 8192 + 8192 * 64 + 64 * 64))


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Every test starts and leaves the process with a cold port cache."""
    prev = autotune._CACHE
    autotune.set_cache(AutotuneCache())
    yield
    autotune.set_cache(prev)


def _linear_graph(b=2, d_in=16, d_out=32):
    x = ir.input_node((b, d_in), name="x")
    w = ir.param_node((d_out, d_in), name="w")
    lin = Node(OpKind.LINEAR, [x, w], TensorSpec((b, d_out)),
               attrs={"out_features": d_out})
    return Graph([x], [lin], {"w": w}), lin


# -- peaks by unit ------------------------------------------------------------

def test_unit_peaks_of_both_cards():
    """SXM: 67 TFLOP/s SIMT, 495/3 TF32 passes, 989 bf16; PCIe: 51, 378/3,
    756.  With no unit, ``compute_s`` keeps the bf16 peak (the election's
    cost, the JAX package's)."""
    assert [H100_SXM.peak_flops(u) for u in UNITS] == [67e12, 165e12, 989e12]
    assert [H100_PCIE.peak_flops(u) for u in UNITS] == [51e12, 126e12,
                                                         756e12]
    assert H100_SXM.compute_s(989e12) == 1.0
    assert H100_SXM.compute_s(67e12, "simt") == 1.0
    with pytest.raises(ValueError):
        H100_SXM.peak_flops("fp8")


@pytest.mark.parametrize("impl,shape,dtype,unit", [
    ("cuda.matmul", (512, 1536, 1536), "float32", "tf32x3"),
    ("cuda.linear", (512, 1536, 1536), "bfloat16", "tensor16"),
    ("cuda.linear", (4, 1536, 151936), "float32", "simt"),      # skinny
    ("cuda.matmul", (2048, 2048, 4), "bfloat16", "simt"),       # skinny
    ("cuda.flash_attention", (4, 128, 12, 128), "float32", "tf32x3"),
    ("cuda.flash_attention", (4, 128, 12, 128), "float16", "tensor16"),
    ("cuda.decode_attention", (4, 128, 12, 128), "bfloat16", "simt"),
    ("cuda.rwkv6_scan", (4, 512, 32, 64), "bfloat16", "simt"),
    ("ref.linear", (512, 1536, 151936), "float32", "simt"),
    ("ref.matmul", (512, 1536, 1536), "bfloat16", "tensor16"),
    ("ref.conv2d", (64, 32, 224, 224), "float16", "tensor16"),
    ("ref.attention", (4, 128, 12, 128), "bfloat16", "simt"),   # f32 inside
    ("ref.compose", (512, 6144), "bfloat16", "simt"),
])
def test_each_impl_declares_the_unit_that_runs_it(impl, shape, dtype, unit):
    assert R.get_impl(impl).unit_at(shape, dtype) == unit


def test_matmul_unit_follows_the_kernel_its_plan_picks():
    from repro_torch.kernels.matmul import ops as mm_ops
    for shape in ((16, 64, 256), (17, 64, 256), (256, 64, 16),
                  (256, 64, 17), (512, 1536, 6144)):
        n = _node("linear", shape)
        kernel = mm_ops.node_plan(n, HW).kernel
        assert (R.get_impl("cuda.linear").unit_of(n) == "simt") == \
            (kernel == "skinny")


# -- the bound: the election's roofline model ------------------------------------

@pytest.mark.parametrize("unit", ["default", *UNITS])
def test_sol_bound_is_the_roofline_model(unit):
    """Each unit's bound is the roofline model at its peak; with no unit
    given, bound and model both take the bf16 peak."""
    kw = {} if unit == "default" else {"unit": unit}
    flops, nbytes = 2 * 256 ** 3, 3 * 256 * 256 * 4
    bound_us, dom = sol.sol_bound_us(HW, flops, nbytes, **kw)
    assert bound_us == pytest.approx(
        HW.roofline_s(flops, nbytes, **kw) * 1e6)
    if unit == "default":
        assert bound_us == sol.sol_bound_us(HW, flops, nbytes, "tensor16")[0]
    assert dom in ("compute", "memory")
    assert sol.sol_bound_us(HW, 1e15, 1.0, **kw)[1] == "compute"
    assert sol.sol_bound_us(HW, 1.0, 1e12, **kw)[1] == "memory"
    assert sol.sol_bound_us(HW, 0.0, 0.0, **kw) == (0.0, "")


def test_node_roofline_terms_matches_node_cost_terms():
    _g, lin = _linear_graph()
    flops, streamed, roundtrip = passes._node_cost_terms(lin)
    f1, b1, s1 = passes.node_roofline_terms(lin, HW)
    assert (f1, b1) == (flops, streamed)
    assert s1 == pytest.approx(HW.roofline_s(flops, streamed))
    f2, b2, s2 = passes.node_roofline_terms(lin, HW, memory="roundtrip",
                                            unit="simt")
    assert (f2, b2) == (flops, roundtrip)
    assert s2 == pytest.approx(HW.roofline_s(flops, roundtrip, unit="simt"))


# -- ratio guarantees ---------------------------------------------------------------

@hypothesis.given(us=st.floats(), bound=st.floats())
def test_sol_ratio_always_finite_nonnegative(us, bound):
    r = sol.sol_ratio(us, bound)
    assert math.isfinite(r) and r >= 0.0


@pytest.mark.parametrize("us,bound", [
    (2.0, 1.1125369292536007e-308),
    (279760242333422.0, 1.5562180046643388e-294),
])
def test_sol_ratio_saturates_the_jax_propertys_overflows(us, bound):
    """The JAX property's recorded falsifying examples: a huge time over a
    subnormal bound, where the JAX ratio overflows to inf."""
    assert math.isinf(jsol.sol_ratio(us, bound))
    assert sol.sol_ratio(us, bound) == sys.float_info.max


@hypothesis.given(us=st.floats(), flops=st.floats(), nbytes=st.floats(),
                  dims=st.lists(st.integers(min_value=1, max_value=2 ** 20),
                                min_size=1, max_size=4),
                  impl=st.sampled_from(["ref.matmul", "cuda.matmul"]))
def test_cache_rows_ratios_finite_for_arbitrary_entries(us, flops, nbytes,
                                                        dims, impl):
    """Any cache entry, degenerate terms and inf/nan times included, gives
    a row whose ratio and bound are finite and non-negative."""
    c = AutotuneCache()
    c.record("matmul", tuple(dims), "float32", "h100", impl, us,
             flops=flops, nbytes=nbytes)
    rows = sol.cache_rows(c)
    assert len(rows) == 1
    assert math.isfinite(rows[0].ratio) and rows[0].ratio >= 0.0
    assert math.isfinite(rows[0].bound_us) and rows[0].bound_us >= 0.0


# -- provenance: exact vs nearest, measured vs calibrated ---------------------------

def test_cache_rows_are_exact_measured_and_best_only_elects():
    c = AutotuneCache()
    c.record("matmul", (256, 256, 256), "float32", "h100", "ref.matmul",
             50.0, flops=2 * 256 ** 3, nbytes=3 * 256 * 256 * 4)
    c.record("matmul", (256, 256, 256), "float32", "h100", "cuda.matmul",
             30.0, config=(1,), flops=2 * 256 ** 3, nbytes=3 * 256 * 256 * 4)
    rows = sol.cache_rows(c)
    assert len(rows) == 2
    assert all(r.confidence == "exact" and r.source == "measured"
               for r in rows)
    assert all(r.ratio == pytest.approx(r.us / r.bound_us) for r in rows)
    assert {r.impl: r.unit for r in rows} == {"ref.matmul": "simt",
                                              "cuda.matmul": "tf32x3"}
    best = sol.cache_rows(c, best_only=True)
    assert len(best) == 1 and best[0].impl == "cuda.matmul"
    # a backend the registry does not know is skipped
    c.record("matmul", (64, 64, 64), "float32", "xla", "ref.matmul", 9.0,
             flops=1.0, nbytes=1.0)
    assert len(sol.cache_rows(c)) == 2


def test_cache_rows_take_the_spec_of_the_card_they_are_read_on(monkeypatch):
    """On a CUDA device the bound takes the card's spec by its name, as
    ``SolServer`` and ``compile_graph`` do: a PCIe card's bound uses its
    2.0 TB/s; the SXM card reads the registered spec."""
    import torch
    c = AutotuneCache()
    c.record("linear", (4, 1536, 151936), "float32", "h100", "ref.linear",
             400.0, flops=2.0 * 4 * 1536 * 151936, nbytes=9.36e8)
    (sxm,) = sol.cache_rows(c)
    assert sxm.bound_us == pytest.approx(9.36e8 / 3.35e12 * 1e6)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 PCIe")
    (pcie,) = sol.cache_rows(c, device="cuda:0")
    assert pcie.bound_us == pytest.approx(9.36e8 / 2.0e12 * 1e6)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    (card,) = sol.cache_rows(c, device="cuda:0")
    assert card.bound_us == sxm.bound_us


def test_node_rows_nearest_bucket_is_tagged_nearest():
    g, lin = _linear_graph(b=2, d_in=16, d_out=32)   # keys on (2, 16, 32)
    lin.impl = "ref.linear"
    backend = get_backend("h100")
    c = AutotuneCache()
    c.record("linear", (2, 16, 64), "float32", "h100", "ref.linear", 50.0,
             flops=1.0, nbytes=1.0)                  # only a neighbour
    (row,) = [r for r in sol.node_rows(g, backend, c) if r.op == "linear"]
    assert row.confidence == "nearest" and row.source == "measured"
    assert row.us == 50.0 and row.ratio > 0.0

    c.record("linear", (2, 16, 32), "float32", "h100", "ref.linear", 40.0,
             flops=1.0, nbytes=1.0)                  # now the exact bucket
    (row,) = [r for r in sol.node_rows(g, backend, c) if r.op == "linear"]
    assert row.confidence == "exact" and row.us == 40.0


def test_node_rows_cold_cache_stays_analytical():
    g, lin = _linear_graph()
    lin.impl = "ref.linear"
    (row,) = [r for r in sol.node_rows(g, get_backend("h100"),
                                       AutotuneCache()) if r.op == "linear"]
    assert row.source == "analytical" and row.ratio == 0.0 and row.us == 0.0
    assert row.bound_us > 0.0 and row.unit == "simt"


def test_node_rows_calibrated_has_no_bucket_confidence():
    g, lin = _linear_graph()
    lin.impl = "ref.linear"
    c = AutotuneCache()
    c.set_calibration("h100", "linear",
                      {"s_per_flop": 1e-12, "s_per_byte": 1e-10, "n": 4.0})
    (row,) = [r for r in sol.node_rows(g, get_backend("h100"), c)
              if r.op == "linear"]
    assert row.source == "calibrated"
    assert row.confidence == ""
    assert row.us > 0.0 and math.isfinite(row.ratio)


def test_rank_never_lets_estimates_outrank_exact_measurements():
    def row(ratio, conf, src):
        return sol.SolRow(op="matmul", bucket=(64, 64, 64), dtype="float32",
                          backend="h100", impl="ref.matmul", us=ratio,
                          bound_us=1.0, ratio=ratio, bottleneck="compute",
                          confidence=conf, source=src)
    exact_small = row(2.0, "exact", "measured")
    exact_big = row(90.0, "exact", "measured")
    nearest_huge = row(1e6, "nearest", "measured")
    calibrated_huge = row(1e9, "", "calibrated")
    ranked = sol.rank([nearest_huge, exact_small, calibrated_huge, exact_big])
    assert ranked[0] is exact_big and ranked[1] is exact_small
    assert all(r in (nearest_huge, calibrated_huge) for r in ranked[2:])
    assert ranked[2] is calibrated_huge


def test_render_lists_every_row():
    c = AutotuneCache()
    c.record("matmul", (64, 64, 64), "float32", "h100", "ref.matmul", 9.0,
             flops=2 * 64 ** 3, nbytes=3 * 64 * 64 * 4)
    text = sol.render(sol.rank(sol.cache_rows(c)))
    assert "ref.matmul" in text and "ratio" in text and "64x64x64" in text
    assert "simt" in text


# -- the port's yardstick on PERF.md's rows ---------------------------------------

def _bound_ms(impl, shape, dtype, flops, nbytes):
    unit = R.get_impl(impl).unit_at(shape, dtype)
    return sol.sol_bound_us(HW, flops, nbytes, unit)[0] / 1e3


@pytest.mark.parametrize("shape,dtype,itemsize,want_ms", [
    ((2048, 4096, 4096), "float32", 4, 0.4165),      # tc, 3xTF32 operations
    ((2048, 4096, 4096), "bfloat16", 2, 0.0695),     # tc16 operations
    ((4, 1536, 151936), "float32", 4, 0.2794),       # skinny, bytes
])
def test_kernel_table_bounds_come_out_of_sol_unchanged(shape, dtype,
                                                       itemsize, want_ms):
    m, k, n = shape
    got = _bound_ms("cuda.linear", shape, dtype, 2.0 * m * k * n,
                    float(itemsize) * (m * k + k * n + m * n))
    assert round(got, 4) == want_ms


def test_lm_head_ranks_the_hand_kernel_above_cublas_sgemm():
    """The served f32 prefill LM head (512x1536x151936, PERF.md): at the
    bf16 peak both read 10-13x off the bytes bound; at the peak of the
    unit that runs each, the 3xTF32 kernel sits 2.61x off and the SGEMM
    1.35x."""
    m, k, n = 512, 1536, 151936
    flops, nbytes = 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)
    c = AutotuneCache()
    for impl, us in (("cuda.linear", 3777.31), ("ref.linear", 4812.96)):
        c.record("linear", (m, k, n), "float32", "h100", impl, us,
                 flops=flops, nbytes=nbytes)
    ranked = sol.rank(sol.cache_rows(c))
    assert [r.impl for r in ranked] == ["cuda.linear", "ref.linear"]
    assert [round(r.ratio, 2) for r in ranked] == [2.61, 1.35]
    # the election's yardstick (the bf16 peak) ranks them the other way
    bf16 = [us / sol.sol_bound_us(HW, flops, nbytes)[0]
            for us in (3777.31, 4812.96)]
    assert bf16[1] > bf16[0] > 10.0


# -- impl_report(sol=True) ------------------------------------------------------

def test_impl_report_sol_surfaces_ranked_rows():
    m = optimize(nn.Sequential(nn.Linear(16, 32, device="cpu"), nn.GELU()),
                 (2, 16), backend="h100", device="cpu")
    rows = m.impl_report(sol=True)
    assert rows and all(
        {"op", "impl", "ratio", "bound_us", "confidence", "source", "unit"}
        <= set(r) for r in rows)
    assert all(math.isfinite(r["ratio"]) and r["ratio"] >= 0.0 for r in rows)
    tiers = [0 if (r["confidence"] == "exact" and r["source"] == "measured")
             else 1 for r in rows]
    assert tiers == sorted(tiers)


def test_impl_report_sol_reflects_cache_measurements():
    m = optimize(nn.Linear(16, 32, device="cpu"), (2, 16), backend="h100",
                 device="cpu")
    lin = m.graph.nodes_of(OpKind.LINEAR)[0]
    autotune.get_cache().record("linear", autotune.node_shape(lin),
                                "float32", "h100", lin.impl, 25.0,
                                flops=1.0, nbytes=1.0)
    (row,) = [r for r in m.impl_report(sol=True) if r["op"] == "linear"]
    assert row["source"] == "measured" and row["confidence"] == "exact"
    assert row["us"] == 25.0 and row["ratio"] > 0.0


# -- Tunable.refine_space ------------------------------------------------------

def test_refine_space_default_pow2_neighborhood():
    tun = Tunable("blk", lambda n, hw: [(64, 64), (128, 128)])
    neigh = tun.refine_space(None, None, (64, 64))
    assert neigh
    assert (64, 64) not in neigh
    assert (128, 128) not in neigh
    assert (32, 32) in neigh and (64, 128) in neigh
    assert all(all(d >= 1 for d in c) for c in neigh)
    assert len(set(neigh)) == len(neigh)


def test_refine_space_floor_at_one():
    tun = Tunable("blk", lambda n, hw: [])
    assert tun.refine_space(None, None, (1,)) == [(2,)]


def test_refine_space_custom_hook_stays_legal():
    """The pooling's refine probes are band heights its plan keeps as they
    are, each whose band fits the card's shared memory."""
    from repro_torch.kernels.avgpool.ops import (avgpool_refine_space,
                                                 node_plan)
    n = Node(OpKind.AVGPOOL, [ir.input_node((2, 16, 226, 226))],
             TensorSpec((2, 16, 224, 224)), attrs={"kernel": 3, "stride": 1})
    probes = avgpool_refine_space(n, HW, (16,))
    assert probes
    for (rows,) in probes:
        p = node_plan(n, rows)
        assert p.rows == rows and p.smem <= HW.smem_bytes


# -- the gap-driven refinement planner -------------------------------------------

def _measurement(config, us):
    return ConfigMeasurement(config=config, us=us, mean_us=us)


def _plan_cache(*entries):
    c = AutotuneCache()
    for impl, us, cfg in entries:
        c.record("matmul", PLAN_SHAPE, "float32", "h100", impl, us,
                 config=cfg, **PLAN_TERMS)
    return c


def _win_and_target():
    node = _node("matmul", PLAN_SHAPE)
    tun = R.get_impl("cuda.matmul").tunable
    initial = set(tun.tune_space(node, HW))
    win = sorted(initial)[0]
    target = tun.refine_space(node, HW, win)[0]
    assert target not in initial
    return initial, win, target


def _times(config, win, win_us, target, target_us):
    """A doctored reading: the incumbent at its cached time, the target
    config faster, every other config slower."""
    return {tuple(win): win_us, tuple(target): target_us}.get(
        tuple(config), 9000.0)


def test_refine_plan_closes_doctored_gap_outside_tune_space():
    initial, win, target = _win_and_target()
    c = _plan_cache(("cuda.matmul", 4000.0, win))

    def fake_measure(node, vals, bk, impl, configs):
        return [_measurement(c2, _times(c2, win, 4000.0, target, 1000.0))
                for c2 in configs]

    (rep,) = refine_plan(c, "h100", top_k=1, rounds=3, budget=64,
                         measure=fake_measure, device="cpu")
    assert rep["refined_impl"] == "cuda.matmul"
    assert rep["rounds"] >= 1 and rep["configs_measured"] > 0
    assert rep["config"] == target and rep["outside_space"]
    assert rep["recorded"] == [target]
    assert rep["after_us"] == 1000.0
    assert rep["after_ratio"] < rep["before_ratio"]
    m = c.lookup("matmul", PLAN_SHAPE, "float32", "h100")["cuda.matmul"]
    assert m.us == 1000.0 and m.config == target


def test_refine_plan_refines_tunable_even_when_ref_wins_the_cell():
    _initial, win, target = _win_and_target()
    c = _plan_cache(("ref.matmul", 500.0, None),
                    ("cuda.matmul", 4000.0, win))

    def fake_measure(node, vals, bk, impl, configs):
        return [_measurement(c2, _times(c2, win, 4000.0, target, 100.0))
                for c2 in configs]

    (rep,) = refine_plan(c, "h100", top_k=1, rounds=3, budget=64,
                         measure=fake_measure, device="cpu")
    assert rep["before_us"] == 500.0
    assert rep["refined_impl"] == "cuda.matmul"
    assert rep["impl"] == "cuda.matmul"
    assert rep["after_us"] == 100.0 and rep["outside_space"]
    assert rep["after_ratio"] < rep["before_ratio"]


def test_refine_plan_early_stops_when_gap_stops_closing():
    _initial, win, _target = _win_and_target()
    c = _plan_cache(("cuda.matmul", 4000.0, win))

    def no_gain(node, vals, bk, impl, configs):
        return [_measurement(c2, 3999.0) for c2 in configs]

    (rep,) = refine_plan(c, "h100", top_k=1, rounds=5, budget=1000,
                         measure=no_gain, device="cpu")
    assert rep["rounds"] == 1
    assert rep["config"] == win and not rep["outside_space"]
    assert rep["after_us"] == 4000.0 and rep["recorded"] == []


def test_refine_plan_records_nothing_where_the_bucket_rounds_down():
    """The cell's time was taken at 80 rows, its bucket holds 64: every
    probe at the bucket reads 20% less work than the cached time, yet no
    config is faster than the incumbent at that shape, so nothing is
    recorded."""
    _initial, win, _target = _win_and_target()
    served = (80,) + PLAN_SHAPE[1:]
    c = AutotuneCache()
    c.record("matmul", served, "float32", "h100", "cuda.matmul",
             80 * 0.05, config=win, **PLAN_TERMS)
    shapes = []

    def per_row(node, vals, bk, impl, configs):
        rows = node.inputs[0].spec.shape[0]
        shapes.append(rows)
        return [_measurement(c2, rows * 0.05) for c2 in configs]

    (rep,) = refine_plan(c, "h100", top_k=1, rounds=3, budget=64,
                         measure=per_row, device="cpu")
    assert rep["bucket"] == PLAN_SHAPE and shapes == [64]
    assert rep["rounds"] == 1 and rep["recorded"] == []
    assert rep["config"] == win and rep["after_us"] == 80 * 0.05
    (m,) = c.lookup("matmul", served, "float32", "h100").values()
    assert m.us == 80 * 0.05 and m.config == win


def test_refine_plan_flags_rewrite_candidates():
    c = _plan_cache(("ref.matmul", 1e6, None))

    def never_called(node, vals, bk, impl, configs):    # pragma: no cover
        raise AssertionError("no tunable impl: nothing to measure")

    (rep,) = refine_plan(c, "h100", top_k=1, measure=never_called,
                         device="cpu")
    assert rep["rewrite_candidate"] and rep["rounds"] == 0
    assert "nothing to refine" in rep["note"]


# -- parity with the JAX package on a cold cache -------------------------------

D = 64


def _pairs():
    """(label, JAX model, port model, input shape): the served LM (2
    layers, d 64), a Griffin block, an RWKV6 block and small_cnn."""
    jcfg = JServeConfig(d_model=D, n_heads=4, n_layers=2, vocab=128)
    tcfg = ServeConfig(d_model=D, n_heads=4, n_layers=2, vocab=128)
    return [
        ("build_lm", j_build_lm(jcfg), build_lm(tcfg, device="cpu"),
         (2, 8, D)),
        ("griffin", jnn.griffin_block(D), nn.griffin_block(D, device="cpu"),
         (2, 16, D)),
        ("rwkv6", jnn.rwkv6_block(D, 4), nn.rwkv6_block(D, 4, device="cpu"),
         (2, 16, D)),
        ("small_cnn", jnn.small_cnn(), nn.small_cnn(device="cpu").eval(),
         (2, 3, 16, 16)),
    ]


def _stem(name: str) -> str:
    """A node's name without the process-wide counter the IR appends."""
    head, _, tail = name.rpartition("_")
    return head if tail.isdigit() else name


@pytest.mark.parametrize("label", ["build_lm", "griffin", "rwkv6",
                                   "small_cnn"])
def test_counts_bounds_and_rank_equal_jax_on_a_cold_cache(label):
    """Each node's flops and nbytes equal the JAX package's ``node_rows``
    (the conv-bias groups, which elect ``ref.compose`` here and
    ``pallas.dfp_fused`` there, count their round trip as the JAX model
    counts it); the tensor16 bound equals JAX's ``sol_bound_us`` on the
    port's spec; ``rank`` gives the same order on the cold cache.  On a
    doctored cache holding the same seeded times in both packages, each
    node resolves the same time and provenance, and each package's
    ``rank`` orders either package's rows alike (the ratios themselves
    differ: the JAX rows are bounded on the TPU's spec)."""
    _, jm, tm, shape = next(p for p in _pairs() if p[0] == label)
    jb = j_backend("pallas_interpret")
    tb = get_backend("h100")
    jg = j_optimize(jm, shape, backend=jb.name).graph
    jrows = jsol.node_rows(jg, jb, JCache())
    jnodes = {n.name: n for n in jg.topo()}
    tg = optimize(tm, shape, backend="h100", device="cpu").graph
    tnodes = {n.name: n for n in tg.topo()}
    trows = sol.node_rows(tg, tb, AutotuneCache())
    assert [_stem(r.node) for r in trows] == [_stem(r.node) for r in jrows]
    for t, j in zip(trows, jrows):
        assert t.flops == j.flops, t.node
        if IMPL_MAP.get(t.impl, t.impl) == j.impl:
            assert t.nbytes == j.nbytes, t.node
        else:       # the mapped conv-bias difference (ROADMAP §3)
            assert (t.impl, j.impl) == ("ref.compose", "pallas.dfp_fused")
            assert t.nbytes == jpasses._node_cost_terms(jnodes[j.node])[2]
        want = jsol.sol_bound_us(HW, j.flops, t.nbytes)
        got = sol.sol_bound_us(HW, t.flops, t.nbytes, "tensor16")
        assert got[1] == want[1]
        assert got[0] == pytest.approx(want[0], rel=1e-12)
    assert [_stem(r.node) for r in sol.rank(trows)] == \
        [_stem(r.node) for r in jsol.rank(jrows)]

    # the same seeded time for three keys in four, in both caches, each
    # under its own package's impl (the mapped conv-bias groups, whose
    # bounds differ by design, stay unmeasured in both)
    rng = np.random.default_rng(5)
    jcache, tcache, times = JCache(), AutotuneCache(), {}
    for t, j in zip(trows, jrows):
        if IMPL_MAP.get(t.impl, t.impl) != j.impl:
            continue
        tn = tnodes[t.node]
        key = (tn.op.value, autotune.node_shape(tn), tn.spec.dtype, t.impl)
        if key not in times:
            times[key] = (float(rng.uniform(1.0, 100.0))
                          if rng.random() < 0.75 else None)
        if times[key] is not None:
            tcache.record(key[0], key[1], key[2], tb.cache_name, t.impl,
                          times[key])
            jcache.record(key[0], key[1], key[2], jb.cache_name, j.impl,
                          times[key])
    trows = sol.node_rows(tg, tb, tcache)
    jrows = jsol.node_rows(jg, jb, jcache)
    for t, j in zip(trows, jrows):
        assert (t.source, t.confidence, t.us) == \
            (j.source, j.confidence, j.us), t.node
        if t.source == "measured":
            assert t.ratio == jsol.sol_ratio(t.us, t.bound_us), t.node
    # both packages' rank, each on both packages' rows
    for rows in (trows, jrows):
        order = [_stem(r.node) for r in sol.rank(rows)]
        assert order == [_stem(r.node) for r in jsol.rank(rows)]
        assert order != [_stem(r.node) for r in rows]   # rank had work

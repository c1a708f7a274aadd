"""The port's benchmark harness on the CPU (``repro_torch.benchmarks``):
``run.py``'s tables, CSV and JSON schema, its side files beside the JSON
and its exit codes, the tables that wait for later slices, the paper's
effort table and Fig. 3 inference and training rows (outputs and
gradients held to the eager module first), the training-step rows, the layouts table and ``--apply``, the matmul rows, the serving
rows' ``main``, and ``tools/bench_diff.py`` on the port's JSON.  On the CPU
every kernel runs its plain version, so no test reads a time as the
card's."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch.backends import get_backend, registry
from repro_torch.benchmarks import layouts, paper_tables, run, serving
from repro_torch.benchmarks.autotune import matmul_rows
from repro_torch.core import autotune

ROOT = Path(__file__).resolve().parents[1]
SCHEMA = {"name", "us_per_call", "derived"}


def _bench_diff():
    spec = importlib.util.spec_from_file_location(
        "bench_diff", ROOT / "tools" / "bench_diff.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """One CPU run of ``effort``, ``sol`` and ``serving`` with ``--json``
    into a directory that does not exist yet: (exit code, JSON path,
    stdout lines)."""
    import contextlib
    import io
    out = tmp_path_factory.mktemp("bench") / "new_dir" / "out.json"
    prev = autotune._CACHE
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = run.main(["effort", "sol", "serving", "--device", "cpu",
                           "--json", str(out)])
    finally:
        autotune.set_cache(prev)
    return rc, out, buf.getvalue().splitlines()


def test_run_exits_0_and_prints_the_csv(harness):
    rc, _out, lines = harness
    assert rc == 0
    assert lines[0] == "name,us_per_call,derived"
    names = [ln.split(",")[0] for ln in lines[1:]]
    assert "loc_kernels_cuda" in names and "serve_h100_step" in names
    assert any(n.startswith("sol_h100_float32_") for n in names)
    assert any(n.startswith("sol_refine_h100_") for n in names)
    assert "decode_step_cache1024" in names


def test_run_json_schema(harness):
    _rc, out, lines = harness
    doc = json.loads(out.read_text())
    assert doc["tables"] == ["effort", "sol", "serving"]
    assert doc["failed"] == []
    assert len(doc["rows"]) == len(lines) - 1
    assert all(set(r) == SCHEMA and isinstance(r["us_per_call"], float)
               for r in doc["rows"])


def test_run_side_files_beside_the_json(harness):
    """``serving`` and ``sol`` each leave their rows alone in a side file
    named apart from the JAX package's series, in the JSON's directory."""
    _rc, out, _lines = harness
    rows = {r["name"]: r for r in json.loads(out.read_text())["rows"]}
    for fname, prefix in (("BENCH_torch_serve.json", ("serve_", "decode_",
                                                       "reforward_")),
                          ("BENCH_torch_sol.json", ("sol_",))):
        side = json.loads((out.parent / fname).read_text())
        assert side["rows"] and all(r["name"].startswith(prefix)
                                    for r in side["rows"])
        assert all(rows[r["name"]] == r for r in side["rows"])
    assert not (out.parent / "BENCH_torch_matmul.json").exists()
    assert not (out.parent / "BENCH_serve.json").exists()


def test_bench_diff_reads_the_ports_json(harness, tmp_path):
    """``tools/bench_diff.py`` takes the port's side files unchanged: a run
    against itself passes, an injected 2x slowdown of one row fails."""
    bd = _bench_diff()
    _rc, out, _lines = harness
    side = out.parent / "BENCH_torch_sol.json"
    assert bd.main([str(side), str(side)]) == 0
    doc = json.loads(side.read_text())
    doc["rows"][0]["us_per_call"] *= 2.0
    slow = tmp_path / "slow.json"
    slow.write_text(json.dumps(doc))
    assert bd.main([str(side), str(slow), "--threshold", "0.15"]) == 1


def test_effort_counts_the_cuda_sources(harness):
    _rc, out, _lines = harness
    rows = {r["name"]: r["us_per_call"]
            for r in json.loads(out.read_text())["rows"]}
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    cuda = sum(len(p.read_text().splitlines())
               for pat in ("*.cu", "*.cuh") for p in csrc.glob(pat))
    assert rows["loc_kernels_cuda"] == cuda > 0
    assert rows["loc_kernels_all"] > cuda


@pytest.mark.parametrize("table", ["nosuchtable", "roofline"])
def test_run_exits_1_for_an_unknown_or_later_table(table, tmp_path, capsys):
    out = tmp_path / "out.json"
    assert run.main([table, "--device", "cpu", "--json", str(out)]) == 1
    assert json.loads(out.read_text())["failed"] == [table]
    err = capsys.readouterr().err
    if table != "nosuchtable":
        assert "NotImplementedError" in err and "ROADMAP" in err


@pytest.mark.parametrize("fn", [serving.mesh_scaling_rows,
                                serving.fleet_rows, serving.decode_bench])
def test_later_slices_raise_not_implemented(fn):
    """Body rewritten, name kept: every one now returns its rows on the
    CPU: the per-architecture decode rows (one per architecture, named as
    JAX names them), the mesh scaling rows (4 spawned ranks) and the fleet
    replay (one injected kill, tokens verified)."""
    if fn is serving.decode_bench:
        rows = fn(device="cpu")
        assert [r[0] for r in rows] == [
            "decode_qwen2-1.5b_smoke", "decode_rwkv6-1.6b_smoke",
            "decode_recurrentgemma-9b_smoke"]
        assert all(us > 0 and d.endswith("tok/s") for _, us, d in rows)
        return
    prev = autotune._CACHE
    try:
        if fn is serving.mesh_scaling_rows:
            rows = fn("h100", (2, 2), requests=4, gen=4, device="cpu")
            names = ["serve_h100_mesh1x1_tok", "serve_h100_mesh2x2_tok"]
        else:
            rows = fn("h100", requests=12, kill_at_tick=2, device="cpu")
            names = [f"serve_h100_fleet3_{k}" for k in (
                "tok", "latency_p50", "latency_p99", "ttft_p50", "recovery")]
            assert "identical=yes" in rows[0][2]
            assert "respawns=1" in rows[-1][2]
    finally:
        autotune.set_cache(prev)
    assert [r[0] for r in rows] == names
    assert all(us > 0 for _, us, _ in rows)


def test_training_tables_run_and_leave_their_side_file(tmp_path):
    """``training`` (Fig. 3 right) and ``train`` run on the CPU; ``train``
    leaves ``BENCH_torch_train.json`` beside the JSON, its fwd+bwd rows
    carrying the ratio."""
    out = tmp_path / "out.json"
    assert run.main(["training", "train", "--device", "cpu", "--json",
                     str(out)]) == 0
    names = [r["name"] for r in json.loads(out.read_text())["rows"]]
    assert names[:4] == [f"train_{c}_{k}" for c in ("mlp_B64",
                                                     "small_cnn_B16")
                         for k in ("reference", "sol")]
    side = json.loads((tmp_path / "BENCH_torch_train.json").read_text())
    assert [r["name"] for r in side["rows"]] == [
        f"train_{f}_{k}" for f in ("transformer", "griffin", "rwkv6")
        for k in ("fwd", "fwdbwd")]
    assert all("ratio=" in r["derived"] for r in side["rows"]
               if r["name"].endswith("_fwdbwd"))


def test_training_fig3_holds_the_gradients_then_times(monkeypatch):
    """A SOL program whose gradients drift past README's f32 row fails
    before any time counts."""
    from repro_torch.core import executor
    real = executor.lower_graph

    def drifting(g, backend, differentiable=False):
        fn = real(g, backend, differentiable=differentiable)
        return lambda params, *xs: fn(params, *xs) * (1 + 1e-3)
    import sys
    monkeypatch.setattr(sys.modules["repro_torch.frontends.optimize"],
                        "lower_graph", drifting)
    with pytest.raises(RuntimeError, match="differ from eager autograd"):
        paper_tables.training_fig3(device="cpu")


def test_inference_fig3_holds_the_outputs_then_times(monkeypatch):
    rows = paper_tables.inference_fig3(device="cpu")
    names = [n for n, _, _ in rows]
    assert names == [f"infer_{c}_B1_{k}" for c in
                     ("mlp", "small_cnn", "depthwise_cnn", "transformer",
                      "griffin") for k in ("reference", "sol")]
    assert all(us > 0 for _, us, _ in rows)
    assert all("speedup=" in d for n, _, d in rows if n.endswith("_sol"))

    # a SOL model that drifts past README's f32 row fails before any time
    from repro_torch.frontends.optimize import SolModel
    real = SolModel.forward

    def drifting(self, *xs):
        return real(self, *xs) + 1e-3
    monkeypatch.setattr(SolModel, "forward", drifting)
    with pytest.raises(RuntimeError, match="differs from the eager"):
        paper_tables.inference_fig3(device="cpu")


def test_matmul_rows_on_the_cpu_run_the_plain_version():
    rows = matmul_rows(device="cpu")
    assert len(rows) == 6
    for name, us, derived in rows:
        assert us > 0
        if name.endswith("_cuda_matmul"):
            assert "max_abs_err=0.00e+00" in derived


def test_layouts_apply_writes_the_winners_into_the_registry():
    """Body rewritten, name kept: ``host_cpu`` is registered at import
    beside ``torch_ref`` and ``h100``, so the winners are written into
    its preferences too (its NCHW conv becomes NHWC)."""
    rows, winners = layouts.bench(device="cpu")
    assert len(rows) == 8 and set(winners) == {"linear", "conv"}
    before = {n: registry.get_backend(n)
              for n in registry.available_backends()}
    assert set(before) >= {"torch_ref", "h100", "host_cpu"}
    try:
        changes = layouts.apply_measured({"linear": "oi", "conv": "nhwc"})
        assert get_backend("h100").linear_weight_layout == "oi"
        assert get_backend("torch_ref").conv_layout == "nhwc"
        assert get_backend("host_cpu").conv_layout == "nhwc"
        assert changes == {"h100": "linear:io→oi",
                           "host_cpu": "conv:nchw→nhwc",
                           "torch_ref": "conv:nchw→nhwc"}
    finally:
        for b in before.values():
            registry.register_backend(b)
    assert get_backend("h100") == before["h100"]


def test_serving_main_merges_rows_into_a_bench_file(tmp_path):
    out = tmp_path / "BENCH_torch_serve.json"
    out.write_text(json.dumps({"rows": [
        {"name": "other_row", "us_per_call": 1.0, "derived": ""}]}))
    prev = autotune._CACHE
    try:
        assert serving.main(["--device", "cpu", "--json", str(out)]) == 0
    finally:
        autotune.set_cache(prev)
    names = [r["name"] for r in json.loads(out.read_text())["rows"]]
    assert names[0] == "other_row"
    assert "serve_h100_step" in names and "serve_h100_ttft_p50" in names
    # the fleet mode merges its rows beside them
    prev = autotune._CACHE
    try:
        assert serving.main(["fleet", "--device", "cpu", "--requests", "9",
                             "--json", str(out)]) == 0
    finally:
        autotune.set_cache(prev)
    names = [r["name"] for r in json.loads(out.read_text())["rows"]]
    assert "serve_h100_step" in names
    assert "serve_h100_fleet3_recovery" in names


def test_serve_rows_serves_the_workload_it_is_given():
    """A given workload replaces the default requests: each request is
    served once in the timed pass, and the percentiles are over them."""
    import numpy as np
    from repro_torch.launch.serve import ServeConfig
    cfg = ServeConfig(d_model=32, n_heads=2, n_layers=1, vocab=64,
                      max_seq=64, max_batch=2, slots=2, backend="h100")
    rng = np.random.default_rng(0)
    workload = [(rng.integers(0, cfg.vocab, n, dtype=np.int32), 5)
                for n in (3, 9, 17)]
    prev = autotune._CACHE
    try:
        rows = dict((n, (us, d)) for n, us, d in serving.serve_rows(
            cfg=cfg, workload=workload, device="cpu"))
    finally:
        autotune.set_cache(prev)
    assert rows["serve_h100_latency_p50"][1] == "3req"
    assert "prefills=" in rows["serve_h100_ttft_p50"][1]
    assert rows["serve_h100_latency_p99"][0] >= \
        rows["serve_h100_latency_p50"][0] > 0.0


def test_compile_graph_keeps_the_registered_spec_off_the_card():
    """On the CPU a compiled graph's backend is the registered one; the
    spec of a CUDA card is read by its name (``registry.for_device``)."""
    from repro_torch.frontends import nn
    from repro_torch.frontends.optimize import optimize
    sol = optimize(nn.Linear(8, 8, device="cpu"), (2, 8), backend="h100",
                   device="cpu")
    assert sol.backend is get_backend("h100")
    assert registry.for_device(get_backend("h100"),
                               torch.device("cpu")).hw is registry.H100_SXM

"""The port's deploy artifacts on the CPU, held to the JAX package's
(``tests/test_frontend.py`` and ``tests/test_serving.py``, their deploy
tests): ``deploy``/``export_fn``/``load`` round trips, params staged once,
the manifest's election report, serving from artifacts (greedy and
temperature sampling, strict provenance, a missing bucket), the pinned
configs as literals of the ``repro_torch::*`` calls, the artifact's
refusals, bf16 leaves, and each custom op's fake impl.

Weights come from a numpy seed and are carried into the port by
``repro_torch.convert``.  Tolerances: the port's artifact equals the port's
live model exactly (the same impls on the same inputs); against the JAX
package, README's f32 row (1e-5).
"""
import io
import json
import os
import zipfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

from repro.frontends import deploy as JD
from repro.frontends import nn as jnn
from repro.frontends.optimize import optimize as j_optimize
from repro.launch import serve as jserve
from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as TAT
from repro_torch.frontends import deploy as D
from repro_torch.frontends import nn
from repro_torch.frontends.offload import NoDeviceError
from repro_torch.frontends.optimize import optimize
from repro_torch.kernels import library
from repro_torch.kernels.dfp_fused.program import (Program, program_from_str,
                                                   program_to_str)
from repro_torch.launch import serve as tserve
from repro_torch.runtime import packed

TOL = dict(rtol=1e-5, atol=1e-5)          # README: f32 row
D_MODEL, H, KV, LAYERS, VOCAB = 64, 4, 2, 2, 128
CPU = dict(device="cpu")
# the port's kernels against the JAX package's, as the decision tests map
# them (tests/test_torch_pipeline.py)
IMPL_MAP = {"cuda.linear": "pallas.linear_mxu",
            "cuda.matmul": "pallas.matmul_mxu",
            "cuda.flash_attention": "pallas.flash_attention",
            "cuda.decode_attention": "pallas.decode_attention",
            "cuda.dfp_fused": "pallas.dfp_fused"}


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def _draw(name: str, shape, rng) -> np.ndarray:
    """One parameter by its role, as ``tests/test_torch_cnn.py`` draws
    them: weights (out, ...) N(0, 2/fan_in), norm gains near 1, running
    variances in (0.5, 1.5), biases and means small and nonzero."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return rng.uniform(0.5, 1.5, shape)
    n = rng.standard_normal(shape)
    if leaf in ("weight", "wq", "wk", "wv", "wo") and len(shape) >= 2:
        fan_in = shape[0] if leaf.startswith("w") and leaf != "weight" \
            else np.prod(shape[1:])
        return n * np.sqrt(2.0 / fan_in)
    if leaf == "weight":
        return 1.0 + 0.1 * n
    return 0.1 * n


def _pair(jm, tm, seed: int = 0):
    """``jm`` and ``tm`` holding the same numpy-drawn weights."""
    rng = np.random.default_rng(seed)
    sd = {k: _draw(k, np.shape(v), rng).astype(np.float32)
          for k, v in sorted(jm.named_parameters().items())}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    load_numpy_state_dict(tm, sd)
    return jm, tm


NETS = {
    "small_cnn": (lambda: jnn.small_cnn(),
                  lambda: nn.small_cnn(**CPU).eval(), (2, 3, 16, 16)),
    "mlp_8192": (lambda: jnn.mlp_8192(2, 32, 16, 4),
                 lambda: nn.mlp_8192(2, 32, 16, 4, **CPU), (2, 16)),
}


def _lm_pair(seed: int = 0):
    jm = jnn.Sequential(*[jnn.transformer_block(D_MODEL, H, n_kv_heads=KV)
                          for _ in range(LAYERS)], jnn.Linear(D_MODEL, VOCAB))
    tm = tnn.Sequential(*[nn.transformer_block(D_MODEL, H, KV, **CPU)
                          for _ in range(LAYERS)],
                        nn.Linear(D_MODEL, VOCAB, **CPU))
    return _pair(jm, tm, seed)


def _x(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# (a) deploy → load → run, against the live model and the JAX artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(NETS))
def test_deploy_roundtrip_equals_live_and_jax(name):
    jb, tb, shape = NETS[name]
    jm, tm = _pair(jb(), tb())
    x = _x(shape)
    sol = optimize(tm, shape, **CPU)
    live = sol(torch.from_numpy(x))
    loaded = D.load(D.deploy(sol), "cpu")
    got = loaded(torch.from_numpy(x))
    assert got.shape == live.shape and torch.equal(got, live)
    jblob = JD.deploy(j_optimize(jm, shape), shape)
    want = np.asarray(JD.load(jblob)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the live model still runs on real tensors after the export
    assert torch.equal(sol(torch.from_numpy(x)), live)


# ---------------------------------------------------------------------------
# (b) export_fn: a nested params dict
# ---------------------------------------------------------------------------

def test_export_fn_nested_pytree_roundtrip():
    params = {"block": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "b": np.ones(3, np.float32)},
              "scale": np.float32(2.0)}

    def fn(p, x):
        return (x @ p["block"]["w"] + p["block"]["b"]) * p["scale"]

    blob = D.export_fn(fn, params, ((4, 2), torch.float32))
    m = D.load(blob, "cpu")
    assert set(m.params) == {"block", "scale"}
    assert set(m.params["block"]) == {"w", "b"}
    x = _x((4, 2), 0)
    want = JD.export_fn(fn, params, jax.ShapeDtypeStruct((4, 2),
                                                         jnp.float32))
    np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(),
                               np.asarray(JD.load(want)(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_export_fn_with_no_params_traces_on_the_card_unless_asked():
    """With no parameter to read a device from, ``export_fn`` traces on
    the card; ``device="cpu"`` traces on the CPU."""
    def fn(p, x):
        return x * 2.0

    blob = D.export_fn(fn, {}, ((3,), torch.float32), device="cpu")
    assert json.loads(zipfile.ZipFile(io.BytesIO(blob)).read(
        "manifest.json"))["device_type"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            D.export_fn(fn, {}, ((3,), torch.float32))


# ---------------------------------------------------------------------------
# (c) params staged exactly once
# ---------------------------------------------------------------------------

def test_deployed_params_staged_exactly_once():
    sol = optimize(nn.mlp_8192(2, 32, 16, 4, **CPU), (1, 16), **CPU)
    blob = D.deploy(sol)
    packed.reset_transfer_stats()
    served = D.load(blob, "cpu")
    assert served.staged_leaves == len(sol._params_for_call())
    after_load = dict(packed.TRANSFER_STATS)
    assert after_load["packed_dmas"] + after_load["direct_dmas"] >= 1
    assert after_load["bytes"] == served.host_bytes
    leaves = list(D._flat(served.params))
    assert leaves and all(isinstance(v, torch.Tensor) for v in leaves)
    x = torch.ones(1, 16)
    y1, y2 = served(x), served(x)
    assert dict(packed.TRANSFER_STATS) == after_load, \
        "params were staged again after load"
    assert torch.equal(y1, y2) and torch.equal(y1, sol(x))


@pytest.mark.parametrize("sizes,direct", [((8,), 1), ((8, 8, 8), 3),
                                          ((4096, 8), 0)])
def test_transfer_policy_split(sizes, direct):
    """A singleton or a batch under the threshold goes direct, one copy an
    array; a larger batch as one packed copy, as the JAX policy splits."""
    arrays = [np.arange(n, dtype=np.float32) for n in sizes]
    packed.reset_transfer_stats()
    out = packed.transfer(arrays, torch.device("cpu"))
    assert packed.TRANSFER_STATS["direct_dmas"] == direct
    assert packed.TRANSFER_STATS["packed_dmas"] == (0 if direct else 1)
    for a, t in zip(arrays, out):
        np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# (d) the election report travels in the manifest
# ---------------------------------------------------------------------------

def _lm_full(jm, tm):
    shape = (2, 8, D_MODEL)
    return (j_optimize(jm, shape, backend="pallas_interpret"),
            optimize(tm, shape, **CPU))


def _mlp(jm, tm):
    return (j_optimize(jm, (2, 16), backend="pallas_interpret"),
            optimize(tm, (2, 16), **CPU))


@pytest.mark.parametrize("build", [_lm_full, _mlp], ids=["lm", "mlp"])
def test_deployed_model_carries_election_metadata(build):
    jm, tm = (_lm_pair() if build is _lm_full
              else _pair(NETS["mlp_8192"][0](), NETS["mlp_8192"][1]()))
    jsol, sol = build(jm, tm)
    loaded = D.load(D.deploy(sol), "cpu")
    assert loaded.impl_report() == sol.impl_report()
    assert loaded.impl_report(by_kind=True) == sol.impl_report(by_kind=True)
    assert loaded.impl_report(provenance=True) == \
        sol.impl_report(provenance=True)
    jrep = JD.load(JD.deploy(jsol)).impl_report(by_kind=True)
    mapped = {op: {IMPL_MAP.get(k, k): n for k, n in v.items()}
              for op, v in loaded.impl_report(by_kind=True).items()}
    assert mapped == jrep
    assert any(k.startswith("cuda.") for k in loaded.impl_report())


# ---------------------------------------------------------------------------
# (e)-(g) serving from artifacts
# ---------------------------------------------------------------------------

def _cfg(mod, **kw):
    base = dict(d_model=D_MODEL, n_heads=H, n_layers=LAYERS, vocab=VOCAB,
                max_seq=32, max_batch=2, slots=3)
    base.update(kw)
    return mod.ServeConfig(**base)


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10, 11], [12, 13, 14, 15]]


def _serve(server, prompts=PROMPTS, gen=5, sampling=None):
    reqs = [server.submit(p, gen, sampling) for p in prompts]
    server.run()
    server.close()
    return reqs


@pytest.mark.parametrize("sampling", [
    None, dict(temperature=0.7, top_p=0.95, seed=42)],
    ids=["greedy", "temperature"])
def test_deploy_serve_roundtrip_equals_live_and_jax(sampling):
    jm, tm = _lm_pair()
    tsp = tserve.SamplingParams(**sampling) if sampling else None
    jsp = jserve.SamplingParams(**sampling) if sampling else None
    live = tserve.SolServer(_cfg(tserve), model=tm, **CPU)
    live_reqs = _serve(live, sampling=tsp)
    arts = live.export_artifacts()
    assert set(arts) == set(live._models) and all(
        isinstance(b, bytes) for b in arts.values())
    replay = tserve.SolServer(_cfg(tserve), deployed=arts, **CPU)
    assert replay.model is None
    assert replay._kv_row_shapes == live._kv_row_shapes
    rep_reqs = _serve(replay, sampling=tsp)
    for a, b in zip(live_reqs, rep_reqs):
        assert a.generated == b.generated
        np.testing.assert_array_equal(a.last_logits, b.last_logits)
    for key in arts:
        assert (replay._models[key].impl_report(by_kind=True)
                == live._models[key].impl_report(by_kind=True))
    assert replay.summary()["dmas"] == replay.summary()["forwards"]
    jreqs = _serve(jserve.SolServer(_cfg(jserve, backend="xla"), model=jm),
                   sampling=jsp)
    assert [r.generated for r in rep_reqs] == [r.generated for r in jreqs]


def test_deploy_mode_refuses_missing_buckets_and_warmup():
    _, tm = _lm_pair()
    live = tserve.SolServer(_cfg(tserve), model=tm, **CPU)
    _serve(live, PROMPTS[:1], gen=2)
    replay = tserve.SolServer(_cfg(tserve), deployed=live.export_artifacts(),
                              **CPU)
    with pytest.raises(KeyError, match="deploy"):
        replay._model_for(("prefill", 8, 8))
    with pytest.raises(RuntimeError, match="deploy"):
        replay.warm_autotune(max_len=8)
    replay.close()


def test_strict_replay_of_measured_artifacts_and_cold_ones_refused():
    _, tm = _lm_pair()
    strict = tserve.SolServer(_cfg(tserve), model=tm, strict_provenance=True,
                              **CPU)
    reqs = [strict.submit(p, 4) for p in PROMPTS]
    strict.warm_autotune(warmup=0, iters=1)
    strict.run()
    strict.close()
    replay = tserve.SolServer(_cfg(tserve), deployed=strict.export_artifacts(),
                              strict_provenance=True, **CPU)
    rep = _serve(replay, gen=4)
    assert [r.generated for r in rep] == [r.generated for r in reqs]
    for rec in replay.served_elections.values():
        for kind in ("linear", "matmul", "attention", "decode_attention"):
            for name in rec["by_op"].get(kind, {}):
                assert set(rec["provenance"][name]["sources"]) == \
                    {"measured"}

    TAT.set_cache(TAT.AutotuneCache())
    cold = tserve.SolServer(_cfg(tserve), model=tm, **CPU)
    _serve(cold, PROMPTS[:2], gen=2)
    with pytest.raises(tserve.ProvenanceError, match="unmeasured"):
        tserve.SolServer(_cfg(tserve), deployed=cold.export_artifacts(),
                         strict_provenance=True, **CPU)


# ---------------------------------------------------------------------------
# (h) pinned configs are literals of the exported calls; (i) no weights in
# the graph
# ---------------------------------------------------------------------------

def _graph(blob: bytes):
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return torch.export.load(io.BytesIO(z.read(D.GRAPH)))


def _calls(ep, name: str):
    return [n for n in ep.graph.nodes if n.op == "call_function"
            and str(n.target).startswith(f"repro_torch.{name}.")]


def test_pinned_configs_are_literal_arguments_of_the_ops():
    _, tm = _lm_pair()
    sol = optimize(tm, (2, 8, D_MODEL), **CPU)
    nodes = {n.impl: n for n in sol.graph.topo() if n.impl}
    nodes["cuda.linear"].attrs["cuda_mm_block"] = (3,)
    nodes["cuda.flash_attention"].attrs["cuda_attn_block"] = (32,)
    nodes["cuda.dfp_fused"].attrs["cuda_dfp_block"] = (8, 1)
    x = torch.from_numpy(_x((2, 8, D_MODEL)))
    live = sol(x)
    blob = D.deploy(sol)
    ep = _graph(blob)
    assert any(c.args[2] == 3 for c in _calls(ep, "matmul"))
    assert [c.args[3:] for c in _calls(ep, "flash_attention")].count(
        (True, 0, 0.0, 32)) == 1
    assert any(c.args[2:] == (8, 1) for c in _calls(ep, "dfp_fused"))
    # the segmented DFP group and the pinned splits give the live output
    assert torch.equal(D.load(blob, "cpu")(x), live)


def test_graph_member_holds_no_weights():
    sol = optimize(nn.mlp_8192(3, 512, 512, 10, **CPU), (2, 512), **CPU)
    blob = D.deploy(sol)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        graph = z.getinfo(D.GRAPH).file_size
        params = sum(i.file_size for i in z.infolist()
                     if i.filename.startswith("params/"))
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in z.infolist())
    assert graph < params / 10, (graph, params)


# ---------------------------------------------------------------------------
# (j) refusals
# ---------------------------------------------------------------------------

def _rewrite(blob: bytes, drop=(), **manifest) -> bytes:
    """``blob`` with its manifest's keys ``drop`` removed and ``manifest``
    written over it."""
    src = zipfile.ZipFile(io.BytesIO(blob))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for info in src.infolist():
            data = src.read(info.filename)
            if info.filename == "manifest.json":
                m = json.loads(data)
                m.update(manifest)
                for k in drop:
                    m.pop(k)
                data = json.dumps(m).encode()
            z.writestr(info.filename, data)
    return buf.getvalue()


def test_load_refuses_foreign_artifacts():
    jm, tm = _pair(NETS["mlp_8192"][0](), NETS["mlp_8192"][1]())
    blob = D.deploy(optimize(tm, (2, 16), **CPU))
    jblob = JD.deploy(j_optimize(jm, (2, 16)), (2, 16))
    with pytest.raises(ValueError, match="graph.stablehlo"):
        D.load(jblob, "cpu")
    with pytest.raises(ValueError, match="schema"):
        D.load(_rewrite(blob, schema=99), "cpu")
    with pytest.raises(ValueError, match="cuda"):
        D.load(_rewrite(blob, device_type="cuda"), "cpu")
    with pytest.raises(ValueError, match="tree"):
        D.load(_rewrite(blob, drop=("tree",)), "cpu")
    with pytest.raises(RuntimeError, match="mesh"):
        sol = optimize(tm, (2, 16), **CPU)
        sol.mesh = object()
        D.deploy(sol)


# ---------------------------------------------------------------------------
# (k) bf16 leaves cross as uint16
# ---------------------------------------------------------------------------

def _listing3_cnn(**kw):
    mods = list(nn.depthwise_cnn(**kw))
    mods.insert(3, nn.AvgPool2d(3, stride=1))
    mods.insert(8, nn.AvgPool2d(3, stride=1))
    return tnn.Sequential(*mods)


def test_bf16_listing3_cnn_roundtrips_its_uint16_leaves():
    shape = (2, 3, 40, 40)
    torch.manual_seed(0)
    model = _listing3_cnn(**CPU).eval().to(torch.bfloat16)
    sol = optimize(model, shape, dtype="bfloat16", **CPU)
    assert sol.impl_report(by_kind=True)["avgpool"] == {"cuda.avgpool": 2}
    x = torch.from_numpy(_x(shape)).to(torch.bfloat16)
    live = sol(x)
    blob = D.deploy(sol)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        manifest = json.loads(z.read("manifest.json"))
        leaf = np.load(io.BytesIO(z.read("params/0.npy")))
    assert leaf.dtype == np.uint16
    assert manifest["inputs"] == [{"shape": list(shape), "dtype": "bfloat16"}]
    loaded = D.load(blob, "cpu")
    staged = dict(zip(sol._params_for_call(), D._flat(loaded.params)))
    for name, t in sol._params_for_call().items():
        assert staged[name].dtype == torch.bfloat16
        assert torch.equal(staged[name], t)
    got = loaded(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, live)


# ---------------------------------------------------------------------------
# (l) each op's fake impl against its CPU result; the DFP program string
# ---------------------------------------------------------------------------

def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


LAYERNORM_GELU = Program(
    (("layernorm", 0, ("op", 0), 1, 2, 1e-5), ("gelu", 1, ("reg", 0), None),
     ("add", 2, ("reg", 1), ("op", 3), None), ("scale", 3, ("reg", 2), 0.1)),
    ("full", "vec", "vec", "full"), 3)


def _op_cases(dtype):
    rng = np.random.default_rng(0)
    t = lambda *s: _t(rng, *s, dtype=dtype)             # noqa: E731
    lens = torch.tensor([0, 5, 9], dtype=torch.int32)
    return {
        "matmul": (t(2, 5, 12), t(12, 7), 0),
        "flash_attention": (t(2, 9, 4, 16), t(2, 9, 2, 16), t(2, 9, 2, 16),
                            True, 0, 0.0, 64),
        "decode_attention": (t(3, 1, 4, 16), t(3, 12, 2, 16),
                             t(3, 12, 2, 16), t(3, 1, 2, 16),
                             t(3, 1, 2, 16), lens, 0, 0.0, 0),
        "dfp_fused": ([t(6, 8), t(8), t(8), t(6, 8)],
                      program_to_str(LAYERNORM_GELU), 0, 2),
        "rglru_scan": (t(2, 7, 6).sigmoid(), t(2, 7, 6), t(2, 6), 0, 0),
        "rwkv6_scan": (t(2, 5, 2, 4), t(2, 5, 2, 4), t(2, 5, 2, 4),
                       -t(2, 5, 2, 4).abs(), t(2, 4), t(2, 2, 4, 4).float(),
                       0),
        "avgpool": (t(2, 3, 9, 8), 3, 2, 0),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(library.OPS))
def test_fake_impl_gives_the_cpu_result_shape_and_dtype(name, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    args = _op_cases(dtype)[name]
    real = library.OPS[name](*args)
    mode = FakeTensorMode()
    fake_args = [
        [mode.from_tensor(a) for a in x] if isinstance(x, list)
        else mode.from_tensor(x) if isinstance(x, torch.Tensor) else x
        for x in args]
    with mode:
        fake = library.OPS[name](*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(r.shape), r.dtype) for r in real] == \
        [(tuple(f.shape), f.dtype) for f in fake]
    assert all(r.is_contiguous() for r in real)


def test_ops_equal_their_entries_and_return_fresh_tensors():
    from repro_torch.kernels.avgpool.ops import avgpool
    from repro_torch.kernels.dfp_fused.ops import dfp_fused_segmented
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    cases = _op_cases(torch.float32)
    x, w, _ = cases["matmul"]
    assert torch.equal(library.matmul(x, w, 0), matmul(x, w))
    ops, prog, _, group = cases["dfp_fused"]
    assert torch.equal(library.dfp_fused(ops, prog, 0, group),
                       dfp_fused_segmented(LAYERNORM_GELU, ops, group))
    a, b, h0, *_ = cases["rglru_scan"]
    for got, want in zip(library.rglru_scan(a, b, h0, 0, 0),
                         rglru_scan(a, b, h0)):
        assert torch.equal(got, want)
    xp = cases["avgpool"][0]
    assert torch.equal(library.avgpool(xp, 3, 2, 0), avgpool(xp, 3, 2))
    # a program that only copies its operand still returns a new tensor
    copy = Program((("copy", 0, ("op", 0), None),), ("full",), 0)
    y = library.dfp_fused([x], program_to_str(copy), 0, 0)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_program_string_roundtrips_its_key():
    text = program_to_str(LAYERNORM_GELU)
    back = program_from_str(text)
    assert back.key() == LAYERNORM_GELU.key()
    assert hash(back.key()) == hash(LAYERNORM_GELU.key())
    odd = Program((("scale", 0, ("op", 0), 0.1 + 0.2),), ("full",), 0)
    assert program_from_str(program_to_str(odd)).instrs[0][3] == 0.1 + 0.2

"""The port's pipeline against the JAX package, on the CPU: the decisions
(IR ops, fusion groups, layouts, elections) in float32, bfloat16 and
float16, and the full, prefill and decode programs' outputs, with the JAX
weights carried over by ``load_numpy_state_dict``.  Small sizes: d 64, 4
heads, 2 KV heads, 2 layers, vocab 128; f32 tolerance 1e-5 (README's
conformance table)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

from repro.backends import get_backend as j_backend
from repro.core import ir as jir
from repro.core import passes as jpasses
from repro.frontends import extract as jex
from repro.frontends import nn as jnn
from repro.frontends.optimize import compile_graph as j_compile
from repro.frontends.optimize import optimize as j_optimize
from repro_torch.backends import get_backend, registry
from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as TAT
from repro_torch.core import ir as tir
from repro_torch.core import passes
from repro_torch.frontends import extract as tex
from repro_torch.frontends import nn
from repro_torch.frontends.offload import device as device_api
from repro_torch.frontends.optimize import compile_graph, optimize

D, H, KV, LAYERS, VOCAB = 64, 4, 2, 2, 128
TOL = dict(rtol=1e-5, atol=1e-5)
# the port's kernel impls and the JAX package's Pallas impls, one for one
IMPL_MAP = {"cuda.linear": "pallas.linear_mxu",
            "cuda.matmul": "pallas.matmul_mxu",
            "cuda.flash_attention": "pallas.flash_attention",
            "cuda.decode_attention": "pallas.decode_attention",
            "cuda.dfp_fused": "pallas.dfp_fused"}
# the storage types the kernels take; a float32 case keeps the id it had
# before the half-precision ones joined
DTYPES = ("float32", "bfloat16", "float16")


def dtype_cases(*pairs):
    """(port backend, JAX backend, dtype) for every pair and dtype."""
    return [pytest.param(p, j, dt, id=f"{p}-{j}" + (
        "" if dt == "float32" else f"-{dt}"))
        for dt in DTYPES for p, j in pairs]


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def models(seed: int = 0):
    """The same LM in both packages: random numpy weights (norm gains and
    biases included) loaded into the JAX modules, then carried over."""
    jm = jnn.Sequential(*[jnn.transformer_block(D, H, n_kv_heads=KV)
                          for _ in range(LAYERS)], jnn.Linear(D, VOCAB))
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(np.shape(v)) * 0.2).astype(np.float32)
          for k, v in jm.named_parameters().items()}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    tm = tnn.Sequential(*[nn.transformer_block(D, H, KV, device="cpu")
                          for _ in range(LAYERS)],
                        nn.Linear(D, VOCAB, device="cpu"))
    load_numpy_state_dict(tm, {k: np.asarray(v)
                               for k, v in jm.named_parameters().items()})
    return jm, tm


def _programs(jm, tm, dtype: str = "float32"):
    yield (jex.extract(jm, (2, 8, D), dtype), tex.extract(tm, (2, 8, D), dtype))
    yield (jex.extract_prefill(jm, (2, 8, D), dtype),
           tex.extract_prefill(tm, (2, 8, D), dtype))
    yield (jex.extract_decode(jm, 2, 16, D, dtype),
           tex.extract_decode(tm, 2, 16, D, dtype))


def test_state_dict_names_and_layouts_match():
    jm, tm = models()
    jsd = {k: np.shape(v) for k, v in jm.named_parameters().items()}
    tsd = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert jsd == tsd
    assert tsd["0.0.1.wq"] == (D, D)                   # MHA (in, out)
    assert tsd["0.1.1.weight"] == (4 * D, D)           # Linear (out, in)


@pytest.mark.parametrize("port_bk,jax_bk,dtype", dtype_cases(
    ("h100", "pallas_interpret"), ("torch_ref", "xla")))
def test_decisions_equal_jax(port_bk, jax_bk, dtype):
    """Node ops, fusion groups, layouts and elected impls equal the JAX
    package's for the full, prefill and decode programs, in each storage
    type the kernels take."""
    jm, tm = models()
    for jg, tg in _programs(jm, tm, dtype):
        jg = jpasses.run_pipeline(jg, j_backend(jax_bk))
        tg = passes.run_pipeline(tg, get_backend(port_bk))
        jt, tt = jg.topo(), tg.topo()
        assert [n.op.value for n in tt] == [n.op.value for n in jt]
        assert [n.name for n in tt if n.op is tir.OpKind.FUSED] == \
            [n.name for n in jt if n.op.value == "fused"]
        assert [n.layout for n in tt] == [n.layout for n in jt]
        assert [IMPL_MAP.get(n.impl, n.impl) for n in tt] == \
            [n.impl for n in jt]
        assert tg.layout_reorders == jg.layout_reorders
        assert len(tg.outputs) == len(jg.outputs)


def _scan_and_pool_nodes(ir, dtype):
    """One RGLRU_SCAN, RWKV6_SCAN and stride-1 AVGPOOL node of ``dtype``,
    built with the IR module ``ir`` (the JAX package's or the port's)."""
    a = ir.input_node((1, 4, 8), dtype)
    rglru = ir.Node(ir.OpKind.RGLRU_SCAN, [a, a, ir.input_node((1, 8), dtype)],
                    ir.TensorSpec((1, 4, 8), dtype))
    seq = ir.input_node((1, 4, 2, 16), dtype)
    rwkv6 = ir.Node(ir.OpKind.RWKV6_SCAN,
                    [seq, seq, seq, seq, ir.input_node((2, 16), dtype),
                     ir.input_node((1, 2, 16, 16), dtype)],
                    ir.TensorSpec((1, 4, 2, 16), dtype))
    pool = ir.Node(ir.OpKind.AVGPOOL, [ir.input_node((1, 2, 9, 9), dtype)],
                   ir.TensorSpec((1, 2, 7, 7), dtype),
                   attrs={"kernel": 3, "stride": 1})
    return [rglru, rwkv6, pool]


@pytest.mark.parametrize("dtype", ["float64", "int32", "int64"])
def test_other_dtypes_elect_the_reference_tier_on_h100(dtype):
    """The one mapped difference the dtypes leave.  Every kernel of the port
    takes float32, bfloat16 and float16 only, so a kernel node of any other
    dtype the IR takes (``core/executor.py``'s ``TORCH_DTYPES``) elects
    ``ref.*`` on ``h100``.  The JAX matmul refuses such a node too; the six
    JAX kernels without a dtype gate admit it.  Every other decision is
    the JAX package's."""
    jm, tm = models()
    mapped = set()
    for jg, tg in _programs(jm, tm, dtype):
        jg = jpasses.run_pipeline(jg, j_backend("pallas_interpret"))
        tg = passes.run_pipeline(tg, get_backend("h100"))
        jt, tt = jg.topo(), tg.topo()
        assert [n.op.value for n in tt] == [n.op.value for n in jt]
        assert [n.layout for n in tt] == [n.layout for n in jt]
        for t, j in zip(tt, jt):
            assert not (t.impl or "").startswith("cuda."), t.name
            if t.impl != j.impl:
                assert j.impl.startswith("pallas.") and \
                    t.impl.startswith("ref."), (t.name, t.impl, j.impl)
                mapped.add((t.op.value, t.impl, j.impl))
    assert mapped == {("attention", "ref.attention", "pallas.flash_attention"),
                      ("decode_attention", "ref.decode_attention",
                       "pallas.decode_attention"),
                      ("fused", "ref.compose", "pallas.dfp_fused")}
    h100, jax_bk = get_backend("h100"), j_backend("pallas_interpret")
    for t, j in zip(_scan_and_pool_nodes(tir, dtype),
                    _scan_and_pool_nodes(jir, dtype)):
        assert h100.resolve(t).name.startswith("ref."), t.op
        assert jax_bk.resolve(j).name.startswith("pallas."), j.op
    for dt in DTYPES:       # the same nodes in a storage type: the kernels
        for t in _scan_and_pool_nodes(tir, dt):
            assert h100.resolve(t).name.startswith("cuda."), (dt, t.op)


@pytest.mark.parametrize("dtype", DTYPES)
def test_h100_elects_every_kernel_on_the_serving_programs(dtype):
    jm, tm = models()
    for _, tg in _programs(jm, tm, dtype):
        g = passes.run_pipeline(tg, get_backend("h100"))
        by_op = g.elections_by_op
        assert set(by_op["linear"]) == {"cuda.linear"}
        assert set(by_op["matmul"]) == {"cuda.matmul"}
        assert set(by_op["fused"]) == {"cuda.dfp_fused"}
        att = by_op.get("attention") or by_op.get("decode_attention")
        assert set(att) <= {"cuda.flash_attention", "cuda.decode_attention"}
        assert all(src == {"analytical": n} for n, src in
                   ((g.elections[i], g.election_provenance[i])
                    for i in g.elections))


def test_torch_ref_backend_never_admits_a_kernel():
    _, tm = models()
    g = passes.run_pipeline(tex.extract(tm, (2, 8, D)),
                            get_backend("torch_ref"))
    assert not any(n.impl and n.impl.startswith("cuda.") for n in g.topo())
    lin = g.nodes_of(tir.OpKind.LINEAR)[0]
    names = [c.name for c in registry.candidates(get_backend("h100"), lin)]
    assert names == ["cuda.linear", "ref.linear"]


def test_unencodable_fusion_group_elects_compose_visibly():
    """A group the DFP kernel cannot encode (a channel bias on a rank-4
    tensor) elects ``ref.compose`` in the report instead of falling back
    inside the kernel impl at run time."""
    x = tir.input_node((2, 3, 4, 5))
    b = tir.param_node((3,), name="b")
    sp = tir.TensorSpec((2, 3, 4, 5))
    n = tir.Node(tir.OpKind.RELU, [tir.Node(tir.OpKind.BIAS_ADD, [x, b], sp,
                                            attrs={"axis": 1})], sp)
    g = passes.run_pipeline(tir.Graph([x], [n], {"b": b}),
                            get_backend("h100"))
    assert g.elections == {"ref.compose": 1}


def test_eager_forward_matches_jax():
    jm, tm = models(1)
    x = np.random.default_rng(2).standard_normal((2, 8, D)).astype(
        np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("backend", ["h100", "torch_ref"])
def test_full_program_matches_jax_optimize(backend):
    jm, tm = models(3)
    x = np.random.default_rng(4).standard_normal((2, 8, D)).astype(
        np.float32)
    want = np.asarray(j_optimize(jm, (2, 8, D), backend="xla")(x))
    sol = optimize(tm, (2, 8, D), backend=backend, device="cpu")
    np.testing.assert_allclose(sol(torch.from_numpy(x)).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("backend", ["h100", "torch_ref"])
def test_prefill_program_matches_jax(backend):
    jm, tm = models(5)
    x = np.random.default_rng(6).standard_normal((2, 8, D)).astype(
        np.float32)
    want = j_compile(jm, jex.extract_prefill(jm, (2, 8, D)), "xla")(x)
    got = compile_graph(tm, tex.extract_prefill(tm, (2, 8, D)), backend,
                        device="cpu")(torch.from_numpy(x))
    assert len(got) == len(want) == 1 + 2 * LAYERS
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("backend", ["h100", "torch_ref"])
def test_decode_program_matches_jax(backend):
    jm, tm = models(7)
    rng = np.random.default_rng(8)
    b, s = 2, 16
    x = rng.standard_normal((b, 1, D)).astype(np.float32)
    lens = np.array([5, 0], np.int32)
    caches = [rng.standard_normal((b, s, KV, D // H)).astype(np.float32)
              for _ in range(2 * LAYERS)]
    want = j_compile(jm, jex.extract_decode(jm, b, s, D), "xla")(
        x, lens, *caches)
    sol = compile_graph(tm, tex.extract_decode(tm, b, s, D), backend,
                        device="cpu")
    got = sol(*[torch.from_numpy(a) for a in [x, lens] + caches])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_solmodel_reads_framework_parameters_in_place():
    """The SolModel serves the source module's own tensors: an in-place
    update shows up in the next forward (version-tracked context)."""
    _, tm = models(9)
    sol = optimize(tm, (1, 4, D), backend="h100", device="cpu")
    x = torch.randn(1, 4, D)
    before = sol(x)
    with torch.no_grad():
        tm[-1].bias.add_(1.0)
    np.testing.assert_allclose((sol(x) - before).numpy(), 1.0, atol=1e-5)
    assert sol.state_dict().keys() == tm.state_dict().keys()


def test_transparent_mode_returns_host_arrays():
    _, tm = models(10)
    try:
        device_api.set("cpu", mode="transparent")
        sol = optimize(tm, (1, 4, D), backend="torch_ref")
        assert isinstance(sol(np.zeros((1, 4, D), np.float32)), np.ndarray)
    finally:
        device_api.set("cuda", mode="native")


def test_impl_report_views_and_provenance_audit():
    _, tm = models()
    sol = optimize(tm, (2, 8, D), backend="h100", device="cpu")
    flat = sol.impl_report()
    assert flat["cuda.linear"] == 5 and flat["cuda.dfp_fused"] == 4
    prov = sol.impl_report(provenance=True)
    assert prov["cuda.matmul"] == {"count": 8,
                                   "sources": {"analytical": 8}}
    # nothing was measured yet, so the strict audit names every served kind
    assert len(sol.check_provenance()) == 3
    assert sol.check_provenance(require=("analytical",)) == []

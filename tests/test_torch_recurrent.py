"""The port's recurrent slice against the JAX package, on the CPU: the
RG-LRU and RWKV6 scans' plain versions, the modules' eager forwards, the
``optimize()`` forwards, and the pass decisions, on the same numpy-seeded
inputs and weights.

Sizes are the JAX package's own sequence-model tests
(``tests/test_sequence_models.py``): ``griffin_block(24)`` at (2, 16, 24)
and ``rwkv6_block(32, 4)`` at (2, 32, 32), plus 2-layer stacks of each;
the interpret-mode Pallas scans run at T ≤ 32, which keeps them to a few
seconds.

Tolerances (README's conformance table): the scans rtol 1e-4, atol 1e-5
(they sum over T in another order than the JAX oracles); the forwards
1e-5, the f32 row, except the 2-layer RWKV6 stack's, which are held to the
scans' row: over weight seeds 0-7 and 11-13 its output reads up to 2.98×
the f32 row between JAX's own ``optimize()`` and JAX's own eager forward
(seed 0), so that row is below the stack's f32 floor.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

from repro.backends import get_backend as j_backend
from repro.core import executor as jexec
from repro.core import ir as jir
from repro.core import passes as jpasses
from repro.frontends import extract as jex
from repro.frontends import nn as jnn
from repro.frontends.optimize import optimize as j_optimize
from repro.kernels.rglru_scan.ops import rglru_scan as j_rglru_pallas
from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_rglru_ref
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv6_pallas
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_rwkv6_ref
from repro.models import recurrent as jrec
from repro_torch.backends import get_backend
from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as TAT
from repro_torch.core import executor as texec
from repro_torch.core import ir as tir
from repro_torch.core import passes
from repro_torch.frontends import extract as tex
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize
from repro_torch.kernels.dfp_fused import ops as fops
from repro_torch.kernels.dfp_fused.kernel import generate_source
from repro_torch.kernels.dfp_fused.program import encode_program
from repro_torch.kernels.rglru_scan import ops as rgops
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.rwkv6_scan import ops as rwops
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.models import recurrent as trec

SCAN_TOL = dict(rtol=1e-4, atol=1e-5)     # README: rglru/rwkv6 f32 row
TOL = dict(rtol=1e-5, atol=1e-5)          # README: f32 row


def forward_tol(name: str, layers: int) -> dict:
    """The 2-layer RWKV6 stack's forwards take the scans' row (module
    docstring); every other forward the f32 row."""
    return SCAN_TOL if (name, layers) == ("rwkv6", 2) else TOL
IMPL_MAP = {"cuda.linear": "pallas.linear_mxu",
            "cuda.matmul": "pallas.matmul_mxu",
            "cuda.dfp_fused": "pallas.dfp_fused",
            "cuda.rglru_scan": "pallas.rglru_scan",
            "cuda.rwkv6_scan": "pallas.rwkv6_scan"}

# (name, JAX builder, port builder, input shape): the JAX package's
# sequence-model test sizes
BLOCKS = {
    "griffin": (lambda: jnn.griffin_block(24),
                lambda: nn.griffin_block(24, device="cpu"), (2, 16, 24)),
    "rwkv6": (lambda: jnn.rwkv6_block(32, 4),
              lambda: nn.rwkv6_block(32, 4, device="cpu"), (2, 32, 32)),
}


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rglru_inputs(rng, b, t, d):
    a = rng.uniform(0.5, 0.999, (b, t, d)).astype(np.float32)
    return a, _rand(rng, b, t, d), _rand(rng, b, d)


def _rwkv6_inputs(rng, b, t, h, hd, logw=None):
    r, k, v = (_rand(rng, b, t, h, hd) * 0.5 for _ in range(3))
    if logw is None:
        logw = -np.exp(_rand(rng, b, t, h, hd) * 0.5 - 1.0)
    return (r, k, v, logw.astype(np.float32), _rand(rng, h, hd) * 0.5,
            _rand(rng, b, h, hd, hd) * 0.5)


def _draw(name: str, shape, rng) -> np.ndarray:
    """One parameter from the numpy generator alone, by its role: (in, out)
    and (out, in) matrices at a fan-in scale, gains near 1, small biases,
    and the recurrences' mixes, decays and bonus in the ranges the modules
    initialize them to."""
    leaf = name.rsplit(".", 1)[-1]
    n = rng.standard_normal(shape)
    if len(shape) == 2:
        return n / np.sqrt(shape[1] if leaf == "weight" else shape[0])
    if leaf == "lam" or leaf.startswith("mu_"):
        return rng.uniform(0.0, 1.0, shape)
    if leaf == "w0":
        return n * 0.3 - 2.0
    if leaf == "u":
        return n * 0.5
    if leaf in ("weight", "gn_gain"):
        return 1.0 + 0.1 * n
    return 0.1 * n                                  # biases, gn_bias


def models(name: str, layers: int = 1, seed: int = 0):
    """The same block stack in both packages, its weights a function of
    (name, layers, seed) alone: each parameter is drawn from the seed in
    name order (the JAX modules' own init depends on how many modules the
    process built before), loaded into the JAX modules and carried over
    name for name."""
    jb, tb, shape = BLOCKS[name]
    if layers == 1:
        jm, tm = jb(), tb()
    else:
        jm = jnn.Sequential(*[jb() for _ in range(layers)])
        tm = tnn.Sequential(*[tb() for _ in range(layers)])
    rng = np.random.default_rng(seed)
    sd = {k: _draw(k, np.shape(v), rng).astype(np.float32)
          for k, v in sorted(jm.named_parameters().items())}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    load_numpy_state_dict(tm, sd)
    return jm, tm, shape


# ---------------------------------------------------------------------------
# the scans' plain versions against the JAX oracles and Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,d,bd", [(2, 16, 24, 8), (3, 1, 24, 24),
                                      (2, 32, 64, 16), (1, 7, 40, 40)])
def test_rglru_plain_matches_jax(b, t, d, bd):
    rng = np.random.default_rng(b * 100 + t)
    a, x, h0 = _rglru_inputs(rng, b, t, d)
    h, h_last = rglru_scan_ref(_t(a), _t(x), _t(h0))
    ja, jx, jh0 = jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0)
    for want_h, want_last in (j_rglru_ref(ja, jx, jh0),
                              j_rglru_pallas(ja, jx, jh0, bd=bd,
                                             interpret=True)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   **SCAN_TOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                                   **SCAN_TOL)
    # the entry point on CPU tensors takes the plain version
    got, _ = rgops.rglru_scan(_t(a), _t(x), _t(h0))
    np.testing.assert_array_equal(got.numpy(), h.numpy())


@pytest.mark.parametrize("b,t,h,hd,bt", [(2, 16, 2, 8, 4), (1, 32, 4, 8, 32),
                                         (2, 12, 1, 16, 5), (1, 1, 2, 8, 1)])
def test_rwkv6_plain_matches_jax(b, t, h, hd, bt):
    rng = np.random.default_rng(t * 10 + hd)
    ins = _rwkv6_inputs(rng, b, t, h, hd)
    o, s_last = rwkv6_scan_ref(*map(_t, ins))
    jins = [jnp.asarray(a) for a in ins]
    for want_o, want_s in (j_rwkv6_ref(*jins),
                           j_rwkv6_pallas(*jins, bt=bt, interpret=True)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **SCAN_TOL)
        np.testing.assert_allclose(s_last.numpy(), np.asarray(want_s),
                                   **SCAN_TOL)
    got, _ = rwops.rwkv6_scan(*map(_t, ins))
    np.testing.assert_array_equal(got.numpy(), o.numpy())


def test_rwkv6_plain_at_the_decay_extremes():
    """logw 0 (no decay) and -50 (exp underflows: the state is forgotten)
    on the card smoke's edge shape (1, 3, 2, 8)."""
    rng = np.random.default_rng(7)
    logw = np.where(rng.random((1, 3, 2, 8)) < 0.5, 0.0, -50.0)
    ins = _rwkv6_inputs(rng, 1, 3, 2, 8, logw=logw)
    o, s_last = rwkv6_scan_ref(*map(_t, ins))
    want_o, want_s = j_rwkv6_ref(*[jnp.asarray(a) for a in ins])
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **SCAN_TOL)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(want_s),
                               **SCAN_TOL)


@pytest.mark.parametrize("t", [7, 32, 40, 64])
def test_wkv_chunked_matches_jax_and_the_plain_scan(t):
    """The modules' chunked WKV (chunk = the largest divisor of T ≤ 32)
    equals the JAX chunked form and the per-step plain scan, from a
    nonzero state."""
    rng = np.random.default_rng(t)
    r, k, v, logw, u, s0 = _rwkv6_inputs(rng, 2, t, 2, 8)
    o, s = trec._wkv_chunked(*map(_t, (r, k, v, logw, u, s0)))
    jo, js = jrec._wkv_chunked(*[jnp.asarray(a) for a in
                                 (r, k, v, logw, u, s0)])
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCAN_TOL)
    po, ps = rwkv6_scan_ref(*map(_t, (r, k, v, logw, u, s0)))
    np.testing.assert_allclose(o.numpy(), po.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), ps.numpy(), **SCAN_TOL)


def test_rglru_seq_with_a_carried_state_matches_jax():
    rng = np.random.default_rng(3)
    d = 24
    p = {"wa": _rand(rng, d, d) * 0.2, "wx": _rand(rng, d, d) * 0.2,
         "lam": rng.uniform(0, 1, d).astype(np.float32)}
    u, h0 = _rand(rng, 2, 16, d), _rand(rng, 2, d)
    h, last = trec.rglru_seq({k: _t(v) for k, v in p.items()}, _t(u), _t(h0))
    jh, jlast = jrec.rglru_seq({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(u), jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **SCAN_TOL)


def test_scan_kernels_raise_on_cpu_tensors():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        rglru_scan_cuda(x, x, torch.zeros(2, 8))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        rwkv6_scan_cuda(q, q, q, q, torch.zeros(2, 8),
                        torch.zeros(1, 2, 8, 8))


# ---------------------------------------------------------------------------
# the reference tier of the ops the recurrent emitters add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,attrs,shape", [
    ("softplus", {}, (24,)), ("sqrt", {"min": 1e-12}, (2, 5, 8)),
    ("sqrt", {}, (2, 5, 8)), ("time_shift", {}, (2, 5, 8)),
])
def test_reference_ops_match_jax(op, attrs, shape):
    rng = np.random.default_rng(len(op))
    x = _rand(rng, *shape) * 3.0
    if op == "sqrt" and not attrs:
        x = np.abs(x)
    nodes = [pkg.Node(pkg.OpKind(op), [pkg.input_node(shape)],
                      pkg.TensorSpec(shape), attrs=dict(attrs))
             for pkg in (jir, tir)]
    want = jexec._lower_node(nodes[0], [jnp.asarray(x)], j_backend("xla"))
    got = texec._lower_node(nodes[1], [_t(x)], get_backend("torch_ref"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# modules: parameters, eager forward, optimize() forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BLOCKS))
def test_state_dict_names_and_layouts_match(name):
    jm, tm, _ = models(name)
    jsd = {k: np.shape(v) for k, v in jm.named_parameters().items()}
    tsd = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert jsd == tsd
    for k, v in jm.named_parameters().items():       # carried over exactly
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(),
                                      np.asarray(v))
    if name == "griffin":
        assert tsd["0.1.wa"] == (24, 24) and tsd["0.1.lam"] == (24,)
    else:
        assert tsd["0.1.lora_a_w"] == (32, 4)            # (d, r)
        assert tsd["0.1.lora_b_w"] == (4, 32)            # (r, d)
        assert tsd["0.1.wo"] == (32, 32)                 # (in, out)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_eager_forward_matches_jax(name, layers):
    jm, tm, shape = models(name, layers, seed=layers)
    x = _rand(np.random.default_rng(1), *shape)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))),
                               **forward_tol(name, layers))


@pytest.mark.parametrize("backend", ["h100", "torch_ref"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_optimize_forward_matches_jax(name, layers, backend):
    jm, tm, shape = models(name, layers, seed=10 + layers)
    x = _rand(np.random.default_rng(2), *shape)
    want = np.asarray(j_optimize(jm, shape, backend="xla")(x))
    sol = optimize(tm, shape, backend=backend, device="cpu")
    np.testing.assert_allclose(sol(_t(x)).numpy(), want,
                               **forward_tol(name, layers))


def test_models_are_a_function_of_the_seed():
    """The same (name, layers, seed) gives the same weights however many
    JAX modules the process built in between."""
    first = models("rwkv6", 2, seed=12)
    jnn.rwkv6_block(32, 4), jnn.griffin_block(24), jnn.Linear(8, 8)
    second = models("rwkv6", 2, seed=12)
    for a, b in zip(first[:2], second[:2]):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            np.testing.assert_array_equal(np.asarray(sa[k]),
                                          np.asarray(sb[k]))
    other = models("rwkv6", 2, seed=13)[1].state_dict()
    assert not np.array_equal(other["0.0.1.wr"].numpy(),
                              first[1].state_dict()["0.0.1.wr"].numpy())


def test_stack_tolerance_still_fails_a_wrong_stack():
    """At the 2-layer RWKV6 stack's limit, a stack whose bonus ``u`` is
    zeroed on the port's side still fails."""
    jm, tm, shape = models("rwkv6", 2, seed=12)
    x = _rand(np.random.default_rng(2), *shape)
    want = np.asarray(j_optimize(jm, shape, backend="xla")(x))
    with torch.no_grad():
        for k, p in tm.named_parameters():
            if k.endswith(".u"):
                p.zero_()
    got = optimize(tm, shape, backend="h100", device="cpu")(_t(x)).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **forward_tol("rwkv6", 2))


# ---------------------------------------------------------------------------
# pass decisions
# ---------------------------------------------------------------------------

def _attrs(n) -> dict:
    if n.op.value == "fused":
        return {}
    if n.op.value == "layernorm":
        return {"eps": n.attrs.get("eps", 1e-5)}
    return n.attrs


# the storage types the kernels take; a float32 case keeps the id it had
# before the half-precision ones joined
DTYPES = ("float32", "bfloat16", "float16")


def dtype_cases(*pairs):
    """(port backend, JAX backend, dtype) for every pair and dtype."""
    return [pytest.param(p, j, dt, id=f"{p}-{j}" + (
        "" if dt == "float32" else f"-{dt}"))
        for dt in DTYPES for p, j in pairs]


@pytest.mark.parametrize("port_bk,jax_bk,dtype", dtype_cases(
    ("h100", "pallas_interpret"), ("torch_ref", "xla")))
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_decisions_equal_jax(name, layers, port_bk, jax_bk, dtype):
    """Node ops, fusion groups, layouts, elected impls and cost terms equal
    the JAX package's, in each storage type the kernels take."""
    jm, tm, shape = models(name, layers)
    jg = jpasses.run_pipeline(jex.extract(jm, shape, dtype),
                              j_backend(jax_bk))
    tg = passes.run_pipeline(tex.extract(tm, shape, dtype),
                             get_backend(port_bk))
    jt, tt = jg.topo(), tg.topo()
    assert [n.op.value for n in tt] == [n.op.value for n in jt]
    assert [n.name for n in tt if n.op is tir.OpKind.FUSED] == \
        [n.name for n in jt if n.op.value == "fused"]
    assert [n.layout for n in tt] == [n.layout for n in jt]
    assert [IMPL_MAP.get(n.impl, n.impl) for n in tt] == [n.impl for n in jt]
    # the port's LayerNorm emitter writes eps 1e-5 out; JAX's leaves the
    # default implicit
    assert [_attrs(n) for n in tt] == [_attrs(n) for n in jt]
    assert [passes._node_cost_terms(n) for n in tt] == \
        [jpasses._node_cost_terms(n) for n in jt]
    assert tg.layout_reorders == jg.layout_reorders


@pytest.mark.parametrize("name,want", [
    ("griffin", {"rglru_scan": {"cuda.rglru_scan": 1},
                 "fused": {"cuda.dfp_fused": 3, "ref.compose": 2},
                 "matmul": {"cuda.matmul": 2}, "linear": {"cuda.linear": 2}}),
    ("rwkv6", {"rwkv6_scan": {"cuda.rwkv6_scan": 1},
               "fused": {"cuda.dfp_fused": 10},
               "matmul": {"cuda.matmul": 17}, "linear": {"cuda.linear": 2}}),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_h100_elects_the_kernels(name, want, dtype):
    """The split of the JAX probe: Griffin's softplus and √ groups compose
    (SOFTPLUS and SQRT are outside the DFP program set), every other group,
    scan, MATMUL and LINEAR elects its kernel, in each storage type."""
    _, tm, shape = models(name)
    sol = optimize(tm, shape, backend="h100", device="cpu", dtype=dtype)
    by_kind = sol.impl_report(by_kind=True)
    for kind, impls in want.items():
        assert by_kind[kind] == impls, (kind, by_kind[kind])
    composed = [n.name for n in sol.graph.topo()
                if n.impl == "ref.compose"]
    assert composed == ([] if name == "rwkv6" else
                        ["fused[softplus+scale]",
                         "fused[mul+sub+sqrt+mul+mul]"])


def test_scan_supports_refuse_what_the_kernels_do_not_take():
    """hd > 128 (the state column no longer fits in registers), dtypes
    other than float32, bfloat16 and float16, and mixed dtypes elect the
    reference tier."""
    h100 = get_backend("h100")
    for hd, dtype, want in ((64, "float32", "cuda.rwkv6_scan"),
                            (128, "float32", "cuda.rwkv6_scan"),
                            (256, "float32", "ref.rwkv6_scan"),
                            (64, "bfloat16", "cuda.rwkv6_scan"),
                            (64, "float16", "cuda.rwkv6_scan"),
                            (256, "bfloat16", "ref.rwkv6_scan"),
                            (64, "float64", "ref.rwkv6_scan")):
        seq = tir.input_node((1, 4, 2, hd), dtype)
        n = tir.Node(tir.OpKind.RWKV6_SCAN,
                     [seq, seq, seq, seq, tir.input_node((2, hd), dtype),
                      tir.input_node((1, 2, hd, hd), dtype)],
                     tir.TensorSpec((1, 4, 2, hd), dtype))
        assert h100.resolve(n).name == want
    a = tir.input_node((1, 4, 8), "bfloat16")      # h0 float32: mixed
    n = tir.Node(tir.OpKind.RGLRU_SCAN, [a, a, tir.input_node((1, 8))],
                 tir.TensorSpec((1, 4, 8), "bfloat16"))
    assert h100.resolve(n).name == "ref.rglru_scan"


def test_vec_operand_groups_run_the_plain_program_like_jax_composes():
    """Every fusion group of both blocks that the port's DFP encoder takes
    (vec operands as value sources included) gives, through the plain
    program, the JAX package's composed result for the same group."""
    for name in BLOCKS:
        jm, tm, shape = models(name)
        jg = jpasses.run_pipeline(jex.extract(jm, shape),
                                  j_backend("pallas_interpret"))
        tg = passes.run_pipeline(tex.extract(tm, shape), get_backend("h100"))
        jf = [n for n in jg.topo() if n.op.value == "fused"]
        tf = [n for n in tg.topo() if n.op is tir.OpKind.FUSED]
        rng = np.random.default_rng(len(name))
        for jn, tn in zip(jf, tf):
            if tn.impl != "cuda.dfp_fused":
                continue
            vals = [_rand(rng, *i.spec.shape) for i in jn.inputs]
            want = jexec.compose_fused(jn, [jnp.asarray(v) for v in vals],
                                       j_backend("xla"))
            prog, ops = encode_program(tn, {id(i): _t(v) for i, v in
                                            zip(tn.inputs, vals)})
            got = fops.dfp_fused(prog, ops)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            compile(generate_source(prog, "dfp_test"), "<dfp>", "exec")


@pytest.mark.parametrize("name", list(BLOCKS))
def test_decode_extraction_refuses_recurrent_blocks(name):
    _, tm, shape = models(name)
    with pytest.raises(tex.UnsupportedModuleError, match="decode emitter"):
        tex.extract_decode(tm, 2, 16, shape[-1])
    # the forward and prefill programs extract
    assert tex.extract_prefill(tm, shape).outputs

"""The port's CNN slice against the JAX package, on the CPU: the
average-pooling kernel's plain version, the CNN modules' weights, eager
and ``optimize()`` forwards, and the pass decisions, on the same
numpy-seeded inputs and weights.

Three networks: ``small_cnn``, ``depthwise_cnn`` and the Listing-3 CNN,
``depthwise_cnn`` with ``AvgPool2d(3, stride=1)`` after each of its two
bias-free depthwise convs (the paper's Listing 3 shows that 3×3/9 pooling
as DFP code).  The Listing-3 CNN is the network whose lone stride-1
AVGPOOL nodes elect the pooling kernel.  Inputs (2, 3, 32, 32), where the
first conv's C equals W, and (2, 3, 40, 40).

Tolerances (README's conformance table): the f32 row, rtol 1e-5 and atol
1e-5, for the forwards; the pooling's plain version rtol 1e-5, atol 1e-6
(it sums the same taps in the same order as the Pallas kernel, in f32).
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
from repro.kernels.avgpool.ops import avgpool as j_avgpool_pallas
from repro.kernels.avgpool.ref import avgpool_ref as j_avgpool_ref
from repro_torch.backends import get_backend
from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as TAT
from repro_torch.core import executor as texec
from repro_torch.core import ir as tir
from repro_torch.core import passes
from repro_torch.frontends import extract as tex
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize
from repro_torch.kernels.avgpool import ops as apops
from repro_torch.kernels.avgpool.kernel import avgpool_cuda
from repro_torch.kernels.avgpool.ref import avgpool_ref
from repro_torch.kernels.dfp_fused import ops as fops
from repro_torch.kernels.dfp_fused.program import encode_program

TOL = dict(rtol=1e-5, atol=1e-5)           # README: f32 row
POOL_TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(2, 3, 32, 32), (2, 3, 40, 40)]
IMPL_MAP = {"cuda.linear": "pallas.linear_mxu",
            "cuda.dfp_fused": "pallas.dfp_fused",
            "cuda.avgpool": "pallas.avgpool"}


def listing3_cnn(pkg, **kw):
    """``depthwise_cnn`` of ``pkg`` (the JAX frontend or the port's) with
    ``AvgPool2d(3, stride=1)`` after each bias-free depthwise conv."""
    mods = list(pkg.depthwise_cnn(**kw))
    mods.insert(3, pkg.AvgPool2d(3, stride=1))
    mods.insert(8, pkg.AvgPool2d(3, stride=1))
    return pkg.Sequential(*mods)


CPU = dict(device="cpu")
NETS = {
    "small_cnn": (jnn.small_cnn, lambda: nn.small_cnn(**CPU)),
    "depthwise_cnn": (jnn.depthwise_cnn, lambda: nn.depthwise_cnn(**CPU)),
    "listing3_cnn": (lambda: listing3_cnn(jnn),
                     lambda: listing3_cnn(nn, **CPU)),
    "mlp_8192": (lambda: jnn.mlp_8192(3, 64, 32, 10),
                 lambda: nn.mlp_8192(3, 64, 32, 10, **CPU)),
}
CNNS = ["small_cnn", "depthwise_cnn", "listing3_cnn"]


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


def _draw(name: str, shape, rng) -> np.ndarray:
    """One parameter from the numpy generator alone, by its role: conv and
    Linear weights (out, ...) N(0, 2/fan_in), batch-norm gains near 1,
    running variances in (0.5, 1.5), biases and means small and nonzero."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return rng.uniform(0.5, 1.5, shape)
    n = rng.standard_normal(shape)
    if leaf == "weight" and len(shape) >= 2:
        return n * np.sqrt(2.0 / np.prod(shape[1:]))
    if leaf == "weight":
        return 1.0 + 0.1 * n
    return 0.1 * n                        # biases, running_mean


def models(name: str, seed: int = 0):
    """The same network in both packages, its weights a function of (name,
    seed) alone; the port's in ``eval()`` mode, since the JAX batch norm
    always normalizes with its running stats."""
    jb, tb = NETS[name]
    jm, tm = jb(), tb().eval()
    rng = np.random.default_rng(seed)
    sd = {k: _draw(k, np.shape(v), rng).astype(np.float32)
          for k, v in sorted(jm.named_parameters().items())}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    load_numpy_state_dict(tm, sd)
    return jm, tm


# ---------------------------------------------------------------------------
# the pooling kernel's plain version against the JAX oracle and Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,h,w,kh,kw", [
    (2, 3, 8, 8, 3, 3), (1, 4, 5, 7, 2, 3), (2, 2, 3, 3, 3, 3),
    (1, 1, 9, 33, 3, 2), (3, 5, 12, 10, 1, 1), (1, 2, 34, 35, 2, 2),
])
def test_avgpool_plain_matches_jax(n, c, h, w, kh, kw):
    x = _rand(np.random.default_rng(h * 100 + w), n, c, h, w)
    got = avgpool_ref(_t(x), kh, kw)
    assert got.shape == (n, c, h - kh + 1, w - kw + 1)
    for want in (j_avgpool_ref(jnp.asarray(x), kh, kw),
                 j_avgpool_pallas(jnp.asarray(x), kh, kw, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **POOL_TOL)
    # the entry point on a CPU tensor takes the plain version
    np.testing.assert_array_equal(apops.avgpool(_t(x), kh, kw).numpy(),
                                  got.numpy())


def test_avgpool_kernel_raises_on_cpu_tensors():
    with pytest.raises(ValueError):
        avgpool_cuda(torch.zeros(1, 2, 5, 5), 3, 3)


@pytest.mark.parametrize("kernel,stride,shape,dtype,want", [
    (3, 1, (2, 4, 9, 9), "float32", "cuda.avgpool"),
    ((2, 3), (1, 1), (2, 4, 9, 9), "float32", "cuda.avgpool"),
    (2, 2, (2, 4, 8, 8), "float32", "ref.avgpool"),
    (3, 1, (2, 4, 9, 9), "bfloat16", "cuda.avgpool"),
    (3, 1, (2, 4, 9, 9), "float16", "cuda.avgpool"),
    (3, 1, (2, 4, 9, 9), "float64", "ref.avgpool"),
    (3, 1, (2, 4, 9, 9), "int32", "ref.avgpool"),
])
def test_avgpool_supports_what_the_kernel_takes(kernel, stride, shape, dtype,
                                                want):
    """Stride 1, rank 4, float32, bfloat16 or float16 elects the kernel;
    the rest the reference tier."""
    k = (kernel, kernel) if isinstance(kernel, int) else kernel
    x = tir.input_node(shape, dtype)
    out = shape[:2] + (shape[2] - k[0] + 1, shape[3] - k[1] + 1)
    n = tir.Node(tir.OpKind.AVGPOOL, [x], tir.TensorSpec(out, dtype),
                 attrs={"kernel": kernel, "stride": stride})
    assert get_backend("h100").resolve(n).name == want
    assert get_backend("torch_ref").resolve(n).name == "ref.avgpool"


# ---------------------------------------------------------------------------
# the reference tier of the CNN ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,attrs,shape,params", [
    ("maxpool", {"kernel": 2, "stride": 2}, (2, 3, 8, 8), []),
    ("maxpool", {"kernel": 3, "stride": 2, "min_value": 0.0}, (2, 3, 9, 9),
     []),
    ("avgpool", {"kernel": 3, "stride": 1}, (2, 3, 8, 8), []),
    ("avgpool", {"kernel": 2, "stride": 2}, (2, 3, 8, 9), []),
    ("globalpool", {}, (2, 3, 5, 7), []),
    ("flatten", {}, (2, 3, 4, 5), []),
    ("batchnorm", {}, (2, 4, 5, 5), [(4,), (4,), (4,), (4,)]),
    ("conv2d", {"stride": 2, "padding": 1, "groups": 1, "out_channels": 6},
     (2, 4, 9, 9), [(6, 4, 3, 3)]),
    ("conv2d", {"stride": 1, "padding": 1, "groups": 4, "out_channels": 4},
     (2, 4, 8, 8), [(4, 1, 3, 3)]),
])
def test_reference_ops_match_jax(op, attrs, shape, params):
    rng = np.random.default_rng(len(op) + len(attrs))
    vals = [_rand(rng, *shape)] + [np.abs(_rand(rng, *p)) + 0.5
                                   for p in params]
    want = None
    for pkg, lower, bk, conv in ((jir, jexec._lower_node, j_backend("xla"),
                                  jnp.asarray),
                                 (tir, texec._lower_node,
                                  get_backend("torch_ref"), _t)):
        ins = [pkg.input_node(v.shape) for v in vals]
        node = pkg.Node(pkg.OpKind(op), ins, pkg.TensorSpec(shape),
                        attrs=dict(attrs))
        got = np.asarray(lower(node, [conv(v) for v in vals], bk))
        if want is None:
            want = got
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# modules: parameters, extraction, eager and optimize() forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(NETS))
def test_state_dict_names_and_layouts_match(name):
    """Every JAX parameter has the port's name and layout and is carried
    over exactly; the port's only extra entries are torch's batch-norm step
    counters."""
    jm, tm = models(name)
    jsd = {k: np.shape(v) for k, v in jm.named_parameters().items()}
    tsd = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    extra = set(tsd) - set(jsd)
    assert all(k.endswith(".num_batches_tracked") for k in extra)
    assert len(extra) == (1 if name == "small_cnn" else 0)
    assert {k: tsd[k] for k in jsd} == jsd
    for k, v in jm.named_parameters().items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(),
                                      np.asarray(v))
    if name == "small_cnn":
        assert tsd["0.weight"] == (32, 3, 3, 3)          # OIHW
        assert tsd["7.running_var"] == (128,)
    if name == "listing3_cnn":
        assert tsd["2.weight"] == (32, 1, 3, 3)          # depthwise
        assert tsd["4.weight"] == (64, 32, 1, 1)         # after the pool


def test_models_are_a_function_of_the_seed():
    a = models("small_cnn", seed=3)[1].state_dict()
    jnn.small_cnn(), jnn.Linear(4, 4)
    b = models("small_cnn", seed=3)[1].state_dict()
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def test_load_still_refuses_a_missing_or_unknown_name():
    jm, tm = models("small_cnn")
    sd = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    sd.pop("7.running_mean")
    with pytest.raises(KeyError, match="running_mean"):
        load_numpy_state_dict(tm, sd)
    sd["7.running_mean"] = np.zeros(128, np.float32)
    sd["7.num_batches_tracked"] = np.zeros((), np.int64)
    with pytest.raises(KeyError, match="num_batches_tracked"):
        load_numpy_state_dict(tm, sd)


@pytest.mark.parametrize("mode", ["eager", "torch_ref", "h100"])
@pytest.mark.parametrize("shape", SHAPES, ids=["32x32", "40x40"])
@pytest.mark.parametrize("name", CNNS)
def test_forward_matches_jax_xla(name, shape, mode):
    """The port's eager forward and both backends' ``optimize()`` forwards
    equal the JAX package's ``optimize(xla)``, nonzero biases included."""
    jm, tm = models(name, seed=1)
    x = _rand(np.random.default_rng(5), *shape)
    want = np.asarray(j_optimize(jm, shape, backend="xla")(x))
    if mode == "eager":
        with torch.no_grad():
            got = tm(_t(x)).numpy()
    else:
        got = optimize(tm, shape, backend=mode, device="cpu")(_t(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_mlp_forward_matches_jax():
    jm, tm = models("mlp_8192", seed=2)
    x = _rand(np.random.default_rng(6), 4, 32)
    want = np.asarray(j_optimize(jm, (4, 32), backend="xla")(x))
    for bk in ("h100", "torch_ref"):
        got = optimize(tm, (4, 32), backend=bk, device="cpu")(_t(x))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_non_square_windows_extract_and_run():
    """torch's (h, w) pairs that differ stay pairs in the IR and lower as
    such (the JAX modules take square windows only)."""
    g = torch.Generator().manual_seed(0)
    model = tnn.Sequential(
        tnn.Conv2d(3, 4, (3, 1), stride=(1, 2), padding=(1, 0)),
        tnn.AvgPool2d((2, 3), stride=1), tnn.MaxPool2d((2, 1))).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    x = torch.randn(2, 3, 10, 12, generator=g)
    with torch.no_grad():
        want = model(x)
    for bk in ("h100", "torch_ref"):
        sol = optimize(model, tuple(x.shape), backend=bk, device="cpu")
        assert sol.graph.outputs[0].spec.shape == tuple(want.shape)
        torch.testing.assert_close(sol(x), want, **TOL)
    g = tex.extract(model, tuple(x.shape))
    attrs = {n.op: n.attrs for n in g.topo()}
    conv, pool = attrs[tir.OpKind.CONV2D], attrs[tir.OpKind.AVGPOOL]
    assert conv == {"stride": (1, 2), "padding": (1, 0), "groups": 1,
                    "out_channels": 4}
    assert pool == {"kernel": (2, 3), "stride": 1}


@pytest.mark.parametrize("module", [
    tnn.MaxPool2d(2, padding=1), tnn.MaxPool2d(2, ceil_mode=True),
    tnn.MaxPool2d(2, dilation=2), tnn.AvgPool2d(3, 1, padding=1),
    tnn.AvgPool2d(2, ceil_mode=True), tnn.AvgPool2d(2, divisor_override=3),
    tnn.Conv2d(3, 3, 3, dilation=2), tnn.Conv2d(3, 3, 3, padding="same"),
    tnn.Conv2d(3, 3, 3, padding=1, padding_mode="reflect"),
    tnn.Flatten(0, -1), tnn.Flatten(1, 2),
    tnn.BatchNorm2d(3, affine=False),
    tnn.BatchNorm2d(3, track_running_stats=False),
], ids=lambda m: repr(m))
def test_extraction_refuses_what_the_ir_does_not_compute(module):
    with pytest.raises(tex.UnsupportedModuleError):
        tex.extract(module, (2, 3, 8, 8))


# ---------------------------------------------------------------------------
# pass decisions
# ---------------------------------------------------------------------------

def _conv_bias_group(n) -> bool:
    return n.op.value == "fused" and any(
        b.op.value == "bias_add" and b.attrs.get("axis") == 1 for b in n.body)


def _attrs(n) -> dict:
    if n.op.value == "fused":
        return {}
    if n.op.value == "batchnorm":       # the port writes eps 1e-5 out
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
@pytest.mark.parametrize("shape", SHAPES, ids=["32x32", "40x40"])
@pytest.mark.parametrize("name", CNNS)
def test_decisions_equal_jax(name, shape, port_bk, jax_bk, dtype):
    """Node ops, fusion groups, layouts, folds, elected impls and cost terms
    equal the JAX package's.  The one mapped difference: a group holding a
    conv's channel bias, which the JAX package elects as
    ``pallas.dfp_fused`` and composes at run time, elects ``ref.compose``
    on ``h100`` (its ``supports`` asks the encoder, which refuses it).  In
    each storage type the kernels take."""
    jm, tm = models(name)
    jg = jpasses.run_pipeline(jex.extract(jm, shape, dtype),
                              j_backend(jax_bk))
    tg = passes.run_pipeline(tex.extract(tm, shape, dtype),
                             get_backend(port_bk))
    jt, tt = jg.topo(), tg.topo()
    assert [n.op.value for n in tt] == [n.op.value for n in jt]
    assert [n.name for n in tt if n.op is tir.OpKind.FUSED] == \
        [n.name for n in jt if n.op.value == "fused"]
    assert [n.layout for n in tt] == [n.layout for n in jt]
    assert tg.attrs_log == jg.attrs_log        # relu_maxpool_folded & co
    mapped = 0
    for t, j in zip(tt, jt):
        got = IMPL_MAP.get(t.impl, t.impl)
        if (port_bk == "h100" and _conv_bias_group(t)
                and got == "ref.compose" and j.impl == "pallas.dfp_fused"):
            mapped += 1
            continue
        assert got == j.impl, (t.name, t.impl, j.impl)
    assert mapped == (1 if port_bk == "h100" and name != "small_cnn" else 0)
    assert [_attrs(n) for n in tt] == [_attrs(n) for n in jt]
    assert [passes._node_cost_terms(n) for n in tt] == \
        [jpasses._node_cost_terms(n) for n in jt]
    assert tg.layout_reorders == jg.layout_reorders


@pytest.mark.parametrize("name,want", [
    ("small_cnn", {"linear": {"cuda.linear": 2}, "conv2d": {"ref.conv2d": 3},
                   "fused": {"ref.compose": 3, "cuda.dfp_fused": 1}}),
    ("depthwise_cnn", {"linear": {"cuda.linear": 1},
                       "conv2d": {"ref.conv2d": 5},
                       "fused": {"ref.compose": 3}}),
    ("listing3_cnn", {"avgpool": {"cuda.avgpool": 2},
                      "linear": {"cuda.linear": 1},
                      "conv2d": {"ref.conv2d": 5},
                      "fused": {"ref.compose": 3}}),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_h100_elects_the_kernels(name, want, dtype):
    """The lone stride-1 pools elect the kernel, every LINEAR its kernel,
    and every group holding a conv bias composes, in each storage type."""
    _, tm = models(name)
    sol = optimize(tm, (2, 3, 32, 32), backend="h100", device="cpu",
                   dtype=dtype)
    by_kind = sol.impl_report(by_kind=True)
    for kind, impls in want.items():
        assert by_kind[kind] == impls, (kind, by_kind[kind])
    for n in sol.graph.topo():
        if _conv_bias_group(n):
            assert n.impl == "ref.compose", n.name


# ---------------------------------------------------------------------------
# the DFP encoder's channel-bias repair
# ---------------------------------------------------------------------------

def _bias_relu_group(shape, axis):
    x = tir.input_node(shape)
    b = tir.param_node((shape[1],), name="b")
    bias = tir.Node(tir.OpKind.BIAS_ADD, [x, b], tir.TensorSpec(shape),
                    attrs={"axis": axis})
    relu = tir.Node(tir.OpKind.RELU, [bias], tir.TensorSpec(shape))
    return tir.Node(tir.OpKind.FUSED, [x, b], tir.TensorSpec(shape),
                    name="fused[bias_add+relu]", body=[bias, relu])


def test_encoder_refuses_a_channel_bias_when_c_equals_w():
    """A BIAS_ADD over axis 1 of (2, 32, 32, 32) has a (32,) operand that
    looks like a last-axis vec; the encoder refuses it, so ``supports``
    does, while the same group over the last axis encodes."""
    chan = _bias_relu_group((2, 32, 32, 32), axis=1)
    with pytest.raises(NotImplementedError, match="axis 1"):
        encode_program(chan, {id(i): i.spec for i in chan.inputs})
    assert not fops._supports_chain(chan)
    last = _bias_relu_group((2, 32, 32, 32), axis=-1)
    prog, _ = encode_program(last, {id(i): i.spec for i in last.inputs})
    assert sorted(prog.operand_kinds) == ["full", "vec"]
    assert fops._supports_chain(last)


def test_depthwise_cnn_at_c_equal_w_matches_xla_where_jax_pallas_does_not():
    """``depthwise_cnn`` at (2, 3, 32, 32): the first conv's 32 channels
    equal W.  The port's ``h100`` forward equals JAX's ``xla``; JAX's
    ``pallas_interpret`` encodes the conv bias as a last-axis vec and
    misses (the reference caveat in ROADMAP)."""
    jm, tm = models("depthwise_cnn", seed=1)
    shape = (2, 3, 32, 32)
    x = _rand(np.random.default_rng(5), *shape)
    want = np.asarray(j_optimize(jm, shape, backend="xla")(x))
    got = optimize(tm, shape, backend="h100", device="cpu")(_t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jax_pallas = np.asarray(j_optimize(jm, shape,
                                       backend="pallas_interpret")(x))
    assert np.abs(jax_pallas - want).max() > 1e-2 * np.abs(want).max()

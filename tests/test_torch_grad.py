"""The port's backward impls against the JAX package's, on the CPU: the
same node, residuals ``(inputs, output)`` and cotangent (numpy, seeded)
through each grad impl of both packages.  The port's ``cuda.*_bwd`` impls
run their kernels' plain versions here (a CPU tensor), the JAX ``pallas.*``
ones in interpret mode; every other impl is torch ops against jnp.
Small sizes; f32 tolerance 1e-5 (README's conformance table), 1e-4 for
RWKV6's recurrence."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as j_backend
from repro.backends import registry as JR
from repro.core import ir as jir
from repro_torch.backends import get_backend, registry
from repro_torch.core import executor
from repro_torch.core import ir as tir

TOL = dict(rtol=1e-5, atol=1e-5)
RWKV6_TOL = dict(rtol=1e-4, atol=1e-4)
# the port's backward impls and the JAX package's, one for one
GRAD_MAP = {"cuda.linear_bwd": "pallas.linear_mxu_bwd",
            "cuda.matmul_bwd": "pallas.matmul_mxu_bwd",
            "cuda.rglru_scan_bwd": "pallas.rglru_scan_bwd"}
# the backend each impl runs on in each package
BACKENDS = {"cuda": ("h100", "pallas_interpret"),
            "ref": ("torch_ref", "xla")}
# the attrs a backward config pins, port and JAX
BWD_ATTRS = {"attention": ("cuda_attn_block_bwd", "attn_block_bwd"),
             "rwkv6_scan": ("cuda_rwkv6_block_bwd", "rwkv6_block_bwd")}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _run(port_impl: str, build, arrays, ct, cfg=None):
    """Both packages' grad impl on the node ``build(ir)`` (built with each
    IR module) at the numpy ``arrays`` and cotangent ``ct``; the forward
    output of the residuals is each package's reference forward.  Returns
    (port cotangents, JAX cotangents) as numpy, None for an integer
    input."""
    tier = port_impl.split(".")[0]
    t_bk, j_bk = BACKENDS.get(tier, ("h100", "pallas_interpret"))
    t_bk, j_bk = get_backend(t_bk), j_backend(j_bk)
    tn, jn = build(tir), build(jir)
    if cfg is not None:
        attr_t, attr_j = BWD_ATTRS[tn.op.value]
        tn.attrs[attr_t] = cfg
        jn.attrs[attr_j] = cfg
    tvals = [torch.from_numpy(a) for a in arrays]
    jvals = [jnp.asarray(a) for a in arrays]
    registry._load_entry_points()
    JR._load_entry_points()
    t_out = registry._REFERENCE_IMPLS[tn.op].fn(tn, tvals, t_bk)
    j_out = JR._REFERENCE_IMPLS[jn.op].fn(jn, jvals, j_bk)
    t_gi = registry.get_grad_impl(port_impl)
    j_gi = JR.get_grad_impl(GRAD_MAP.get(port_impl, port_impl))
    assert t_gi.admissible(t_bk, tn) and j_gi.admissible(j_bk, jn)
    got = t_gi.fn(tn, (tvals, t_out), torch.from_numpy(ct), t_bk)
    want = j_gi.fn(jn, (tuple(jvals), j_out), jnp.asarray(ct), j_bk)
    assert len(got) == len(want) == len(arrays)
    return ([None if g is None else g.detach().numpy() for g in got],
            [None if w is None else np.asarray(w) for w in want])


def _close(got, want, tol=TOL, skip=()):
    for i, (g, w) in enumerate(zip(got, want)):
        if i in skip:
            assert g is None
            continue
        np.testing.assert_allclose(g, w, err_msg=f"cotangent {i}", **tol)


# -- products -----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["cuda.matmul_bwd", "ref.matmul_bwd"])
def test_matmul_bwd_equals_jax(impl):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 20)) * 0.2).astype(np.float32)
    ct = rng.standard_normal((2, 7, 20)).astype(np.float32)

    def build(ir):
        return ir.Node(ir.OpKind.MATMUL, [ir.input_node(x.shape),
                                          ir.param_node(w.shape)],
                       ir.TensorSpec((2, 7, 20)))
    _close(*_run(impl, build, [x, w], ct))


@pytest.mark.parametrize("impl", ["cuda.linear_bwd", "ref.linear_bwd"])
@pytest.mark.parametrize("stored", ["oi", "io"])
@pytest.mark.parametrize("layout", ["oi", "io"])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_bwd_equals_jax(impl, stored, layout, bias):
    """A Linear's weight stored (out, in) or (in, out), the node in either
    layout the layout pass assigns, with and without a bias: dx, dw in
    the stored layout, and the bias's sum."""
    rng = _rng(2)
    k, n = 24, 20
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    w = (rng.standard_normal((n, k) if stored == "oi" else (k, n)) * 0.2
         ).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ct = rng.standard_normal((3, 5, n)).astype(np.float32)
    arrays = [x, w] + ([b] if bias else [])

    def build(ir):
        ins = [ir.input_node(x.shape), ir.param_node(w.shape)]
        if bias:
            ins.append(ir.param_node(b.shape))
        node = ir.Node(ir.OpKind.LINEAR, ins, ir.TensorSpec((3, 5, n)),
                       attrs={"out_features": n, "in_features": k})
        node.layout = layout
        return node
    got, want = _run(impl, build, arrays, ct)
    assert got[1].shape == w.shape
    _close(got, want)


# -- attention ----------------------------------------------------------------

ATTN_CASES = [  # (S, H, KV, causal, window, cap, chunk)
    pytest.param(40, 4, 4, True, 0, 0.0, None, id="causal"),
    pytest.param(200, 4, 2, True, 0, 0.0, 128, id="gqa-ragged-chunks"),
    pytest.param(150, 4, 2, True, 48, 0.0, 128, id="window"),
    pytest.param(96, 4, 1, True, 0, 20.0, 128, id="softcap-mqa"),
    pytest.param(72, 2, 2, False, 0, 0.0, 128, id="bidirectional"),
]


@pytest.mark.parametrize("impl", ["flash.attention_bwd",
                                  "ref.attention_bwd"])
@pytest.mark.parametrize("s,h,kv,causal,window,cap,chunk", ATTN_CASES)
def test_attention_bwd_equals_jax(impl, s, h, kv, causal, window, cap,
                                  chunk):
    rng = _rng(3)
    hd = 16
    q = rng.standard_normal((2, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((2, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((2, s, kv, hd)).astype(np.float32)
    ct = rng.standard_normal((2, s, h, hd)).astype(np.float32)

    def build(ir):
        return ir.Node(ir.OpKind.ATTENTION,
                       [ir.input_node(q.shape), ir.input_node(k.shape),
                        ir.input_node(v.shape)],
                       ir.TensorSpec(q.shape),
                       attrs={"causal": causal, "window": window,
                              "cap": cap})
    cfg = (chunk,) if chunk and impl.startswith("flash.") else None
    _close(*_run(impl, build, [q, k, v], ct, cfg))


def test_decode_attention_bwd_equals_jax():
    """Decode attention's reference backward; the integer ``lens`` gets
    no cotangent."""
    rng = _rng(4)
    b, s, h, kv, hd = 3, 12, 4, 2, 16
    arrays = [rng.standard_normal((b, 1, h, hd)).astype(np.float32),
              rng.standard_normal((b, s, kv, hd)).astype(np.float32),
              rng.standard_normal((b, s, kv, hd)).astype(np.float32),
              rng.standard_normal((b, 1, kv, hd)).astype(np.float32),
              rng.standard_normal((b, 1, kv, hd)).astype(np.float32),
              np.array([0, 5, 12], np.int32)]
    ct = rng.standard_normal((b, 1, h, hd)).astype(np.float32)

    def build(ir):
        ins = [ir.input_node(a.shape) for a in arrays[:5]]
        ins.append(ir.input_node((b,), "int32"))
        return ir.Node(ir.OpKind.DECODE_ATTENTION, ins,
                       ir.TensorSpec((b, 1, h, hd)), attrs={})
    got, want = _run("ref.decode_attention_bwd", build, arrays, ct)
    _close(got[:5], want[:5])
    assert got[5] is None


# -- the scans ----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["cuda.rglru_scan_bwd", "ref.rglru_scan_bwd"])
def test_rglru_bwd_equals_jax(impl):
    """The reverse recurrence with a nonzero h0, T and D ragged."""
    rng = _rng(5)
    b, t, d = 2, 13, 40
    a = rng.uniform(0.5, 1.0, (b, t, d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    ct = rng.standard_normal((b, t, d)).astype(np.float32)

    def build(ir):
        return ir.Node(ir.OpKind.RGLRU_SCAN,
                       [ir.input_node(a.shape), ir.input_node(x.shape),
                        ir.input_node(h0.shape)], ir.TensorSpec((b, t, d)))
    _close(*_run(impl, build, [a, x, h0], ct))


@pytest.mark.parametrize("impl,cfg", [("ckpt.rwkv6_scan_bwd", None),
                                      ("ckpt.rwkv6_scan_bwd", (8,)),
                                      ("ckpt.rwkv6_scan_bwd", (20,)),
                                      ("ref.rwkv6_scan_bwd", None)])
def test_rwkv6_bwd_equals_jax(impl, cfg):
    """T 20 is no multiple of the default chunk (16) nor of a pinned 8:
    the chunk is gcd(config, T)."""
    rng = _rng(6)
    b, t, h, hd = 2, 20, 2, 8
    r, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = (-np.exp(rng.standard_normal((b, t, h, hd)) * 0.5 - 1.0)
            ).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hd, hd)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((b, t, h, hd)).astype(np.float32)

    def build(ir):
        seq = [ir.input_node(r.shape) for _ in range(4)]
        return ir.Node(ir.OpKind.RWKV6_SCAN,
                       seq + [ir.input_node(u.shape),
                              ir.input_node(s0.shape)],
                       ir.TensorSpec(r.shape))
    _close(*_run(impl, build, [r, k, v, logw, u, s0], ct, cfg),
           tol=RWKV6_TOL)


# -- DFP groups and the pooling ---------------------------------------------

def _fused(ir, ops, shape, side_shapes):
    """A FUSED node of the chain ``ops`` (each taking the previous value
    and, for a binary op, the next side input) over an input of
    ``shape``."""
    x = ir.input_node(shape)
    sides = [ir.input_node(s) for s in side_shapes]
    body, cur, it = [], x, iter(sides)
    for op, attrs in ops:
        kind = ir.OpKind(op)
        ins = [cur] + ([next(it)] if op in ("add", "mul", "bias_add",
                                            "sub") else [])
        cur = ir.Node(kind, ins, ir.TensorSpec(shape), attrs=dict(attrs))
        body.append(cur)
    return ir.Node(ir.OpKind.FUSED, [x] + sides, ir.TensorSpec(shape),
                   attrs={"length": len(body)},
                   name="fused[" + "+".join(o for o, _ in ops) + "]",
                   body=body)


FUSED_CASES = [
    pytest.param([("bias_add", {"axis": -1}), ("gelu", {})], [(32,)],
                 id="bias_add+gelu"),
    pytest.param([("sigmoid", {}), ("mul", {}), ("exp", {})], [(32,)],
                 id="sigmoid+mul+exp"),
    pytest.param([("layernorm", {"eps": 1e-5}), ("silu", {}), ("add", {})],
                 [(32,), (32,), (2, 6, 32)], id="layernorm+silu+add"),
]


@pytest.mark.parametrize("ops,sides", FUSED_CASES)
def test_fused_bwd_equals_jax(ops, sides):
    """``recompute.fused_bwd`` (autograd of the composed chain) on three
    programs, a norm's gain and bias among the side inputs."""
    rng = _rng(7)
    shape = (2, 6, 32)
    if ops[0][0] == "layernorm":      # LN(x, g, b), then the residual
        def build(ir):
            x = ir.input_node(shape)
            g, b_, res = (ir.input_node(s) for s in sides)
            ln = ir.Node(ir.OpKind.LAYERNORM, [x, g, b_],
                         ir.TensorSpec(shape), attrs={"eps": 1e-5})
            act = ir.Node(ir.OpKind.SILU, [ln], ir.TensorSpec(shape))
            out = ir.Node(ir.OpKind.ADD, [act, res], ir.TensorSpec(shape))
            return ir.Node(ir.OpKind.FUSED, [x, g, b_, res],
                           ir.TensorSpec(shape), attrs={"length": 3},
                           name="fused[layernorm+silu+add]",
                           body=[ln, act, out])
    else:
        def build(ir):
            return _fused(ir, ops, shape, sides)
    arrays = [rng.standard_normal(shape).astype(np.float32)] + [
        rng.standard_normal(s).astype(np.float32) for s in sides]
    ct = rng.standard_normal(shape).astype(np.float32)
    _close(*_run("recompute.fused_bwd", build, arrays, ct))


@pytest.mark.parametrize("kernel", [3, 2, (2, 3)])
def test_avgpool_bwd_equals_jax(kernel):
    rng = _rng(8)
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    x = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    out = (2, 3, 9 - kh + 1, 11 - kw + 1)
    ct = rng.standard_normal(out).astype(np.float32)

    def build(ir):
        return ir.Node(ir.OpKind.AVGPOOL, [ir.input_node(x.shape)],
                       ir.TensorSpec(out),
                       attrs={"kernel": kernel, "stride": 1})
    _close(*_run("conv.avgpool_bwd", build, [x], ct))


# -- the executor's per-node Function ---------------------------------------

def test_node_function_checks_the_cotangent_count():
    """A backward impl that returns the wrong number of cotangents
    raises, naming itself."""
    node = tir.Node(tir.OpKind.MATMUL, [tir.input_node((3, 4)),
                                        tir.param_node((4, 5))],
                    tir.TensorSpec((3, 5)))
    bk = get_backend("torch_ref")
    fwd = registry.get_impl("ref.matmul")
    bad = registry.Impl("bad.matmul_bwd", tir.OpKind.MATMUL,
                        lambda n, res, ct, b: (ct,), registry.TIER_SHARED)
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 5, requires_grad=True)
    y = executor._NodeFunction.apply(node, fwd, bad, bk, x, w)
    with pytest.raises(ValueError, match="bad.matmul_bwd returned 1"):
        y.sum().backward()


def test_node_function_fills_and_casts_cotangents():
    """A None cotangent of a float input becomes zeros, an integer input
    gets none, and a cotangent is cast to its input's dtype."""
    node = tir.Node(tir.OpKind.MATMUL, [tir.input_node((3, 4)),
                                        tir.param_node((4, 5))],
                    tir.TensorSpec((3, 5)))
    bk = get_backend("torch_ref")
    fwd = registry.get_impl("ref.matmul")
    gi = registry.Impl(
        "half.matmul_bwd", tir.OpKind.MATMUL,
        lambda n, res, ct, b: ((ct @ res[0][1].T).double(), None),
        registry.TIER_SHARED)
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 5, requires_grad=True)
    executor._NodeFunction.apply(node, fwd, gi, bk, x, w).sum().backward()
    assert x.grad.dtype == torch.float32
    torch.testing.assert_close(x.grad, torch.ones(3, 5) @ w.detach().T)
    assert torch.equal(w.grad, torch.zeros(4, 5))

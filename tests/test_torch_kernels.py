"""The port's kernel families against the JAX package, on the CPU.

Each plain version (``repro_torch/kernels/*/ref.py``) is held to the JAX
``ref.py`` and to the JAX Pallas kernel run with ``interpret=True``, on the
same numpy-seeded inputs, at the f32 tolerance of README's conformance
table (1e-5).  The DFP program the port encodes must equal the JAX one
(``Program.key()``).  The CUDA and Triton kernels themselves run only on
the card: the ``gpu``-marked tests at the end hold them to the plain
versions there and skip here.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro.core import passes as jpasses
from repro.kernels.decode_attention.kernel import decode_attention_call
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.dfp_fused.ops import dfp_fused as j_dfp_fused
from repro.kernels.dfp_fused.program import encode_program as j_encode
from repro.kernels.flash_attention.kernel import flash_attention_call
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fref
from repro.kernels.matmul.kernel import matmul_call
from repro.kernels.matmul.ref import matmul_ref as j_mref
from repro_torch.core import autotune as TAT
from repro_torch.core import ir as tir
from repro_torch.core import passes as tpasses
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.dfp_fused import ops as fops
from repro_torch.kernels.dfp_fused.kernel import (block_shape,
                                                  dfp_fused_triton,
                                                  generate_source)
from repro_torch.kernels.dfp_fused.program import encode_program
from repro_torch.kernels.dfp_fused.ref import dfp_fused_ref
from repro_torch.kernels.flash_attention import ops as aops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.matmul import ops as mops
from repro_torch.kernels.matmul import kernel as mkernel
from repro_torch.kernels.matmul.kernel import matmul_cuda, plan
from repro_torch.kernels.matmul.ref import matmul_ref

TOL = dict(rtol=1e-5, atol=1e-5)        # README: f32 row of the table


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    """Pin an empty port autotune cache: a developer's SOL_AUTOTUNE_CACHE
    must not flip elections inside these tests."""
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (4, 96, 40), (37, 130, 70),
                                   (128, 256, 128)])
def test_matmul_plain_matches_jax(m, k, n):
    rng = np.random.default_rng(m * 1000 + n)
    x, w = _rand(rng, m, k), _rand(rng, k, n) / np.float32(np.sqrt(k))
    got = matmul_ref(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_mref(jnp.asarray(x),
                                                      jnp.asarray(w))),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(matmul_call(
        jnp.asarray(x), jnp.asarray(w), interpret=True)), **TOL)


def test_matmul_ops_folds_leading_dims_and_reads_transposed_weight():
    rng = np.random.default_rng(3)
    x, w_oi = _rand(rng, 2, 5, 48), _rand(rng, 24, 48)   # (out, in) weight
    got = mops.matmul(_t(x), _t(w_oi).T)                 # a view, no copy
    np.testing.assert_allclose(got.numpy(), x @ w_oi.T, **TOL)


def _plan_of(m, k, n, oi, x_off=0, w_off=0, pad=0, itemsize=4):
    """The plan of x (M, K) @ w (K, N) laid out as the port lays them out:
    x row-major with row stride K + pad, w (K, N) row-major or, with
    ``oi``, an (N, K) weight's transposed view, each at a byte offset, in
    elements of ``itemsize`` bytes."""
    ldb_k, ldb_n = (1, k + pad) if oi else (n + pad, 1)
    return plan(m, n, k, k + pad, ldb_k, ldb_n, 256 + x_off, 512 + w_off,
                itemsize=itemsize)


# (M, K, N, (out,in) weight, x / w byte offset, row padding) → the fields
# of the plan that must hold
@pytest.mark.parametrize("m,k,n,oi,x_off,w_off,pad,want", [
    # the path at M or N of 1, 4, 16 and 17
    (1, 1536, 1536, True, 0, 0, 0, dict(kernel="skinny", small="x", rows=1)),
    (4, 1536, 151936, True, 0, 0, 0,
     dict(kernel="skinny", small="x", rows=4, big_kmajor=True, splits=1)),
    (16, 1536, 6144, False, 0, 0, 0,
     dict(kernel="skinny", small="x", rows=16, big_kmajor=False)),
    (17, 1536, 6144, False, 0, 0, 0, dict(kernel="tensor_core")),
    (2048, 2048, 1, False, 0, 0, 0, dict(kernel="skinny", small="w", rows=1)),
    (2048, 2048, 4, False, 0, 0, 0,
     dict(kernel="skinny", small="w", rows=4, big_kmajor=True, splits=1)),
    (2048, 2048, 16, True, 0, 0, 0, dict(kernel="skinny", small="w",
                                         rows=16)),
    (2048, 2048, 17, True, 0, 0, 0, dict(kernel="tensor_core")),
    (2048, 4, 2048, False, 0, 0, 0,                  # LoRA B: K 4
     dict(kernel="tensor_core", splits=1, k_chunk=32)),
    # split counts: few output tiles or columns split K, many do not
    (256, 1536, 1536, False, 0, 0, 0,
     dict(kernel="tensor_core", splits=5, k_chunk=320, grid=(24, 5))),
    (256, 1536, 6144, True, 0, 0, 0,
     dict(kernel="tensor_core", splits=1, b_kmajor=True, grid=(96, 1))),
    (4, 1536, 1536, False, 0, 0, 0, dict(kernel="skinny", splits=22)),
    (4, 6144, 1536, True, 0, 0, 0,                   # K 2048 a split at most
     dict(kernel="skinny", splits=3, k_chunk=2048)),
    (16, 6144, 1536, True, 0, 0, 0, dict(splits=12, k_chunk=512)),
    (1, 64, 100, False, 0, 0, 0, dict(splits=1)),    # tiny K
    # no split at the recurrent stacks' 2048-row shapes
    (2048, 2048, 2048, False, 0, 0, 0, dict(kernel="tensor_core", splits=1)),
    (2048, 2048, 6144, True, 0, 0, 0, dict(kernel="tensor_core", splits=1)),
    (2048, 6144, 2048, True, 0, 0, 0, dict(kernel="tensor_core", splits=1)),
    (2048, 4096, 4096, False, 0, 0, 0, dict(kernel="tensor_core", splits=1)),
    (2048, 4096, 12288, True, 0, 0, 0,
     dict(kernel="tensor_core", splits=1, grid=(1536, 1))),
    (2048, 12288, 4096, True, 0, 0, 0, dict(kernel="tensor_core", splits=1)),
    # copy width: 16-byte copies only from aligned bases and row strides
    (256, 512, 384, False, 0, 0, 0, dict(kernel="tensor_core", vec=4)),
    (37, 130, 70, True, 0, 0, 0, dict(kernel="tensor_core", vec=1)),
    (256, 512, 384, False, 4, 0, 0, dict(kernel="tensor_core", vec=1)),
    (256, 512, 384, True, 0, 4, 0, dict(kernel="tensor_core", vec=1)),
    (256, 512, 384, False, 0, 0, 1, dict(kernel="tensor_core", vec=1)),
    (256, 512, 384, False, 16, 32, 4, dict(kernel="tensor_core", vec=4)),
    (4, 512, 700, True, 0, 0, 0, dict(kernel="skinny", vec=4)),
    (4, 512, 700, True, 0, 4, 0, dict(kernel="skinny", vec=1)),
    (4, 512, 700, True, 4, 0, 0, dict(kernel="skinny", vec=4)),  # x small
    (700, 512, 4, False, 4, 0, 0, dict(kernel="skinny", vec=1)),  # x big
])
def test_matmul_split_k_policy(m, k, n, oi, x_off, w_off, pad, want):
    p = _plan_of(m, k, n, oi, x_off, w_off, pad)
    assert {f: getattr(p, f) for f in want} == want, p


@pytest.mark.parametrize("m,k,n,oi", [
    (1, 1, 1, False), (4, 1536, 151936, True), (3, 100000, 5, True),
    (16, 12288, 7, False), (17, 12288, 3000, True), (300, 1000, 260, False),
    (64, 12288, 64, False), (2048, 4, 2048, True), (5000, 33, 9, True),
])
def test_matmul_plan_covers_k_within_the_kernels_limits(m, k, n, oi):
    """Whatever the shapes, the splits cover K exactly once, each chunk is
    a whole number of the kernel's steps, the skinny kernel's small
    operand fits its shared memory and the tensor-core grid is its
    tiles."""
    p = _plan_of(m, k, n, oi)
    assert (p.splits - 1) * p.k_chunk < max(k, 1) <= p.splits * p.k_chunk
    assert p.grid[1] == p.splits
    if p.kernel == "tensor_core":
        bm, bn, bk = mkernel.TC_TILE
        assert p.k_chunk % bk == 0
        assert p.grid[0] == -(-m // bm) * -(-n // bn)
    else:
        assert p.k_chunk % 4 == 0 and p.rows in mkernel.SKINNY_ROWS
        assert p.rows * p.k_chunk <= mkernel.SKINNY_S_FLOATS
        assert p.rows >= (m if p.small == "x" else n)


# bf16 and f16 (2-byte values): the copy width in values, 8 (16 bytes) from
# 16-byte-aligned bases and row strides, 2 (4 bytes) from 4-byte-aligned
# ones, else 1 (2 bytes); the rest of the plan is the f32 plan's
@pytest.mark.parametrize("m,k,n,oi,x_off,w_off,pad,want", [
    (256, 512, 384, False, 0, 0, 0, dict(kernel="tensor_core", vec=8)),
    (256, 512, 384, True, 0, 0, 0, dict(kernel="tensor_core", vec=8)),
    (37, 130, 70, True, 0, 0, 0, dict(kernel="tensor_core", vec=2)),
    (37, 131, 70, True, 0, 0, 0, dict(kernel="tensor_core", vec=1)),  # odd K
    (256, 512, 385, False, 0, 0, 0, dict(kernel="tensor_core", vec=1)),  # odd N
    (256, 512, 384, False, 2, 0, 0, dict(kernel="tensor_core", vec=1)),
    (256, 512, 384, False, 4, 0, 0, dict(kernel="tensor_core", vec=2)),
    (256, 512, 384, True, 0, 8, 0, dict(kernel="tensor_core", vec=2)),
    (256, 512, 384, True, 0, 2, 0, dict(kernel="tensor_core", vec=1)),
    (256, 512, 384, False, 16, 32, 8, dict(kernel="tensor_core", vec=8)),
    (256, 512, 384, False, 0, 0, 2, dict(kernel="tensor_core", vec=2)),
    (4, 512, 700, True, 0, 0, 0, dict(kernel="skinny", vec=8)),
    (4, 512, 700, True, 0, 2, 0, dict(kernel="skinny", vec=1)),
    (4, 512, 700, True, 0, 4, 0, dict(kernel="skinny", vec=2)),
    (4, 512, 700, True, 2, 0, 0, dict(kernel="skinny", vec=8)),  # x small
    (4, 512, 701, False, 0, 0, 0, dict(kernel="skinny", vec=1)),  # odd N
    (700, 512, 4, False, 2, 0, 0, dict(kernel="skinny", vec=1)),  # x big
    (700, 514, 4, False, 0, 0, 0, dict(kernel="skinny", vec=2)),
    (2048, 1536, 1536, True, 0, 0, 0,
     dict(kernel="tensor_core", vec=8, splits=1, b_kmajor=True)),
    # a lane streams 8 columns of an N-contiguous w, not 4: 6 column
    # groups where f32 has 12, so K splits 24 ways (f32: 22)
    (4, 1536, 1536, False, 0, 0, 0, dict(kernel="skinny", vec=8, splits=24)),
])
def test_matmul_half_precision_copy_width(m, k, n, oi, x_off, w_off, pad,
                                          want):
    p = _plan_of(m, k, n, oi, x_off, w_off, pad, itemsize=2)
    assert {f: getattr(p, f) for f in want} == want, p


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("m,k,n,oi", [
    (1, 1, 1, False), (4, 1536, 151936, True), (3, 100000, 5, True),
    (16, 12287, 7, False), (17, 12288, 3000, True), (301, 1001, 261, False),
    (2048, 4, 2048, True), (5000, 33, 9, True),
])
def test_matmul_plan_chunks_suit_each_element_size(m, k, n, oi, itemsize):
    """Each K chunk starts a multiple of 8 values in, so a 16-byte copy of
    bf16 or f16 stays aligned across splits, and the splits cover K once;
    a copy moves 16 or 4 bytes or one value, and a half-precision plan
    picks the f32 plan's kernel and operand roles."""
    p = _plan_of(m, k, n, oi, itemsize=itemsize)
    assert p.k_chunk % 8 == 0
    if p.kernel == "tensor_core":     # whole slabs: 32 f32 or 64 16-bit k
        assert p.k_chunk % (32 if itemsize == 4 else 64) == 0
    assert (p.splits - 1) * p.k_chunk < max(k, 1) <= p.splits * p.k_chunk
    assert p.vec * itemsize in (16, 4) or p.vec == 1
    f32 = _plan_of(m, k, n, oi)
    roles = ("kernel", "b_kmajor", "small", "rows", "big_kmajor")
    assert [getattr(p, f) for f in roles] == [getattr(f32, f) for f in roles]


def test_matmul_plan_refuses_a_weight_with_no_unit_stride():
    with pytest.raises(ValueError):
        plan(64, 64, 64, 64, 2, 128)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,kv,causal,window,cap", [
    (16, 4, 2, True, 0, 0.0),
    (37, 4, 1, True, 0, 0.0),       # ragged S, MQA
    (40, 6, 2, True, 8, 0.0),       # window
    (24, 4, 4, True, 0, 5.0),       # softcap, MHA
    (33, 4, 2, False, 0, 0.0),      # non-causal
])
def test_flash_plain_matches_jax(s, h, kv, causal, window, cap):
    rng = np.random.default_rng(s * 10 + h)
    b, hd = 2, 16
    q, k, v = _rand(rng, b, h, s, hd), _rand(rng, b, kv, s, hd), \
        _rand(rng, b, kv, s, hd)
    attrs = dict(causal=causal, window=window, cap=cap)
    got = flash_attention_ref(_t(q), _t(k), _t(v), **attrs).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(got, np.asarray(j_fref(jq, jk, jv, **attrs)),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(flash_attention_call(
        jq, jk, jv, bq=16, bk=16, interpret=True, **attrs)), **TOL)
    # the model-layout entry point on CPU tensors takes the plain version
    bshd = aops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                                _t(v).transpose(1, 2), **attrs)
    np.testing.assert_allclose(bshd.transpose(1, 2).numpy(), got, **TOL)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (0, 4.0)])
def test_decode_plain_matches_jax(window, cap):
    rng = np.random.default_rng(11 + window)
    b, h, kv, s, hd = 4, 4, 2, 24, 16
    q = _rand(rng, b, h, hd)
    k, v = _rand(rng, b, kv, s, hd), _rand(rng, b, kv, s, hd)
    kn, vn = _rand(rng, b, kv, hd), _rand(rng, b, kv, hd)
    lens = np.array([0, 5, 17, 24], np.int32)       # 0 = batch padding
    attrs = dict(window=window, cap=cap)
    got = decode_attention_ref(_t(q), _t(k), _t(v), _t(kn), _t(vn),
                               _t(lens), **attrs).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, kn, vn, lens)]
    np.testing.assert_allclose(got, np.asarray(j_dref(*j, **attrs)), **TOL)
    np.testing.assert_allclose(got, np.asarray(decode_attention_call(
        *j, bk=8, interpret=True, **attrs)), **TOL)
    # lens 0 attends only the step's own pair: the output is v_new exactly
    np.testing.assert_allclose(got[0], np.repeat(vn[0], h // kv, axis=0),
                               rtol=0, atol=1e-6)


def test_decode_equals_causal_row_of_flash():
    """Decoding position L against a cache of L rows is row L of causal
    attention over L + 1 positions."""
    rng = np.random.default_rng(5)
    h, kv, s, hd = 4, 2, 12, 16
    q, k, v = _rand(rng, 1, s, h, hd), _rand(rng, 1, s, kv, hd), \
        _rand(rng, 1, s, kv, hd)
    full = aops.flash_attention(_t(q), _t(k), _t(v)).numpy()
    last = s - 1
    cache_k = np.zeros((1, 16, kv, hd), np.float32)
    cache_v = np.zeros_like(cache_k)
    cache_k[0, :last], cache_v[0, :last] = k[0, :last], v[0, :last]
    out = dops.decode_attention(
        _t(q[:, last:last + 1]), _t(cache_k), _t(cache_v),
        _t(k[:, last:last + 1]), _t(v[:, last:last + 1]),
        torch.tensor([last], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(out[0, 0], full[0, last], **TOL)


# ---------------------------------------------------------------------------
# DFP programs
# ---------------------------------------------------------------------------

def _chain(pkg_ir, rows: int, d: int, kind: str):
    """The same fusion-group graph built with either package's IR: x → a
    chain → output, with a bias vector, a residual and norm params."""
    Node, Op, Spec = pkg_ir.Node, pkg_ir.OpKind, pkg_ir.TensorSpec
    x = pkg_ir.input_node((rows, d), name="x")
    res = pkg_ir.input_node((rows, d), name="res")
    b = pkg_ir.param_node((d,), name="b")
    g = pkg_ir.param_node((d,), name="g")
    sp = Spec((rows, d))
    if kind == "bias_gelu":
        n = Node(Op.GELU, [Node(Op.BIAS_ADD, [x, b], sp, attrs={"axis": -1})],
                 sp)
    elif kind == "bias_add":
        n = Node(Op.ADD, [Node(Op.BIAS_ADD, [x, b], sp, attrs={"axis": -1}),
                          res], sp)
    elif kind == "layernorm":
        ln = Node(Op.LAYERNORM, [x, g, b], sp, attrs={"eps": 1e-5})
        n = Node(Op.ADD, [Node(Op.GELU, [ln], sp), res], sp)
    elif kind == "mixed":
        t = Node(Op.SILU, [Node(Op.SCALE, [x], sp, attrs={"value": 0.5})], sp)
        t = Node(Op.SOFTCAP, [Node(Op.MUL, [t, res], sp)], sp,
                 attrs={"cap": 3.0})
        t = Node(Op.RMSNORM, [Node(Op.SUB, [t, x], sp), g], sp,
                 attrs={"eps": 1e-6})
        t = Node(Op.SIGMOID, [Node(Op.EXP, [Node(Op.TANH, [t], sp)], sp)],
                 sp)
        n = Node(Op.DIV, [t, res], sp)
    return pkg_ir.Graph([x, res], [n], {"b": b, "g": g})


def _fused_node(graph, pkg_passes, pkg_ir):
    graph = pkg_passes.form_fusion_groups(pkg_passes.assign_modules(graph))
    (node,) = graph.nodes_of(pkg_ir.OpKind.FUSED)
    return node


@pytest.mark.parametrize("kind", ["bias_gelu", "bias_add", "layernorm",
                                  "mixed"])
def test_dfp_program_and_plain_run_match_jax(kind):
    rows, d = 12, 40
    rng = np.random.default_rng(len(kind))
    vals = {"x": _rand(rng, rows, d), "res": _rand(rng, rows, d) + 2.0,
            "b": _rand(rng, d), "g": _rand(rng, d)}
    jn = _fused_node(_chain(jir, rows, d, kind), jpasses, jir)
    tn = _fused_node(_chain(tir, rows, d, kind), tpasses, tir)
    assert jn.name == tn.name
    jprog, jops = j_encode(jn, {id(i): jnp.asarray(vals[i.name])
                                for i in jn.inputs})
    tprog, tops = encode_program(tn, {id(i): _t(vals[i.name])
                                      for i in tn.inputs})
    assert tprog.key() == jprog.key()
    want = np.asarray(j_dfp_fused(jprog, jops, interpret=True))
    got = fops.dfp_fused(tprog, tops)            # CPU → plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        dfp_fused_ref(tprog, tops, (rows, d), torch.float32).numpy(), want,
        **TOL)
    # the generated Triton source parses and names every operand
    src = generate_source(tprog, "dfp_test")
    compile(src, "<dfp>", "exec")
    assert all(f"p{i}" in src for i in range(len(tprog.operand_kinds)))


def test_dfp_block_shape_keeps_d_untiled():
    assert block_shape(512, 6144) == (1, 8192, 8)
    assert block_shape(512, 1536) == (2, 2048, 8)
    assert block_shape(4, 64) == (4, 64, 4)


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version; kernels refuse CPU tensors
# ---------------------------------------------------------------------------

def test_kernel_wrappers_raise_on_cpu_tensors():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        matmul_cuda(x, torch.zeros(8, 4))
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        decode_attention_cuda(torch.zeros(1, 1, 2, 16), q, q,
                              torch.zeros(1, 1, 2, 16),
                              torch.zeros(1, 1, 2, 16),
                              torch.zeros(1, dtype=torch.int32))
    node = _fused_node(_chain(tir, 4, 8, "bias_gelu"), tpasses, tir)
    prog, _ = encode_program(node, {id(i): i.spec for i in node.inputs})
    with pytest.raises(ValueError):
        dfp_fused_triton(prog, [torch.zeros(4, 8), torch.zeros(8)], (4, 8),
                         torch.float32)

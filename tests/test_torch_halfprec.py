"""The port in bfloat16 and float16 against the JAX package, on the CPU.

Per kernel family, the port's plain version (the CPU path of each
``repro_torch/kernels/*/ops.py`` entry) against the JAX Pallas kernel run
with ``interpret=True`` on the same inputs: numpy-seeded f32 arrays, each
rounded to the storage type by both frameworks (round to nearest even, so
both see the same values).  Then the slices: a 2-layer transformer LM, a
2-layer Griffin and RWKV6 stack and the Listing-3 CNN with their weights
rounded to bf16 (JAX ``load_state_dict`` of bf16 arrays; the port's
``load_numpy_state_dict`` and ``.to(torch.bfloat16)``), the port's
``optimize(..., backend="h100", device="cpu")`` against JAX's
``optimize(..., backend="pallas_interpret")``.

Tolerance: the bf16 row of README's conformance table, rtol 3e-2 and atol
3e-2, and rtol 5e-2 and atol 5e-2 for the RWKV6 scan; the float16 cases
are held to the same row.  A kernel's output is held to it element by
element.  A slice's output is held to it relative to the output's scale
(max |Δ| ≤ rtol · max |JAX output|), as ``chip_smoke.py`` holds the bf16
paths on the card: through two bf16 layers JAX's own ``pallas_interpret``
and ``xla`` outputs already differ by 0.66e-2 (transformer), 1.34e-2
(Griffin) and 1.10e-2 (RWKV6) of their scale on these weights, so an
element's own row is below the slices' bf16 floor.  Both packages
accumulate in f32 and round once per kernel; the DFP kernel rounds once
per instruction in both, where JAX also rounds each primitive inside an
instruction (gelu, silu, softcap; ROADMAP section 3).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro.core import passes as jpasses
from repro.frontends.optimize import optimize as j_optimize
from repro.kernels.avgpool.ops import avgpool as j_avgpool
from repro.kernels.decode_attention.kernel import decode_attention_call
from repro.kernels.dfp_fused.ops import dfp_fused as j_dfp_fused
from repro.kernels.dfp_fused.program import encode_program as j_encode
from repro.kernels.flash_attention.kernel import flash_attention_call
from repro.kernels.matmul.kernel import matmul_call
from repro.kernels.rglru_scan.ops import rglru_scan as j_rglru
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv6
from repro_torch.core import autotune as TAT
from repro_torch.core import ir as tir
from repro_torch.core import passes as tpasses
from repro_torch.frontends.optimize import optimize
from repro_torch.kernels.avgpool import ops as apops
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.dfp_fused import ops as fops
from repro_torch.kernels.dfp_fused.program import encode_program
from repro_torch.kernels.flash_attention import ops as aops
from repro_torch.kernels.matmul import ops as mops
from repro_torch.kernels.rglru_scan import ops as rgops
from repro_torch.kernels.rwkv6_scan import ops as rwops

import test_torch_cnn as cnn_tests
import test_torch_kernels as kernel_tests
import test_torch_pipeline as pipeline_tests
import test_torch_recurrent as recurrent_tests

# README's conformance table, bf16 row: (rtol, atol)
ROW = (3e-2, 3e-2)
RWKV6_ROW = (5e-2, 5e-2)
DTYPES = ("bfloat16", "float16")
TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}
JAX = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(dtype, *arrays):
    """Each f32 array rounded to ``dtype`` by torch and by JAX: (torch
    tensors, JAX arrays)."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[dtype])
          for a in arrays]
    js = [jnp.asarray(a).astype(JAX[dtype]) for a in arrays]
    return ts, js


def _close(got, want, row=ROW, dtype=None):
    """``got`` (torch) against ``want`` (JAX) at the row, in f32, after
    checking both came out in the storage type."""
    if dtype is not None:
        assert got.dtype == TORCH[dtype] and want.dtype == JAX[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=row[0], atol=row[1])


# ---------------------------------------------------------------------------
# each kernel family: the plain version against the interpret-mode kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n,oi", [(4, 96, 40, False), (37, 130, 70, True),
                                      (64, 256, 128, False)])
def test_matmul_plain_matches_jax(m, k, n, oi, dtype):
    rng = np.random.default_rng(m * 1000 + n)
    x, w = _rand(rng, m, k), _rand(rng, k, n) / np.float32(np.sqrt(k))
    (tx, tw), (jx, jw) = _both(dtype, x, w)
    if oi:      # an (N, K) weight read through its transposed view
        tw = tw.T.contiguous().T
    _close(mops.matmul(tx, tw), matmul_call(jx, jw, interpret=True),
           dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,h,kv,causal,window,cap", [
    (16, 4, 2, True, 0, 0.0), (37, 4, 1, True, 0, 0.0),
    (40, 6, 2, True, 8, 0.0), (24, 4, 4, True, 0, 5.0)])
def test_flash_plain_matches_jax(s, h, kv, causal, window, cap, dtype):
    rng = np.random.default_rng(s * 10 + h)
    b, hd = 2, 16
    q, k, v = _rand(rng, b, h, s, hd), _rand(rng, b, kv, s, hd), \
        _rand(rng, b, kv, s, hd)
    attrs = dict(causal=causal, window=window, cap=cap)
    (tq, tk, tv), (jq, jk, jv) = _both(dtype, q, k, v)
    got = aops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), **attrs).transpose(1, 2)
    _close(got, flash_attention_call(jq, jk, jv, bq=16, bk=16,
                                     interpret=True, **attrs), dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (0, 4.0)])
def test_decode_plain_matches_jax(window, cap, dtype):
    rng = np.random.default_rng(11 + window)
    b, h, kv, s, hd = 4, 4, 2, 24, 16
    q = _rand(rng, b, h, hd)
    k, v = _rand(rng, b, kv, s, hd), _rand(rng, b, kv, s, hd)
    kn, vn = _rand(rng, b, kv, hd), _rand(rng, b, kv, hd)
    lens = np.array([0, 5, 17, 24], np.int32)
    (tq, tk, tv, tkn, tvn), j = _both(dtype, q, k, v, kn, vn)
    got = dops.decode_attention(
        tq[:, None], tk.transpose(1, 2), tv.transpose(1, 2), tkn[:, None],
        tvn[:, None], torch.from_numpy(lens), window=window, cap=cap)[:, 0]
    want = decode_attention_call(*j, jnp.asarray(lens), bk=8, window=window,
                                 cap=cap, interpret=True)
    _close(got, want, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["bias_gelu", "bias_add", "layernorm",
                                  "mixed"])
def test_dfp_plain_matches_jax(kind, dtype):
    """The same encoded program, run by the port's plain version (each
    instruction rounded once) and by the JAX kernel (each primitive
    rounded)."""
    rows, d = 12, 40
    rng = np.random.default_rng(len(kind))
    vals = {"x": _rand(rng, rows, d), "res": _rand(rng, rows, d) + 2.0,
            "b": _rand(rng, d), "g": _rand(rng, d)}
    names = sorted(vals)
    ts, js = _both(dtype, *(vals[k] for k in names))
    tv, jv = dict(zip(names, ts)), dict(zip(names, js))
    jn = kernel_tests._fused_node(kernel_tests._chain(jir, rows, d, kind),
                                  jpasses, jir)
    tn = kernel_tests._fused_node(kernel_tests._chain(tir, rows, d, kind),
                                  tpasses, tir)
    jprog, jops = j_encode(jn, {id(i): jv[i.name] for i in jn.inputs})
    tprog, tops = encode_program(tn, {id(i): tv[i.name] for i in tn.inputs})
    assert tprog.key() == jprog.key()
    _close(fops.dfp_fused(tprog, tops),
           j_dfp_fused(jprog, jops, interpret=True), dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,d,bd", [(2, 16, 24, 8), (1, 32, 64, 16)])
def test_rglru_plain_matches_jax(b, t, d, bd, dtype):
    rng = np.random.default_rng(b * 100 + t)
    ins = recurrent_tests._rglru_inputs(rng, b, t, d)
    ts, js = _both(dtype, *ins)
    h, h_last = rgops.rglru_scan(*ts)
    want_h, want_last = j_rglru(*js, bd=bd, interpret=True)
    _close(h, want_h, dtype=dtype)
    _close(h_last, want_last, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,h,hd,bt", [(2, 16, 2, 8, 4), (1, 32, 4, 16, 8)])
def test_rwkv6_plain_matches_jax(b, t, h, hd, bt, dtype):
    """o in the inputs' dtype; the final state f32, as the JAX kernel's."""
    rng = np.random.default_rng(t * 10 + hd)
    ins = recurrent_tests._rwkv6_inputs(rng, b, t, h, hd)
    ts, js = _both(dtype, *ins)
    o, s_last = rwops.rwkv6_scan(*ts)
    want_o, want_s = j_rwkv6(*js, bt=bt, interpret=True)
    _close(o, want_o, RWKV6_ROW, dtype=dtype)
    assert s_last.dtype == torch.float32 and want_s.dtype == jnp.float32
    _close(s_last, want_s, RWKV6_ROW)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,kh,kw", [((2, 4, 9, 11), 3, 3),
                                         ((1, 3, 17, 45), 2, 3)])
def test_avgpool_plain_matches_jax(shape, kh, kw, dtype):
    rng = np.random.default_rng(sum(shape))
    (tx,), (jx,) = _both(dtype, _rand(rng, *shape))
    _close(apops.avgpool(tx, kh, kw), j_avgpool(jx, kh, kw, interpret=True),
           dtype=dtype)


# ---------------------------------------------------------------------------
# the slices in bf16: h100 on the CPU against JAX's pallas_interpret
# ---------------------------------------------------------------------------

def _to_bf16(jm, tm):
    """Both packages' modules with every parameter rounded to bf16."""
    jm.load_state_dict({k: jnp.asarray(v).astype(jnp.bfloat16)
                        for k, v in jm.named_parameters().items()})
    return jm, tm.to(torch.bfloat16)


def _slice_close(tm, jm, shape, rng, rtol=ROW[0]):
    """optimize() of both packages in bf16 on one bf16 input, the port's
    output within ``rtol`` of the JAX output's scale: the port's elected
    h100 graph runs every kernel's plain version on the CPU."""
    (tx,), (jx,) = _both("bfloat16", _rand(rng, *shape))
    got = optimize(tm, shape, backend="h100", device="cpu",
                   dtype="bfloat16")(tx)
    want = j_optimize(jm, shape, backend="pallas_interpret",
                      dtype="bfloat16")(jx)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def test_transformer_lm_in_bf16_matches_jax():
    jm, tm = _to_bf16(*pipeline_tests.models())
    _slice_close(tm, jm, (2, 8, pipeline_tests.D), np.random.default_rng(5))


@pytest.mark.parametrize("name", ["griffin", "rwkv6"])
def test_recurrent_stack_in_bf16_matches_jax(name):
    jm, tm, shape = recurrent_tests.models(name, 2)
    jm, tm = _to_bf16(jm, tm)
    _slice_close(tm, jm, shape, np.random.default_rng(6),
                 (RWKV6_ROW if name == "rwkv6" else ROW)[0])


def test_rwkv6_bf16_row_still_fails_a_wrong_stack():
    """At README's RWKV6 bf16 row, the bf16 stack of the test above with
    its bonus ``u`` zeroed on the port's side fails."""
    jm, tm, shape = recurrent_tests.models("rwkv6", 2)
    jm, tm = _to_bf16(jm, tm)
    with torch.no_grad():
        zeroed = [p.zero_() for k, p in tm.named_parameters()
                  if k.endswith(".u")]
    assert len(zeroed) == 2
    with pytest.raises(AssertionError):
        _slice_close(tm, jm, shape, np.random.default_rng(6), RWKV6_ROW[0])


def test_listing3_cnn_in_bf16_matches_jax():
    """At 40×40: at 32×32 the first conv's C equals W, where JAX's
    ``pallas_interpret`` broadcasts the conv bias over W (the reference
    caveat of ROADMAP section 3) and reads 4.6e-2 of its scale off its own
    ``xla`` output in bf16."""
    jm, tm = _to_bf16(*cnn_tests.models("listing3_cnn"))
    _slice_close(tm, jm, (2, 3, 40, 40), np.random.default_rng(7))


def test_kernel_entries_take_three_storage_types_and_refuse_the_rest():
    """Each wrapper picks its kernel's entry by the tensors' shared storage
    type, and raises for any other dtype or for mixed ones before a
    pointer reaches a kernel."""
    from repro_torch.kernels import dtypes
    assert [dtypes.suffix("k", torch.zeros(1, dtype=d))
            for d in (torch.float32, torch.bfloat16, torch.float16)] == \
        ["f32", "bf16", "f16"]
    for bad in ((torch.zeros(1, dtype=torch.float64),),
                (torch.zeros(1, dtype=torch.int32),),
                (torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16))):
        with pytest.raises(TypeError):
            dtypes.suffix("k", *bad)

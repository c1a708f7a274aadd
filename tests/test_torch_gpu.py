"""The port's hand-written kernels on the card, each held to its plain
PyTorch version, a small served model, small recurrent stacks and a small
Listing-3 CNN on the card held to the plain path.  Every test here is marked ``gpu`` and skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (the suite's ``conftest.py`` imports the JAX
package, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerance in f32: 1e-4 absolute and relative.  The kernels sum in another order
than the plain versions (tiles, online softmax, split K) on O(1) values,
which leaves ~1e-6 of rounding; 1e-4 keeps a wide margin over that while
any indexing or masking fault shows as an O(1) error.
"""
import functools
import math

import numpy as np
import pytest
import torch
from torch import nn as tnn

from repro_torch.backends import registry
from repro_torch.frontends import nn
from repro_torch.frontends.optimize import optimize
from repro_torch.kernels.avgpool.kernel import avgpool_cuda, avgpool_plan
from repro_torch.kernels.avgpool.ref import avgpool_banded_ref, avgpool_ref
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.kernel import (MAX_GROUP,
                                                         decode_attention_cuda,
                                                         decode_plan)
from repro_torch.kernels.dfp_fused.kernel import dfp_fused_triton
from repro_torch.kernels.dfp_fused.program import Program
from repro_torch.kernels.dfp_fused.ref import dfp_fused_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.matmul.kernel import matmul_cuda
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.launch import serve

TOL = dict(rtol=1e-4, atol=1e-4)
ALL_DTYPES_BY_NAME = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                      "float16": torch.float16}

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, seed, *shape):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(*shape, device=dev, generator=g)


def _weight(dev, seed, k, n, oi):
    """(K, N) weight scaled to O(1) outputs; ``oi`` reads an (N, K) one
    through its transposed view."""
    if oi:
        return (_randn(dev, seed, n, k) * k ** -0.5).T
    return _randn(dev, seed, k, n) * k ** -0.5


@pytest.mark.parametrize("m,k,n,oi", [
    (1, 1536, 256, False),          # decode row, split K
    (4, 1536, 1536, True),          # decode, (out, in) weight read in place
    (37, 130, 70, True),            # ragged edges on every dim
    (256, 512, 384, False),         # prefill tile
    (2048, 2048, 4, False),         # LoRA A: N 4, x streamed
    (2048, 4, 2048, False),         # LoRA B: K 4
    (4, 1536, 5000, True),          # LM-head-like, ragged N
    (300, 1000, 260, False),        # ragged tiles, split K
    (300, 1000, 260, True),
    (16, 6144, 1536, True),         # 16 rows, K split to fit
    (16, 2000, 1100, False),
    (200, 64, 10, True),            # N 10, x streamed
])
def test_matmul_kernel_matches_plain(dev, m, k, n, oi):
    x = _randn(dev, 0, m, k)
    w = _weight(dev, 1, k, n, oi)
    torch.testing.assert_close(matmul_cuda(x, w), matmul_ref(x, w), **TOL)


@pytest.mark.parametrize("oi", [False, True])
@pytest.mark.parametrize("k", [4, 8, 9, 130])
@pytest.mark.parametrize("n", [1, 4, 16, 17])
@pytest.mark.parametrize("m", [1, 4, 16, 17])
def test_matmul_kernel_small_shapes(dev, m, n, k, oi):
    """Both kernels at the skinny threshold (M or N of 16 and 17) with K
    below, at and off a copy's width."""
    x = _randn(dev, 2, m, k)
    w = _weight(dev, 3, k, n, oi)
    torch.testing.assert_close(matmul_cuda(x, w), matmul_ref(x, w), **TOL)


@pytest.mark.parametrize("m,k,n,oi", [
    (300, 256, 260, False), (300, 256, 260, True),      # tensor cores
    (4, 512, 700, False), (4, 512, 700, True),          # skinny, x small
    (700, 512, 4, False),                               # skinny, w small
])
def test_matmul_kernel_reads_views_at_a_4_byte_offset(dev, m, k, n, oi):
    """Operands that start 4 bytes into their storage, with row strides of
    K + 1 floats: the 4-byte copy variant, no copy of either operand."""
    x = _randn(dev, 4, m, k + 1)[:, 1:]
    wide = (_randn(dev, 5, n, k + 1) if oi
            else _randn(dev, 5, k, n + 1)) * k ** -0.5
    w = wide[:, 1:].T if oi else wide[:, 1:]
    assert x.data_ptr() % 16 == 4 and w.data_ptr() % 16 == 4
    torch.testing.assert_close(matmul_cuda(x, w), matmul_ref(x, w), **TOL)


@pytest.mark.parametrize("m,k,n", [(300, 256, 260), (4, 512, 700)])
def test_matmul_kernel_takes_a_weight_with_no_unit_stride(dev, m, k, n):
    """A weight view strided along both K and N (every other column of a
    wider one) still computes, on either kernel."""
    x = _randn(dev, 8, m, k)
    w = (_randn(dev, 9, k, 2 * n) * k ** -0.5)[:, ::2]
    assert w.stride() == (2 * n, 2)
    torch.testing.assert_close(matmul_cuda(x, w), matmul_ref(x, w), **TOL)


def test_matmul_kernel_keeps_f32_accuracy_at_k_12288(dev):
    """K = 12288 (Griffin's MLP down projection): max |error| relative to
    the output's max |value| within 1e-5, as an f32 product.  One TF32
    pass reads ≈ 1e-4 here; the three-pass split keeps ≈ 1e-6."""
    x = _randn(dev, 6, 256, 12288)
    w = _weight(dev, 7, 12288, 1024, True)
    got, want = matmul_cuda(x, w), matmul_ref(x, w)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("s,hd,causal,window,cap", [
    (128, 128, True, 0, 0.0),       # the serving prefill
    (77, 128, True, 16, 0.0),       # ragged S, window
    (64, 128, True, 0, 5.0),        # softcap
    (33, 64, False, 0, 0.0),        # non-causal
    (40, 16, True, 0, 0.0),         # the small serving smoke's head dim
])
def test_flash_kernel_matches_plain(dev, s, hd, causal, window, cap):
    q = _randn(dev, 2, 2, s, 12, hd)
    k, v = _randn(dev, 3, 2, s, 2, hd), _randn(dev, 4, 2, s, 2, hd)
    attrs = dict(causal=causal, window=window, cap=cap)
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **attrs).transpose(1, 2)
    torch.testing.assert_close(flash_attention_cuda(q, k, v, **attrs), want,
                               **TOL)


@pytest.mark.parametrize("hd,window,cap", [(128, 0, 0.0), (128, 24, 0.0),
                                           (128, 0, 4.0), (16, 0, 0.0)])
def test_decode_kernel_matches_plain(dev, hd, window, cap):
    q = _randn(dev, 5, 4, 1, 12, hd)
    kc, vc = _randn(dev, 6, 4, 128, 2, hd), _randn(dev, 7, 4, 128, 2, hd)
    kn, vn = _randn(dev, 8, 4, 1, 2, hd), _randn(dev, 9, 4, 1, 2, hd)
    lens = torch.tensor([0, 1, 64, 128], dtype=torch.int32, device=dev)
    got = decode_attention_cuda(q, kc, vc, kn, vn, lens, window=window,
                                cap=cap)
    torch.testing.assert_close(
        got, dops._ref_model_layout(q, kc, vc, kn, vn, lens, window, cap),
        **TOL)
    # lens 0 (batch padding) attends only the step's own pair
    torch.testing.assert_close(got[0, 0], vn[0, 0].repeat_interleave(6, 0),
                               rtol=0, atol=1e-6)


# every instruction of the DFP program set, in one chain
_ALL_INSTRS = Program((
    ("bias", 0, ("op", 0), 1, None),
    ("gelu", 1, ("reg", 0), None),
    ("silu", 2, ("reg", 1), None),
    ("sigmoid", 3, ("reg", 2), None),
    ("tanh", 4, ("op", 0), None),
    ("exp", 5, ("reg", 4), None),
    ("copy", 6, ("reg", 5), None),
    ("add", 7, ("reg", 3), ("reg", 6), None),
    ("sub", 8, ("reg", 7), ("op", 3), None),
    ("mul", 9, ("reg", 8), ("reg", 4), None),
    ("div", 10, ("reg", 9), ("reg", 5), None),
    ("scale", 11, ("reg", 10), 0.5),
    ("softcap", 12, ("reg", 11), 3.0),
    ("relu", 13, ("reg", 12), None),
    ("rmsnorm", 14, ("reg", 13), 2, 1e-6),
    ("layernorm", 15, ("reg", 14), 2, 1, 1e-5),
), ("full", "vec", "vec", "full"), 15)

_SERVING = {
    "bias_add+gelu": Program((("bias", 0, ("op", 0), 1, None),
                              ("gelu", 1, ("reg", 0), None)),
                             ("full", "vec"), 1),
    "bias_add+add": Program((("bias", 0, ("op", 0), 1, None),
                             ("add", 1, ("reg", 0), ("op", 2), None)),
                            ("full", "vec", "full"), 1),
    "all_instructions": _ALL_INSTRS,
}


@pytest.mark.parametrize("name,rows,d", [
    ("bias_add+gelu", 512, 6144), ("bias_add+add", 512, 1536),
    ("all_instructions", 64, 1536), ("all_instructions", 7, 40),
])
def test_dfp_kernel_matches_plain(dev, name, rows, d):
    prog = _SERVING[name]
    ops = [_randn(dev, 10 + i, *((rows, d) if kind == "full" else (d,)))
           for i, kind in enumerate(prog.operand_kinds)]
    torch.testing.assert_close(
        dfp_fused_triton(prog, ops, (rows, d), torch.float32),
        dfp_fused_ref(prog, ops, (rows, d), torch.float32), **TOL)


def test_served_tokens_on_the_card_match_the_plain_path(dev):
    """A small LM served on the card through the kernels gives the plain
    path's greedy tokens, and every kernel's launch count moves."""
    d, heads, kv, layers, vocab = 64, 4, 2, 2, 128
    g = torch.Generator(dev).manual_seed(0)
    model = tnn.Sequential(
        *[nn.transformer_block(d, heads, kv, device=dev, generator=g)
          for _ in range(layers)],
        nn.Linear(d, vocab, device=dev, generator=g))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n, dtype=np.int32)
               for n in (3, 9, 14, 20)]
    counters = (matmul_cuda, flash_attention_cuda, decode_attention_cuda,
                dfp_fused_triton)
    tokens = {}
    for backend in ("torch_ref", "h100"):
        cfg = serve.ServeConfig(d_model=d, n_heads=heads, n_layers=layers,
                                vocab=vocab, max_seq=32, max_batch=4,
                                slots=4, backend=backend)
        server = serve.SolServer(cfg, model=model)      # device=None: cuda
        before = [c.launches for c in counters]
        reqs = [server.submit(p, 8) for p in prompts]
        summary = server.run()
        server.close()
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert summary["device"].startswith("cuda")
        assert summary["dmas"] == summary["forwards"]
        if backend == "h100":
            assert all(n > 0 for n in launched), launched
        else:
            assert launched == [0, 0, 0, 0]
        tokens[backend] = [r.generated for r in reqs]
    assert tokens["h100"] == tokens["torch_ref"]


@pytest.mark.parametrize("b,t,d", [
    (4, 512, 4096), (3, 1, 24), (2, 37, 200), (1, 300, 4100), (2, 0, 64),
    (2, 129, 130), (1, 1000, 3)])
def test_rglru_kernel_matches_plain(dev, b, t, d):
    """Full width; T 0, 1, ragged over the chunks and over several tiles;
    D not a multiple of a block's channels (and not of 4: one value a
    load)."""
    a = torch.rand(b, t, d, device=dev,
                   generator=torch.Generator(dev).manual_seed(20)) * 0.5 + 0.5
    x, h0 = _randn(dev, 21, b, t, d), _randn(dev, 22, b, d)
    h, last = rglru_scan_cuda(a, x, h0)
    want_h, want_last = rglru_scan_ref(a, x, h0)
    torch.testing.assert_close(h, want_h, **TOL)
    torch.testing.assert_close(last, want_last, **TOL)


@pytest.mark.parametrize("b,t,h,hd,extremes", [
    (4, 512, 32, 64, False), (1, 3, 2, 8, True), (2, 20, 3, 128, False),
    (1, 9, 2, 40, False), (1, 300, 2, 64, True), (1, 300, 2, 64, False),
    (2, 200, 3, 16, False), (2, 150, 2, 32, True), (1, 333, 2, 128, True),
    (1, 0, 2, 64, False), (1, 1, 2, 64, False), (2, 77, 2, 40, True)])
def test_rwkv6_kernel_matches_plain(dev, b, t, h, hd, extremes):
    """Full width; many ragged chunks at hd 16, 32, 40, 64 and 128, with
    log decays of 0 and -50 across them; T 0 and 1."""
    r, k, v = (_randn(dev, 30 + i, b, t, h, hd) * 0.5 for i in range(3))
    if extremes:            # no decay, and a decay whose exp underflows
        logw = torch.where(_randn(dev, 33, b, t, h, hd) > 0, 0.0, -50.0)
    else:
        logw = -torch.exp(_randn(dev, 33, b, t, h, hd) * 0.5 - 1.0)
    u, s0 = _randn(dev, 34, h, hd) * 0.5, _randn(dev, 35, b, h, hd, hd) * 0.5
    o, s_last = rwkv6_scan_cuda(r, k, v, logw, u, s0)
    want_o, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(o, want_o, **TOL)
    torch.testing.assert_close(s_last, want_s, **TOL)


@pytest.mark.parametrize("name", ["griffin", "rwkv6"])
def test_recurrent_stack_on_the_card_matches_the_plain_path(dev, name):
    """Two small blocks through optimize() on the card: the h100 backend's
    output equals torch_ref's, and every kernel of the path launched."""
    g = torch.Generator(dev).manual_seed(1)
    if name == "griffin":
        blocks = [nn.griffin_block(64, device=dev, generator=g)
                  for _ in range(2)]
        scan = rglru_scan_cuda
    else:
        blocks = [nn.rwkv6_block(64, 4, device=dev, generator=g)
                  for _ in range(2)]
        scan = rwkv6_scan_cuda
    model = tnn.Sequential(*blocks)
    shape = (2, 48, 64)
    x = _randn(dev, 40, *shape)
    counters = (matmul_cuda, dfp_fused_triton, scan)
    before = [c.launches for c in counters]
    got = optimize(model, shape, backend="h100")(x)
    assert all(c.launches > n for c, n in zip(counters, before))
    want = optimize(model, shape, backend="torch_ref")(x)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("n,c,h,w,kh,kw", [
    (2, 32, 224, 224, 3, 3),        # the Listing-3 CNN's first pool, N 2
    (2, 64, 111, 111, 3, 3),        # its second
    (3, 5, 17, 45, 2, 2), (1, 1, 3, 3, 3, 3), (2, 3, 9, 40, 2, 3),
    (1, 1, 70, 33, 3, 1),
])
def test_avgpool_kernel_matches_plain(dev, n, c, h, w, kh, kw):
    """k 2 and 3, kh != kw, H or W equal to k, N·C = 1, sizes that are no
    multiple of a warp: to 1e-5.  The kernel sums each row's taps first and
    then the row sums, the plain version the taps in the listing's order:
    a few ulps apart on O(1) values."""
    x = _randn(dev, 50, n, c, h, w)
    torch.testing.assert_close(avgpool_cuda(x, kh, kw),
                               avgpool_ref(x, kh, kw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES_BY_NAME))
@pytest.mark.parametrize("n,c,h,w,kh,kw,offset", [
    (1, 2, 20, 5000, 3, 3, 0),      # column tiles
    (70000, 1, 4, 4, 3, 3, 0),      # N·C above 65,535: the grid strides
    (2, 3, 13, 111, 3, 3, 1),       # rows of 111: no 16-byte alignment,
    (2, 3, 13, 111, 3, 3, 3),       # and x at an odd element offset
    (3, 2, 17, 45, 2, 2, 5),
    (2, 3, 30, 40, 5, 5, 0),        # run-time windows
    (2, 3, 30, 41, 1, 7, 2),
    (1, 1, 3, 3, 3, 3, 1),
])
def test_avgpool_kernel_matches_its_algorithm_exactly(dev, n, c, h, w, kh,
                                                      kw, offset, dtype):
    """The kernel equals ``avgpool_banded_ref`` (its bands, tiles and sum
    order in plain torch, an IEEE division) bit for bit, and the plain
    version within 1e-5 (f32) or one rounding step; x may start at any
    element of a 16-byte line."""
    t = ALL_DTYPES_BY_NAME[dtype]
    numel = n * c * h * w
    flat = _randn(dev, 53, numel + offset).to(t)
    x = flat[offset:].view(n, c, h, w)
    got = avgpool_cuda(x, kh, kw)
    plan = avgpool_plan(n, c, h, w, kh, kw, x.element_size())
    want = avgpool_banded_ref(x, kh, kw, plan)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if dtype == "float32":
        torch.testing.assert_close(got, avgpool_ref(x, kh, kw), rtol=1e-5,
                                   atol=1e-5)
    else:
        _close_half(got, avgpool_ref(x, kh, kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [0, 1, 4, 8, 16, 24, 32, 48, 64])
def test_avgpool_kernel_at_every_band_height(dev, rows, dtype):
    """The Listing-3 CNN's first pool (N 4) with each band height of the
    plans sweep forced: the same outputs, bit for bit, as the plan's own."""
    x = _randn(dev, 54, 4, 32, 224, 224).to(ALL_DTYPES_BY_NAME[dtype])
    plan = avgpool_plan(4, 32, 224, 224, 3, 3, x.element_size(), rows)
    got = avgpool_cuda(x, 3, 3, rows=rows)
    torch.testing.assert_close(got, avgpool_banded_ref(x, 3, 3, plan),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, avgpool_cuda(x, 3, 3), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES_BY_NAME))
@pytest.mark.parametrize("n,c,h,w,kh,kw", [
    (2, 4, 111, 111, 3, 3), (1, 2, 20, 5000, 3, 3), (2, 3, 17, 46, 2, 2),
    (2, 3, 30, 41, 5, 5), (300, 2, 9, 9, 3, 3)])
def test_avgpool_kernel_matches_its_algorithm_at_odd_and_even_widths(
        dev, n, c, h, w, kh, kw, dtype):
    """Odd and even output widths, column tiles, run-time windows and many
    small planes: the same outputs, bit for bit, as the algorithm's."""
    x = _randn(dev, 55, n, c, h, w).to(ALL_DTYPES_BY_NAME[dtype])
    plan = avgpool_plan(n, c, h, w, kh, kw, x.element_size())
    torch.testing.assert_close(avgpool_cuda(x, kh, kw),
                               avgpool_banded_ref(x, kh, kw, plan),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES_BY_NAME))
@pytest.mark.parametrize("kh,kw", [(3, 3), (2, 2), (1, 7)])
def test_avgpool_kernel_divides_exactly_at_every_magnitude(dev, kh, kw,
                                                          dtype):
    """Inputs from 2^-130 to 2^125 (subnormal sums in f32), with zeros,
    negative zeros, infinities and NaNs among them, and a plane of negative
    zeros: every output, sign of zero included, equals the IEEE division's
    (``avgpool_banded_ref`` divides), where the 3x3 kernel takes a
    product and Markstein's correction."""
    t = ALL_DTYPES_BY_NAME[dtype]
    g = torch.Generator(dev).manual_seed(56)
    shape = (3, 4, 37, 45)
    scale = torch.randint(-130, 126, shape, device=dev, generator=g)
    x = torch.randn(*shape, device=dev, generator=g) * torch.exp2(
        scale.float())
    pick = torch.rand(*shape, device=dev, generator=g)
    for lo, v in ((0.00, 0.0), (0.02, -0.0), (0.04, float("inf")),
                  (0.045, float("-inf")), (0.05, float("nan"))):
        x = torch.where((pick >= lo) & (pick < lo + 0.005), v, x)
    x[1, 2] = -0.0
    x = x.to(t)
    got = avgpool_cuda(x, kh, kw)
    plan = avgpool_plan(*shape, kh, kw, x.element_size())
    want = avgpool_banded_ref(x, kh, kw, plan)
    bits = torch.int32 if dtype == "float32" else torch.int16
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])
    assert bool((got[1, 2].view(bits) == want[1, 2].view(bits)).all())


def test_listing3_cnn_on_the_card_matches_the_plain_path(dev):
    """``depthwise_cnn`` with a stride-1 3×3 mean after each depthwise conv
    through optimize() on the card: both pools launch the kernel, and the
    output equals torch_ref's."""
    g = torch.Generator(dev).manual_seed(2)
    mods = list(nn.depthwise_cnn(device=dev, generator=g))
    mods.insert(3, nn.AvgPool2d(3, stride=1))
    mods.insert(8, nn.AvgPool2d(3, stride=1))
    model = tnn.Sequential(*mods).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(_randn(dev, 51, *p.shape) * 0.1)
    shape = (4, 3, 64, 64)
    x = _randn(dev, 52, *shape)
    sol = optimize(model, shape, backend="h100")
    assert sol.impl_report(by_kind=True)["avgpool"] == {"cuda.avgpool": 2}
    before = avgpool_cuda.launches
    got = sol(x)
    assert avgpool_cuda.launches == before + 2
    want = optimize(model, shape, backend="torch_ref")(x)
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# bfloat16 and float16
# ---------------------------------------------------------------------------
#
# Kernel and plain version both widen the operands to f32, compute in f32
# and round once to the storage type, so their outputs may differ by one
# rounding step of that type: rtol one unit in the last place (2^-7 for
# bf16, 2^-10 for f16), atol 1e-4 for values near zero.  A fault that
# rounds an intermediate or drops a term shows as many units.  A DFP
# program rounds every instruction in both versions, and a one-unit step
# where an instruction's two f32 results straddle a rounding boundary is
# carried on by later instructions: DFP outputs also get one unit at the
# output's scale.

HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}
HALF_TOL = {"bfloat16": dict(rtol=2.0 ** -7, atol=1e-4),
            "float16": dict(rtol=2.0 ** -10, atol=1e-4)}


def _close_half(got, want, dtype, chain=False):
    assert got.dtype == want.dtype == HALF[dtype]
    tol = dict(HALF_TOL[dtype])
    if chain:
        tol["atol"] += tol["rtol"] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("m,k,n,oi", [
    (1, 1536, 256, False), (4, 1536, 1536, True), (37, 130, 70, True),
    (256, 512, 384, False), (2048, 2048, 4, False), (2048, 4, 2048, False),
    (4, 1536, 5000, True), (300, 1000, 260, False), (300, 1000, 260, True),
    (16, 6144, 1536, True), (200, 64, 10, True), (256, 12288, 1024, True),
    (37, 131, 71, False), (37, 131, 71, True), (5, 131, 71, True),
    (300, 257, 9, False),
])
def test_matmul_half_kernel_matches_plain(dev, m, k, n, oi, dtype):
    """Both kernels, both weight orientations, split K, and odd K and N
    (rows 2-byte aligned only: the 2-byte copies)."""
    x = _randn(dev, 60, m, k).to(HALF[dtype])
    w = _weight(dev, 61, k, n, oi).to(HALF[dtype])
    _close_half(matmul_cuda(x, w), matmul_ref(x, w), dtype)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("m,k,n,oi", [
    (300, 256, 260, False), (300, 256, 260, True),      # tensor cores
    (4, 512, 700, False), (4, 512, 700, True),          # skinny, x small
    (700, 512, 4, False),                               # skinny, w small
])
def test_matmul_half_kernel_reads_offset_views(dev, m, k, n, oi, offset,
                                               dtype):
    """Operands that start ``offset`` values (2 or 4 bytes) into their
    storage, with row strides of K + offset values: the 2-byte and 4-byte
    copy paths, no copy of either operand."""
    x = _randn(dev, 62, m, k + offset).to(HALF[dtype])[:, offset:]
    wide = (_randn(dev, 63, n, k + offset) if oi
            else _randn(dev, 63, k, n + offset)) * k ** -0.5
    wide = wide.to(HALF[dtype])
    w = wide[:, offset:].T if oi else wide[:, offset:]
    assert x.data_ptr() % 16 == 2 * offset
    assert w.data_ptr() % 16 == 2 * offset
    _close_half(matmul_cuda(x, w), matmul_ref(x, w), dtype)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("m,k,n", [(300, 256, 260), (4, 512, 700)])
def test_matmul_half_kernel_takes_a_weight_with_no_unit_stride(dev, m, k, n,
                                                               dtype):
    x = _randn(dev, 64, m, k).to(HALF[dtype])
    w = (_randn(dev, 65, k, 2 * n) * k ** -0.5).to(HALF[dtype])[:, ::2]
    _close_half(matmul_cuda(x, w), matmul_ref(x, w), dtype)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("s,hd,causal,window,cap", [
    (128, 128, True, 0, 0.0), (77, 128, True, 16, 0.0),
    (64, 128, True, 0, 5.0), (33, 64, False, 0, 0.0)])
def test_flash_half_kernel_matches_plain(dev, s, hd, causal, window, cap,
                                         dtype):
    q = _randn(dev, 66, 2, s, 12, hd).to(HALF[dtype])
    k = _randn(dev, 67, 2, s, 2, hd).to(HALF[dtype])
    v = _randn(dev, 68, 2, s, 2, hd).to(HALF[dtype])
    attrs = dict(causal=causal, window=window, cap=cap)
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **attrs).transpose(1, 2)
    _close_half(flash_attention_cuda(q, k, v, **attrs), want, dtype)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("hd,window,cap", [(128, 0, 0.0), (128, 24, 0.0),
                                           (64, 0, 4.0)])
def test_decode_half_kernel_matches_plain(dev, hd, window, cap, dtype):
    q, kc, vc, kn, vn = (
        _randn(dev, 69 + i, *shape).to(HALF[dtype]) for i, shape in
        enumerate(((4, 1, 12, hd), (4, 128, 2, hd), (4, 128, 2, hd),
                   (4, 1, 2, hd), (4, 1, 2, hd))))
    lens = torch.tensor([0, 37, 100, 127], dtype=torch.int32, device=dev)
    _close_half(decode_attention_cuda(q, kc, vc, kn, vn, lens, window=window,
                                      cap=cap),
                dops._ref_model_layout(q, kc, vc, kn, vn, lens, window, cap),
                dtype)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("name,rows,d", [
    ("bias_add+gelu", 512, 6144), ("bias_add+add", 512, 1536),
    ("all_instructions", 64, 1536), ("all_instructions", 7, 40)])
def test_dfp_half_kernel_matches_plain(dev, name, rows, d, dtype):
    prog = _SERVING[name]
    ops = [_randn(dev, 75 + i, *((rows, d) if kind == "full" else (d,)))
           .to(HALF[dtype]) for i, kind in enumerate(prog.operand_kinds)]
    _close_half(dfp_fused_triton(prog, ops, (rows, d), HALF[dtype]),
                dfp_fused_ref(prog, ops, (rows, d), HALF[dtype]), dtype,
                chain=True)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("b,t,d", [(4, 512, 4096), (2, 37, 200),
                                   (1, 300, 4100), (2, 0, 64), (1, 1, 130),
                                   (1, 200, 3)])
def test_rglru_half_kernel_matches_plain(dev, b, t, d, dtype):
    a = (torch.rand(b, t, d, device=dev,
                    generator=torch.Generator(dev).manual_seed(80)) * 0.5
         + 0.5).to(HALF[dtype])
    x = _randn(dev, 81, b, t, d).to(HALF[dtype])
    h0 = _randn(dev, 82, b, d).to(HALF[dtype])
    h, last = rglru_scan_cuda(a, x, h0)
    want_h, want_last = rglru_scan_ref(a, x, h0)
    _close_half(h, want_h, dtype)
    _close_half(last, want_last, dtype)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("s0_f32", [False, True])
@pytest.mark.parametrize("b,t,h,hd", [(4, 512, 32, 64), (1, 9, 2, 40),
                                     (1, 300, 2, 64), (2, 150, 2, 16),
                                     (1, 200, 2, 128), (1, 0, 2, 64),
                                     (1, 1, 2, 32)])
def test_rwkv6_half_kernel_matches_plain(dev, b, t, h, hd, s0_f32, dtype):
    """o in the inputs' dtype; s0 in it or in f32; s_last always f32."""
    r, k, v = ((_randn(dev, 83 + i, b, t, h, hd) * 0.5).to(HALF[dtype])
               for i in range(3))
    logw = (-torch.exp(_randn(dev, 86, b, t, h, hd) * 0.5 - 1.0)
            ).to(HALF[dtype])
    u = (_randn(dev, 87, h, hd) * 0.5).to(HALF[dtype])
    s0 = _randn(dev, 88, b, h, hd, hd) * 0.5
    s0 = s0 if s0_f32 else s0.to(HALF[dtype])
    o, s_last = rwkv6_scan_cuda(r, k, v, logw, u, s0)
    want_o, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
    _close_half(o, want_o, dtype)
    assert s_last.dtype == want_s.dtype == torch.float32
    torch.testing.assert_close(s_last, want_s, **TOL)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("n,c,h,w,kh,kw", [
    (2, 32, 224, 224, 3, 3), (3, 5, 17, 45, 2, 2), (1, 1, 70, 33, 3, 1)])
def test_avgpool_half_kernel_matches_plain(dev, n, c, h, w, kh, kw, dtype):
    x = _randn(dev, 89, n, c, h, w).to(HALF[dtype])
    _close_half(avgpool_cuda(x, kh, kw), avgpool_ref(x, kh, kw), dtype)


def test_half_kernels_refuse_other_dtypes(dev):
    """A wrapper given a dtype outside float32, bfloat16 and float16, or
    mixed ones, raises instead of converting."""
    x64 = torch.zeros(4, 8, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        matmul_cuda(x64, x64.T)
    with pytest.raises(TypeError):
        matmul_cuda(x64.float(), x64.T.to(torch.bfloat16))
    with pytest.raises(TypeError):
        avgpool_cuda(torch.zeros(1, 1, 4, 4, dtype=torch.float64,
                                 device=dev))



# ---------------------------------------------------------------------------
# the tensor-core flash kernel and the split-KV decode, widened
# ---------------------------------------------------------------------------

ALL_DTYPES = {"float32": torch.float32, **HALF}


def _close_dtype(got, want, dtype):
    if dtype == "float32":
        torch.testing.assert_close(got, want, **TOL)
    else:
        _close_half(got, want, dtype)


def _bshd(dev, seed, b, s, heads, hd, dtype, layout):
    """A (b, s, heads, hd) operand: contiguous as the served graph passes
    it (a reshaped projection), a view with wider row strides (16-byte
    aligned), or one that starts a value into its storage (no 16-byte
    copies)."""
    dt = ALL_DTYPES[dtype]
    if layout == "contiguous":
        return _randn(dev, seed, b, s, heads, hd).to(dt)
    if layout == "strided":
        return _randn(dev, seed, b, s, heads + 3, hd + 8).to(dt)[:, :, 1:heads + 1, 8:]
    flat = _randn(dev, seed, b * s * heads * hd + 1).to(dt)
    return flat[1:].view(b, s, heads, hd)


def _flash_case(dev, s, hd, dtype, causal=True, window=0, cap=0.0,
                layout="contiguous", b=2, h=6, kv=2):
    q = _bshd(dev, 91, b, s, h, hd, dtype, layout)
    k = _bshd(dev, 92, b, s, kv, hd, dtype, layout)
    v = _bshd(dev, 93, b, s, kv, hd, dtype, layout)
    attrs = dict(causal=causal, window=window, cap=cap)
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **attrs).transpose(1, 2)
    _close_dtype(flash_attention_cuda(q, k, v, **attrs), want, dtype)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [1, 17, 64, 65, 128, 129, 256, 300])
def test_flash_kernel_at_every_length(dev, s, hd, dtype):
    """Every head dim at lengths below, at and past the 32- and 64-key
    tiles, on contiguous BSHD operands as the served graph passes them."""
    _flash_case(dev, s, hd, dtype)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
@pytest.mark.parametrize("layout", ["contiguous", "strided", "offset"])
@pytest.mark.parametrize("s,hd,causal,window,cap", [
    (300, 128, True, 64, 0.0),      # a window across tiles
    (129, 64, True, 16, 30.0),      # window and softcap
    (65, 128, True, 0, 5.0),        # softcap
    (256, 32, False, 0, 0.0),       # non-causal
    (17, 16, False, 8, 0.0),        # non-causal window
    (128, 128, True, 1, 0.0),       # each row sees only itself
])
def test_flash_kernel_windows_caps_and_layouts(dev, s, hd, causal, window,
                                               cap, layout, dtype):
    _flash_case(dev, s, hd, dtype, causal, window, cap, layout)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_flash_kernel_at_the_serving_widths(dev, dtype):
    """B 4, S 128 and 256, H 12, KV 2, hd 128: the prefill's and the bf16
    transformer's shapes."""
    for s in (128, 256):
        _flash_case(dev, s, 128, dtype, b=4, h=12, kv=2)


def _decode_case(dev, cache, g, dtype, lens, hd=128, window=0, cap=0.0,
                 sm_count=0, kv=2):
    dt = ALL_DTYPES[dtype]
    b = len(lens)
    q, kc, vc, kn, vn = (
        _randn(dev, 94 + i, *shape).to(dt) for i, shape in
        enumerate(((b, 1, kv * g, hd), (b, cache, kv, hd), (b, cache, kv, hd),
                   (b, 1, kv, hd), (b, 1, kv, hd))))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attention_cuda(q, kc, vc, kn, vn, lens_t, window=window,
                                cap=cap, sm_count=sm_count)
    _close_dtype(got, dops._ref_model_layout(q, kc, vc, kn, vn, lens_t,
                                             window, cap), dtype)
    for i, n in enumerate(lens):
        if n == 0:      # batch padding attends only the step's own pair
            assert torch.equal(got[i, 0], vn[i, 0].repeat_interleave(g, 0))


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
@pytest.mark.parametrize("g", [1, 3, 6, 16])
@pytest.mark.parametrize("cache", [1, 7, 64, 128, 256, 1000])
def test_decode_kernel_at_every_cache(dev, cache, g, dtype):
    """lens 0, full and mixed, one to MAX_GROUP query heads per kv head."""
    assert g <= MAX_GROUP
    _decode_case(dev, cache, g, dtype,
                 [0, cache, max(1, cache // 3), max(0, cache - 1)])


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
@pytest.mark.parametrize("sm_count", [1, 10_000])
@pytest.mark.parametrize("cache,hd,g,window,cap", [
    (128, 128, 6, 0, 0.0), (1000, 128, 6, 100, 0.0), (256, 64, 4, 0, 4.0),
    (1000, 32, 16, 300, 20.0), (200, 16, 2, 5, 0.0),
])
def test_decode_kernel_at_one_split_and_many(dev, cache, hd, g, window, cap,
                                             sm_count, dtype):
    """The plan forced to one split (sm_count 1) and to its most (a large
    sm_count), with windows that start inside a split and softcaps."""
    p = decode_plan(4, 2, cache, hd, ALL_DTYPES[dtype].itemsize, sm_count)
    assert (p.splits == 1) == (sm_count == 1)
    _decode_case(dev, cache, g, dtype, [0, cache, cache // 2 + 3, 9],
                 hd=hd, window=window, cap=cap, sm_count=sm_count)


def test_decode_kernel_reads_unaligned_views(dev):
    """A cache that starts a value into its storage: one value per load."""
    b, cache, kv, hd = 3, 100, 2, 128
    flat = _randn(dev, 99, 2 * b * cache * kv * hd + 1)
    kc = flat[1:b * cache * kv * hd + 1].view(b, cache, kv, hd)
    vc = flat[b * cache * kv * hd + 1:].view(b, cache, kv, hd)
    q = _randn(dev, 100, b, 1, 12, hd)
    kn, vn = _randn(dev, 101, b, 1, kv, hd), _randn(dev, 102, b, 1, kv, hd)
    lens = torch.tensor([0, 50, 100], dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        decode_attention_cuda(q, kc, vc, kn, vn, lens),
        dops._ref_model_layout(q, kc, vc, kn, vn, lens, 0, 0.0), **TOL)


# ---------------------------------------------------------------------------
# the chunked scans, widened
# ---------------------------------------------------------------------------

def _rwkv6_inputs(dev, b, t, h, hd, dtype, extremes):
    dt = ALL_DTYPES[dtype]
    r, k, v = ((_randn(dev, 110 + i, b, t, h, hd) * 0.5).to(dt)
               for i in range(3))
    if extremes:            # no decay, and a decay whose exp underflows
        logw = torch.where(_randn(dev, 113, b, t, h, hd) > 0, 0.0, -50.0)
    else:
        logw = -torch.exp(_randn(dev, 113, b, t, h, hd) * 0.5 - 1.0)
    u = (_randn(dev, 114, h, hd) * 0.5).to(dt)
    s0 = (_randn(dev, 115, b, h, hd, hd) * 0.5).to(dt)
    return r, k, v, logw.to(dt), u, s0


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
@pytest.mark.parametrize("sm_count", [1, 10_000])
@pytest.mark.parametrize("b,t,h,hd,extremes", [
    (2, 300, 2, 64, True), (2, 129, 2, 16, False), (2, 200, 2, 32, True),
    (2, 257, 2, 128, False), (2, 70, 3, 40, True), (2, 64, 2, 64, False)])
def test_rwkv6_kernel_at_one_chunk_and_many(dev, b, t, h, hd, extremes,
                                            sm_count, dtype):
    """The plan forced to one chunk walked in several staged tiles
    (sm_count 1) and to 16-step chunks (a large sm_count), at every head
    dim, with log decays of 0 and -50 across the chunks; s_last in f32."""
    from repro_torch.kernels.rwkv6_scan.kernel import max_tile, rwkv6_plan
    p = rwkv6_plan(b, t, h, hd, ALL_DTYPES[dtype].itemsize, sm_count)
    assert (p.chunks == 1) == (sm_count == 1 or t <= max_tile(hd))
    ins = _rwkv6_inputs(dev, b, t, h, hd, dtype, extremes)
    o, s_last = rwkv6_scan_cuda(*ins, sm_count=sm_count)
    want_o, want_s = rwkv6_scan_ref(*ins)
    _close_dtype(o, want_o, dtype)
    assert s_last.dtype == torch.float32
    torch.testing.assert_close(s_last, want_s, **TOL)


def test_rwkv6_kernel_at_t_0_returns_s0(dev):
    r, k, v, logw, u, s0 = _rwkv6_inputs(dev, 2, 0, 3, 64, "bfloat16", False)
    o, s_last = rwkv6_scan_cuda(r, k, v, logw, u, s0)
    assert o.shape == r.shape and s_last.dtype == torch.float32
    assert torch.equal(s_last, s0.float())


def _offset_view(x):
    """x copied into storage that starts one value in: no 16-byte loads."""
    flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    return flat[1:].view(x.shape).copy_(x)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_rwkv6_kernel_reads_unaligned_views(dev, dtype):
    ins = _rwkv6_inputs(dev, 1, 100, 2, 64, dtype, False)
    ins = [_offset_view(x) for x in ins[:4]] + list(ins[4:])
    o, s_last = rwkv6_scan_cuda(*ins)
    want_o, want_s = rwkv6_scan_ref(*ins)
    _close_dtype(o, want_o, dtype)
    torch.testing.assert_close(s_last, want_s, **TOL)


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
@pytest.mark.parametrize("sm_count", [1, 10_000])
@pytest.mark.parametrize("b,t,d", [(2, 300, 4100), (3, 9, 130),
                                   (1, 1000, 512), (4, 17, 5)])
def test_rglru_kernel_at_wide_and_narrow_warps(dev, b, t, d, sm_count,
                                               dtype):
    """The plan forced to its widest rows (32 lanes of channels, sm_count
    1) and its narrowest (4 lanes, a large sm_count); T ragged over the
    chunks and the tiles, D not a multiple of a block's channels."""
    from repro_torch.kernels.rglru_scan.kernel import rglru_plan
    dt = ALL_DTYPES[dtype]
    p = rglru_plan(b, t, d, dt.itemsize, sm_count)
    assert p.lanes == (32 if sm_count == 1 else 4)
    a = (torch.rand(b, t, d, device=dev,
                    generator=torch.Generator(dev).manual_seed(130)) * 0.5
         + 0.5).to(dt)
    x, h0 = _randn(dev, 131, b, t, d).to(dt), _randn(dev, 132, b, d).to(dt)
    h, last = rglru_scan_cuda(a, x, h0, sm_count=sm_count)
    want_h, want_last = rglru_scan_ref(a, x, h0)
    _close_dtype(h, want_h, dtype)
    _close_dtype(last, want_last, dtype)
    if t:
        assert torch.equal(last, h[:, -1])


@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_rglru_kernel_reads_unaligned_views(dev, dtype):
    dt = ALL_DTYPES[dtype]
    b, t, d = 2, 50, 256
    a = (torch.rand(b, t, d, device=dev,
                    generator=torch.Generator(dev).manual_seed(140)) * 0.5
         + 0.5).to(dt)
    a, x = _offset_view(a), _offset_view(_randn(dev, 141, b, t, d).to(dt))
    h0 = _randn(dev, 142, b, d).to(dt)
    h, last = rglru_scan_cuda(a, x, h0)
    want_h, want_last = rglru_scan_ref(a, x, h0)
    _close_dtype(h, want_h, dtype)
    _close_dtype(last, want_last, dtype)


# README's bf16 row, relative to the output's scale
BF16_ROW = {"griffin": 3e-2, "rwkv6": 5e-2, "listing3_cnn": 3e-2}


def _bf16_path(dev, name):
    """(bf16 module, input shape, the wrappers its forward launches) of a
    small path."""
    g = torch.Generator(dev).manual_seed(3)
    if name == "listing3_cnn":
        mods = list(nn.depthwise_cnn(device=dev, generator=g))
        mods.insert(3, nn.AvgPool2d(3, stride=1))
        mods.insert(8, nn.AvgPool2d(3, stride=1))
        model, shape = tnn.Sequential(*mods).eval(), (4, 3, 64, 64)
        counters = (matmul_cuda, avgpool_cuda)
    elif name == "griffin":
        model = tnn.Sequential(*[nn.griffin_block(64, device=dev, generator=g)
                                 for _ in range(2)])
        shape, counters = (2, 48, 64), (matmul_cuda, dfp_fused_triton,
                                        rglru_scan_cuda)
    else:
        model = tnn.Sequential(*[nn.rwkv6_block(64, 4, device=dev,
                                                generator=g)
                                 for _ in range(2)])
        shape, counters = (2, 48, 64), (matmul_cuda, dfp_fused_triton,
                                        rwkv6_scan_cuda)
    return model.to(torch.bfloat16), shape, counters


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", ["griffin", "rwkv6", "listing3_cnn"])
def test_bf16_path_on_the_card_elects_and_runs_the_kernels(dev, name):
    """A bf16 module and input through optimize(..., dtype="bfloat16"):
    every node a cuda.* impl admits elects it, the path's kernels launch,
    and the output is within README's bf16 row (3e-2; 5e-2 for RWKV6) of
    torch_ref's scale on the same bf16 module."""
    model, shape, counters = _bf16_path(dev, name)
    x = _randn(dev, 90, *shape).to(torch.bfloat16)
    sol = optimize(model, shape, backend="h100", dtype="bfloat16")
    for n in sol.graph.topo():
        if any(c.name.startswith("cuda.")
               for c in registry.candidates(sol.backend, n)):
            assert (n.impl or "").startswith("cuda."), (n.name, n.impl)
    before = [c.launches for c in counters]
    got = sol(x)
    assert all(c.launches > b for c, b in zip(counters, before))
    want = optimize(model, shape, backend="torch_ref", dtype="bfloat16")(x)
    assert got.dtype == want.dtype == torch.bfloat16
    err = _rel_err(got, want)
    assert err <= BF16_ROW[name], err


def test_bf16_rwkv6_row_still_fails_a_wrong_stack(dev):
    """At README's RWKV6 bf16 row, the stack of the test above with its
    bonus u zeroed on the h100 side fails: the row separates a wrong scan
    from rounding."""
    model, shape, _ = _bf16_path(dev, "rwkv6")
    x = _randn(dev, 90, *shape).to(torch.bfloat16)
    want = optimize(model, shape, backend="torch_ref", dtype="bfloat16")(x)
    with torch.no_grad():
        zeroed = [p.zero_() for k, p in model.named_parameters()
                  if k.endswith(".u")]
    assert len(zeroed) == 2
    got = optimize(model, shape, backend="h100", dtype="bfloat16")(x)
    assert _rel_err(got, want) > BF16_ROW["rwkv6"]


# ---------------------------------------------------------------------------
# every config of every kernel's Tunable space, and measurement on the card
# ---------------------------------------------------------------------------

CONFIG_CASES = [
    ("matmul", (512, 1536, 1536)), ("matmul", (4, 1536, 1536)),
    ("linear", (4, 1536, 5000)), ("linear", (512, 6144, 1536)),
    ("attention", (2, 128, 12, 2, 128)), ("attention", (1, 65, 4, 4, 64)),
    ("decode_attention", (4, 128, 12, 2, 128)),
    ("decode_attention", (2, 300, 8, 2, 64)),
    ("fused", (512, 6144)), ("fused", (7, 40)),
    ("rglru_scan", (4, 512, 4096)), ("rglru_scan", (1, 300, 4100)),
    ("rwkv6_scan", (4, 512, 32, 64)), ("rwkv6_scan", (1, 300, 2, 64)),
    ("avgpool", (4, 32, 222, 222)), ("avgpool", (2, 3, 7, 38)),
]


def _chip_smoke():
    """``chip_smoke.py``, loaded from the checkout: it holds the plain
    version every tunable config is held against."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,shape", CONFIG_CASES)
def test_every_tunable_config_matches_plain(dev, op, shape, dtype):
    """Each config of the kernel's space, pinned on the node as a measured
    election pins it, runs through the impl and equals the plain version
    (f32: 1e-4; bf16: one rounding step)."""
    from repro_torch.benchmarks import autotune as drv
    node, vals = drv._build(op, shape, dtype, dev)
    backend = registry.get_backend("h100")
    impl = next(i for i in registry.candidates(backend, node)
                if i.name.startswith("cuda."))
    space = impl.tunable.tune_space(node, backend.hw)
    assert space
    want = _chip_smoke().plain_version(node, vals)
    for cfg in space:
        impl.tunable.bind_config(node, cfg)
        try:
            got = impl.fn(node, vals, backend)
        finally:
            impl.tunable.bind_config(node, None)
        torch.cuda.synchronize()
        if dtype == "float32":
            torch.testing.assert_close(got, want, **TOL)
        else:
            _close_half(got, want, dtype, chain=op == "fused")


def test_measurement_on_the_card_records_min_and_mean(dev):
    from repro_torch.benchmarks import autotune as drv
    from repro_torch.core import autotune as AT
    from repro_torch.core import measure
    node, vals = drv._build("linear", (4, 1536, 1536), "float32", dev)
    cache = AT.AutotuneCache()
    out = measure.sweep_node(node, vals, registry.get_backend("h100"), cache,
                             warmup=1, iters=5)
    assert {m.impl for m in out} == {"cuda.linear", "ref.linear"}
    assert "cuda_mm_block" not in node.attrs
    for m in out:
        assert m.mean_us >= m.us > 0.0


def test_strict_serving_on_the_card(dev):
    """warm_autotune on the card, then strict serving: every served
    election measured on its exact bucket, tokens equal to a cold
    server's."""
    from repro_torch.core import autotune as AT
    cfg = serve.ServeConfig(d_model=64, n_heads=4, n_layers=2, vocab=128,
                            max_seq=32, max_batch=2, slots=3)
    model = serve.build_lm(cfg, n_kv_heads=2, device=dev)
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12, 13, 14, 15]]
    prev = AT.get_cache()
    AT.set_cache(AT.AutotuneCache())
    try:
        cold = serve.SolServer(cfg, model=model, device=dev)
        creqs = [cold.submit(p, 5) for p in prompts]
        cold.run()
        cold.close()
        strict = serve.SolServer(cfg, model=model, device=dev,
                                 strict_provenance=True)
        reqs = [strict.submit(p, 5) for p in prompts]
        assert strict.warm_autotune()["nodes"] > 0
        strict.run()
        strict.close()
    finally:
        AT.set_cache(prev)
    kinds = ("linear", "matmul", "attention", "decode_attention")
    for key, model_ in strict._models.items():
        assert model_.check_provenance(kinds=kinds) == []
    assert [r.generated for r in reqs] == [r.generated for r in creqs]


def test_matmul_rows_hold_the_kernel_to_torch_matmul_on_the_card(dev):
    from repro_torch.benchmarks.autotune import matmul_rows
    rows = matmul_rows(device=dev)
    errs = [float(d.split("max_abs_err=")[1]) for n, _, d in rows
            if n.endswith("_cuda_matmul")]
    assert len(errs) == 3 and max(errs) <= 1e-4
    assert all(us > 0 for _, us, _ in rows)


def test_inference_fig3_outputs_agree_on_the_card(dev):
    """The five B=1 cases' SOL models agree with the eager forward within
    README's f32 row on the card (the table raises otherwise)."""
    from repro_torch.benchmarks.paper_tables import inference_fig3
    rows = inference_fig3(device=dev)
    assert len(rows) == 10 and all(us > 0 for _, us, _ in rows)


def test_sol_rows_on_the_card_rank_finite_ratios(dev):
    """The ``sol`` table on the card: every tuned cell's ratio finite and
    non-negative at its unit's peak, on this card's spec."""
    from repro_torch.backends import h100_spec
    from repro_torch.benchmarks.autotune import sol_rows
    from repro_torch.core import autotune as AT
    from repro_torch.core import sol
    rows = sol_rows(device=dev)
    cells = [d for n, _, d in rows if not n.startswith("sol_refine_")]
    assert cells
    for d in cells:
        fields = dict(kv.split("=") for kv in d.split(";"))
        ratio = float(fields["ratio"])
        assert math.isfinite(ratio) and ratio >= 0.0
    c = AT.AutotuneCache()
    c.record("matmul", (4, 1536, 1536), "float32", "h100", "ref.matmul",
             30.0, flops=2.0 * 4 * 1536 * 1536, nbytes=9.48e6)
    (row,) = sol.cache_rows(c, device=dev)
    hw = h100_spec(torch.cuda.get_device_name(dev))
    assert row.bound_us == pytest.approx(9.48e6 / hw.hbm_bandwidth * 1e6)


# -- the backward impls through autograd on the card --------------------------

def _grad_graph(model, shape, dev):
    """An h100 ``training=True`` SOL model and its parameters as
    leaves."""
    sm = optimize(model, shape, backend="h100", training=True, device=dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in sm._params_for_call().items()}
    return sm, params


def _linear_node(m, k, n, layout, bias):
    """A LINEAR node on x (m, k), its weight stored (out, in) for "oi" or
    (in, out) for "io", with an optional bias."""
    from repro_torch.core.ir import Node, OpKind, TensorSpec, input_node, \
        param_node
    w = (n, k) if layout == "oi" else (k, n)
    ins = [input_node((m, k)), param_node(w, name="weight")]
    if bias:
        ins.append(param_node((n,), name="bias"))
    node = Node(OpKind.LINEAR, ins, TensorSpec((m, n)),
                attrs={"out_features": n, "in_features": k})
    node.layout = "io"
    return node


@pytest.mark.parametrize("layout", ["oi", "io"])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_bwd_through_autograd_on_the_card(dev, layout, bias):
    """``backward()`` through ``cuda.linear_bwd`` (a weight stored (out,
    in) or (in, out)) runs dx and dw on the matmul kernel, on autograd's
    device thread (its launches rise during backward), and equals autograd
    of ``F.linear``; dw comes back in the weight's own layout."""
    from repro_torch.backends import get_backend
    from repro_torch.core.executor import _NodeFunction
    from repro_torch.kernels.matmul.kernel import KERNELS
    m, k, n = 51, 96, 80
    node = _linear_node(m, k, n, layout, bias)
    impl = registry.get_impl("cuda.linear")
    gi = registry.get_grad_impl("cuda.linear_bwd")
    x = _randn(dev, 2, m, k)
    w_oi = _randn(dev, 3, n, k) * k ** -0.5
    w = w_oi if layout == "oi" else w_oi.T.contiguous()
    vals = [x, w] + ([_randn(dev, 4, n)] if bias else [])
    ct = _randn(dev, 5, m, n)
    leaves = [v.clone().requires_grad_(True) for v in vals]
    before = sum(c.launches for c in KERNELS.values())
    y = _NodeFunction.apply(node, impl, gi, get_backend("h100"), *leaves)
    y.backward(ct)
    torch.cuda.synchronize()
    assert sum(c.launches for c in KERNELS.values()) - before == 3
    want = [v.clone().requires_grad_(True)
            for v in [x, w_oi] + vals[2:]]
    torch.nn.functional.linear(*want).backward(ct)
    torch.testing.assert_close(leaves[0].grad, want[0].grad, **TOL)
    dw = want[1].grad if layout == "oi" else want[1].grad.T
    assert leaves[1].grad.shape == w.shape
    torch.testing.assert_close(leaves[1].grad, dw, **TOL)
    if bias:
        torch.testing.assert_close(leaves[2].grad, want[2].grad, **TOL)


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_matmul_bwd_with_a_pinned_split_on_the_card(dev, splits):
    """``cuda.matmul_bwd`` in a transformer block's q/k/v/o products, with
    a pinned K split of the dx product (``cuda_mm_block_bwd``), equals the
    block's eager autograd; the elected graph's gradients of every
    parameter agree."""
    blk = nn.transformer_block(64, 4, 2, device=dev,
                               generator=torch.Generator(dev).manual_seed(3))
    sm, params = _grad_graph(blk, (2, 24, 64), dev)
    assert set(sm.impl_report(by_kind=True)["matmul_bwd"]) == {
        "cuda.matmul_bwd"}
    if splits is not None:
        for n in sm.graph.topo():
            if n.impl_bwd == "cuda.matmul_bwd":
                n.attrs["cuda_mm_block_bwd"] = (splits,)
    x = _randn(dev, 4, 2, 24, 64)
    loss = sm._fn(params, x).square().mean()
    loss.backward()
    blk.zero_grad()
    blk(x).square().mean().backward()
    torch.cuda.synchronize()
    for k, p in blk.named_parameters():
        torch.testing.assert_close(params[k].grad, p.grad, **TOL)


def test_rglru_bwd_through_autograd_on_the_card(dev):
    """``backward()`` through ``cuda.rglru_scan_bwd`` launches the RG-LRU
    kernel for the reverse recurrence and equals autograd of the plain
    scan, h0 ≠ 0, at a ragged T."""
    from repro_torch.backends import get_backend
    from repro_torch.core.executor import _NodeFunction
    from repro_torch.core.ir import Node, OpKind, TensorSpec, input_node
    b, t, d = 2, 77, 130
    ins = [input_node((b, t, d), "float32", name=nm) for nm in "abh"]
    ins[2] = input_node((b, d), "float32", name="h0")
    node = Node(OpKind.RGLRU_SCAN, ins, TensorSpec((b, t, d), "float32"))
    bk = get_backend("h100")
    impl = registry.get_impl("cuda.rglru_scan")
    gi = registry.get_grad_impl("cuda.rglru_scan_bwd")
    g = torch.Generator(dev).manual_seed(5)
    a = (torch.rand(b, t, d, device=dev, generator=g) * 0.5 + 0.5)
    bb = torch.randn(b, t, d, device=dev, generator=g)
    h0 = torch.randn(b, d, device=dev, generator=g)
    ct = torch.randn(b, t, d, device=dev, generator=g)
    leaves = [v.clone().requires_grad_(True) for v in (a, bb, h0)]
    before = rglru_scan_cuda.launches
    _NodeFunction.apply(node, impl, gi, bk, *leaves).backward(ct)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches - before == 2     # forward, backward
    want = [v.clone().requires_grad_(True) for v in (a, bb, h0)]
    rglru_scan_ref(*want)[0].backward(ct)
    for got, ref in zip(leaves, want):
        torch.testing.assert_close(got.grad, ref.grad, **TOL)


# ---------------------------------------------------------------------------
# the custom ops an exported graph calls (kernels/library.py)
# ---------------------------------------------------------------------------

def _op_case(dev, name):
    """(op args, the direct entry call, the kernel's wrapper) at one shape
    of the paths: the serve's decode-step q/o product, prefill and decode
    attention and a layernorm group at Qwen2-1.5B's attention widths, both
    scans at the recurrent stacks' widths, the Listing-3 CNN's first pool."""
    from repro_torch.kernels.avgpool.ops import avgpool
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.dfp_fused.ops import dfp_fused
    from repro_torch.kernels.dfp_fused.program import program_to_str
    from repro_torch.kernels.flash_attention.kernel import BLOCK_Q
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    r = functools.partial(_randn, dev)
    if name == "matmul":
        x, w = r(1, 4, 1536), _weight(dev, 2, 1536, 1536, True)
        return (x, w, 0), lambda: matmul(x, w), matmul_cuda
    if name == "flash_attention":
        q, k, v = r(1, 4, 128, 12, 128), r(2, 4, 128, 2, 128), \
            r(3, 4, 128, 2, 128)
        return ((q, k, v, True, 0, 0.0, BLOCK_Q),
                lambda: flash_attention(q, k, v), flash_attention_cuda)
    if name == "decode_attention":
        q, kn, vn = r(1, 4, 1, 12, 128), r(2, 4, 1, 2, 128), \
            r(3, 4, 1, 2, 128)
        k, v = r(4, 4, 128, 2, 128), r(5, 4, 128, 2, 128)
        lens = torch.tensor([0, 37, 100, 127], device=dev,
                            dtype=torch.int32)
        return ((q, k, v, kn, vn, lens, 0, 0.0, 0),
                lambda: decode_attention(q, k, v, kn, vn, lens),
                decode_attention_cuda)
    if name == "dfp_fused":
        prog = Program((("layernorm", 0, ("op", 0), 1, 2, 1e-5),),
                       ("full", "vec", "vec"), 0)
        ops = [r(1, 512, 1536), 1.0 + 0.1 * r(2, 1536), r(3, 1536)]
        return ((ops, program_to_str(prog), 0, 0),
                lambda: dfp_fused(prog, ops), dfp_fused_triton)
    if name == "rglru_scan":
        a = torch.sigmoid(r(1, 4, 512, 4096))
        b, h0 = r(2, 4, 512, 4096), r(3, 4, 4096)
        return (a, b, h0, 0, 0), lambda: rglru_scan(a, b, h0), \
            rglru_scan_cuda
    if name == "rwkv6_scan":
        rr, kk, vv = (0.1 * r(i, 4, 512, 32, 64) for i in (1, 2, 3))
        logw = -torch.exp(r(4, 4, 512, 32, 64) - 1.0)
        u, s0 = 0.1 * r(5, 32, 64), torch.zeros(4, 32, 64, 64, device=dev)
        return ((rr, kk, vv, logw, u, s0, 0),
                lambda: rwkv6_scan(rr, kk, vv, logw, u, s0), rwkv6_scan_cuda)
    x = r(1, 64, 32, 112, 112)
    return (x, 3, 3, 0), lambda: avgpool(x, 3, 3), avgpool_cuda


@pytest.mark.parametrize("name", ["matmul", "flash_attention",
                                  "decode_attention", "dfp_fused",
                                  "rglru_scan", "rwkv6_scan", "avgpool"])
def test_custom_op_equals_its_entry_on_the_card(dev, name):
    """The ``repro_torch::*`` op on CUDA tensors launches its kernel (the
    wrapper's count moves) and equals the direct entry call bit for bit."""
    from repro_torch.kernels import library
    args, entry, wrapper = _op_case(dev, name)
    before = wrapper.launches
    got = library.OPS[name](*args)
    torch.cuda.synchronize()
    assert wrapper.launches > before
    want = entry()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.is_cuda and g_.dtype == w_.dtype
        assert torch.equal(g_, w_)


def test_mesh_serve_on_the_card_equals_one_device(dev):
    """Four ranks sharing the card (gloo) serve a small model on a (2, 2)
    mesh: the tokens equal one device's, every rank's kernels launch."""
    import _torch_mesh_ranks as R
    from repro_torch.launch.mesh import run_on_mesh
    cfg_kw = dict(d_model=64, n_heads=4, n_layers=2, vocab=128, max_seq=32,
                  max_batch=4, slots=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, int(rng.integers(3, 14)), dtype=np.int32)
               for _ in range(4)]
    cfg = serve.ServeConfig(**cfg_kw)
    one = serve.SolServer(cfg, model=serve.build_lm(cfg, device=dev),
                          device=dev)
    want = [one.submit(p, 6) for p in prompts]
    one.run()
    one.close()
    ranks = run_on_mesh(R.card_serve, 2, 2, device="cuda",
                        dist_backend="gloo", timeout_s=300,
                        args=(cfg_kw, prompts, 6))
    for r in ranks:
        assert r["tokens"] == [q.generated for q in want]
        assert all(n > 0 for n in r["launches"].values()), r["launches"]


def test_fleet_kill_on_the_card(dev):
    """Three replicas on the card, one killed mid-stream: every request
    completes with the tokens of an undisturbed one-replica fleet."""
    from repro_torch.launch.fleet import FleetConfig, SolFleet
    cfg = serve.ServeConfig(d_model=64, n_heads=4, n_layers=2, vocab=128,
                            max_seq=32, max_batch=4, slots=4)
    model = serve.build_lm(cfg, device=dev)
    rng = np.random.default_rng(1)
    work = [(rng.integers(0, 128, int(rng.integers(3, 14)), dtype=np.int32),
             serve.SamplingParams(temperature=0.8, seed=100 + i))
            for i in range(9)]
    fleet = SolFleet(cfg, FleetConfig(n_replicas=3), model=model, device=dev)
    reqs = [fleet.submit(p, 5, sampling=sp) for p, sp in work]
    fleet.tick()
    fleet.tick()
    fleet.kill()
    s = fleet.run()
    fleet.close()
    assert s["kills"] == 1 and s["respawns"] == 1 and s["requeued"] >= 1
    base = SolFleet(cfg, FleetConfig(n_replicas=1), model=model, device=dev)
    breqs = [base.submit(p, 5, sampling=sp) for p, sp in work]
    base.run()
    base.close()
    assert [r.generated for r in reqs] == [b.generated for b in breqs]


# ---------------------------------------------------------------------------
# the model-zoo backbone: the kernel route against the plain route
# ---------------------------------------------------------------------------

def _backbone_serve(cfg, params, batch, steps, plain):
    """A prefill into a fresh cache on the one-process mesh's default
    device, then greedy decode steps: (tokens, the logits of each)."""
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import backbone as B
    mesh = make_debug_mesh(1, 1)
    assert mesh.device.type == "cuda"
    s = batch["tokens"].shape[1]
    cache = B.init_cache(cfg, batch["tokens"].shape[0], s + steps)
    logits, cache = make_prefill_step(mesh, cfg, plain=plain)(
        params, batch, cache)
    decode = make_decode_step(mesh, cfg, plain=plain)
    rows, toks = [logits[:, -1]], [logits[:, -1].argmax(-1)]
    for j in range(steps):
        lg, cache = decode(params, cache, toks[-1][:, None], s + j)
        rows.append(lg[:, 0])
        toks.append(lg[:, 0].argmax(-1))
    return torch.stack(toks, 1), torch.stack(rows, 1).float()


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_backbone_kernel_route_at_qwen2_width(dev, dtype, rtol):
    """qwen2-1.5b's widths at two layers: one flash launch a layer in the
    prefill and one decode launch a layer a step, as attention_route
    predicts; logits within README's tolerance of the plain route's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import backbone as B
    from repro_torch.models.layers import attention_route
    cfg = dataclasses.replace(get_config("qwen2_1_5b"), n_layers=2,
                              dtype=dtype)
    assert attention_route(cfg, "attn", "prefill", dtype) == "kernel"
    assert attention_route(cfg, "attn", "decode", dtype,
                           cache_len=68) == "kernel"
    params = B.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator(dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64), generator=g,
                                     device=dev)}
    f0, d0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    toks, rows = _backbone_serve(cfg, params, batch, 4, plain=False)
    assert flash_attention_cuda.launches - f0 == 2
    assert decode_attention_cuda.launches - d0 == 2 * 4
    ptoks, prows = _backbone_serve(cfg, params, batch, 4, plain=True)
    assert _rel(rows[:, 0], prows[:, 0]) <= rtol
    if dtype == "float32":
        assert torch.equal(toks, ptoks)
        assert _rel(rows, prows) <= rtol


@pytest.mark.parametrize("arch,scan", [("recurrentgemma_9b", "rglru"),
                                       ("rwkv6_1_6b", "rwkv6")])
def test_backbone_recurrent_config_on_the_card(dev, arch, scan):
    """A reduced recurrent config: its scan kernel launches in the
    prefill, and the kernel route's tokens and logits equal the plain
    route's (1e-4 of the scale)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import backbone as B
    cfg = get_smoke(arch)
    params = B.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator(dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g,
                                     device=dev)}
    counter = rglru_scan_cuda if scan == "rglru" else rwkv6_scan_cuda
    n0 = counter.launches
    toks, rows = _backbone_serve(cfg, params, batch, 6, plain=False)
    assert counter.launches > n0
    ptoks, prows = _backbone_serve(cfg, params, batch, 6, plain=True)
    assert torch.equal(toks, ptoks)
    assert _rel(rows, prows) <= 1e-4


# -- the backbone trainer's explicit backwards and its step -------------------

def _grads_of(fn, *xs):
    leaves = [x.detach().clone().requires_grad_(True) for x in xs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(outs[0].device).manual_seed(9)
    loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                        device=o.device)).sum() for o in outs)
    return torch.autograd.grad(loss, leaves)


def _grad_gap(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().norm()) for a, b in zip(got, want))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 30.0)])
def test_flash_mha_backward_on_the_card(dev, window, cap):
    """The flash kernel's forward with the explicit backward against the
    plain scan's forward with the same backward: gradients within 1e-4
    of their norms; the kernel launches once."""
    from repro_torch.models.flash import flash_mha
    g = torch.Generator(dev).manual_seed(3)
    q = torch.randn(2, 96, 4, 64, generator=g, device=dev)
    k, v = (torch.randn(2, 96, 2, 64, generator=g, device=dev)
            for _ in range(2))
    n0 = flash_attention_cuda.launches
    got = _grads_of(lambda *a: flash_mha(*a, True, window, cap,
                                         kernel=True), q, k, v)
    assert flash_attention_cuda.launches - n0 == 1
    want = _grads_of(lambda *a: flash_mha(*a, True, window, cap), q, k, v)
    assert _grad_gap(got, want) <= 1e-4


def test_scan_backwards_on_the_card(dev):
    """The RG-LRU and RWKV6 scan entries' explicit backwards on the card
    against autograd of the plain scans: within 1e-4 of the norms; the
    RG-LRU's reverse scan launches its kernel."""
    from repro_torch.models import recurrent as R
    g = torch.Generator(dev).manual_seed(4)
    a = torch.rand(2, 64, 128, generator=g, device=dev) * 0.5 + 0.5
    b, h0 = (torch.randn(*s, generator=g, device=dev)
             for s in ((2, 64, 128), (2, 128)))
    n0 = rglru_scan_cuda.launches
    got = _grads_of(R.rglru_scan_kernel, a, b, h0)
    assert rglru_scan_cuda.launches - n0 == 2
    assert _grad_gap(got, _grads_of(rglru_scan_ref, a, b, h0)) <= 1e-4
    r, k, v = (0.5 * torch.randn(2, 64, 4, 32, generator=g, device=dev)
               for _ in range(3))
    logw = -torch.exp(torch.randn(2, 64, 4, 32, generator=g, device=dev)
                      - 1.0)
    u = 0.3 * torch.randn(4, 32, generator=g, device=dev)
    s0 = 0.2 * torch.randn(2, 4, 32, 32, generator=g, device=dev)
    ins = (r, k, v, logw, u, s0)
    got = _grads_of(R.rwkv6_scan_kernel, *ins)
    assert _grad_gap(got, _grads_of(rwkv6_scan_ref, *ins)) <= 1e-4


def test_backbone_train_step_on_the_card(dev):
    """Two train steps of a reduced recurrent config on the one-process
    mesh's default device (the card), kernel route against plain route:
    losses within 1e-5 at step 0 and 1e-3 at step 1."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.distributed.steps import (StepOptions,
                                               init_train_state,
                                               make_train_step)
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = get_smoke("recurrentgemma_9b")
    opts = StepOptions(lr=3e-3, warmup=0, total_steps=2)
    ds = SyntheticTokenDataset(DataConfig(vocab=cfg.vocab, seq_len=64,
                                          global_batch=2))
    losses = {}
    for plain in (False, True):
        step, _ = make_train_step(make_debug_mesh(1, 1), cfg, opts,
                                  plain=plain)
        state = init_train_state(cfg, opts,
                                 torch.Generator(dev).manual_seed(0))
        losses[plain] = []
        for i in range(2):
            batch = {k: torch.from_numpy(x).to(dev)
                     for k, x in ds.batch(i).items()}
            state, m = step(state, batch)
            losses[plain].append(float(m["loss"]))
    for i, tol in enumerate((1e-5, 1e-3)):
        assert abs(losses[False][i] - losses[True][i]) <= \
            tol * abs(losses[True][i])

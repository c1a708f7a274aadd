"""The port's band-staged average pooling (``csrc/avgpool.cu``) against the
JAX package, on the CPU, where the kernel itself cannot run.

- The band algorithm in plain torch (``avgpool_banded_ref``: the bands
  and column tiles exactly as ``avgpool_plan`` cuts them, each staged row's
  kw-tap sum, then each output's kh row sums, one division, one rounding)
  against JAX's ``avgpool_call(..., interpret=True)`` in f32 within the
  pooling's row (rtol 1e-5, atol 1e-6: the two orders of a kh·kw-term f32
  sum of O(1) values differ by a few ulps) and in bf16 and f16 within
  ``chip_smoke.py``'s one rounding step of the type, at a ragged last band,
  widths no multiple of 4 or 8, kh ≠ kw, H or W equal to the window,
  N·C = 1, widths that force column tiles, and the run-time windows.
- A control: the same walk with its halo rows staged as zeros fails those
  tolerances.
- ``avgpool_plan``: every output row and column lies in exactly one band
  and tile, each band's halo lies inside the plane, the staged band fits
  the shared-memory budget (a forced band height fits a block's 227 KB),
  the thread groups cover every row, and the Listing-3 shapes give at
  least 2 blocks per SM's worth of grid on 132 SMs.
- The kernel's index arithmetic, modelled here line by line for 16-byte
  vectors at every offset of x and y within a 16-byte line: every tap the
  walk reads holds the element it wants, no load leaves x, and every
  output element is stored once, by a store inside its band's span.
- The plan and the wrapper read nothing from the device.

Inputs are drawn from fixed numpy seeds.
"""
import inspect
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.avgpool.kernel import avgpool_call
from repro_torch.kernels.avgpool import kernel as apkernel
from repro_torch.kernels.avgpool.kernel import avgpool_plan
from repro_torch.kernels.avgpool.ref import avgpool_banded_ref, avgpool_ref

POOL_TOL = dict(rtol=1e-5, atol=1e-6)
# chip_smoke.py's HALF_TOL: (rtol, atol) of one rounding step of the type
HALF_TOL = {"bfloat16": dict(rtol=2.0 ** -7, atol=1e-4),
            "float16": dict(rtol=2.0 ** -10, atol=1e-4)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
SMS = 132

# (n, c, h, w, kh, kw, forced band height or 0 for the plan's own)
CASES = [
    (2, 3, 13, 37, 3, 3, 4),        # 11 rows in bands of 4: the last 3
    (2, 2, 11, 29, 2, 2, 3),        # 2x2, 10 rows in bands of 3
    (1, 3, 12, 19, 2, 3, 0),        # kh != kw, W no multiple of 4
    (2, 1, 9, 14, 3, 1, 0),         # kw 1
    (2, 2, 3, 9, 3, 3, 0),          # H equal to the window
    (2, 2, 10, 3, 3, 3, 0),         # W equal to the window
    (1, 1, 20, 23, 3, 3, 6),        # N·C = 1, bands of 6
    (1, 2, 12, 30, 5, 5, 0),        # run-time window 5x5
    (1, 2, 8, 31, 1, 7, 0),         # run-time window 1x7
    (1, 1, 7, 2100, 3, 3, 0),       # column tiles in every dtype
]


def _inputs(dtype, n, c, h, w):
    """The same numpy-seeded values in ``dtype`` for torch and JAX."""
    x = np.random.default_rng(n * 1000 + h * 10 + w).standard_normal(
        (n, c, h, w)).astype(np.float32)
    tx = torch.from_numpy(x).to(TORCH[dtype])
    return tx, jnp.asarray(tx.float().numpy()).astype(JAX[dtype])


def _agrees(got, want, dtype) -> bool:
    tol = POOL_TOL if dtype == "float32" else HALF_TOL[dtype]
    return np.allclose(got.float().numpy(),
                       np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", list(TORCH))
@pytest.mark.parametrize("n,c,h,w,kh,kw,rows", CASES)
def test_banded_matches_jax(n, c, h, w, kh, kw, rows, dtype):
    tx, jx = _inputs(dtype, n, c, h, w)
    plan = avgpool_plan(n, c, h, w, kh, kw, tx.element_size(), rows)
    got = avgpool_banded_ref(tx, kh, kw, plan)
    assert got.dtype == TORCH[dtype]
    assert got.shape == (n, c, h - kh + 1, w - kw + 1)
    want = avgpool_call(jx, kh, kw, interpret=True)
    assert want.dtype == JAX[dtype]
    assert _agrees(got, want, dtype)
    # and the listing's plain version, summed in the other order
    plain = avgpool_ref(tx, kh, kw)
    tol = POOL_TOL if dtype == "float32" else HALF_TOL[dtype]
    torch.testing.assert_close(got.float(), plain.float(), **tol)


@pytest.mark.parametrize("dtype", list(TORCH))
def test_wide_rows_take_column_tiles(dtype):
    """The widest case really cuts its rows into tiles, so the tests above
    walk a tiled plan in each dtype."""
    n, c, h, w, kh, kw, rows = CASES[-1]
    plan = avgpool_plan(n, c, h, w, kh, kw, TORCH[dtype].itemsize, rows)
    assert not plan.full and plan.tiles > 1


@pytest.mark.parametrize("dtype", list(TORCH))
@pytest.mark.parametrize("n,c,h,w,kh,kw,rows", [CASES[0], CASES[-1]])
def test_banded_without_its_halo_fails(n, c, h, w, kh, kw, rows, dtype):
    """Dropping the kh - 1 halo rows of each band changes its last outputs
    far beyond the tolerance: the comparison sees the staging fault."""
    tx, jx = _inputs(dtype, n, c, h, w)
    plan = avgpool_plan(n, c, h, w, kh, kw, tx.element_size(), rows)
    want = avgpool_call(jx, kh, kw, interpret=True)
    assert _agrees(avgpool_banded_ref(tx, kh, kw, plan), want, dtype)
    assert not _agrees(avgpool_banded_ref(tx, kh, kw, plan, halo=False),
                       want, dtype)


SHAPES = [(64, 32, 224, 224, 3, 3), (64, 64, 111, 111, 3, 3),
          (1, 2, 20, 5000, 3, 3), (70000, 1, 4, 4, 3, 3),
          (3, 5, 17, 45, 2, 2), (1, 1, 3, 3, 3, 3), (2, 3, 9, 40, 2, 3),
          (1, 1, 70, 33, 3, 1), (2, 3, 30, 40, 5, 5), (2, 3, 30, 40, 1, 7),
          (1, 1, 300, 1, 1, 1), (1, 1, 1, 300, 1, 1), (2, 2, 2000, 900, 7, 3)]


@pytest.mark.parametrize("rows", [0, 1, 5, 16, 64])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,c,h,w,kh,kw", SHAPES)
def test_plan_covers_every_output_once(n, c, h, w, kh, kw, itemsize, rows):
    p = avgpool_plan(n, c, h, w, kh, kw, itemsize, rows)
    oh, ow = h - kh + 1, w - kw + 1
    assert p.rows == (min(rows, oh) if rows else p.rows) >= 1
    starts_r = range(0, oh, p.rows)
    starts_c = range(0, ow, p.cols)
    assert len(starts_r) == p.bands and len(starts_c) == p.tiles
    covered_r = [r for r0 in starts_r for r in range(r0, min(oh, r0 + p.rows))]
    covered_c = [j for c0 in starts_c for j in range(c0, min(ow, c0 + p.cols))]
    assert covered_r == list(range(oh)) and covered_c == list(range(ow))
    # the halos lie inside the plane
    for r0 in starts_r:
        assert r0 + min(p.rows, oh - r0) + kh - 1 <= h
    for c0 in starts_c:
        assert c0 + min(p.cols, ow - c0) + kw - 1 <= w
    assert p.full == (p.cols == ow) and (p.tiles == 1) == p.full
    assert p.smem <= (apkernel.SMEM_MAX if rows else apkernel.SMEM_BUDGET) \
        or p.rows == 1
    assert p.smem <= apkernel.SMEM_MAX
    assert p.tx % 32 == 0 and p.tx * p.groups <= apkernel.MAX_THREADS
    assert p.groups * p.group_rows >= p.rows > (p.groups - 1) * p.group_rows
    assert p.tx * p.cols_per_thread >= p.cols > \
        p.tx * (p.cols_per_thread - 1)
    assert p.grid == (p.bands * p.tiles, min(n * c, 65535))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_fills_the_card_at_the_listing3_shapes(itemsize):
    """Both Listing-3 pools stage whole rows and give at least 2 blocks per
    SM's worth of grid, in bands of more than a few rows (the halo a small
    share of the reads)."""
    for shape in SHAPES[:2]:
        p = avgpool_plan(*shape, itemsize)
        assert p.full and p.grid[0] * p.grid[1] >= 2 * SMS
        assert p.rows >= 8


def test_plan_refuses_a_band_no_block_can_hold():
    with pytest.raises(ValueError):
        avgpool_plan(1, 1, 100_000, 64, 99_000, 3, 4)
    with pytest.raises(ValueError):
        avgpool_plan(1, 1, 4000, 4000, 3, 3, 4, rows=2000)


# ---------------------------------------------------------------------------
# the kernel's index arithmetic, modelled line by line
# ---------------------------------------------------------------------------

def _round_up(a, b):
    return -(-a // b) * b


def _shift(elem, base, itemsize):
    """``shift_of(p)``: p's element offset within its 16-byte line, for p
    at element ``elem`` of a tensor whose base lies ``base`` elements past
    a 16-byte line."""
    return ((base + elem) * itemsize % 16) // itemsize


def _stage_span(total, gs, ln, base, itemsize, dst, smem):
    """``stage_span``: fills ``smem`` (slot → element of x) from slot
    ``dst`` on and returns the elements it read."""
    ve = 16 // itemsize
    sh = _shift(gs, base, itemsize)
    nv = (sh + ln + ve - 1) // ve
    read = []
    for q in range(nv):
        g = gs - sh + q * ve
        vector = 0 < q < nv - 1 or (g >= 0 and g + ve <= total)
        if vector:      # a 16-byte copy: both ends aligned
            assert (base + g) * itemsize % 16 == 0 and (dst + q * ve) % ve == 0
        for k in range(ve):
            if vector or 0 <= g + k < total:
                smem[dst + q * ve + k] = g + k
                read.append(g + k)
    return read


def _store_span(gs, ln, base, itemsize, src, smem, written):
    """``store_span``: appends (element of y, what its slot holds) per
    element stored; asserts each store lies inside the span."""
    ve = 16 // itemsize
    sh = _shift(gs, base, itemsize)
    nv = (sh + ln + ve - 1) // ve
    for q in range(nv):
        lo = q * ve - sh
        vector = lo >= 0 and lo + ve <= ln
        if vector:
            assert (base + gs + lo) * itemsize % 16 == 0
            assert (src + q * ve) % ve == 0
        for k in range(ve):
            if vector or 0 <= lo + k < ln:
                assert 0 <= lo + k < ln
                written.append((gs + lo + k, smem[src + q * ve + k]))


def _model(n, c, h, w, kh, kw, itemsize, xb, yb, planes):
    """Run the model of every block of the first ``planes`` planes; x
    starts ``xb`` and y ``yb`` elements past a 16-byte line."""
    p = avgpool_plan(n, c, h, w, kh, kw, itemsize)
    oh, ow = h - kh + 1, w - kw + 1
    ve = 16 // itemsize
    total = n * c * h * w
    full = p.cols >= ow
    in_step = w if full else apkernel._row_step(p.cols + kw - 1, w, ve)
    out_step = ow if full else apkernel._row_step(p.cols, ow, ve)
    in_elems = _round_up((p.rows + kh - 1) * in_step + ve - 1, ve)
    out_elems = _round_up(p.rows * out_step + ve - 1, ve)
    written = []
    for pl in range(planes):
        for bx in range(p.bands * p.tiles):
            band, tile = bx % p.bands, bx // p.bands
            r0, c0 = band * p.rows, tile * p.cols
            rows, ocw = min(p.rows, oh - r0), min(p.cols, ow - c0)
            rin = rows + kh - 1
            gin = pl * h * w + r0 * w + c0
            gout = pl * oh * ow + r0 * ow + c0
            in_sh, out_sh = _shift(gin, xb, itemsize), _shift(gout, yb,
                                                              itemsize)
            xs, ys = {}, {}
            if full:
                read = _stage_span(total, gin, rin * w, xb, itemsize, 0, xs)
            else:
                read = []
                for r in range(rin):
                    g = gin + r * w
                    dst = in_sh + r * in_step - _shift(g, xb, itemsize)
                    assert dst >= 0
                    read += _stage_span(total, g, ocw + kw - 1, xb, itemsize,
                                        dst, xs)
            assert all(0 <= e < total for e in read)
            assert all(0 <= slot < in_elems for slot in xs)
            for i in range(rows):
                for j in range(ocw):
                    for k1 in range(kh):
                        for k2 in range(kw):
                            assert xs[in_sh + (i + k1) * in_step + j + k2] \
                                == gin + (i + k1) * w + j + k2
                    ys[out_sh + i * out_step + j] = gout + i * ow + j
            assert all(0 <= slot < out_elems for slot in ys)
            if full:
                _store_span(gout, rows * ow, yb, itemsize, 0, ys, written)
            else:
                for i in range(rows):
                    g = gout + i * ow
                    _store_span(g, ocw, yb, itemsize,
                                out_sh + i * out_step - _shift(g, yb, itemsize),
                                ys, written)
    # every output stored once, from the slot that holds it
    assert sorted(e for e, _ in written) == list(range(planes * oh * ow))
    assert all(e == slot for e, slot in written)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,c,h,w,kh,kw", [
    (2, 1, 11, 29, 3, 3), (1, 2, 13, 111, 3, 3), (1, 1, 7, 2100, 3, 3),
    (2, 2, 5, 7, 2, 2), (3, 1, 4, 4, 3, 3), (1, 2, 9, 13, 1, 7)])
def test_kernel_index_model_stages_and_stores_every_element(n, c, h, w, kh,
                                                            kw, itemsize):
    for xb in range(16 // itemsize):
        _model(n, c, h, w, kh, kw, itemsize, xb, (3 * xb + 1) % (
            16 // itemsize), planes=n * c)


def test_plan_and_wrapper_read_nothing_from_the_device():
    """The plan takes integers only; the wrapper makes no host read of a
    device tensor (each would add a sync to every forward)."""
    sig = inspect.signature(avgpool_plan)
    assert all(p.annotation in (int, "int") for p in sig.parameters.values())
    src = inspect.getsource(apkernel.avgpool_cuda)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", ".max()",
                 ".any(", ".all(", "bool("):
        assert call not in src


def test_wrapper_raises_on_cpu_tensors():
    with pytest.raises(ValueError):
        apkernel.avgpool_cuda(torch.zeros(1, 2, 5, 5), 3, 3, rows=2)

"""The port's two attention kernels' algorithms against the JAX package, on
the CPU, where the kernels themselves cannot run.

- The split-KV decode (``csrc/decode_attention.cu``): its algorithm in
  plain torch (``decode_attention_split_ref``: per-split f32 partials
  (m, l, acc), merged in split order, the step's own pair folded in last)
  against JAX's ``decode_attention_call(..., interpret=True)`` in f32 at
  1e-5, for one split, two, three and one per cache row, with lens 0,
  partial and full, a window that starts inside a split, and a softcap.
  With lens 0 the output is exactly v_new.
- ``decode_plan``, which cuts the cache into splits from the shapes alone:
  every cache row lies in exactly one split, the serve's shapes give at
  least 64 blocks, and neither the plan nor the wrapper reads a tensor.
- The tensor-core flash kernel's rounding points (``csrc/flash_attention.cu``),
  emulated in torch: the scale applied to the f32 scores, 64-key tiles
  with an online softmax, and P split as P_hi + P_lo in the storage type
  for the P·V products.  Held against JAX's ``flash_attention_call(...,
  interpret=True)`` on the same bf16 or f16 inputs within
  ``chip_smoke.py``'s half-precision rule: one rounding step of the type
  (|got - want| <= rtol |want| + atol, rtol 2^-7 for bf16 and 2^-10 for
  f16, atol 1e-4).

Inputs are drawn from fixed numpy seeds; nothing here is random between
runs.
"""
import inspect
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_call
from repro.kernels.flash_attention.kernel import flash_attention_call
from repro_torch.kernels.decode_attention import kernel as dkernel
from repro_torch.kernels.decode_attention.kernel import (MAX_SPLITS,
                                                         decode_plan,
                                                         tile_rows)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)

# chip_smoke.py's HALF_TOL: (rtol, atol) of one rounding step of the type
HALF_TOL = {"bfloat16": (2.0 ** -7, 1e-4), "float16": (2.0 ** -10, 1e-4)}
TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}
JAX = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# split-KV decode
# ---------------------------------------------------------------------------

DECODE_S = 24


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (0, 4.0),
                                        (5, 3.0)])
@pytest.mark.parametrize("chunk", [DECODE_S, 12, 8, 1])   # 1, 2, 3, S splits
def test_split_decode_matches_jax(chunk, window, cap):
    """lens 0 (batch padding), partial, full; with chunk 8 and lens 17 a
    window of 5 or 6 starts inside the third split."""
    rng = np.random.default_rng(7 + chunk + window)
    b, h, kv, hd = 4, 6, 2, 16
    q = _rand(rng, b, h, hd)
    k, v = _rand(rng, b, kv, DECODE_S, hd), _rand(rng, b, kv, DECODE_S, hd)
    kn, vn = _rand(rng, b, kv, hd), _rand(rng, b, kv, hd)
    lens = np.array([0, 5, 17, DECODE_S], np.int32)
    got = decode_attention_split_ref(
        *(torch.from_numpy(a) for a in (q, k, v, kn, vn, lens)), chunk=chunk,
        window=window, cap=cap)
    want = decode_attention_call(*(jnp.asarray(a) for a in (q, k, v, kn, vn,
                                                           lens)),
                                 bk=8, window=window, cap=cap, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert math.ceil(DECODE_S / chunk) == len(range(0, DECODE_S, chunk))
    # lens 0 attends only the step's own pair: exactly v_new
    assert torch.equal(got[0], torch.from_numpy(vn[0]).repeat_interleave(
        h // kv, 0))


@pytest.mark.parametrize("chunk", [DECODE_S, 8, 1])
def test_split_decode_matches_the_plain_version(chunk):
    """The split algorithm and the one-pass plain version agree in f32 on
    the port's own layouts."""
    g = torch.Generator().manual_seed(chunk)
    b, h, kv, hd = 3, 4, 1, 32
    q = torch.randn(b, h, hd, generator=g)
    k, v = (torch.randn(b, kv, DECODE_S, hd, generator=g) for _ in range(2))
    kn, vn = (torch.randn(b, kv, hd, generator=g) for _ in range(2))
    lens = torch.tensor([0, 11, DECODE_S], dtype=torch.int32)
    torch.testing.assert_close(
        decode_attention_split_ref(q, k, v, kn, vn, lens, chunk=chunk,
                                   window=9, cap=2.0),
        decode_attention_ref(q, k, v, kn, vn, lens, window=9, cap=2.0),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# decode_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("cache", [0, 1, 7, 64, 128, 256, 1000, 4096,
                                   100_000])
def test_decode_plan_covers_every_cache_row_once(cache, hd, itemsize):
    rows = tile_rows(hd, itemsize)
    for b, kv, sms in ((4, 2, 132), (1, 1, 132), (64, 8, 132), (4, 2, 1),
                       (4, 2, 10_000)):
        p = decode_plan(b, kv, cache, hd, itemsize, sms)
        assert 1 <= p.splits <= MAX_SPLITS
        assert p.chunk % rows == 0 and p.chunk >= rows
        assert p.splits * p.chunk >= cache            # every row in a split
        assert (p.splits - 1) * p.chunk < max(cache, 1)   # no empty tail
        assert p.grid == (p.splits, kv, b)
        if sms == 1:
            assert p.splits == 1


@pytest.mark.parametrize("itemsize", [4, 2])
def test_decode_plan_fills_the_card_at_the_serve_shapes(itemsize):
    """B 4, KV 2, cache 128, hd 128 on 132 SMs: more than B·KV blocks, at
    least 64."""
    p = decode_plan(4, 2, 128, 128, itemsize, 132)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    assert blocks >= 64 and blocks > 4 * 2


def test_decode_plan_and_wrapper_read_nothing_from_the_device():
    """The plan takes integers only; the wrapper makes no host read of a
    device tensor (each would add a sync to every decode step)."""
    sig = inspect.signature(decode_plan)
    assert all(p.annotation in (int, "int") for p in sig.parameters.values())
    src = inspect.getsource(dkernel.decode_attention_cuda)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(lens",
                 ".max()"):
        assert call not in src


# ---------------------------------------------------------------------------
# the flash kernel's rounding points
# ---------------------------------------------------------------------------

def flash_tiles_emulated(q, k, v, bkv=64, split_p=True):
    """causal attention with the 16-bit tensor-core kernel's rounding
    points: q, k, v (B, H, S, hd) in the storage type T (KV = 1 here);
    scores as exact products summed in f32, scaled in f32; an online
    softmax over ``bkv``-key tiles in f32; P·V as P_hi V + P_lo V with
    P_hi = T(P), P_lo = T(P - P_hi) (``split_p``; else P_hi V alone); o
    rounded once to T."""
    dt = q.dtype
    b, h, s, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, h, s, 1), -math.inf)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, bkv):
        kt, vt = kf[:, :, k0:k0 + bkv], vf[:, :, k0:k0 + bkv]
        sc = (qf @ kt.transpose(-1, -2)) * scale
        keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
        sc = torch.where(rows >= keys, sc, torch.full_like(sc, -math.inf))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        p_hi = p.to(dt).float()
        acc = acc * corr + p_hi @ vt
        if split_p:
            acc = acc + (p - p_hi).to(dt).float() @ vt
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l).to(dt)


def _within_one_step(got, want, dtype):
    rtol, atol = HALF_TOL[dtype]
    g, w = got.float(), want.float()
    return float(((g - w).abs() - rtol * w.abs()).max()) <= atol


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("split_p", [True, False])
def test_flash_rounding_points_match_jax(s, dtype, split_p):
    """P as P_hi + P_lo stays within one rounding step of JAX; P rounded
    once to the storage type (one 16-bit product) does not, on the same
    inputs: why the kernel takes two."""
    rng = np.random.default_rng(s)
    b, h, kv, hd = 1, 2, 1, 128
    q, k, v = _rand(rng, b, h, s, hd), _rand(rng, b, kv, s, hd), \
        _rand(rng, b, kv, s, hd)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v))
    want = flash_attention_call(*(jnp.asarray(a).astype(JAX[dtype])
                                  for a in (q, k, v)), causal=True,
                                interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = flash_tiles_emulated(tq, tk.expand(b, h, s, hd),
                               tv.expand(b, h, s, hd), split_p=split_p)
    assert got.dtype == TORCH[dtype]
    assert _within_one_step(got, want, dtype) == split_p

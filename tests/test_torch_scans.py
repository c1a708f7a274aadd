"""The port's two chunked scans' algorithms against the JAX package, on the
CPU, where the kernels themselves cannot run.

- The chunked RWKV6 scan (``csrc/rwkv6_scan.cu``): its algorithm in plain
  torch (``rwkv6_scan_chunked_ref``: each chunk's own state and decay
  from a zero state, the carry in chunk order, each chunk walked again
  from its incoming state) against JAX's ``rwkv6_scan_call(...,
  interpret=True)`` and the per-step plain version, in f32 within
  README's scan row (rtol 1e-4, atol 1e-5), for chunks of 1, 2, 3 and 16
  steps and one chunk of all of T, at T a multiple of the chunk and
  ragged, from a nonzero state, with random log decays and with log
  decays of 0 and -50 over several chunks.
- The chunked RG-LRU scan (``csrc/rglru_scan.cu``,
  ``rglru_scan_chunked_ref``: each chunk's local state and decay product
  from zero, the carry in chunk order, each chunk walked again) against
  JAX's ``rglru_scan_call(..., interpret=True)`` and the plain version in
  the same way, with random decays and with decays of 0 and 1.
- Both in bf16 and f16 against the JAX kernels on the same half-precision
  inputs, within ``chip_smoke.py``'s half-precision rule: one rounding
  step of the type (|got - want| <= rtol |want| + atol, rtol 2^-7 for
  bf16 and 2^-10 for f16, atol 1e-4).
- A control: either algorithm with the carry dropped (every chunk from a
  zero state) fails those tolerances, so the tests see the one fault the
  chunking can bring.
- ``rwkv6_plan`` and ``rglru_plan``, which cut T (and the channels) from
  the shapes alone: every step lies in exactly one chunk, the RWKV6 and
  Griffin shapes give at least 4 blocks per SM on 132 SMs, the staged
  RWKV6 tile fits a block's shared memory at every head dim, and neither
  the plans nor the wrappers read a tensor.

Inputs are drawn from fixed numpy seeds; nothing here is random between
runs.
"""
import functools
import inspect
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.kernel import rglru_scan_call
from repro.kernels.rwkv6_scan.kernel import rwkv6_scan_call
from repro_torch.kernels.rglru_scan import kernel as rgkernel
from repro_torch.kernels.rglru_scan.kernel import rglru_plan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_chunked_ref,
                                                rglru_scan_ref)
from repro_torch.kernels.rwkv6_scan import kernel as rwkernel
from repro_torch.kernels.rwkv6_scan.kernel import (head_threads, max_tile,
                                                   rwkv6_plan, stage_bytes)
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_chunked_ref,
                                                rwkv6_scan_ref)

SCAN_TOL = dict(rtol=1e-4, atol=1e-5)     # README: rglru/rwkv6 f32 row
# chip_smoke.py's HALF_TOL: (rtol, atol) of one rounding step of the type
HALF_TOL = {"bfloat16": (2.0 ** -7, 1e-4), "float16": (2.0 ** -10, 1e-4)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
SMEM_PER_BLOCK = 232_448        # H100: 227 KB of shared memory a block
SMS = 132

B, H, HD, D = 2, 2, 8, 24
LENGTHS = (7, 40, 70)
CHUNKS = (1, 2, 3, 16, "T")             # "T": one chunk of all of T


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=SCAN_TOL) -> bool:
    return np.allclose(np.asarray(got, np.float32),
                       np.asarray(want, np.float32), **tol)


def _within_one_step(got, want, dtype) -> bool:
    rtol, atol = HALF_TOL[dtype]
    g, w = (torch.as_tensor(np.asarray(x, np.float32)) for x in (got, want))
    return float(((g - w).abs() - rtol * w.abs()).max()) <= atol


def _jax_out(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# inputs and the JAX kernels' outputs, made once per case
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rwkv6_case(t: int, decays: str, dtype: str = "float32"):
    """(inputs as numpy f32 rounded to ``dtype``, JAX kernel's (o, s_last)
    in f32).  ``decays``: "random" log decays in (-e^0.5, 0) as the
    modules draw them, or "extremes", 0 (no decay) and -50 (exp
    underflows to 0), each over several chunks."""
    rng = np.random.default_rng(t + (100 if decays == "extremes" else 0))
    r, k, v = (_rand(rng, B, t, H, HD) * 0.5 for _ in range(3))
    if decays == "extremes":
        logw = np.where(rng.random((B, t, H, HD)) < 0.5, 0.0,
                        -50.0).astype(np.float32)
    else:
        logw = -np.exp(_rand(rng, B, t, H, HD) * 0.5 - 1.0)
    u, s0 = _rand(rng, H, HD) * 0.5, _rand(rng, B, H, HD, HD) * 0.5
    jins = [jnp.asarray(a).astype(JAX[dtype]) for a in (r, k, v, logw, u,
                                                        s0)]
    o, s_last = rwkv6_scan_call(*jins, interpret=True)
    return [_jax_out(a) for a in jins], _jax_out(o), _jax_out(s_last)


@functools.lru_cache(maxsize=None)
def rglru_case(t: int, decays: str, dtype: str = "float32"):
    """As ``rwkv6_case``: "random" decays a in (0.5, 0.999), or
    "extremes", a of 0 (the state is reset) and 1 (no decay)."""
    rng = np.random.default_rng(t + (200 if decays == "extremes" else 300))
    if decays == "extremes":
        a = np.where(rng.random((B, t, D)) < 0.5, 0.0, 1.0)
    else:
        a = rng.uniform(0.5, 0.999, (B, t, D))
    x, h0 = _rand(rng, B, t, D), _rand(rng, B, D)
    jins = [jnp.asarray(np.asarray(y, np.float32)).astype(JAX[dtype])
            for y in (a, x, h0)]
    h, h_last = rglru_scan_call(*jins, bd=8, interpret=True)
    return [_jax_out(y) for y in jins], _jax_out(h), _jax_out(h_last)


def _torch(ins, dtype):
    return [torch.from_numpy(a).to(TORCH[dtype]) for a in ins]


def _chunk(c, t):
    return max(t, 1) if c == "T" else c


# ---------------------------------------------------------------------------
# f32: the chunked algorithms against JAX and the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decays", ["random", "extremes"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("t", LENGTHS)
def test_rwkv6_chunked_matches_jax(t, chunk, decays):
    ins, want_o, want_s = rwkv6_case(t, decays)
    tins = _torch(ins, "float32")
    o, s_last = rwkv6_scan_chunked_ref(*tins, chunk=_chunk(chunk, t))
    assert o.dtype == torch.float32 and s_last.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), want_o, **SCAN_TOL)
    np.testing.assert_allclose(s_last.numpy(), want_s, **SCAN_TOL)
    plain_o, plain_s = rwkv6_scan_ref(*tins)
    torch.testing.assert_close(o, plain_o, **SCAN_TOL)
    torch.testing.assert_close(s_last, plain_s, **SCAN_TOL)


@pytest.mark.parametrize("decays", ["random", "extremes"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("t", LENGTHS)
def test_rglru_chunked_matches_jax(t, chunk, decays):
    ins, want_h, want_last = rglru_case(t, decays)
    tins = _torch(ins, "float32")
    h, h_last = rglru_scan_chunked_ref(*tins, chunk=_chunk(chunk, t))
    np.testing.assert_allclose(h.numpy(), want_h, **SCAN_TOL)
    np.testing.assert_allclose(h_last.numpy(), want_last, **SCAN_TOL)
    plain_h, plain_last = rglru_scan_ref(*tins)
    torch.testing.assert_close(h, plain_h, **SCAN_TOL)
    torch.testing.assert_close(h_last, plain_last, **SCAN_TOL)
    # the kernel's h_last is the last step's h as stored
    assert torch.equal(h_last, h[:, -1])


@pytest.mark.parametrize("chunk", [1, 16])
def test_chunked_scans_at_t_0_return_the_incoming_state(chunk):
    """An empty T returns s0 (f32) and h0 as the last state."""
    rng = np.random.default_rng(0)
    r = torch.zeros(B, 0, H, HD)
    s0 = torch.from_numpy(_rand(rng, B, H, HD, HD))
    o, s_last = rwkv6_scan_chunked_ref(r, r, r, r, torch.zeros(H, HD),
                                       s0.to(torch.bfloat16), chunk=chunk)
    assert o.shape == r.shape and s_last.dtype == torch.float32
    assert torch.equal(s_last, s0.to(torch.bfloat16).float())
    h0 = torch.from_numpy(_rand(rng, B, D))
    a = torch.zeros(B, 0, D)
    h, h_last = rglru_scan_chunked_ref(a, a, h0, chunk=chunk)
    assert h.shape == a.shape and torch.equal(h_last, h0)


# ---------------------------------------------------------------------------
# bf16 and f16: within one rounding step of the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("chunk", [3, 16])
@pytest.mark.parametrize("decays", ["random", "extremes"])
def test_rwkv6_chunked_half_matches_jax(decays, chunk, dtype):
    ins, want_o, want_s = rwkv6_case(40, decays, dtype)
    o, s_last = rwkv6_scan_chunked_ref(*_torch(ins, dtype),
                                       chunk=chunk)
    assert o.dtype == TORCH[dtype] and s_last.dtype == torch.float32
    assert _within_one_step(o.float(), want_o, dtype)
    np.testing.assert_allclose(s_last.numpy(), want_s, **SCAN_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("chunk", [3, 16])
@pytest.mark.parametrize("decays", ["random", "extremes"])
def test_rglru_chunked_half_matches_jax(decays, chunk, dtype):
    ins, want_h, want_last = rglru_case(40, decays, dtype)
    h, h_last = rglru_scan_chunked_ref(*_torch(ins, dtype), chunk=chunk)
    assert h.dtype == h_last.dtype == TORCH[dtype]
    assert _within_one_step(h.float(), want_h, dtype)
    assert _within_one_step(h_last.float(), want_last, dtype)


# ---------------------------------------------------------------------------
# the control: with the carry dropped, the same checks fail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rwkv6_without_the_carry_fails(dtype):
    ins, want_o, want_s = rwkv6_case(40, "random", dtype)
    tins = _torch(ins, dtype)
    got = rwkv6_scan_chunked_ref(*tins, chunk=16)
    dropped = rwkv6_scan_chunked_ref(*tins, chunk=16, carry=False)
    for (o, s_last), ok in ((got, True), (dropped, False)):
        if dtype == "float32":
            assert _close(o.numpy(), want_o) == ok
        else:
            assert _within_one_step(o.float(), want_o, dtype) == ok
        assert _close(s_last.numpy(), want_s) == ok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rglru_without_the_carry_fails(dtype):
    ins, want_h, want_last = rglru_case(40, "random", dtype)
    tins = _torch(ins, dtype)
    got = rglru_scan_chunked_ref(*tins, chunk=16)
    dropped = rglru_scan_chunked_ref(*tins, chunk=16, carry=False)
    for (h, h_last), ok in ((got, True), (dropped, False)):
        if dtype == "float32":
            assert _close(h.numpy(), want_h) == ok
            assert _close(h_last.numpy(), want_last) == ok
        else:
            assert _within_one_step(h.float(), want_h, dtype) == ok
            assert _within_one_step(h_last.float(), want_last, dtype) == ok


# ---------------------------------------------------------------------------
# rwkv6_plan and rglru_plan
# ---------------------------------------------------------------------------

SHAPES_BH = ((4, 32), (1, 2), (1, 1), (64, 32), (2, 3))


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hd", [8, 16, 40, 64, 128])
@pytest.mark.parametrize("t", [0, 1, 15, 16, 17, 63, 64, 65, 300, 512,
                               4096])
def test_rwkv6_plan_covers_every_step_once(t, hd, itemsize):
    for (b, h), sms in [(bh, s) for bh in SHAPES_BH
                        for s in (SMS, 1, 10_000)]:
        p = rwkv6_plan(b, t, h, hd, itemsize, sms)
        steps = [s for c in range(p.chunks)
                 for s in range(c * p.chunk, min(t, (c + 1) * p.chunk))]
        assert steps == list(range(t))          # each step in one chunk
        assert (p.chunks - 1) * p.chunk < max(t, 1)     # no empty chunk
        assert p.grid == (p.chunks, h, b)
        assert p.tile % 16 == 0 and 16 <= p.tile <= max_tile(hd)
        assert p.tile <= 16 * -(-p.chunk // 16)         # no idle tile rows
        if p.chunks > 1:
            assert p.chunk % 16 == 0 and p.chunk <= rwkernel.MAX_CHUNK
        if b * h >= 4 * sms or t <= max_tile(hd):
            assert p.chunks == 1
        assert p.threads == head_threads(hd) >= hd
        assert p.workspace == b * h * (p.chunks - 1) * hd * (hd + 1)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [1, 3, 24, 130, 4096])
@pytest.mark.parametrize("t", [0, 1, 7, 8, 9, 127, 128, 129, 300, 512])
def test_rglru_plan_covers_every_step_once(t, d, itemsize):
    for b, sms in ((4, SMS), (1, SMS), (64, SMS), (4, 1), (4, 10_000)):
        p = rglru_plan(b, t, d, itemsize, sms)
        span = p.chunks * p.chunk
        steps = [t0 + c * p.chunk + s for t0 in range(0, t, span)
                 for c in range(p.chunks) for s in range(p.chunk)
                 if t0 + c * p.chunk + s < t]
        assert steps == list(range(t))          # each step in one chunk
        assert p.chunks <= rgkernel.MAX_CHUNKS
        assert p.chunks == p.warps * (32 // p.lanes)
        assert p.channels == p.lanes * rgkernel.VEC
        assert p.grid[0] * p.channels >= d > (p.grid[0] - 1) * p.channels
        assert p.grid[1] == b
        if t:           # no tile holds a warp of chunks past T only
            assert (p.warps - 1) * (32 // p.lanes) * p.chunk < t


@pytest.mark.parametrize("itemsize", [4, 2])
def test_scan_plans_fill_the_card_at_the_path_shapes(itemsize):
    """On 132 SMs, RWKV6-1.6B's scan (B 4, T 512, H 32, hd 64) gives at
    least 4 blocks per SM; Griffin's (B 4, T 512, D 4096) at least 2
    blocks and 15 warps per SM, its rows 8 lanes wide (128 bytes in f32:
    they read faster on the card than 4-lane rows in twice the blocks)."""
    p = rwkv6_plan(4, 512, 32, 64, itemsize, SMS)
    assert p.chunks > 1 and p.grid[0] * p.grid[1] * p.grid[2] >= 4 * SMS
    g = rglru_plan(4, 512, 4096, itemsize, SMS)
    blocks = g.grid[0] * g.grid[1]
    assert blocks >= 2 * SMS and blocks * g.warps >= 15 * SMS
    assert g.lanes == 8 and g.chunks > 1


@pytest.mark.parametrize("hd", [8, 32, 40, 64, 100, 128])
def test_rwkv6_staged_tile_fits_shared_memory(hd):
    """The output pass's staged tile (f32 whatever the storage type)
    fits a block's 227 KB, at hd 128 too, and every plan's does."""
    n = head_threads(hd)
    assert stage_bytes(max_tile(hd), n) <= SMEM_PER_BLOCK
    for t in (1, 300, 512, 100_000):
        for b, h in SHAPES_BH:
            assert rwkv6_plan(b, t, h, hd, 4, SMS).smem <= SMEM_PER_BLOCK


def test_scan_plans_and_wrappers_read_nothing_from_the_device():
    """The plans take integers only; the wrappers make no host read of a
    device tensor (each would add a sync to every forward)."""
    for plan in (rwkv6_plan, rglru_plan):
        sig = inspect.signature(plan)
        assert all(p.annotation in (int, "int")
                   for p in sig.parameters.values())
    for fn in (rwkernel.rwkv6_scan_cuda, rgkernel.rglru_scan_cuda):
        src = inspect.getsource(fn)
        for call in (".item(", ".tolist(", ".cpu(", ".numpy(", ".max()",
                     ".any(", ".all(", "bool("):
            assert call not in src


def test_scan_wrappers_raise_on_cpu_tensors():
    with pytest.raises(ValueError):
        rgkernel.rglru_scan_cuda(torch.zeros(2, 4, 8), torch.zeros(2, 4, 8),
                                 torch.zeros(2, 8))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        rwkernel.rwkv6_scan_cuda(q, q, q, q, torch.zeros(2, 8),
                                 torch.zeros(1, 2, 8, 8))

"""The backbone's layers and recurrent blocks in the port held to the JAX
package's, on the CPU.

Each function of ``repro_torch.models.layers`` (norms, softcap, RoPE,
direct, chunked and flash attention with GQA, windows and softcaps, decode
attention at several positions, the projections, the FFNs and the dense
MoE) and the recurrent blocks of ``repro_torch.models.recurrent`` (the
causal conv, the Griffin block's sequence and step forms, RWKV6's time mix
with a carried state and its step, the channel mix) run on the same numpy
inputs, from a seed, as their ``repro.models`` counterparts.  Tolerances,
relative to the reference's scale: f32 1e-5; RWKV6 1e-4 (README's
conformance table).  On the CPU the kernel route takes each kernel's plain
version, so both routes are held here.  Also: ``attention_route`` on the
cases of its contract, and the serve steps' mesh rule.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import backbone as JB
from repro.models import flash as JF
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro_torch.configs import get_config, get_smoke
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed import steps as TS
from repro_torch.frontends.offload import NoDeviceError
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import backbone as TB
from repro_torch.models import flash as TF
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR

F32_TOL = 1e-5
RWKV_TOL = 1e-4
KEY = jax.random.PRNGKey(0)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def close(got, want, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|Δ| {err:.3g} > {tol} × {scale:.3g}"


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _params(jtree):
    """A JAX parameter dict as numpy-backed tensors, leaf for leaf."""
    return {k: (_params(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, dtype=np.float32)))
            for k, v in jtree.items()}


def _block(arch, kind_key="pos0", m=0):
    """A reduced config and one macro block's parameters of it, from the
    JAX package's init (f32)."""
    cfg = jget_smoke(arch)
    p = JB.init_params(cfg, KEY)["macro"][kind_key]
    return cfg, jax.tree.map(lambda x: x[m], p)


# ---------------------------------------------------------------------------
# norms, softcap, RoPE
# ---------------------------------------------------------------------------

def test_norms_and_softcap():
    r = _rng(1)
    x = r.standard_normal((2, 5, 24)).astype(np.float32) * 3
    g = r.standard_normal(24).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    tx, tg, tb = _t(x, g, b)
    close(TL.rmsnorm(tx, tg), JL.rmsnorm(x, g))
    close(TL.layernorm(tx, tg, tb), JL.layernorm(x, g, b))
    close(TL.apply_norm("layernorm", tx, {"gain": tg, "bias": tb}),
          JL.apply_norm("layernorm", x, {"gain": g, "bias": b}))
    close(TL.apply_norm("rmsnorm", tx, {"gain": tg}),
          JL.apply_norm("rmsnorm", x, {"gain": g}))
    for cap in (1.0, 30.0, 50.0):
        close(TL.softcap(tx * 20, cap), JL.softcap(x * 20, cap))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    r = _rng(2)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    close(TL.rope_freqs(16, theta), JL.rope_freqs(16, theta))
    pos = np.arange(7)
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          JL.apply_rope(x, jnp.asarray(pos), theta))
    # a decode position, and per-sequence positions
    one = x[:, :1]
    close(TL.apply_rope(torch.from_numpy(one), torch.tensor([123]), theta),
          JL.apply_rope(one, jnp.asarray([123]), theta))
    bpos = np.stack([np.arange(7), np.arange(7) + 40])
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(bpos), theta),
          JL.apply_rope(x, jnp.asarray(bpos), theta))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (h, kv, causal, window, cap)
    (4, 4, True, 0, 0.0), (4, 2, True, 0, 0.0), (4, 1, True, 5, 0.0),
    (6, 2, True, 0, 30.0), (4, 2, True, 4, 50.0), (4, 4, False, 0, 0.0)]


def _qkv(b, sq, skv, h, kv, hd, seed=3):
    r = _rng(seed)
    return (r.standard_normal((b, sq, h, hd)).astype(np.float32),
            r.standard_normal((b, skv, kv, hd)).astype(np.float32),
            r.standard_normal((b, skv, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("h,kv,causal,window,cap", ATTN_CASES)
def test_attention_direct_chunked_and_kernel_route(h, kv, causal, window,
                                                   cap):
    q, k, v = _qkv(2, 12, 12, h, kv, 16)
    want = JL.multihead_attention(q, k, v, causal=causal, window=window,
                                  cap=cap)
    tq, tk, tv = _t(q, k, v)
    close(TL.multihead_attention(tq, tk, tv, causal=causal, window=window,
                                 cap=cap), want)
    # the kernel route (on the CPU: the flash kernel's plain version)
    close(TL.multihead_attention(tq, tk, tv, causal=causal, window=window,
                                 cap=cap, route="kernel"), want)
    pos = np.arange(12)
    kw = dict(causal=causal, window=window, cap=cap)
    close(TL._chunked_attention(tq, tk, tv, q_pos=torch.from_numpy(pos),
                                kv_pos=torch.from_numpy(pos), chunk=5, **kw),
          JL._chunked_attention(q, k, v, q_pos=jnp.asarray(pos),
                                kv_pos=jnp.asarray(pos), chunk=5, **kw))
    close(TL._direct_attention(tq, tk, tv, q_pos=torch.from_numpy(pos),
                               kv_pos=torch.from_numpy(pos), **kw),
          JL._direct_attention(q, k, v, q_pos=jnp.asarray(pos),
                               kv_pos=jnp.asarray(pos), **kw))


def test_attention_at_explicit_positions_and_cross():
    """Queries at later positions than their keys (a chunk of a longer
    sequence), and non-causal cross attention of unequal lengths."""
    q, k, v = _qkv(1, 5, 9, 4, 2, 8, seed=4)
    qp, kp = np.arange(4, 9), np.arange(9)
    tq, tk, tv = _t(q, k, v)
    for window in (0, 3):
        close(TL.multihead_attention(
            tq, tk, tv, causal=True, window=window,
            q_pos=torch.from_numpy(qp), kv_pos=torch.from_numpy(kp)),
            JL.multihead_attention(q, k, v, causal=True, window=window,
                                   q_pos=jnp.asarray(qp),
                                   kv_pos=jnp.asarray(kp)))
    close(TL.multihead_attention(tq, tk, tv, causal=False),
          JL.multihead_attention(q, k, v, causal=False))
    with pytest.raises(ValueError, match="itself"):
        TL.multihead_attention(tq, tk, tv, route="kernel")


def test_long_attention_takes_the_flash_scan():
    """Past ATTN_CHUNK_THRESHOLD keys the natural layout takes flash_mha's
    chunked scan, a chunk of keys at a time, in both packages."""
    s = TL.ATTN_CHUNK_THRESHOLD + 60
    q, k, v = _qkv(1, s, s, 2, 1, 8, seed=5)
    tq, tk, tv = _t(q, k, v)
    close(TL.multihead_attention(tq, tk, tv, window=700, cap=20.0),
          JL.multihead_attention(q, k, v, window=700, cap=20.0))
    close(TF.flash_mha(tq[:, :300], tk[:, :300], tv[:, :300], True, 0, 0.0,
                       128),
          JF.flash_mha(q[:, :300], k[:, :300], v[:, :300], True, 0, 0.0,
                       128))


@pytest.mark.parametrize("pos", [0, 1, 6, 15])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (4, 0.0), (0, 50.0),
                                        (6, 30.0)])
def test_decode_attention_plain_and_kernel_route(pos, window, cap):
    """Plain decode over the written cache, and the decode kernel's entry
    over the cache before the write with the step's own (k, v), equal
    JAX's decode attention."""
    r = _rng(6)
    b, s, h, kv, hd = 2, 16, 4, 2, 16
    q = r.standard_normal((b, 1, h, hd)).astype(np.float32)
    kc = r.standard_normal((b, s, kv, hd)).astype(np.float32)
    vc = r.standard_normal((b, s, kv, hd)).astype(np.float32)
    kn = r.standard_normal((b, 1, kv, hd)).astype(np.float32)
    vn = r.standard_normal((b, 1, kv, hd)).astype(np.float32)
    kw, vw = kc.copy(), vc.copy()
    kw[:, pos], vw[:, pos] = kn[:, 0], vn[:, 0]
    want = JL.decode_attention(q, kw, vw, jnp.asarray(pos), window=window,
                               cap=cap)
    tq, tkw, tvw, tkc, tvc, tkn, tvn = _t(q, kw, vw, kc, vc, kn, vn)
    close(TL.decode_attention(tq, tkw, tvw, pos, window=window, cap=cap),
          want)
    close(TL.decode_attention_kernel(tq, tkc, tvc, tkn, tvn, pos,
                                     window=window, cap=cap), want)


def test_attention_route_follows_the_kernels_contracts():
    qwen = get_config("qwen2_1_5b")
    gemma = get_config("gemma2_9b")
    rg = get_config("recurrentgemma_9b")
    stable = get_config("stablelm_3b")
    whisper = get_config("whisper_tiny")
    route = TL.attention_route
    for dt in ("float32", "bfloat16", "float16", torch.bfloat16):
        assert route(qwen, "attn", "prefill", dt) == "kernel"
        assert route(qwen, "attn", "decode", dt, cache_len=160) == "kernel"
    assert route(qwen, "attn", "prefill", "float64") == "plain"
    assert route(qwen, "attn", "decode", torch.float64,
                 cache_len=8) == "plain"
    # head dims outside 16-128
    for cfg in (gemma, rg, stable):
        assert route(cfg, "attn", "prefill", "bfloat16") == "plain"
        assert route(cfg, "local", "decode", "bfloat16",
                     cache_len=8) == "plain"
    # the encoder's non-causal self-attention takes the flash kernel; the
    # cross attention neither kernel
    assert route(whisper, "enc", "prefill", "float32") == "kernel"
    assert route(whisper, "cross", "prefill", "float32") == "plain"
    assert route(whisper, "cross", "decode", "float32",
                 cache_len=8) == "plain"
    with pytest.raises(ValueError):
        route(whisper, "enc", "decode", "float32", cache_len=8)
    with pytest.raises(ValueError):
        route(whisper, "rglru", "prefill", "float32")
    # a local layer's ring cache (exactly `window` rows) is plain; a
    # cache shorter than the window, or a global layer's, the kernel
    small = get_smoke("recurrentgemma_9b")            # window 32, hd 32
    assert route(small, "local", "decode", "float32", cache_len=32) == \
        "plain"
    assert route(small, "local", "decode", "float32") == "plain"
    assert route(small, "local", "decode", "float32", cache_len=24) == \
        "kernel"
    assert route(small, "local", "prefill", "float32") == "kernel"
    assert route(get_smoke("gemma2_9b"), "attn", "decode", "float32",
                 cache_len=64) == "kernel"
    # more query heads per KV head than the decode kernel's warps take
    wide = dataclasses.replace(qwen, n_heads=64, n_kv=2, head_dim=128)
    assert route(wide, "attn", "prefill", "float32") == "kernel"
    assert route(wide, "attn", "decode", "float32", cache_len=64) == "plain"


# ---------------------------------------------------------------------------
# projections, FFNs, MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_1_5b", "whisper_tiny",
                                  "stablelm_3b"])
def test_projections_and_ffn(arch):
    cfg, p = _block(arch)
    tp = _params(p)
    x = _rng(7).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    for got, want in zip(TL.attn_proj_qkv(tp, tx, cfg),
                         JL.attn_proj_qkv(p, x, cfg)):
        close(got, want)
    o = _rng(8).standard_normal((2, 6, cfg.n_heads, cfg.hd)).astype(
        np.float32)
    close(TL.attn_out(tp, torch.from_numpy(o)), JL.attn_out(p, o))
    close(TL.ffn_apply(tp["ffn"], tx, cfg.ffn),
          JL.ffn_apply(p["ffn"], x, cfg.ffn))


@pytest.mark.parametrize("arch,capacity", [("olmoe_1b_7b", 4.0),
                                           ("kimi_k2_1t_a32b", 4.0),
                                           ("olmoe_1b_7b", 1.0)])
def test_dense_moe(arch, capacity):
    """Routing, slot tables, the auxiliary loss and the combined output;
    capacity 1.0 drops tokens past an expert's slots in both."""
    cfg, p = _block(arch)
    moe = dataclasses.replace(cfg.moe, capacity_factor=capacity)
    x = _rng(9).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    tp = _params(p)
    out, aux = TL.moe_apply(tp["moe"], torch.from_numpy(x), moe)
    jout, jaux = JL._moe_apply_dense(p["moe"], jnp.asarray(x), moe)
    close(out, jout)
    close(aux, jaux)
    ng, gs, k, e = 2, moe.group_size, moe.top_k, moe.n_experts
    gates, topw, topi = TL.moe_routing(tp["moe"], torch.from_numpy(x), moe)
    jg = jax.nn.softmax(jnp.einsum("gtd,de->gte", x.reshape(ng, gs, -1),
                                   p["moe"]["router"]), axis=-1)
    jw, ji = jax.lax.top_k(jg, k)
    close(gates, jg)
    assert np.array_equal(topi.numpy(), np.asarray(ji))
    jw = jw / jnp.maximum(jw.sum(-1, keepdims=True), 1e-9)
    cap = int(np.ceil(gs * k / e * capacity))
    cap = max(8, ((cap + 7) // 8) * 8)
    st, sw = TL._slot_tables(topi, topw, ng, gs, k, e, cap)
    jst, jsw = JL._slot_tables(ji, jw, ng, gs, k, e, cap)
    assert np.array_equal(st.numpy(), np.asarray(jst))
    close(sw, jsw)


# ---------------------------------------------------------------------------
# recurrent blocks
# ---------------------------------------------------------------------------

def test_causal_conv1d_with_a_carried_state():
    r = _rng(10)
    x = r.standard_normal((2, 7, 12)).astype(np.float32)
    w = r.standard_normal((4, 12)).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    st = r.standard_normal((2, 3, 12)).astype(np.float32)
    tx, tw, tb, tst = _t(x, w, b, st)
    for got, want in zip(TR._causal_conv1d(tx, tw, tb, tst),
                         JR._causal_conv1d(x, w, b, st)):
        close(got, want)
    for got, want in zip(TR._causal_conv1d(tx, tw, tb),
                         JR._causal_conv1d(x, w, b)):
        close(got, want)


@pytest.mark.parametrize("kernel", [True, False])
def test_rglru_block_seq_and_step(kernel):
    """The Griffin block from a carried state, against JAX; stepping it
    token by token equals its sequence form."""
    cfg, p = _block("recurrentgemma_9b")
    tp = _params(p)
    r = _rng(11)
    x = r.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    st = {"h": r.standard_normal((2, cfg.drnn)).astype(np.float32),
          "conv": r.standard_normal((2, 3, cfg.drnn)).astype(np.float32)}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    tx = torch.from_numpy(x)
    out, new = TR.rglru_block_seq(tp, tx, tst, kernel=kernel)
    jout, jnew = JR.rglru_block_seq(p, x, st)
    close(out, jout)
    for k in ("h", "conv"):
        close(new[k], jnew[k])
    s = tst
    outs = []
    for t in range(x.shape[1]):
        o, s = TR.rglru_block_step(tp, tx[:, t:t + 1], s)
        outs.append(o)
    close(torch.cat(outs, 1), out)
    close(s["h"], new["h"])
    jo, js = JR.rglru_block_step(p, x[:, :1], st)
    o, s1 = TR.rglru_block_step(tp, tx[:, :1], tst)
    close(o, jo)
    close(s1["h"], js["h"])
    init = TR.rglru_init_state(2, cfg.drnn, 4, torch.float32, "cpu")
    jinit = JR.rglru_init_state(2, cfg.drnn, 4, jnp.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in jinit.items()}


@pytest.mark.parametrize("kernel", [True, False])
def test_rwkv_time_mix_with_state_and_step(kernel):
    """RWKV6's time mix from a carried state (its chunked form, or the
    scan kernel's entry), against JAX within 1e-4; its step form walked
    token by token equals it; the channel mix with a carried token."""
    cfg, p = _block("rwkv6_1_6b")
    n_heads = cfg.d_model // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    tp = _params(p)
    r = _rng(12)
    x = r.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    st = {"last_x": r.standard_normal((2, cfg.d_model)).astype(np.float32),
          "S": 0.3 * r.standard_normal((2, n_heads, hd, hd)).astype(
              np.float32)}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    tx = torch.from_numpy(x)
    out, new = TR.rwkv_time_mix_seq(tp, tx, n_heads, tst, return_state=True,
                                    kernel=kernel)
    jout, jnew = JR.rwkv_time_mix_seq(p, x, n_heads, st)
    close(out, jout, RWKV_TOL)
    close(new["S"], jnew["S"], RWKV_TOL)
    close(new["last_x"], jnew["last_x"])
    s, outs = tst, []
    for t in range(x.shape[1]):
        o, s = TR.rwkv_time_mix_step(tp, tx[:, t:t + 1], n_heads, s)
        outs.append(o)
    close(torch.cat(outs, 1), out, RWKV_TOL)
    close(s["S"], new["S"], RWKV_TOL)
    jo, js = JR.rwkv_time_mix_step(p, x[:, :1], n_heads, st)
    o, s1 = TR.rwkv_time_mix_step(tp, tx[:, :1], n_heads, tst)
    close(o, jo, RWKV_TOL)
    close(s1["S"], js["S"], RWKV_TOL)
    # the sequence form with no state still returns the output alone
    close(TR.rwkv_time_mix_seq(tp, tx, n_heads),
          JR.rwkv_time_mix_seq(p, x, n_heads)[0], RWKV_TOL)
    last = st["last_x"]
    for lx in (None, last):
        got = TR.rwkv_channel_mix_seq(
            tp, tx, None if lx is None else torch.from_numpy(lx))
        want = JR.rwkv_channel_mix_seq(p, x, lx)
        close(got[0], want[0])
        close(got[1], want[1])
    init = TR.rwkv_init_state(2, cfg.d_model, n_heads, torch.float32, "cpu")
    jinit = JR.rwkv_init_state(2, cfg.d_model, n_heads, jnp.float32)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in init.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jinit.items()}


def test_rwkv_shift_carries_the_last_token():
    x = torch.arange(12.0).reshape(1, 3, 4)
    assert torch.equal(TR.rwkv_shift(x)[:, 0], torch.zeros(1, 4))
    last = torch.full((1, 4), 7.0)
    got = TR.rwkv_shift(x, last)
    assert torch.equal(got[:, 0], last) and torch.equal(got[:, 1:], x[:, :2])


# ---------------------------------------------------------------------------
# the serve steps' mesh rule and device default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [TS.make_prefill_step, TS.make_decode_step])
def test_serve_steps_refuse_a_sharded_mesh(make):
    """Body rewritten, name kept: the sharded steps run on ranks
    (tests/test_torch_mesh_backbone.py), and an abstract mesh of several
    devices, which has none, raises naming the process groups."""
    cfg = get_smoke("qwen2_1_5b")
    with pytest.raises(ValueError, match="process groups"):
        make(tshd.AbstractMesh((1, 2)), cfg)
    with pytest.raises(ValueError, match="process groups"):
        make(tshd.AbstractMesh((2, 1)), cfg)


def test_backbone_entry_points_want_the_card_unless_asked():
    cfg = get_smoke("qwen2_1_5b")
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            TB.init_params(cfg, torch.Generator())
        with pytest.raises(NoDeviceError):
            TB.init_cache(cfg, 1, 8)
        with pytest.raises(NoDeviceError):
            TS.make_prefill_step(make_debug_mesh(1, 1), cfg)
    mesh = make_debug_mesh(1, 1, device="cpu")
    params = TB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = TS.make_prefill_step(mesh, cfg)
    logits = step(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert logits.shape == (1, 4, cfg.vocab_padded)
    with pytest.raises(ValueError, match="parameters are on"):
        TS.make_decode_step(make_debug_mesh(1, 1, device="meta"), cfg)(
            params, TB.init_cache(cfg, 1, 8, "cpu"),
            torch.zeros((1, 1), dtype=torch.long), 0)

"""RWKV6 backward by chunk-level checkpointing, as torch ops (counterpart
of ``repro.kernels.rwkv6_scan.grad``, which is jnp code outside any
Pallas kernel).

The WKV state is an hd×hd matrix a head; keeping it for every step, as
autograd of the per-step scan does, costs O(T·hd²) of device memory.
``ckpt.rwkv6_scan_bwd`` walks the recurrence once keeping only the state
at each chunk boundary, then sweeps the chunks in reverse, each one's
step math recomputed from its checkpoint and differentiated by autograd
against the output cotangent and the carried state cotangent.  Peak
residency is O(T/bt·hd² + bt·hd²).  The chunk length ``bt`` is
gcd(config, T), its ``Tunable`` pinned as
``node.attrs['cuda_rwkv6_block_bwd']`` (16 without one); it is shared
with no capability needed, as in the JAX package.  Every step is a few
torch ops on (B, H, hd, hd) states, so at full width the walk is bound by
the host's launches.  ``ref.rwkv6_scan_bwd`` is autograd of the plain
scan.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from ...backends import registry
from ...core import executor
from ...core.autotune import Tunable
from ...core.ir import Node, OpKind
from .ops import ATTR

Tensor = torch.Tensor
ATTR_BWD = ATTR + "_bwd"
DEFAULT_BT = 16
# candidate chunk lengths beside T and T/2, each cut to a divisor of T
BT_STEPS = (8, 32, 128)


def _chunk_fwd(rc: Tensor, kc: Tensor, vc: Tensor, wc: Tensor, u: Tensor,
               s: Tensor) -> Tuple[Tensor, Tensor]:
    """One chunk of the WKV recurrence.  rc..wc: (bt, B, H, hd) f32;
    u: (H, hd); s: (B, H, hd, hd) → (o (bt, B, H, hd), s_out)."""
    uk = u[None, :, :, None]
    outs = []
    for t in range(rc.shape[0]):
        kv = kc[t][..., :, None] * vc[t][..., None, :]
        outs.append(((s + uk * kv) * rc[t][..., :, None]).sum(-2))
        s = torch.exp(wc[t])[..., :, None] * s + kv
    return torch.stack(outs), s


def rwkv6_scan_vjp(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                   u: Tensor, s0: Tensor, ct: Tensor,
                   ds_last: Optional[Tensor] = None, *,
                   bt: int = DEFAULT_BT) -> Tuple[Tensor, ...]:
    """(dr, dk, dv, dlogw, du, ds0) in f32 of (o, s_last) = the WKV scan
    of (r, k, v, logw, u, s0), against the cotangents ``ct`` of o and
    ``ds_last`` of s_last (zero when None), walked in chunks of
    gcd(bt, T) steps."""
    b, t, h, hd = r.shape
    bt = math.gcd(bt, t)
    nc = t // bt
    rf, kf, vf, wf, ctf = (x.float().transpose(0, 1).reshape(nc, bt, b, h,
                                                              hd)
                           for x in (r, k, v, logw, ct))
    uf = u.float()
    # pass 1: the state entering each chunk (the checkpoints)
    s_ins: List[Tensor] = []
    s = s0.float()
    for c in range(nc):
        s_ins.append(s)
        s = _chunk_fwd(rf[c], kf[c], vf[c], wf[c], uf, s)[1]
    # pass 2: the chunks in reverse, each differentiated from its
    # checkpoint with the state cotangent carried back
    ds = torch.zeros_like(s) if ds_last is None else ds_last.float()
    du = torch.zeros_like(uf)
    grads: List[Tuple[Tensor, ...]] = [()] * nc
    for c in reversed(range(nc)):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True)
                      for x in (rf[c], kf[c], vf[c], wf[c], uf, s_ins[c])]
            o, s_out = _chunk_fwd(*leaves)
            dr, dk, dv, dw, du_c, ds = torch.autograd.grad(
                (o, s_out), leaves, (ctf[c], ds))
        du = du + du_c
        grads[c] = (dr, dk, dv, dw)

    def unchunk(i: int) -> Tensor:
        return torch.stack([g[i] for g in grads]).reshape(
            t, b, h, hd).transpose(0, 1)
    return unchunk(0), unchunk(1), unchunk(2), unchunk(3), du, ds


def _rwkv6_grad_impl(n: Node, res, ct: Tensor,
                     backend: "registry.Backend"):
    (r, k, v, logw, u, s0), _o = res
    cfg = n.attrs.get(ATTR_BWD)
    return rwkv6_scan_vjp(r, k, v, logw, u, s0, ct,
                          bt=int(cfg[0]) if cfg else DEFAULT_BT)


def rwkv6_bwd_tune_space(n: Node, hw) -> List[Tuple[int]]:
    """Chunk lengths 8, 32 and 128 steps, T and T/2, each cut to a divisor
    of T, deduplicated."""
    t = n.spec.shape[1]
    return [(bt,) for bt in sorted({math.gcd(c, t) for c in
                                    (*BT_STEPS, t, max(1, t // 2))})]


def rwkv6_bwd_refine_space(n: Node, hw, cfg) -> List[Tuple[int]]:
    """Half, twice and four times the winning chunk, cut to divisors of
    T."""
    t, bt = n.spec.shape[1], int(cfg[0])
    return [(math.gcd(max(1, c), t),) for c in (bt // 2, 2 * bt, 4 * bt)]


registry.register_shared_grad_impl(
    OpKind.RWKV6_SCAN, _rwkv6_grad_impl, name="ckpt.rwkv6_scan_bwd",
    supports=lambda n: len(n.spec.shape) == 4,
    tunable=Tunable(ATTR_BWD, rwkv6_bwd_tune_space,
                    refine=rwkv6_bwd_refine_space))
registry.register_reference_grad_impl(
    OpKind.RWKV6_SCAN, executor.reference_vjp_grad,
    name="ref.rwkv6_scan_bwd")

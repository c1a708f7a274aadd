#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA H100: it builds the hand-written kernels from this checkout,
holds each one against its plain PyTorch version at the main paths'
shapes in float32, bfloat16 and float16, serves a few requests at full
Qwen2-1.5B attention width through ``SolServer``, runs the Griffin and
RWKV6 block stacks at full width and three CNNs at ImageNet resolution
through ``optimize()``, runs the transformer, both stacks and the Listing-3
CNN again in bf16, serves the transformer once more under a strict
measured-provenance audit, and checks every path against the plain path.

    python3 chip_smoke.py          # one CUDA card, run from the repo root

Phases, each failing loudly:

1. device — ``nvidia-smi`` name and power limit; kernel build time;
   ``-Xptxas -v`` registers and spills of every instance (a spill in an
   avgpool instance fails).
2. kernels — matmul (serving, LoRA and the recurrent stacks' dense
   shapes, each on the kernel its plan picks: 3xTF32 tensor cores or the
   skinny kernel; one K = 12288 row held to 1e-5 of the output's scale),
   flash attention (tensor cores), decode attention (split-KV, with the
   number of splits), the generated DFP programs (the served graph's
   groups and the recurrent graphs' gate, mix and group-norm programs),
   the RG-LRU scan, the RWKV6 scan and the average pooling (full width
   and edge cases: column tiles, N·C past 65,535, run-time windows,
   unaligned rows in each dtype) against their plain versions (max
   |error| against the stated tolerance) with their device times (cold L2, the host ahead of
   the device), the plain version's, one PyTorch library call's where one
   computes the same function (decode attention: SDPA on a copy of the
   cache that already holds the step's row), and the roofline bound of
   the same work on this card, taken at the peak of the units that run
   it (3xTF32 or 16-bit tensor cores for the matmul's tensor-core rows
   and for flash attention); beside them the back-to-back launch time,
   which host launch cost can push above the device time.  The two scans
   are also timed at the paths' shapes under every cut their plans can
   take, and the pooling at both Listing-3 shapes under every band height
   of ``AVGPOOL_SWEEP`` in f32 and bf16 (``[plans]`` lines; RWKV6 with its
   time by pass).  Then an f32
   row at every kernel node that phases 3, 5 and 6 run and no row above
   holds (``path_nodes``: two-block versions of the serve's programs at
   the buckets phase 3 opens, of both stacks and of the three CNNs); then
   every kernel in bf16 at the f32 rows' shapes, in bf16 at every shape
   and DFP program that phase 7's paths run and no row above holds (the
   transformer's 1024-row products, LM head and S 256 attention, its
   decode step's products, each path's DFP groups, the CNN's head), and
   in f16 at one shape each (flash also at S 256), held to its plain
   version on the same rounded values within one rounding step of the
   storage type, bytes counted at the storage size.  Then, for each
   kernel (the matmul's two), every config of its ``Tunable`` space pinned
   on the first f32 and the first bf16 path node that runs it, through the
   impl, held to the plain version at the same tolerances (one
   ``[configs]`` line per kernel).  Phases 3, 5, 6 and 7
   fail on a kernel node of their paths that no row of their dtype holds
   (``node_key``, ``check_held``).
3. serve — 28 × ``transformer_block(1536, 12, n_kv_heads=2)`` + a
   Linear(1536, 151936) head with random weights from a seeded generator
   (build_lm's block: pre-norm LayerNorm, 4·d tanh-GELU MLP, no RoPE — not
   Qwen2's SwiGLU/RMSNorm/RoPE block), 4 greedy requests; every LINEAR,
   MATMUL, ATTENTION, DECODE_ATTENTION and FUSED node must elect a
   ``cuda.*`` impl and every kernel's launch count must move.  The same
   requests are then served once more under ``torch.profiler``: device
   time by kernel family and the device's busy share.
4. end to end — the same requests on ``backend="torch_ref"`` (PyTorch ops,
   TF32 off): logits agree at every served step and greedy tokens match
   (a position where the reference's top-2 gap is below the tolerance is a
   near tie and is reported, not failed); at 2 layers, the decode program's
   tokens equal the ``decode=False`` re-forward's.
5. recurrent forward — 24 × ``rwkv6_block(2048, 32, mlp_mult=3)``
   (RWKV6-1.6B width) and 26 × ``griffin_block(4096, mlp_mult=3)``
   (RecurrentGemma-9B width, its 26 RG-LRU layers) on a (4, 512, d) f32
   input, random weights from a seeded generator: every node a ``cuda.*``
   impl admits must elect one, and each kernel of the graph must launch in
   one forward.  Against ``backend="torch_ref"`` on the same weights: each
   block, compiled alone and fed the same input, within 1e-4 of its
   output's scale; the stack's output within a fixed limit per stack of
   its scale (1e-4 Griffin, 1e-2 RWKV6, whose random 24-layer stack
   amplifies f32 rounding; ``tools/torch_recurrent_agreement.py`` reads
   both).  Warm forward times of both backends and one profiled
   forward.
6. CNN forward — ``small_cnn``, ``depthwise_cnn`` and the Listing-3 CNN
   (``depthwise_cnn`` with ``AvgPool2d(3, stride=1)`` after each
   depthwise conv) with 1000 classes on a (64, 3, 224, 224) f32 input,
   random weights and nonzero biases from a seeded generator: every
   AVGPOOL elects ``cuda.avgpool`` (two launches per Listing-3 forward),
   every LINEAR ``cuda.linear``, every group holding a conv bias
   ``ref.compose``; each output within 1e-4 of ``torch_ref``'s scale on
   the same weights.  Warm forward times of both backends and a profile
   of 3 forwards back to back (per forward) behind ``PROFILE_PAD`` pad
   kernels; for the Listing-3 CNN a gate: the profile shows both pools in
   every forward and spans at least ``PROFILE_SPAN_SHARE`` of the warm
   forward.
7. bf16 — the phase-3 model's 28 blocks and head, the phase-5 stacks and
   the Listing-3 CNN with their weights cast to bf16, through
   ``optimize(..., dtype="bfloat16", backend="h100")`` on bf16 inputs: the
   transformer's full program at (4, 256, 1536) and one decode step
   against a bf16 cache with lens 0/37/100/127, the stacks at (4, 512, d),
   the CNN at (64, 3, 224, 224).  Every node a ``cuda.*`` impl admits
   elects it, each path's kernels launch, and phase 2 held every kernel
   node of the path at its shapes.  Gates, relative to the output's
   scale: logits, each recurrent block alone and the CNN's output within
   README's bf16 row (3e-2, RWKV6 5e-2) of ``torch_ref`` bf16 on the same
   module; a stack's output no further from ``torch_ref`` in f32 on the
   same bf16-rounded weights than twice ``torch_ref`` bf16's own distance
   (its bf16 floor).  RWKV6's floor at 24 blocks is about half the
   output's scale, so that gate cannot catch a wrong kernel there; its
   first two blocks are held to the same rule, and the same two blocks
   with the scan's bonus u zeroed must fail it.  Warm times in turns with
   ``torch_ref`` bf16, beside the same path's f32 h100 time, and one
   profiled call per path (the Listing-3 CNN as in phase 6).  Every
   profile counts only the events after its ``PROFILE_PAD`` pad kernels;
   the recurrent phases add the DFP groups' summed bytes bounds beside the
   profiled DFP family (``[dfp]`` lines).
8. measured serve — phase 3's model (the same weights) and requests on
   ``SolServer(strict_provenance=True)`` with a fresh autotune cache
   installed for the phase (the previous one restored after it, so phases
   3 and 5-7 keep their cold-cache elections): ``warm_autotune`` over the
   buckets the workload opens (one ``[measured]`` line per (op, shape):
   each impl's min and mean µs, ``core.measure``'s CUDA-event times with a
   warm L2 and the host's launch cost where it exceeds the device time,
   the winner and its pinned config), then two passes of serving.  A
   ``ProvenanceError`` fails the run; every served election must be
   measured on its exact bucket; every elected kernel must launch in the
   second pass (counts from 0, read after it) and no other; every pinned
   config of the served buckets is held to the plain version at its
   node's shapes; logits at every served step of both passes within 1e-4
   of phase 4's ``torch_ref`` and greedy tokens equal (near ties
   reported); tokens/s beside phases 3 and 4.  Then the driver's ``tune``
   at the bf16 transformer's products (phase 7's shapes) prints which impl
   measurement elects there, with no gate on the winner.

The second-to-last lines are the card's ``nvidia-smi`` line and a JSON
``kernels`` line (an entry per kernel in f32, and one per kernel in bf16
named ``<kernel>_bf16`` with its launches on the bf16 paths); the last line
is ``{"ok": true, "device": ...}``; the ``kernels`` line's launches are
phases 3 and 5-7's.  The
full record goes to ``chiprun_out/chip_smoke.json``.  The script imports
nothing of JAX or of the JAX package ``src/repro``; it exits non-zero,
printing no result, without a CUDA card or without the package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# f32 products accumulate in another order than the plain version; outputs
# are O(1), so agreement to 1e-4 absolute leaves ~100x margin over the
# expected ~1e-6 rounding while catching any indexing or masking fault.
# The pooling sums each input row's kw taps, then the kh row sums; the
# plain version sums the taps in the listing's order (k1 outer, k2 inner):
# a few ulps apart on O(1) values, so 1e-5.
KERNEL_TOL = {"matmul": 1e-4, "flash_attention": 1e-4,
              "decode_attention": 1e-4, "dfp_fused": 1e-4,
              "rglru_scan": 1e-4, "rwkv6_scan": 1e-4, "avgpool": 1e-5}
# a long f32 product (K 12288) relative to its output's scale: an f32
# product keeps ~1e-6, one TF32 pass ~1e-4
MATMUL_ACCURACY_RTOL = 1e-5
# end-to-end logits through 28 layers: relative to the logits' scale
LOGIT_RTOL = 1e-4

# bf16 and f16 kernel rows: kernel and plain version both compute in f32
# and round once to the storage type, so they may differ by one rounding
# step of it: rtol one unit in the last place, atol 1e-4 near zero.  A DFP
# program rounds every instruction in both versions; where an
# instruction's two f32 results straddle a rounding boundary, the one-unit
# step is carried on by later instructions, so DFP rows also allow one unit
# at the output's scale
HALF_DTYPES = ("bfloat16", "float16")
HALF_TOL = {"bfloat16": (2.0 ** -7, 1e-4), "float16": (2.0 ** -10, 1e-4)}

# band heights the plans sweep forces on both Listing-3 pools
AVGPOOL_SWEEP = (4, 8, 16, 24, 32, 48, 64)

PEAK_F32 = 67e12        # FLOP/s, f32 outside the tensor cores (H100 SXM)
PEAK_3XTF32 = 495e12 / 3    # FLOP/s, f32-accurate products as 3 TF32 passes
PEAK_16BIT = 989e12     # FLOP/s, bf16 and f16 products on the tensor cores
HBM = 3.35e12           # bytes/s

FULL = dict(d_model=1536, n_heads=12, n_kv_heads=2, n_layers=28,
            vocab=151936, max_seq=256, max_batch=4, slots=8)
PROMPT_LENS = (17, 40, 64, 100)
GEN = 16


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


FLUSH_BYTES = 256 << 20     # written before each timed call: > the 50 MB L2
SLEEP_CYCLES = 20_000_000   # ~10 ms of device sleep ahead of each call


def time_ms(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Two times of one call, after ``warmup`` calls.  ``device``: the
    median over ``iters`` single calls of CUDA events recorded right around
    the call, each call made with a cold L2 (a 256 MB buffer is written
    first) and behind a ~10 ms device sleep, so the host has enqueued the
    whole call before the device reaches it: the kernels' own time.
    ``launch``: CUDA events around ``iters`` back-to-back calls, over
    ``iters``; it is the larger when a call costs the host more time to
    launch than its kernels cost the device."""
    import statistics

    import torch
    for _ in range(warmup):
        fn()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in pairs:
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    device = statistics.median(a.elapsed_time(b) for a, b in pairs)
    start, end = pairs[0]
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"device": device, "launch": start.elapsed_time(end) / iters}


def bound(flops: float, nbytes: float, peak: float = PEAK_F32):
    t_ops, t_bytes = flops / peak, nbytes / HBM
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(gen) -> dict:
    """Every kernel against its plain version: in f32 at the main paths'
    shapes and edge cases, then in bf16 at the f32 rows' shapes (the
    matmul: serving, LoRA, the 2048-row products and the K = 12288 row),
    in bf16 at every kernel node's shapes in phase 7's paths
    (``bf16_path_nodes``) that no bf16 row holds yet, and in f16 at one
    shape per kernel.  A half-precision row runs the same random values rounded
    to its storage type, counts bytes at the storage size, and takes a
    tensor-core matmul row's operations at the 16-bit tensor cores' rate
    (PEAK_16BIT); its library call runs in the same dtype.  Each row
    carries its ``node_key``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.avgpool.kernel import avgpool_cuda, avgpool_plan
    from repro_torch.kernels.avgpool.ref import avgpool_ref
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, decode_plan)
    from repro_torch.kernels.decode_attention.ops import _ref_model_layout
    from repro_torch.kernels.dfp_fused.kernel import dfp_fused_triton
    from repro_torch.kernels.dfp_fused.ref import dfp_fused_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.kernel import matmul_cuda, plan
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.rglru_scan.kernel import (rglru_plan,
                                                       rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_scan.kernel import (MAX_CHUNK, STEP,
                                                       rwkv6_plan,
                                                       rwkv6_scan_cuda)
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
    csrc = "src/repro_torch/kernels/csrc/"

    def randn(*shape, scale=1.0, dt="float32"):
        return (torch.randn(*shape, device=dev, generator=gen) * scale
                ).to(tdt[dt])

    def verdict(got, want, dt, chain=False):
        """(max |error|, the half-precision check's verdict; None in f32,
        whose rows compare the error with KERNEL_TOL)."""
        if dt == "float32":
            return max_err(got, want), None
        return half_check(got, want, dt, chain)

    cases = []

    def record(name, shape, err, fn, plain, library, flops, nbytes,
               replaces, source, route, key, on_path=True, peak=PEAK_F32,
               extra=None, dtype="float32", within=None):
        t = {"": time_ms(fn), "plain_": time_ms(plain)}
        if library is not None:
            t["library_"] = time_ms(library)
        b_ms, b_by = bound(flops, nbytes, peak)
        tol = KERNEL_TOL[name] if within is None else HALF_TOL[dtype]
        row = {"name": name, "dtype": dtype, "shape": shape, "route": route,
               "source": source, "replaces": replaces, "max_abs_err": err,
               "tol": tol, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "on_path": on_path,
               "key": key, **(extra or {})}
        for pre, v in t.items():
            row[f"{pre}ms"] = v["device"]
            row[f"{pre}launch_ms"] = v["launch"]
        ms, p_ms, lib_ms = row["ms"], row["plain_ms"], row["library_ms"]
        note = "".join(f"; {k} {v:.4g}" if isinstance(v, float)
                       else f"; {k} {v}" for k, v in (extra or {}).items())
        tag = "" if dtype == "float32" else f" {dtype}"
        log(f"[kernels] {name}{tag} {shape}"
            f"{'' if on_path else ' (off path)'}: max|err| {err:.3g} (tol "
            f"{tol}) device ms: kernel {ms:.4f}, plain "
            f"{p_ms:.4f}, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)}, bound "
            f"{b_ms:.4f} ({b_by}); back-to-back launch ms: kernel "
            f"{row['launch_ms']:.4f}, plain {row['plain_launch_ms']:.4f}"
            f"{note}")
        if not (err <= tol if within is None else within):
            fail(f"{name}{tag} {shape} disagrees with its plain version: "
                 f"max |error| {err}, tolerance {tol}")
        cases.append(row)

    # matmul: (M, K) @ (K, N); 'oi' cases read an (N, K) weight transposed.
    # Each row names the kernel its plan picks, and its bound takes that
    # kernel's peak: on the tensor cores 3xTF32 (f32) or 16-bit wgmma
    # (bf16, f16), else f32 outside them
    def matmul_case(m, k, n, oi, label="", rtol=None, dt="float32"):
        x = randn(m, k, dt=dt)
        w = (randn(n, k, scale=k ** -0.5, dt=dt).T if oi
             else randn(k, n, scale=k ** -0.5, dt=dt))
        y = matmul_cuda(x, w)
        torch.cuda.synchronize()
        want = matmul_ref(x, w)
        err, within = verdict(y, want, dt)
        rel = max_err(y, want) / float(want.float().abs().max())
        size = x.element_size()
        p = plan(m, n, k, x.stride(0), w.stride(0), w.stride(1),
                 x.data_ptr(), w.data_ptr(), itemsize=size)
        peak = PEAK_F32
        if p.kernel == "tensor_core":
            peak = PEAK_3XTF32 if dt == "float32" else PEAK_16BIT
        shape = f"{m}x{k}x{n}{' (out,in)' if oi else ''}{label}"
        record("matmul", shape, err, lambda: matmul_cuda(x, w),
               lambda: matmul_ref(x, w), lambda: torch.matmul(x, w),
               2.0 * m * k * n, float(size) * (m * k + k * n + m * n),
               "src/repro/kernels/matmul/kernel.py:85", csrc + "matmul.cu",
               "cuda", ("matmul", m, k, n, oi), peak=peak,
               extra={"kernel": p.kernel, "splits": p.splits, "vec": p.vec,
                      "rel_err": rel}, dtype=dt, within=within)
        if rtol is not None and not rel <= rtol:
            fail(f"matmul {shape}: max |error| {rel:.3g} of the output's "
                 f"scale > {rtol}")

    # flash attention, by default causal at the prefill bucket: B 4, S 128,
    # H 12, KV 2, hd 128.  The products run on the tensor cores: bound at
    # the 16-bit rate in bf16 and f16, at the 3xTF32 rate in f32
    def flash_case(dt="float32", b=4, s=128, h=12, kv=2, hd=128,
                   causal=True, window=0, cap=0.0):
        q, k_, v = randn(b, s, h, hd, dt=dt), randn(b, s, kv, hd, dt=dt), \
            randn(b, s, kv, hd, dt=dt)
        attrs = dict(causal=causal, window=window, cap=cap)
        o = flash_attention_cuda(q, k_, v, **attrs)
        torch.cuda.synchronize()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k_, v))

        def fa_plain():
            return flash_attention_ref(qt, kt, vt, **attrs).transpose(1, 2)

        sdpa = None
        if not window and not cap:
            try:
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True)
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            except TypeError:   # an older torch without GQA in SDPA
                ke, ve = (t.repeat_interleave(h // kv, 1) for t in (kt, vt))
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, ke, ve, is_causal=causal)
        err, within = verdict(o, fa_plain(), dt)
        pairs = sum(min(i + 1, window or s) if causal
                    else s - max(0, i - window + 1) if window else s
                    for i in range(s))
        half = dt != "float32"
        tags = (" causal" if causal else "") + (f" window{window}" if window
                                                else "") + \
            (f" cap{cap:g}" if cap else "")
        record("flash_attention", f"B{b} S{s} H{h} KV{kv} hd{hd}{tags}", err,
               lambda: flash_attention_cuda(q, k_, v, **attrs), fa_plain, sdpa,
               4.0 * b * h * pairs * hd,
               float(q.element_size()) * (2 * b * s * h * hd
                                          + 2 * b * s * kv * hd),
               "src/repro/kernels/flash_attention/kernel.py:82",
               csrc + "flash_attention.cu", "cuda",
               ("flash_attention", b, s, h, kv, hd, causal, window, cap),
               peak=PEAK_16BIT if half else PEAK_3XTF32,
               extra={"units": "16-bit mma.sync" if half
                      else "3xTF32 mma.sync"}, dtype=dt, within=within)

    # decode attention, by default at the decode bucket: cache 128, lens
    # 0/37/100/127.  Library yardstick: one SDPA call (GQA, a boolean mask
    # pos <= lens[b]) on a copy of the cache holding the step's own row at
    # lens[b], made outside the timed call
    def decode_case(dt="float32", b=4, cache=128, h=12, kv=2, hd=128):
        if (b, cache) == (4, 128):
            lens_l = [0, 37, 100, 127]
        else:       # batch padding, then spread up to a full cache
            lens_l = [0] + [cache * (i + 1) // b for i in range(b - 1)]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        qd = randn(b, 1, h, hd, dt=dt)
        kc, vc = randn(b, cache, kv, hd, dt=dt), randn(b, cache, kv, hd, dt=dt)
        kn, vn = randn(b, 1, kv, hd, dt=dt), randn(b, 1, kv, hd, dt=dt)
        od = decode_attention_cuda(qd, kc, vc, kn, vn, lens)
        torch.cuda.synchronize()
        plain = lambda: _ref_model_layout(qd, kc, vc, kn, vn, lens, 0, 0.0)  # noqa: E731
        if max_err(od[0], vn[0].repeat_interleave(h // kv, 1)) != 0.0:
            fail(f"decode attention {dt} with lens 0 is not exactly v_new")
        err, within = verdict(od, plain(), dt)
        library = None
        if max(lens_l) < cache:
            kfull, vfull = kc.clone(), vc.clone()
            rows = torch.arange(b, device=dev)
            kfull[rows, lens.long()] = kn[:, 0]
            vfull[rows, lens.long()] = vn[:, 0]
            qs, ks, vs = (t.transpose(1, 2) for t in (qd, kfull, vfull))
            mask = (torch.arange(cache, device=dev)[None, :]
                    <= lens.long()[:, None])[:, None, None, :]
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
        rows_n = int(sum(lens_l))
        p = decode_plan(b, kv, cache, hd, qd.element_size(),
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
        record("decode_attention", f"B{b} cache{cache} H{h} KV{kv} hd{hd} "
               f"lens{lens_l}", err,
               lambda: decode_attention_cuda(qd, kc, vc, kn, vn, lens), plain,
               library, 4.0 * h * hd * (rows_n + b),
               float(qd.element_size()) * (2 * b * h * hd
                                           + 2 * rows_n * kv * hd
                                           + 2 * b * kv * hd) + 4.0 * b,
               "src/repro/kernels/decode_attention/kernel.py:94",
               csrc + "decode_attention.cu", "cuda",
               ("decode_attention", b, cache, h, kv, hd), dtype=dt,
               within=within, extra={"splits": p.splits, "chunk": p.chunk,
                                     "blocks": p.splits * kv * b})

    # a generated DFP program on random operands, N(0, scale^2)
    def dfp_case(label, rows_n, d, prog, on_path=True, dt="float32",
                 scale=1.0):
        ops = [randn(rows_n, d, scale=scale, dt=dt) if kd == "full"
               else randn(d, scale=scale, dt=dt)
               for kd in prog.operand_kinds]
        t0 = time.perf_counter()
        y = dfp_fused_triton(prog, ops, (rows_n, d), tdt[dt])
        torch.cuda.synchronize()
        log(f"[kernels] dfp_fused {label} {dt}: Triton compile + first "
            f"launch {time.perf_counter() - t0:.2f} s")
        err, within = verdict(y, dfp_fused_ref(prog, ops, (rows_n, d),
                                               tdt[dt]), dt, chain=True)
        n_full = prog.operand_kinds.count("full")
        n_vec = prog.operand_kinds.count("vec")
        library = None
        names = tuple(i[0] for i in prog.instrs)
        if names == ("bias", "gelu"):
            library = lambda: F.gelu(ops[0] + ops[1], approximate="tanh")  # noqa: E731
        elif names == ("layernorm",):       # RWKV6's group norm
            eps = prog.instrs[0][5]
            library = lambda: F.layer_norm(ops[0], (d,), ops[1], ops[2], eps)  # noqa: E731
        record("dfp_fused", f"{label} rows{rows_n} d{d}"
               + (f" operands x{scale:g}" if scale != 1.0 else ""), err,
               lambda: dfp_fused_triton(prog, ops, (rows_n, d), tdt[dt]),
               lambda: dfp_fused_ref(prog, ops, (rows_n, d), tdt[dt]),
               library, 10.0 * rows_n * d,
               float(ops[0].element_size()) * ((n_full + 1) * rows_n * d
                                               + n_vec * d),
               "src/repro/kernels/dfp_fused/kernel.py:117",
               "src/repro_torch/kernels/dfp_fused/kernel.py", "triton",
               ("dfp_fused", repr(prog), rows_n, d), on_path, dtype=dt,
               within=within)

    # RG-LRU scan: a in (0.5, 1), h0 nonzero; one launch a call, the
    # channels and T cut by rglru_plan
    def rglru_case(b_, t_, d_, dt="float32"):
        a = (torch.rand(b_, t_, d_, device=dev, generator=gen) * 0.5
             + 0.5).to(tdt[dt])
        bb, h0 = randn(b_, t_, d_, dt=dt), randn(b_, d_, dt=dt)
        h, last = rglru_scan_cuda(a, bb, h0)
        torch.cuda.synchronize()
        want_h, want_last = rglru_scan_ref(a, bb, h0)
        e1, w1 = verdict(h, want_h, dt)
        e2, w2 = verdict(last, want_last, dt)
        n = b_ * t_ * d_
        p = rglru_plan(b_, t_, d_, a.element_size(), sms)
        record("rglru_scan", f"B{b_} T{t_} D{d_}, h0 nonzero", max(e1, e2),
               lambda: rglru_scan_cuda(a, bb, h0),
               lambda: rglru_scan_ref(a, bb, h0), None, 2.0 * n,
               float(a.element_size()) * (3 * n + 2 * b_ * d_),
               "src/repro/kernels/rglru_scan/kernel.py:36",
               csrc + "rglru_scan.cu", "cuda", ("rglru_scan", b_, t_, d_),
               dtype=dt,
               within=None if w1 is None else w1 and w2,
               extra={"cuda_launches": 1, "lanes": p.lanes,
                      "chunk": p.chunk, "chunks_a_tile": p.chunks,
                      "blocks": p.grid[0] * p.grid[1]})

    # RWKV6 scan; ``extremes``: log decays 0 (no decay) and -50 (exp
    # underflows to 0).  The state comes back in f32 in every dtype.  T in
    # rwkv6_plan's chunks: three launches a call (chunk states, carry,
    # output), one where there is one chunk
    def rwkv6_case(b_, t_, h_, hd, extremes=False, dt="float32"):
        r, k_, v = (randn(b_, t_, h_, hd, scale=0.5, dt=dt) for _ in range(3))
        if extremes:
            logw = torch.where(randn(b_, t_, h_, hd) > 0, 0.0, -50.0)
        else:
            logw = -torch.exp(randn(b_, t_, h_, hd, scale=0.5) - 1.0)
        logw = logw.to(tdt[dt])
        u = randn(h_, hd, scale=0.5, dt=dt)
        s0 = randn(b_, h_, hd, hd, scale=0.5, dt=dt)
        o, s_last = rwkv6_scan_cuda(r, k_, v, logw, u, s0)
        torch.cuda.synchronize()
        want_o, want_s = rwkv6_scan_ref(r, k_, v, logw, u, s0)
        err, within = verdict(o, want_o, dt)
        s_err = max_err(s_last, want_s)
        if within is not None:
            within = within and s_err <= KERNEL_TOL["rwkv6_scan"]
        n, state = b_ * t_ * h_ * hd, b_ * h_ * hd * hd
        p = rwkv6_plan(b_, t_, h_, hd, r.element_size(), sms)
        record("rwkv6_scan", f"B{b_} T{t_} H{h_} hd{hd}, s0 nonzero"
               + (", logw in {0, -50}" if extremes else ""), max(err, s_err),
               lambda: rwkv6_scan_cuda(r, k_, v, logw, u, s0),
               lambda: rwkv6_scan_ref(r, k_, v, logw, u, s0), None,
               5.0 * n * hd,
               float(r.element_size()) * (5 * n + h_ * hd + state)
               + 4.0 * state,
               "src/repro/kernels/rwkv6_scan/kernel.py:55",
               csrc + "rwkv6_scan.cu", "cuda", ("rwkv6_scan", b_, t_, h_, hd),
               dtype=dt, within=within,
               extra={"s_last_max_abs_err": s_err,
                      "cuda_launches": 3 if p.chunks > 1 else 1,
                      "chunk": p.chunk, "chunks": p.chunks,
                      "blocks": p.chunks * h_ * b_})

    def scan_passes(fn, calls=5) -> dict:
        """Device ms of one call by the scan kernels' passes, warm L2,
        from the profiler over ``calls`` calls."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by: dict = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            name = ("chunk states" if ", false>" in e.name else
                    "output" if ", true>" in e.name else
                    "carry" if "carry" in e.name else
                    "chunks" if "rglru_chunk" in e.name else "other")
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        return {k: v / calls for k, v in by.items()}

    def sm_count_for(plan, field, value, *shape) -> int:
        """An SM count with which ``plan`` picks ``value`` for ``field``."""
        return next(n for n in range(1, 100_000)
                    if getattr(plan(*shape, n), field) == value)

    # the scans at the paths' shapes under each cut their plans can take
    # (forced through sm_count), beside the plan's own, each held to the
    # plain version: which cut the plan should pick, and where the RWKV6
    # passes spend their time
    def scan_plans(dt):
        size = tdt[dt].itemsize
        r, k_, v = (randn(4, 512, 32, 64, scale=0.5, dt=dt) for _ in range(3))
        logw = (-torch.exp(randn(4, 512, 32, 64, scale=0.5) - 1.0)
                ).to(tdt[dt])
        u, s0 = randn(32, 64, scale=0.5, dt=dt), \
            randn(4, 32, 64, 64, scale=0.5, dt=dt)
        want_o, want_s = rwkv6_scan_ref(r, k_, v, logw, u, s0)
        a = (torch.rand(4, 512, 4096, device=dev, generator=gen) * 0.5
             + 0.5).to(tdt[dt])
        bb, h0 = randn(4, 512, 4096, dt=dt), randn(4, 4096, dt=dt)
        want_h, _ = rglru_scan_ref(a, bb, h0)
        rows = []
        shape6 = (4, 512, 32, 64, size)
        for chunk in (None, *range(STEP, MAX_CHUNK + 1, STEP), 512):
            n = sms if chunk is None else sm_count_for(
                rwkv6_plan, "chunk", chunk, *shape6)
            p = rwkv6_plan(*shape6, n)
            fn = (lambda n=n: rwkv6_scan_cuda(r, k_, v, logw, u, s0,
                                              sm_count=n))
            o, s_last = fn()
            torch.cuda.synchronize()
            err, within = verdict(o, want_o, dt)
            if not (err <= KERNEL_TOL["rwkv6_scan"] if within is None
                    else within) or max_err(s_last, want_s) > 1e-4:
                fail(f"rwkv6_scan {dt} at chunk {p.chunk} disagrees with "
                     f"its plain version: {err}")
            rows.append({"kernel": "rwkv6_scan", "dtype": dt,
                         "plan": chunk is None, "chunk": p.chunk,
                         "chunks": p.chunks, "ms": time_ms(fn)["device"],
                         "passes_warm_ms": scan_passes(fn)})
        shape3 = (4, 512, 4096, size)
        for lanes in (None, 32, 16, 8, 4):
            n = sms if lanes is None else sm_count_for(
                rglru_plan, "lanes", lanes, *shape3)
            p = rglru_plan(*shape3, n)
            fn = (lambda n=n: rglru_scan_cuda(a, bb, h0, sm_count=n))
            h, _ = fn()
            torch.cuda.synchronize()
            err, within = verdict(h, want_h, dt)
            if not (err <= KERNEL_TOL["rglru_scan"] if within is None
                    else within):
                fail(f"rglru_scan {dt} at {p.lanes} lanes disagrees with "
                     f"its plain version: {err}")
            rows.append({"kernel": "rglru_scan", "dtype": dt,
                         "plan": lanes is None, "lanes": p.lanes,
                         "blocks": p.grid[0] * p.grid[1],
                         "ms": time_ms(fn)["device"]})
        for row in rows:
            cut = (f"chunk {row['chunk']} ({row['chunks']} chunks)"
                   if row["kernel"] == "rwkv6_scan" else
                   f"{row['lanes']} lanes ({row['blocks']} blocks)")
            passes = "".join(f", {k} {v:.4f}" for k, v in
                             row.get("passes_warm_ms", {}).items())
            log(f"[plans] {row['kernel']} {dt} at the path's shape, "
                f"{cut}{' (the plan)' if row['plan'] else ''}: device ms "
                f"{row['ms']:.4f}{' (warm, by pass' if passes else ''}"
                f"{passes}{')' if passes else ''}")
        return rows

    # average pooling; F.avg_pool2d is the library call.  ``offset``
    # starts x that many elements into its buffer (rows and planes then
    # off every 16-byte line); each row names the plan's cut
    def avgpool_case(n_, c_, h_, w_, kh=3, kw=3, on_path=True, dt="float32",
                     offset=0):
        x = randn(n_ * c_ * h_ * w_ + offset, dt=dt)[offset:].view(
            n_, c_, h_, w_)
        y = avgpool_cuda(x, kh, kw)
        torch.cuda.synchronize()
        err, within = verdict(y, avgpool_ref(x, kh, kw), dt)
        out = y.numel()
        p = avgpool_plan(n_, c_, h_, w_, kh, kw, x.element_size())
        at = f" at element {offset}" if offset else ""
        record("avgpool", f"({n_}, {c_}, {h_}, {w_}) k{kh}x{kw}{at}", err,
               lambda: avgpool_cuda(x, kh, kw),
               lambda: avgpool_ref(x, kh, kw),
               lambda: F.avg_pool2d(x, (kh, kw), stride=1),
               float(kh * kw) * out,
               float(x.element_size()) * (x.numel() + out),
               "src/repro/kernels/avgpool/kernel.py:34", csrc + "avgpool.cu",
               "cuda", ("avgpool", n_, c_, h_, w_, kh, kw), on_path, dtype=dt,
               within=within,
               extra={"band_rows": p.rows, "bands": p.bands,
                      "tiles": p.tiles, "threads": p.tx * p.groups,
                      "smem": p.smem})

    # both Listing-3 pools under every band height of the sweep, beside the
    # plan's own, each held to the plain version: which height the plan
    # should pick
    def avgpool_plans(dt):
        rows = []
        for shape in listing3_pools:
            x = randn(*shape, dt=dt)
            want = avgpool_ref(x, 3, 3)
            nbytes = float(x.element_size()) * (x.numel() + want.numel())
            b_ms, _ = bound(9.0 * want.numel(), nbytes)
            for band in (0, *AVGPOOL_SWEEP):
                fn = (lambda band=band: avgpool_cuda(x, 3, 3, rows=band))
                y = fn()
                torch.cuda.synchronize()
                err, within = verdict(y, want, dt)
                if not (err <= KERNEL_TOL["avgpool"] if within is None
                        else within):
                    fail(f"avgpool {dt} {shape} at a band of {band} rows "
                         f"disagrees with its plain version: {err}")
                p = avgpool_plan(*shape, 3, 3, x.element_size(), band)
                ms = time_ms(fn)["device"]
                rows.append({"kernel": "avgpool", "dtype": dt,
                             "shape": shape, "plan": band == 0,
                             "rows": p.rows, "bands": p.bands,
                             "smem": p.smem, "threads": p.tx * p.groups,
                             "ms": ms, "bound_ms": b_ms})
                log(f"[plans] avgpool {dt} at {shape}, bands of {p.rows} "
                    f"rows ({p.bands} a plane, {p.smem} bytes staged, "
                    f"{p.tx * p.groups} threads)"
                    f"{' (the plan)' if band == 0 else ''}: device ms "
                    f"{ms:.4f}, {100 * b_ms / ms:.1f}% of the bound "
                    f"{b_ms:.4f}")
        return rows

    serve_mm = [(4, 1536, 151936, True), (256, 1536, 1536, False),
               (256, 1536, 6144, False), (256, 1536, 6144, True),
               (4, 1536, 1536, False), (4, 6144, 1536, True)]
    lora = [(2048, 2048, 4), (2048, 4, 2048)]
    dense = [(2048, 2048, 2048, False), (2048, 2048, 6144, True),
             (2048, 6144, 2048, True), (2048, 4096, 4096, False),
             (2048, 4096, 12288, True), (2048, 12288, 4096, True)]
    listing3_pools = [(64, 32, 224, 224), (64, 64, 111, 111)]

    # f32: the serving shapes, then the recurrent slice's (LoRA products,
    # the RWKV6 (d 2048, MLP 6144) and Griffin (d 4096, MLP 12288) dense
    # products on their 2048 rows, a K = 12288 accuracy row, the groups its
    # graphs add, the scans), then the Listing-3 pools and edge cases
    nodes32 = path_nodes(torch, dev, "float32")
    serving = serving_programs(nodes32)
    for m, k, n, oi in serve_mm:
        matmul_case(m, k, n, oi)
    flash_case()
    decode_case()
    for label, rows_n, d, prog, on_path in serving:
        dfp_case(label, rows_n, d, prog, on_path)
    for m, k, n in lora:
        matmul_case(m, k, n, False, " (LoRA)")
    for m, k, n, oi in dense:
        matmul_case(m, k, n, oi)
    matmul_case(256, 12288, 1024, True, " (accuracy)",
                rtol=MATMUL_ACCURACY_RTOL)
    for label, rows_n, d, prog, on_path in recurrent_programs():
        dfp_case(label, rows_n, d, prog, on_path)
    # Griffin's; T 1, D 24; T ragged over the chunks and tiles, D no
    # multiple of a block's channels
    for shape in ((4, 512, 4096), (3, 1, 24), (1, 300, 4100)):
        rglru_case(*shape)
    rwkv6_case(4, 512, 32, 64)                      # RWKV6-1.6B's heads
    rwkv6_case(1, 3, 2, 8, extremes=True)
    rwkv6_case(1, 300, 2, 64, extremes=True)        # 19 chunks, the last 12
    plans = scan_plans("float32") + scan_plans("bfloat16")
    for n_, c_, h_, w_ in listing3_pools:
        avgpool_case(n_, c_, h_, w_)
    # k 2 and 3, kh != kw, H or W equal to k, N·C 1, widths no multiple of
    # a warp; column tiles; N·C past 65,535; run-time windows 5x5 and 1x7
    for n_, c_, h_, w_, kh, kw in ((3, 5, 17, 45, 2, 2), (1, 1, 3, 3, 3, 3),
                                   (2, 3, 9, 40, 2, 3), (1, 1, 70, 33, 3, 1),
                                   (1, 2, 20, 5000, 3, 3),
                                   (70000, 1, 4, 4, 3, 3),
                                   (2, 3, 30, 40, 5, 5),
                                   (2, 3, 30, 41, 1, 7)):
        avgpool_case(n_, c_, h_, w_, kh, kw, on_path=False)
    # unaligned rows (111 elements) from an unaligned base, in each dtype
    for dt in ("float32", *HALF_DTYPES):
        avgpool_case(2, 3, 13, 111, on_path=False, dt=dt, offset=1)
    plans += avgpool_plans("float32") + avgpool_plans("bfloat16")
    # flash at the bf16 transformer's S 256 in f32 too, beside its bf16 row
    flash_case(s=256)

    def hold(dt, nodes, tag):
        """A row in ``dt`` at every kernel node of ``nodes`` that no row
        of ``dt`` holds yet."""
        held = {c["key"] for c in cases if c["dtype"] == dt}
        for key, (_, node) in nodes.items():
            if key in held:
                continue
            kind, dims = key[0], key[1:]
            if kind == "matmul":
                matmul_case(*dims, tag, dt=dt)
            elif kind == "flash_attention":
                flash_case(dt, *dims)
            elif kind == "decode_attention":
                decode_case(dt, *dims)
            elif kind == "dfp_fused":
                # KERNEL_TOL assumes O(1) outputs: an f32 program that
                # exponentiates gets operands at half scale (exp of a sum
                # of two N(0, 1) operands reaches e^7.5, where an f32 ulp
                # is 1.2e-4)
                prog = dfp_program(node)
                scale = 0.5 if dt == "float32" and any(
                    i[0] == "exp" for i in prog.instrs) else 1.0
                dfp_case(node.name[len("fused["):-1] + tag, dims[1], dims[2],
                         prog, dt=dt, scale=scale)
            elif kind == "rglru_scan":
                rglru_case(*dims, dt=dt)
            elif kind == "rwkv6_scan":
                rwkv6_case(*dims, dt=dt)
            elif kind == "avgpool":
                avgpool_case(*dims, dt=dt)
            else:
                fail(f"phase 2 has no {dt} case for the paths' {key}")
            held.add(key)

    # f32 at every kernel node of phases 3-6 that no row above holds
    hold("float32", nodes32, " (f32 path)")
    configs = sweep_configs(torch, gen, "float32", nodes32)

    # bf16 at the f32 rows' shapes, then f16 at one shape per kernel
    bf = "bfloat16"
    for m, k, n, oi in serve_mm:
        matmul_case(m, k, n, oi, dt=bf)
    for m, k, n in lora:
        matmul_case(m, k, n, False, " (LoRA)", dt=bf)
    for m, k, n, oi in dense:
        matmul_case(m, k, n, oi, dt=bf)
    matmul_case(256, 12288, 1024, True, " (accuracy)", dt=bf)
    for label, rows_n, d, prog, on_path in serving:
        dfp_case(label, rows_n, d, prog, on_path, dt=bf)
    for label, rows_n, d, prog, on_path in recurrent_programs():
        dfp_case(label, rows_n, d, prog, on_path, dt=bf)
    for n_, c_, h_, w_ in listing3_pools:
        avgpool_case(n_, c_, h_, w_, dt=bf)
    for dt in HALF_DTYPES:
        flash_case(dt)
        decode_case(dt)
        rglru_case(4, 512, 4096, dt)
        rwkv6_case(4, 512, 32, 64, dt=dt)
    flash_case("float16", s=256)

    # bf16 at every kernel node of phase 7's paths that no row above holds
    nodes16 = path_nodes(torch, dev, bf)
    hold(bf, nodes16, " (bf16 path)")
    configs += sweep_configs(torch, gen, bf, nodes16)
    log_configs(configs)
    f16 = "float16"
    matmul_case(4, 1536, 151936, True, dt=f16)
    matmul_case(2048, 4096, 4096, False, dt=f16)
    label, rows_n, d, prog, _ = next(r for r in serving
                                     if r[0] == "bias_add+gelu")
    dfp_case(label, rows_n, d, prog, dt=f16)
    avgpool_case(*listing3_pools[0], dt=f16)
    # the bf16 transformer's products, (M, K, N, LINEAR): phase 8 tunes them
    products = sorted({key[1:] for key, (path, _) in nodes16.items()
                       if key[0] == "matmul" and path.startswith(
                           "transformer")})
    return {"cases": cases, "plans": plans, "configs": configs,
            "bf16_products": products}


def node_operands(torch, node, gen) -> list:
    """Random operands of a kernel node at its shapes and dtypes, on
    ``gen``'s device, scaled as phase 2's rows scale them: O(1) outputs (a product's
    weight by K^-1/2, an f32 DFP program that exponentiates at half
    scale), an RG-LRU decay in (0.5, 1), RWKV6's log decays below 0, and
    decode lengths from a batch-padding 0 up to a full cache."""
    from repro_torch.core.executor import TORCH_DTYPES
    from repro_torch.core.ir import OpKind
    dev = gen.device
    shapes = [tuple(i.spec.shape) for i in node.inputs]
    dts = [TORCH_DTYPES[i.spec.dtype] for i in node.inputs]

    def randn(i, scale=1.0):
        return (torch.randn(shapes[i], device=dev, generator=gen)
                * scale).to(dts[i])

    op = node.op
    if op in (OpKind.LINEAR, OpKind.MATMUL):
        k = shapes[0][-1]
        return [randn(0), randn(1, k ** -0.5)] + [
            randn(i, 0.1) for i in range(2, len(shapes))]
    if op is OpKind.DECODE_ATTENTION:
        b, cache = shapes[1][0], shapes[1][1]
        lens = ([0, 37, 100, 127] if (b, cache) == (4, 128) else
                [0] + [cache * (i + 1) // b for i in range(b - 1)])[:b]
        return [randn(i) for i in range(5)] + [
            torch.tensor(lens, dtype=torch.int32, device=dev)]
    if op is OpKind.RGLRU_SCAN:
        a = (torch.rand(shapes[0], device=dev, generator=gen) * 0.5
             + 0.5).to(dts[0])
        return [a, randn(1), randn(2)]
    if op is OpKind.RWKV6_SCAN:
        logw = (-torch.exp(torch.randn(shapes[3], device=dev, generator=gen)
                           * 0.5 - 1.0)).to(dts[3])
        return [randn(0, 0.5), randn(1, 0.5), randn(2, 0.5), logw,
                randn(4, 0.5), randn(5, 0.5)]
    if op is OpKind.FUSED:
        scale = 0.5 if node.spec.dtype == "float32" and any(
            i[0] == "exp" for i in dfp_program(node).instrs) else 1.0
        return [randn(i, scale) for i in range(len(shapes))]
    return [randn(i) for i in range(len(shapes))]


def kernel_of(node, hw) -> str:
    """The kernel a ``cuda.*`` node runs: its family, the matmul split by
    the kernel its plan picks."""
    kind = node_key(node)[0]
    if kind == "matmul":
        from repro_torch.kernels.matmul.ops import node_plan
        return {"tensor_core": "matmul_tc",
                "skinny": "matmul_skinny"}[node_plan(node, hw).kernel]
    return kind


def plain_version(node, vals):
    """The plain PyTorch version of the kernel a node's ``cuda.*`` impl
    runs (its family's ``ref.py``), on the same operands: what every
    config of the impl's ``Tunable`` space is held against.  Attention,
    decode attention and the scans take the reference tier's impls, which
    are their families' plain versions."""
    from repro_torch.backends import get_backend, registry
    from repro_torch.core.executor import linear_weight_kn
    from repro_torch.core.ir import OpKind
    from repro_torch.kernels.avgpool.ref import avgpool_ref
    from repro_torch.kernels.dfp_fused.program import encode_program
    from repro_torch.kernels.dfp_fused.ref import dfp_fused_ref
    from repro_torch.kernels.matmul.ref import matmul_ref
    op = node.op
    ref = {OpKind.ATTENTION: "ref.attention",
           OpKind.DECODE_ATTENTION: "ref.decode_attention",
           OpKind.RGLRU_SCAN: "ref.rglru_scan",
           OpKind.RWKV6_SCAN: "ref.rwkv6_scan"}.get(op)
    if ref is not None:
        return registry.get_impl(ref).fn(node, vals, get_backend("torch_ref"))
    if op is OpKind.MATMUL:
        return matmul_ref(vals[0], vals[1])
    if op is OpKind.LINEAR:
        y = matmul_ref(vals[0], linear_weight_kn(node, vals[1]))
        return y + vals[2] if len(vals) > 2 and vals[2] is not None else y
    if op is OpKind.FUSED:
        prog, operands = encode_program(
            node, {id(i): v for i, v in zip(node.inputs, vals)})
        full = next(o for o, k in zip(operands, prog.operand_kinds)
                    if k == "full")
        return dfp_fused_ref(prog, operands, tuple(full.shape), full.dtype)
    if op is OpKind.AVGPOOL:        # stride 1: the window from the shapes
        (h, w), (oh, ow) = vals[0].shape[2:], node.spec.shape[2:]
        return avgpool_ref(vals[0], h - oh + 1, w - ow + 1)
    raise KeyError(f"no kernel family for {op}")


def hold_config(torch, node, vals, hw, cfg) -> float:
    """Run ``node``'s elected ``cuda.*`` impl with ``cfg`` pinned (None:
    the pin it carries) and hold it against the plain version at phase 2's
    tolerance of its dtype; returns max |error|."""
    from repro_torch.backends import get_backend, registry
    impl = registry.get_impl(node.impl)
    backend = dataclasses.replace(get_backend("h100"), hw=hw)
    saved = node.attrs.get(impl.tunable.attr)
    if cfg is not None:
        impl.tunable.bind_config(node, cfg)
    try:
        got = impl.fn(node, vals, backend)
    finally:
        impl.tunable.bind_config(node, saved)
    torch.cuda.synchronize()
    want = plain_version(node, vals)
    dt = node.spec.dtype
    kind = node_key(node)[0]
    if dt == "float32":
        err = max_err(got, want)
        ok = err <= KERNEL_TOL[kind]
    else:
        err, ok = half_check(got, want, dt, chain=kind == "dfp_fused")
    if not ok:
        fail(f"{kernel_of(node, hw)} {dt} at {node_key(node)[1:]} with "
             f"config {cfg or saved} disagrees with its plain version: max "
             f"|error| {err}")
    return err


def sweep_configs(torch, gen, dtype: str, nodes) -> list:
    """Every config of each kernel's Tunable space at the first node of
    ``nodes`` (``path_nodes``, phase order) that runs it, held against the
    plain version at phase 2's tolerance."""
    from repro_torch.backends import h100_spec, registry
    hw = h100_spec(torch.cuda.get_device_name(0))
    rows, seen = [], set()
    for key, (path, node) in nodes.items():
        kernel = kernel_of(node, hw)
        if kernel in seen:
            continue
        seen.add(kernel)
        impl = registry.get_impl(node.impl)
        vals = node_operands(torch, node, gen)
        space = impl.tunable.tune_space(node, hw)
        if not space:
            fail(f"{kernel} {dtype} at {key[1:]}: an empty config space")
        for cfg in space:
            rows.append({"kernel": kernel, "dtype": dtype, "path": path,
                         "key": key, "config": cfg,
                         "max_abs_err": hold_config(torch, node, vals, hw,
                                                    cfg)})
    want = {"matmul_tc", "matmul_skinny", "flash_attention",
            "decode_attention", "dfp_fused", "rglru_scan", "rwkv6_scan",
            "avgpool"}
    if seen != want:
        fail(f"phase 2 swept the configs of {sorted(seen)} in {dtype}, not "
             f"of {sorted(want)}")
    return rows


def log_configs(rows) -> None:
    """One ``[configs]`` line per kernel: each config's max |error| at the
    f32 node and the bf16 node."""
    for kernel in dict.fromkeys(r["kernel"] for r in rows):
        parts = []
        for dt in ("float32", "bfloat16"):
            mine = [r for r in rows if r["kernel"] == kernel
                    and r["dtype"] == dt]
            if mine:
                errs = ", ".join(f"{r['config']} {r['max_abs_err']:.3g}"
                                 for r in mine)
                parts.append(f"{dt} at {mine[0]['key'][1:]} ({mine[0]['path']}"
                             f"): {errs}")
        log(f"[configs] {kernel}: every config of its space within its "
            f"plain version's tolerance; " + "; ".join(parts))


def half_check(got, want, dtype: str, chain: bool = False):
    """(max |error|, whether every element is within one rounding step of
    ``dtype``: |got - want| <= rtol * |want| + atol, plus rtol * max |want|
    for a DFP ``chain``)."""
    rtol, atol = HALF_TOL[dtype]
    g, w = got.float(), want.float()
    if chain:
        atol += rtol * float(w.abs().max())
    return (max_err(g, w),
            float(((g - w).abs() - rtol * w.abs()).max()) <= atol)


def serving_programs(nodes) -> list:
    """(label, rows, d, Program, on_path) of the DFP groups of the serve's
    prefill program, encoded from the served graph (``path_nodes``), so
    each row's key is its node's; then a LayerNorm + residual program on
    the same rows, off the path (the served LayerNorms elect
    ``ref.layernorm``, as in the JAX package)."""
    from repro_torch.kernels.dfp_fused.program import Program
    groups = sorted(((n.name[len("fused["):-1], key[2], key[3],
                      dfp_program(n), True)
                     for key, (path, n) in nodes.items()
                     if key[0] == "dfp_fused" and path == "serve prefill"),
                    key=lambda g: (g[0], g[2]))
    groups.append(("layernorm+add", groups[0][1], FULL["d_model"], Program(
        (("layernorm", 0, ("op", 0), 1, 2, 1e-5),
         ("add", 1, ("reg", 0), ("op", 3), None)),
        ("full", "vec", "vec", "full"), 1), False))
    return groups


def recurrent_programs():
    """(label, rows, d, Program, on_path) of the DFP groups the recurrent
    graphs add, encoded from the extracted graphs of small blocks (a
    program does not depend on the sizes), at the full-width stacks' rows
    and widths: the RG-LRU gate chain, RWKV6's token-shift mix, and
    RWKV6's per-head group norm over hd 64 on B·T·H rows.  The group norm
    is off the main path: its node is a lone 4-D LAYERNORM, which elects
    ``ref.layernorm`` as in the JAX package; the case holds the program
    such a node would run."""
    from repro_torch.backends import get_backend
    from repro_torch.core import passes
    from repro_torch.frontends import extract, nn
    from repro_torch.kernels.dfp_fused.program import (Program,
                                                       encode_program)
    from repro_torch.models.recurrent import GN_EPS

    def group(model, name):
        g = passes.run_pipeline(extract.extract(model, (1, 4, 64)),
                                get_backend("h100"))
        node = next(n for n in g.topo() if n.name == name)
        return encode_program(node, {id(i): i.spec for i in node.inputs})[0]

    rows = 4 * 512
    return [
        ("rglru gate sigmoid+mul+exp", rows, 4096,
         group(nn.griffin_block(64, device="cpu"), "fused[sigmoid+mul+exp]"),
         True),
        ("rwkv6 mix add+mul+add", rows, 2048,
         group(nn.rwkv6_block(64, 4, device="cpu"), "fused[add+mul+add]"),
         True),
        ("rwkv6 group norm", rows * 32, 64,
         Program((("layernorm", 0, ("op", 0), 1, 2, GN_EPS),),
                 ("full", "vec", "vec"), 0), False),
    ]


# ---------------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------------

CUDA_KINDS = ("linear", "matmul", "attention", "decode_attention", "fused")


def _workload(vocab: int, seed: int = 7):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in PROMPT_LENS]


def serve_trace(server, prompts, gen: int):
    """Serve greedily step by step; returns per request the tokens and the
    logits of every served step."""
    reqs = [server.submit(p, gen) for p in prompts]
    trace = {r.rid: [] for r in reqs}
    t0 = time.perf_counter()
    while server.depth:
        for rid in server.step():
            r = next(q for q in reqs if q.rid == rid)
            trace[rid].append(r.last_logits.copy())
    wall = time.perf_counter() - t0
    return reqs, [(r.generated, trace[r.rid]) for r in reqs], wall


def measured_serve(server, prompts, on_measure=None):
    """Serve ``prompts`` twice on one server.  The first pass opens its
    buckets: it compiles their programs and loads the kernels.  The second
    pass, the measured one, then runs in steady state; ``on_measure`` is
    called just before it.  Returns the second pass's (tokens, logits) per
    request and its metrics."""
    import statistics
    _, _, first_wall = serve_trace(server, prompts, GEN)
    seen = {k: len(v) for k, v in server.stats["forward_ms"].items()}
    if on_measure is not None:
        on_measure()
    reqs, out, wall = serve_trace(server, prompts, GEN)
    fwd = {k: v[seen[k]:] for k, v in server.stats["forward_ms"].items()}
    tokens = sum(len(r.generated) for r in reqs)
    forwards_ms = sum(sum(v) for v in fwd.values())
    return out, {
        "first_pass_s": first_wall, "wall_ms": 1e3 * wall, "tokens": tokens,
        "tokens_per_s": tokens / wall,
        "ttft_p50_ms": statistics.median(
            1e3 * (r.first_token_time - r.submitted) for r in reqs),
        "prefill_ms": fwd["prefill"],
        "decode_p50_ms": statistics.median(fwd["decode"]),
        "decode_steps": len(fwd["decode"]), "forwards_ms": forwards_ms,
        "between_forwards_ms": 1e3 * wall - forwards_ms}


# kernel-name fragments → the family a device event belongs to; the rest are
# PyTorch's own kernels (reference-tier ops, gathers, casts)
FAMILIES = (("tc_kernel", "matmul"), ("tc16_kernel", "matmul"),
            ("skinny_kernel", "matmul"),
            ("reduce_splits", "matmul"),
            ("flash_mma_kernel", "flash_attention"),
            ("decode_split_kernel", "decode_attention"),
            ("decode_combine_kernel", "decode_attention"),
            ("dfp_", "dfp_fused"),
            ("rglru_chunk_kernel", "rglru_scan"),
            ("rwkv6_chunk_kernel", "rwkv6_scan"),
            ("rwkv6_carry_kernel", "rwkv6_scan"),
            ("avgpool_kernel", "avgpool"),
            ("conv", "conv"), ("fprop", "conv"),
            ("Memcpy HtoD", "copy to card"), ("Memcpy DtoH", "copy to host"),
            ("Memcpy", "copy on card"), ("Memset", "memset"))


# tiny device kernels each profile runs ahead of the measured calls: the
# first device events of a profile can be lost (in this script's later
# phases 11-14 of them; none in a fresh process), whatever the host waits
# first, and the profiled Listing-3 forward then showed part of its span
# and one of its two pools or none.  Only events after the last pad count.
PROFILE_PAD = 256
PAD_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel


def device_breakdown(torch, run, calls: int = 1) -> dict:
    """Run ``PROFILE_PAD`` one-cycle ``torch.cuda._sleep`` kernels, then
    ``run()`` ``calls`` times back to back, under one ``torch.profiler`` session
    (CUDA activity only), and return per call the device time and
    launches per family of the events after the last pad, the span from
    the first of them to the last, and the device's busy share over it:
    the union of device events over that span.  ``pad_events_lost``: the
    pads the profile did not record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    events = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    pads = [e for e in events if PAD_KERNEL in e[2]]
    cut = max((e[1] for e in pads), default=float("-inf"))
    spans = sorted(e for e in events
                   if PAD_KERNEL not in e[2] and e[0] >= cut)
    if not spans:
        return {"measured": False,
                "pad_events_lost": PROFILE_PAD - len(pads)}
    busy, (lo, hi) = 0.0, spans[0][:2]
    by_family: dict = {}
    launches: dict = {}
    for s, e, name in spans:
        fam = next((f for frag, f in FAMILIES if frag in name), "torch ops")
        by_family[fam] = by_family.get(fam, 0.0) + (e - s) / 1e3 / calls
        launches[fam] = launches.get(fam, 0) + 1
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    return {"measured": True, "calls": calls, "events": len(spans),
            "pad_events_lost": PROFILE_PAD - len(pads),
            "span_ms": span / 1e3 / calls, "busy_ms": busy / 1e3 / calls,
            "busy_share": busy / span,
            "device_ms_by_family": dict(sorted(
                by_family.items(), key=lambda kv: -kv[1])),
            "launches_by_family": {k: v / calls for k, v in sorted(
                launches.items(), key=lambda kv: -kv[1])}}


def profiled(torch, label: str, run, digits: int = 2,
             calls: int = 1) -> dict:
    """``device_breakdown`` of ``calls`` calls of ``run()``, logged under
    ``label`` per call."""
    breakdown = device_breakdown(torch, run, calls)
    if breakdown["measured"]:
        fams = ", ".join(f"{k} {v:.{digits}f}" for k, v in
                         breakdown["device_ms_by_family"].items())
        per = "" if calls == 1 else f" (a call, of {calls} back to back)"
        log(f"[profile] {label}{per}: device busy "
            f"{breakdown['busy_ms']:.{digits}f} of "
            f"{breakdown['span_ms']:.{digits}f} ms "
            f"({100 * breakdown['busy_share']:.1f}%); device ms by family: "
            f"{fams}; launches by family: "
            f"{breakdown['launches_by_family']}; of {PROFILE_PAD} pad "
            f"kernels ahead, {breakdown['pad_events_lost']} not recorded")
    else:
        log(f"[profile] {label}: torch.profiler recorded no device events: "
            f"device busy share not measured")
    return breakdown


DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def dfp_in_path(sol, breakdown: dict, label: str) -> dict:
    """The DFP groups a forward of ``sol`` runs, the sum of their bytes
    bounds (each operand read once and the output written once, at its
    storage size, over HBM) and the profiled dfp_fused family beside it:
    how far the kernel is from its bound where the path runs it."""
    groups = [n for n in sol.graph.topo() if n.impl == "cuda.dfp_fused"]
    nbytes = sum(DTYPE_BYTES[t.spec.dtype] * math.prod(t.spec.shape)
                 for n in groups for t in (n, *n.inputs))
    by_program: dict = {}
    for n in groups:
        by_program[n.name] = by_program.get(n.name, 0) + 1
    out = {"groups": len(groups), "by_program": by_program,
           "bound_ms": 1e3 * nbytes / HBM,
           "family_ms": breakdown.get("device_ms_by_family", {}).get(
               "dfp_fused")}
    if out["family_ms"]:
        log(f"[dfp] {label}: {out['groups']} DFP groups a forward "
            f"{by_program}, their "
            f"bytes bounds sum to {out['bound_ms']:.3f} ms; the profiled "
            f"dfp_fused family reads {out['family_ms']:.3f} ms, so it runs "
            f"at {100 * out['bound_ms'] / out['family_ms']:.1f}% of its "
            f"bound")
    return out


# the padded Listing-3 profile must cover most of a warm forward
PROFILE_SPAN_SHARE = 0.75


def check_pools_profiled(name: str, breakdown: dict, forward_ms: float):
    """The Listing-3 forward's profile shows both pools in every call and
    spans most of the forward: nothing was lost at its start."""
    pools = breakdown.get("launches_by_family", {}).get("avgpool")
    span = breakdown.get("span_ms", 0.0)
    if pools != 2 or span < PROFILE_SPAN_SHARE * forward_ms:
        fail(f"{name}: the profiled forward shows {pools} avgpool launches "
             f"a call over {span:.3f} ms, the warm forward takes "
             f"{forward_ms:.3f} ms: events were lost")


def compare_tokens(name: str, got, ref, tol_of) -> list:
    """Greedy tokens must match; at the first mismatch of a request the
    reference's top-2 gap must be below its tolerance (a near tie)."""
    import numpy as np
    ties = []
    for i, ((g_tok, _), (r_tok, r_logits)) in enumerate(zip(got, ref)):
        for pos, (a, b) in enumerate(zip(g_tok, r_tok)):
            if a == b:
                continue
            top2 = np.sort(r_logits[pos])[-2:]
            gap = float(top2[1] - top2[0])
            if gap >= tol_of(r_logits[pos]):
                fail(f"{name}: request {i} token {pos} differs ({a} vs {b}) "
                     f"with a top-2 gap {gap:.3g} above the tolerance")
            ties.append({"request": i, "position": pos, "gap": gap})
            break
        if len(g_tok) != len(r_tok):
            fail(f"{name}: request {i} length {len(g_tok)} vs {len(r_tok)}")
    return ties


def serve_model(torch, dev):
    """Phase 3's model and config: the same weights on every call (a
    generator seeded 0 on the card)."""
    from repro_torch.frontends import nn
    from repro_torch.launch.serve import ServeConfig
    from torch import nn as tnn

    gen = torch.Generator(dev).manual_seed(0)
    kvh = FULL["n_kv_heads"]
    d, heads = FULL["d_model"], FULL["n_heads"]
    model = tnn.Sequential(
        *[nn.transformer_block(d, heads, kvh, device=dev, generator=gen)
          for _ in range(FULL["n_layers"])],
        nn.Linear(d, FULL["vocab"], device=dev, generator=gen))
    cfg_kw = {k: v for k, v in FULL.items() if k != "n_kv_heads"}
    return model, ServeConfig(**cfg_kw, backend="h100")


def phase_serve(torch, counters, dev, held):
    """Phases 3 and 4; returns the record and phase 4's ``torch_ref``
    trace (tokens and logits per request), which phase 8 is held to."""
    import numpy as np
    from repro_torch.launch.serve import SolServer
    from torch import nn as tnn

    t0 = time.perf_counter()
    model, cfg = serve_model(torch, dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] model: {n_params / 1e6:.1f} M parameters on the card "
        f"({4 * n_params / 1e9:.2f} GB f32) built in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = _workload(cfg.vocab)

    server = SolServer(cfg, model=model, device=dev)

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    got, m = measured_serve(server, prompts, reset_counts)
    launches = {name: c.launches for name, c in counters.items()}
    s = server.summary()            # both passes: copies, forwards, buckets
    log(f"[serve] h100: first pass (bucket compiles, kernel loads) "
        f"{m['first_pass_s']:.2f} s")
    log(f"[serve] h100, second pass: {m['tokens']} tokens in "
        f"{m['wall_ms']:.2f} ms = {m['tokens_per_s']:.2f} tok/s; ttft p50 "
        f"{m['ttft_p50_ms']:.2f} ms; prefill {m['prefill_ms']} ms; decode "
        f"step p50 {m['decode_p50_ms']:.2f} ms over {m['decode_steps']} "
        f"steps; forwards {m['forwards_ms']:.2f} ms, between forwards "
        f"(admission, KV gather and staging, arena writes, sampling) "
        f"{m['between_forwards_ms']:.2f} ms; dmas {s['dmas']} == forwards "
        f"{s['forwards']}: {s['dmas'] == s['forwards']}; buckets "
        f"{s['buckets']}")
    log(f"[serve] kernel launches in the second pass: {launches}")
    for key, sol in sorted(server._models.items()):
        check_held(sol, f"serve bucket {key}", held, "float32")
    if sorted(server._models) != sorted(serve_buckets(server)):
        fail(f"serve opened buckets {sorted(server._models)}, phase 2 held "
             f"{serve_buckets(server)}")
    if s["dmas"] != s["forwards"]:
        fail("more than one packed copy per forward")
    check_matmul_kernels("serve", launches)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    for key, rec in sorted(server.served_elections.items()):
        for kind in CUDA_KINDS:
            for impl in rec["by_op"].get(kind, {}):
                if not impl.startswith("cuda."):
                    fail(f"bucket {key}: {kind} elected {impl}")
        log(f"[serve] bucket {key}: {rec['by_op']}")
    for r, _ in got:
        if len(r) != GEN:
            fail("a request ended early")

    # a third pass under the profiler: where the device time goes, and how
    # much of the run the device is idle
    breakdown = profiled(torch, "h100 serve",
                         lambda: serve_trace(server, prompts, GEN))
    server.close()

    # phase 4: the plain path on the card, same weights, same requests
    ref_server = SolServer(dataclasses.replace(cfg, backend="torch_ref"),
                           model=model, device=dev)
    ref, rm = measured_serve(ref_server, prompts)
    ref_server.close()
    log(f"[serve] torch_ref, second pass: {rm['tokens_per_s']:.2f} tok/s; "
        f"ttft p50 {rm['ttft_p50_ms']:.2f} ms; decode step p50 "
        f"{rm['decode_p50_ms']:.2f} ms")
    worst = 0.0
    for i, ((g_tok, g_log), (r_tok, r_log)) in enumerate(zip(got, ref)):
        for pos, (a, b) in enumerate(zip(g_log, r_log)):
            scale = float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            worst = max(worst, err / scale)
            if err > LOGIT_RTOL * scale:
                fail(f"request {i} step {pos}: logits differ by {err:.3g} "
                     f"(scale {scale:.3g}, rtol {LOGIT_RTOL})")
            if g_tok[pos] != r_tok[pos]:
                break           # later steps see different tokens
    ties = compare_tokens("h100 vs torch_ref", got, ref,
                          lambda row: LOGIT_RTOL * float(np.abs(row).max()))
    log(f"[serve] logits vs torch_ref: worst max|Δ|/max|logit| {worst:.3g} "
        f"(rtol {LOGIT_RTOL}); greedy tokens identical"
        + (f" except near ties {ties}" if ties else ""))

    # decode program vs decode=False re-forward, 2 layers at full width
    model2 = tnn.Sequential(*list(model)[:2], model[-1])
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    dec_srv = SolServer(cfg2, model=model2, device=dev)
    _, dec, _ = serve_trace(dec_srv, prompts, GEN)
    dec_srv.close()
    ref_srv = SolServer(dataclasses.replace(cfg2, decode=False),
                        model=model2, device=dev)
    _, refw, _ = serve_trace(ref_srv, prompts, GEN)
    ref_srv.close()
    ties2 = compare_tokens("decode vs re-forward", dec, refw,
                           lambda row: LOGIT_RTOL * float(np.abs(row).max()))
    log(f"[serve] 2 layers: decode tokens == re-forward tokens"
        + (f" except near ties {ties2}" if ties2 else ""))
    return {"h100": m, "summary": s, "launches": launches,
            "device_breakdown": breakdown, "torch_ref": rm,
            "logit_rel_err": worst, "near_ties": ties,
            "decode_vs_reforward_near_ties": ties2}, ref


# ---------------------------------------------------------------------------
# phase 5: the recurrent block stacks through optimize()
# ---------------------------------------------------------------------------

# RWKV6-1.6B width (src/repro/configs/rwkv6_1_6b.py, arXiv:2404.05892) and
# RecurrentGemma-9B width (src/repro/configs/recurrentgemma_9b.py,
# arXiv:2402.19427): nn.py's blocks, full depth for RWKV6, and for Griffin
# the 26 RG-LRU layers of the model's 38 (pattern rglru, rglru, local)
STACKS = (
    ("rwkv6", dict(d_model=2048, n_heads=32, mlp_mult=3, layers=24)),
    ("griffin", dict(d_model=4096, mlp_mult=3, layers=26)),
)
REC_SHAPE_BT = (4, 512)
# h100 vs torch_ref, relative to the output's scale: each block alone, and
# each stack's output at these weights (seed 100 + its index).  Read by
# tools/torch_recurrent_agreement.py (PERF.md): Griffin's output reads
# ≤ 2.1e-6 over 6 seeds, a wrong scan ≥ 5.0e-4; RWKV6's reads 3.7e-4 and
# moves up to 2.2e-3 under f32 rounding of its input at this seed (up to
# 7.2e-2 at other seeds), a gross scan fault ≥ 0.83, while its subtle
# faults show only in the per-layer reading.
REC_LAYER_RTOL = 1e-4
REC_STACK_RTOL = {"rwkv6": 1e-2, "griffin": 1e-4}
REC_REPEATS = 3
SCAN_KIND = {"rwkv6": "rwkv6_scan", "griffin": "rglru_scan"}
# the graph kinds each kernel serves, so a kernel must launch where they are
KERNEL_KINDS = {"matmul": ("matmul", "linear"), "dfp_fused": ("fused",),
                "rglru_scan": ("rglru_scan",), "rwkv6_scan": ("rwkv6_scan",)}
# the matmul kernels each stack's products run on: RWKV6's LoRA A (N 4)
# is skinny, every other product of both stacks (LoRA B's K 4 included)
# takes the tensor cores
STACK_MATMUL_KERNELS = {"rwkv6": ("matmul_tc", "matmul_skinny"),
                        "griffin": ("matmul_tc",)}


def check_matmul_kernels(name: str, launches: dict, want=()) -> None:
    """Every matmul launch ran one of the two kernels, and each kernel in
    ``want`` launched."""
    split = launches["matmul_tc"] + launches["matmul_skinny"]
    if split != launches["matmul"]:
        fail(f"{name}: {launches['matmul']} matmul launches, {split} by the "
             f"tensor-core and skinny kernels")
    for k in want:
        if launches[k] <= 0:
            fail(f"{name}: {k} was not launched")


def _build_stack(name: str, cfg: dict, dev, gen):
    from repro_torch.frontends import nn
    from torch import nn as tnn
    if name == "rwkv6":
        blocks = [nn.rwkv6_block(cfg["d_model"], cfg["n_heads"],
                                 cfg["mlp_mult"], device=dev, generator=gen)
                  for _ in range(cfg["layers"])]
    else:
        blocks = [nn.griffin_block(cfg["d_model"], cfg["mlp_mult"],
                                   device=dev, generator=gen)
                  for _ in range(cfg["layers"])]
    return tnn.Sequential(*blocks)


def check_cuda_elected(sol, name: str) -> dict:
    """Every node that a ``cuda.*`` impl admits must have elected one (an
    unencodable FUSED group admits none and composes)."""
    from repro_torch.backends import registry
    from repro_torch.core.ir import SOURCE_OPS, OpKind
    for n in sol.graph.topo():
        if n.op in SOURCE_OPS or n.op is OpKind.OUTPUT:
            continue
        cuda = [c.name for c in registry.candidates(sol.backend, n)
                if c.name.startswith("cuda.")]
        if cuda and not (n.impl or "").startswith("cuda."):
            fail(f"{name}: {n.name or n.op.value} elected {n.impl} though "
                 f"{cuda} admit it")
    return sol.impl_report(by_kind=True)


def check_elections(sol, name: str) -> dict:
    """``check_cuda_elected``, and the scan must have elected its
    kernel."""
    by_kind = check_cuda_elected(sol, name)
    scan = SCAN_KIND[name]
    if set(by_kind.get(scan, {})) != {f"cuda.{scan}"}:
        fail(f"{name}: {scan} elected {by_kind.get(scan)}")
    return by_kind


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, taken in f32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def per_layer_errors(torch, model, shape, x, optimize,
                     dtype: str = "float32") -> list:
    """Each block compiled alone on both backends and fed the same input,
    torch_ref's output of the block before: the h100 output's error
    relative to its scale, layer by layer.  This holds every layer's
    kernels to the plain path at full width without the stack's own
    amplification of rounding."""
    out, cur = [], x
    for blk in model:
        h = optimize(blk, shape, backend="h100", dtype=dtype)(cur)
        cur = optimize(blk, shape, backend="torch_ref", dtype=dtype)(cur)
        out.append(rel_err(h, cur))
    torch.cuda.synchronize()
    return out


def timed_calls(torch, fn, repeats: int) -> list:
    """Host ms of ``fn()`` from an idle device to its end on the device,
    ``repeats`` times."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def timed_forwards(torch, sol, x, repeats: int) -> list:
    return timed_calls(torch, lambda: sol(x), repeats)


def phase_recurrent(torch, counters, dev, held) -> dict:
    """Each stack at full width through ``optimize(..., backend="h100")``:
    elections, launch counts of one forward, agreement with ``torch_ref``
    on the same weights layer by layer and at the output, warm forward
    times of both backends, and one profiled forward."""
    import gc
    import statistics
    from repro_torch.frontends.optimize import optimize

    results = {}
    for i, (name, cfg) in enumerate(STACKS):
        t0 = time.perf_counter()
        gen = torch.Generator(dev).manual_seed(100 + i)
        model = _build_stack(name, cfg, dev, gen)
        shape = REC_SHAPE_BT + (cfg["d_model"],)
        x = torch.randn(*shape, device=dev, generator=gen)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[recurrent] {name}: {cfg['layers']} blocks at d "
            f"{cfg['d_model']}, {n_params / 1e9:.3f} B parameters "
            f"({4 * n_params / 1e9:.2f} GB f32), input {shape}, built in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sol = optimize(model, shape, backend="h100")
        compile_s = time.perf_counter() - t0
        by_kind = check_elections(sol, name)
        check_held(sol, name, held, "float32")
        log(f"[recurrent] {name} h100 elections (optimize {compile_s:.2f} "
            f"s): {by_kind}")

        # the main path's run: counts from 0, one forward, counts read
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        y = sol(x)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: c.launches for k, c in counters.items()}
        for kernel, kinds in KERNEL_KINDS.items():
            if any(k in by_kind for k in kinds) and launches[kernel] <= 0:
                fail(f"{name}: kernel {kernel} was not launched though the "
                     f"graph has {kinds}")
        check_matmul_kernels(name, launches, STACK_MATMUL_KERNELS[name])
        if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()):
            fail(f"{name}: output {tuple(y.shape)} not finite or not "
                 f"{shape}")
        log(f"[recurrent] {name} kernel launches in one h100 forward: "
            f"{launches}; first forward {first_ms:.1f} ms")

        ref = optimize(model, shape, backend="torch_ref")
        want = ref(x)
        layers = per_layer_errors(torch, model, shape, x, optimize)
        worst_layer = max(layers)
        if not worst_layer <= REC_LAYER_RTOL:
            fail(f"{name}: layer {layers.index(worst_layer)} on h100 differs "
                 f"from torch_ref on the same input by {worst_layer:.3g} of "
                 f"its output's scale (rtol {REC_LAYER_RTOL})")
        err, limit = rel_err(y, want), REC_STACK_RTOL[name]
        if not err <= limit:
            fail(f"{name}: h100 output differs from torch_ref by {err:.3g} "
                 f"of its scale (rtol {limit})")
        log(f"[recurrent] {name} vs torch_ref: each layer on the same input "
            f"within {worst_layer:.3g} of its scale (rtol {REC_LAYER_RTOL});"
            f" the stack's output within {err:.3g} of max|y| "
            f"{float(want.abs().max()):.3g} (rtol {limit})")

        # warm forwards, the two backends in turns: h100, ref, ref, h100
        h_ms = timed_forwards(torch, sol, x, REC_REPEATS)
        r_ms = timed_forwards(torch, ref, x, 2 * REC_REPEATS)
        h_ms += timed_forwards(torch, sol, x, REC_REPEATS)
        h_med, r_med = statistics.median(h_ms), statistics.median(r_ms)
        log(f"[recurrent] {name} warm forward ms, median of "
            f"{len(h_ms)}: h100 {h_med:.2f} {[round(v, 2) for v in h_ms]}, "
            f"torch_ref {r_med:.2f} {[round(v, 2) for v in r_ms]}")
        breakdown = profiled(torch, f"{name} h100 forward", lambda: sol(x))
        dfp = dfp_in_path(sol, breakdown, name)
        results[name] = {
            "config": cfg, "shape": shape, "parameters": n_params,
            "optimize_s": compile_s, "elections": by_kind,
            "launches": launches, "first_forward_ms": first_ms,
            "rel_err": err, "rel_err_limit": limit,
            "per_layer_rel_err": layers,
            "output_scale": float(want.abs().max()),
            "h100_ms": h_ms, "h100_ms_median": h_med,
            "torch_ref_ms": r_ms, "torch_ref_ms_median": r_med,
            "device_breakdown": breakdown, "dfp_in_path": dfp}
        del model, sol, ref, x, y, want
        gc.collect()
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 6: the CNNs through optimize()
# ---------------------------------------------------------------------------

CNN_SHAPE = (64, 3, 224, 224)       # ImageNet resolution, batch 64
CNN_CLASSES = 1000
CNN_RTOL = 1e-4
CNN_REPEATS = 3
CNN_PROFILE_CALLS = 3   # forwards a CNN's profile takes, back to back


def listing3_cnn(nn, **kw):
    """``depthwise_cnn`` with ``AvgPool2d(3, stride=1)`` after each of its
    two bias-free depthwise convs: the paper's Listing 3 pooling."""
    from torch import nn as tnn
    mods = list(nn.depthwise_cnn(**kw))
    mods.insert(3, nn.AvgPool2d(3, stride=1))
    mods.insert(8, nn.AvgPool2d(3, stride=1))
    return tnn.Sequential(*mods)


def _build_cnn(torch, name: str, dev, gen):
    """The network with seeded weights, nonzero biases and running stats,
    in eval mode."""
    from repro_torch.frontends import nn
    kw = dict(classes=CNN_CLASSES, device=dev, generator=gen)
    model = (listing3_cnn(nn, **kw) if name == "listing3_cnn"
             else getattr(nn, name)(**kw)).eval()
    with torch.no_grad():
        for pname, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if pname.endswith("bias") or pname.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, device=dev,
                                          generator=gen))
            elif pname.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, device=dev,
                                         generator=gen))
    return model


def conv_bias_group(n) -> bool:
    return n.op.value == "fused" and any(
        b.op.value == "bias_add" and b.attrs.get("axis") == 1 for b in n.body)


def host_enqueue_ms(torch, sol, x) -> float:
    """Host time from an idle device until ``sol(x)`` returns, before the
    device has finished: the forward's Python and launch cost."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol(x)
    ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ms


def phase_cnn(torch, counters, dev, held) -> dict:
    """Each CNN through ``optimize(..., backend="h100")``: elections, the
    launch counts of one forward, agreement with ``torch_ref`` on the same
    weights, warm forward times of both backends in turns, and one
    profiled forward."""
    import gc
    import statistics
    from repro_torch.frontends.optimize import optimize

    results = {}
    for i, name in enumerate(("small_cnn", "depthwise_cnn",
                              "listing3_cnn")):
        gen = torch.Generator(dev).manual_seed(200 + i)
        model = _build_cnn(torch, name, dev, gen)
        x = torch.randn(*CNN_SHAPE, device=dev, generator=gen)
        t0 = time.perf_counter()
        sol = optimize(model, CNN_SHAPE, backend="h100")
        compile_s = time.perf_counter() - t0
        by_kind = check_cuda_elected(sol, name)
        check_held(sol, name, held, "float32")
        nodes = sol.graph.topo()
        pools = sum(n.op.value == "avgpool" for n in nodes)
        if pools != (2 if name == "listing3_cnn" else 0) or \
                by_kind.get("avgpool", {}) != (
                    {"cuda.avgpool": pools} if pools else {}):
            fail(f"{name}: {pools} AVGPOOL nodes elected "
                 f"{by_kind.get('avgpool')}")
        if set(by_kind.get("linear", {})) != {"cuda.linear"}:
            fail(f"{name}: linear elected {by_kind.get('linear')}")
        for n in nodes:
            if conv_bias_group(n) and n.impl != "ref.compose":
                fail(f"{name}: conv bias group {n.name} elected {n.impl}")
        log(f"[cnn] {name} h100 elections (optimize {compile_s:.2f} s): "
            f"{by_kind}")

        # the main path's run: counts from 0, one forward, counts read
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        y = sol(x)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: c.launches for k, c in counters.items()}
        if launches["avgpool"] != pools:
            fail(f"{name}: {launches['avgpool']} avgpool launches in one "
                 f"forward, {pools} AVGPOOL nodes")
        if launches["matmul"] < by_kind["linear"]["cuda.linear"]:
            fail(f"{name}: matmul launched {launches['matmul']} times")
        check_matmul_kernels(name, launches, ("matmul_tc",))
        if "cuda.dfp_fused" in by_kind.get("fused", {}) and \
                launches["dfp_fused"] <= 0:
            fail(f"{name}: dfp_fused elected but not launched")
        want_shape = (CNN_SHAPE[0], CNN_CLASSES)
        if tuple(y.shape) != want_shape or not bool(torch.isfinite(y).all()):
            fail(f"{name}: output {tuple(y.shape)} not finite or not "
                 f"{want_shape}")
        ref = optimize(model, CNN_SHAPE, backend="torch_ref")
        want = ref(x)
        err = rel_err(y, want)
        if not err <= CNN_RTOL:
            fail(f"{name}: h100 output differs from torch_ref by {err:.3g} "
                 f"of its scale (rtol {CNN_RTOL})")
        log(f"[cnn] {name}: launches in one h100 forward {launches}; first "
            f"forward {first_ms:.1f} ms; output within {err:.3g} of "
            f"torch_ref's max|y| {float(want.abs().max()):.3g} (rtol "
            f"{CNN_RTOL})")

        # warm forwards, the two backends in turns: h100, ref, ref, h100;
        # then the host's share: how long a call takes to return
        h_ms = timed_forwards(torch, sol, x, CNN_REPEATS)
        r_ms = timed_forwards(torch, ref, x, 2 * CNN_REPEATS)
        h_ms += timed_forwards(torch, sol, x, CNN_REPEATS)
        h_med, r_med = statistics.median(h_ms), statistics.median(r_ms)
        enqueue_ms = statistics.median(
            host_enqueue_ms(torch, sol, x) for _ in range(CNN_REPEATS))
        log(f"[cnn] {name} warm forward ms, median of {len(h_ms)}: h100 "
            f"{h_med:.3f} {[round(v, 3) for v in h_ms]}, torch_ref "
            f"{r_med:.3f} {[round(v, 3) for v in r_ms]}; an h100 call "
            f"returns to the host after {enqueue_ms:.3f} ms")
        breakdown = profiled(torch, f"{name} h100 forward", lambda: sol(x),
                             digits=3, calls=CNN_PROFILE_CALLS)
        if name == "listing3_cnn":
            check_pools_profiled(name, breakdown, h_med)
        results[name] = {
            "shape": CNN_SHAPE, "classes": CNN_CLASSES,
            "parameters": sum(p.numel() for p in model.parameters()),
            "optimize_s": compile_s, "elections": by_kind,
            "launches": launches, "first_forward_ms": first_ms,
            "rel_err": err, "rel_err_limit": CNN_RTOL,
            "output_scale": float(want.abs().max()),
            "h100_ms": h_ms, "h100_ms_median": h_med,
            "torch_ref_ms": r_ms, "torch_ref_ms_median": r_med,
            "h100_enqueue_ms": enqueue_ms, "device_breakdown": breakdown}
        del model, sol, ref, x, y, want
        gc.collect()
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 7: the bf16 paths
# ---------------------------------------------------------------------------

# Gates, relative to the output's scale, written before the first run of
# this phase: each recurrent block alone, the transformer's logits (full
# program and decode step) and the CNN's output against torch_ref on the
# same bf16 module, at README's bf16 row; a recurrent stack's output
# against torch_ref in f32 on the same bf16-rounded weights and input,
# within BF16_FLOOR_FACTOR times torch_ref bf16's own error there (the
# stack's bf16 floor).
BF16_ROW = {"transformer": 3e-2, "rwkv6": 5e-2, "griffin": 3e-2,
            "listing3_cnn": 3e-2}
BF16_FLOOR_FACTOR = 2.0
# RWKV6's floor at 24 blocks is about half its output's scale (torch_ref
# bf16 lies 0.51 of it from torch_ref f32), where the floor gate passes any
# output; its first two blocks, where the floor is a few percent, are held
# to the same rule, beside a control with the scan's bonus u zeroed
BF16_PREFIX_BLOCKS = 2
BF16_LM_SHAPE = (4, 256, 1536)       # the full program: 4 x 256 tokens
BF16_DECODE_CACHE = 128
BF16_DECODE_LENS = (0, 37, 100, 127)
BF16_REPEATS = 3
# what each bf16 path must launch, beside check_cuda_elected's elections
BF16_KERNELS = {
    "transformer": ("matmul", "matmul_tc", "flash_attention", "dfp_fused"),
    "transformer decode": ("matmul", "matmul_skinny", "decode_attention",
                           "dfp_fused"),
    "rwkv6": ("matmul", "dfp_fused", "rwkv6_scan"),
    "griffin": ("matmul", "dfp_fused", "rglru_scan"),
    "listing3_cnn": ("matmul", "avgpool"),
}


def dfp_program(n):
    from repro_torch.kernels.dfp_fused.program import encode_program
    return encode_program(n, {id(i): i.spec for i in n.inputs})[0]


def node_key(n) -> tuple:
    """What a phase-2 row must match to hold a ``cuda.*`` node: its kernel
    and the shapes (a DFP group's program, flash attention's mask) it runs
    them at.  A LINEAR reads its (out, in) weight transposed."""
    kind = n.impl[len("cuda."):]
    s = [tuple(i.spec.shape) for i in n.inputs]
    if kind in ("matmul", "linear"):
        lead, w = s[0][:-1], s[1]
        n_out = w[0] if kind == "linear" else w[-1]
        return ("matmul", math.prod(lead), s[0][-1], n_out, kind == "linear")
    if kind == "flash_attention":
        b, t, h, hd = s[0]
        return (kind, b, t, h, s[1][2], hd, n.attrs.get("causal", True),
                n.attrs.get("window", 0), n.attrs.get("cap", 0.0))
    if kind == "decode_attention":
        b, _, h, hd = s[0]
        return (kind, b, s[1][1], h, s[1][2], hd)
    if kind == "dfp_fused":
        out = tuple(n.spec.shape)
        return (kind, repr(dfp_program(n)), math.prod(out[:-1]), out[-1])
    if kind == "avgpool":
        k = n.attrs.get("kernel", 2)
        return (kind, *s[0], *((k, k) if isinstance(k, int) else k))
    return (kind, *s[0])            # the scans: their first operand


def cuda_keys(sol) -> dict:
    """node_key -> the first ``cuda.*`` node of ``sol``'s graph with it."""
    out = {}
    for n in sol.graph.topo():
        if (n.impl or "").startswith("cuda."):
            out.setdefault(node_key(n), n)
    return out


def serve_buckets(server) -> list:
    """The bucket keys phase 3's requests open on ``server``, by
    ``SolServer``'s own bucket rule: every request is admitted at once and
    prefilled in one forward, then decoded together while the longest
    cache grows from max(PROMPT_LENS) for GEN - 1 steps."""
    n = min(len(PROMPT_LENS), server.cfg.max_batch)
    keys = [("prefill",) + server._bucket(n, max(PROMPT_LENS))]
    for i in range(GEN - 1):
        key = ("decode",) + server._bucket(n, max(PROMPT_LENS) + i)
        if key not in keys:
            keys.append(key)
    return keys


def path_nodes(torch, dev, dtype: str) -> dict:
    """node_key -> (path, node) of every kernel node that a phase runs in
    ``dtype``, read from two-block versions of its paths at full width (a
    path's blocks are alike; nothing is launched).  float32: the serve's
    programs at the buckets phase 3 opens (``serve_buckets``, built by a
    two-layer ``SolServer``), both stacks (phase 5) and the three CNNs
    (phase 6).  bfloat16 (phase 7): the transformer's full program and
    decode step with the LM head, each stack, the Listing-3 CNN."""
    from repro_torch.frontends import extract
    from repro_torch.frontends.optimize import compile_graph, optimize
    from repro_torch.launch.serve import ServeConfig, SolServer, build_lm

    gen = torch.Generator(dev).manual_seed(0)
    half = dtype != "float32"
    tdt, out = getattr(torch, dtype), {}
    kw = dict(dtype=dtype) if half else {}

    def add(sol, path):
        for k, n in cuda_keys(sol).items():
            out.setdefault(k, (path, n))

    cfg = ServeConfig(**{k: v for k, v in FULL.items() if k != "n_kv_heads"},
                      backend="h100")
    cfg = dataclasses.replace(cfg, n_layers=2)
    with torch.no_grad():
        lm = build_lm(cfg, n_kv_heads=FULL["n_kv_heads"], device=dev,
                      generator=gen).to(tdt)
    if half:
        b, d = BF16_LM_SHAPE[0], FULL["d_model"]
        add(optimize(lm, BF16_LM_SHAPE, backend="h100", device=dev, **kw),
            "transformer")
        add(compile_graph(lm, extract.extract_decode(
            lm, b, BF16_DECODE_CACHE, d, dtype), "h100", device=dev),
            "transformer decode")
    else:
        server = SolServer(cfg, model=lm, device=dev)
        for key in serve_buckets(server):
            add(server._model_for(key), f"serve {key[0]}")
        server.close()
    del lm
    for name, stack in STACKS:
        with torch.no_grad():
            m = _build_stack(name, {**stack, "layers": 2}, dev, gen).to(tdt)
        add(optimize(m, REC_SHAPE_BT + (stack["d_model"],), backend="h100",
                     device=dev, **kw), name)
    for name in (("listing3_cnn",) if half else
                 ("small_cnn", "depthwise_cnn", "listing3_cnn")):
        with torch.no_grad():
            m = _build_cnn(torch, name, dev, gen).to(tdt)
        add(optimize(m, CNN_SHAPE, backend="h100", device=dev, **kw), name)
    return out


def check_held(sol, name: str, held, dtype: str) -> None:
    """Phase 2 held every kernel node of the path against its plain
    version at the node's shapes, in ``dtype``; ``held``: the node keys of
    its rows in that dtype."""
    missing = [k for k in cuda_keys(sol) if k not in held]
    if missing:
        fail(f"{name} {dtype}: phase 2 held no {dtype} row at {missing}")


def _bf16_run(torch, counters, name, fn):
    """The path's run: counts from 0, one call, counts read; every kernel
    of BF16_KERNELS[name] must have launched."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    check_matmul_kernels(f"{name} bf16", launches)
    for k in BF16_KERNELS[name]:
        if launches[k] <= 0:
            fail(f"{name} bf16: {k} was not launched")
    return out, launches


def _check_finite(torch, name, y, shape) -> None:
    if tuple(y.shape) != tuple(shape) or y.dtype != torch.bfloat16 or \
            not bool(torch.isfinite(y.float()).all()):
        fail(f"{name} bf16: output {tuple(y.shape)} {y.dtype} not finite "
             f"bf16 of shape {tuple(shape)}")


def _gate(name: str, what: str, err: float, limit: float) -> None:
    if not err <= limit:
        fail(f"{name} bf16: {what} {err:.3g} of its scale > {limit}")


def _in_turns(torch, h100, ref):
    """Warm calls of both backends in turns (h100, ref, ref, h100): the
    h100 and torch_ref ms lists."""
    h_ms = timed_calls(torch, h100, BF16_REPEATS)
    r_ms = timed_calls(torch, ref, 2 * BF16_REPEATS)
    h_ms += timed_calls(torch, h100, BF16_REPEATS)
    return h_ms, r_ms


def bf16_transformer(torch, counters, dev, held) -> dict:
    """build_lm's 28 blocks and head at Qwen2-1.5B width, cast to bf16: the
    full program at BF16_LM_SHAPE and one decode step against a bf16 cache
    with lens BF16_DECODE_LENS, each against torch_ref bf16, timed beside
    the same program in f32 on h100."""
    import statistics
    from repro_torch.frontends import extract
    from repro_torch.frontends.optimize import compile_graph, optimize
    from repro_torch.launch.serve import ServeConfig, build_lm

    cfg = ServeConfig(**{k: v for k, v in FULL.items() if k != "n_kv_heads"},
                      backend="h100")
    gen = torch.Generator(dev).manual_seed(300)
    model = build_lm(cfg, n_kv_heads=FULL["n_kv_heads"], device=dev,
                     generator=gen)
    shape = BF16_LM_SHAPE
    b, d = shape[0], FULL["d_model"]
    x = torch.randn(*shape, device=dev, generator=gen)
    lens = torch.tensor(BF16_DECODE_LENS, dtype=torch.int32, device=dev)

    def decode_graph(dtype):
        return extract.extract_decode(model, b, BF16_DECODE_CACHE, d, dtype)

    step = torch.randn(b, 1, d, device=dev, generator=gen)
    caches = [torch.randn(*n.spec.shape, device=dev, generator=gen)
              for n in decode_graph("float32").inputs[2:]]

    # the same programs in f32 on h100, for the times beside bf16's
    sol32 = optimize(model, shape, backend="h100")
    dec32 = compile_graph(model, decode_graph("float32"), "h100")
    sol32(x)
    dec32(step, lens, *caches)
    f32_ms = timed_calls(torch, lambda: sol32(x), 2 * BF16_REPEATS)
    f32_dec_ms = timed_calls(torch, lambda: dec32(step, lens, *caches),
                             2 * BF16_REPEATS)
    del sol32, dec32

    model.to(torch.bfloat16)
    x16, step16 = x.to(torch.bfloat16), step.to(torch.bfloat16)
    caches16 = [c.to(torch.bfloat16) for c in caches]
    sol = optimize(model, shape, backend="h100", dtype="bfloat16")
    by_kind = check_cuda_elected(sol, "transformer bf16")
    dec = compile_graph(model, decode_graph("bfloat16"), "h100")
    by_kind_dec = check_cuda_elected(dec, "transformer decode bf16")
    check_held(sol, "transformer", held, "bfloat16")
    check_held(dec, "transformer decode", held, "bfloat16")
    for kind, impl, rep in (("linear", "cuda.linear", by_kind),
                            ("matmul", "cuda.matmul", by_kind),
                            ("attention", "cuda.flash_attention", by_kind),
                            ("fused", "cuda.dfp_fused", by_kind),
                            ("decode_attention", "cuda.decode_attention",
                             by_kind_dec)):
        if set(rep.get(kind, {})) != {impl}:
            fail(f"transformer bf16: {kind} elected {rep.get(kind)}")
    y, launches = _bf16_run(torch, counters, "transformer", lambda: sol(x16))
    _check_finite(torch, "transformer", y, shape[:2] + (FULL["vocab"],))
    outs, dec_launches = _bf16_run(
        torch, counters, "transformer decode",
        lambda: dec(step16, lens, *caches16))
    for o in outs:
        _check_finite(torch, "transformer decode", o, o.shape)

    ref = optimize(model, shape, backend="torch_ref", dtype="bfloat16")
    dref = compile_graph(model, decode_graph("bfloat16"), "torch_ref")
    err = rel_err(y, ref(x16))
    _gate("transformer", "logits differ from torch_ref's by", err,
          BF16_ROW["transformer"])
    want_outs = dref(step16, lens, *caches16)
    dec_err = max(rel_err(o, w) for o, w in zip(outs, want_outs))
    _gate("transformer", "the decode step's outputs differ by", dec_err,
          BF16_ROW["transformer"])
    log(f"[bf16] transformer: elections {by_kind}; decode {by_kind_dec}; "
        f"launches, full program {launches}, decode step {dec_launches}; "
        f"logits within {err:.3g} of torch_ref bf16's scale, decode step "
        f"{dec_err:.3g} (row {BF16_ROW['transformer']})")

    h_ms, r_ms = _in_turns(torch, lambda: sol(x16), lambda: ref(x16))
    hd_ms, rd_ms = _in_turns(torch, lambda: dec(step16, lens, *caches16),
                             lambda: dref(step16, lens, *caches16))
    med = statistics.median
    log(f"[bf16] transformer full program {shape} warm ms: h100 bf16 "
        f"{med(h_ms):.3f} {[round(v, 3) for v in h_ms]}, torch_ref bf16 "
        f"{med(r_ms):.3f}, h100 f32 {med(f32_ms):.3f}; decode step: h100 "
        f"bf16 {med(hd_ms):.3f}, torch_ref bf16 {med(rd_ms):.3f}, h100 f32 "
        f"{med(f32_dec_ms):.3f}")
    breakdown = profiled(torch, "transformer bf16 full program",
                         lambda: sol(x16))
    dec_breakdown = profiled(torch, "transformer bf16 decode step",
                             lambda: dec(step16, lens, *caches16))
    total = {k: launches[k] + dec_launches[k] for k in launches}
    return {"shape": shape, "device_breakdown": breakdown,
            "decode_device_breakdown": dec_breakdown, "decode_lens": BF16_DECODE_LENS,
            "decode_cache": BF16_DECODE_CACHE, "elections": by_kind,
            "decode_elections": by_kind_dec, "launches": total,
            "launches_full": launches, "launches_decode": dec_launches,
            "rel_err": err, "decode_rel_err": dec_err,
            "rel_err_limit": BF16_ROW["transformer"],
            "h100_ms": h_ms, "h100_ms_median": med(h_ms),
            "torch_ref_ms": r_ms, "torch_ref_ms_median": med(r_ms),
            "h100_f32_ms": f32_ms, "h100_f32_ms_median": med(f32_ms),
            "decode_h100_ms": hd_ms, "decode_h100_ms_median": med(hd_ms),
            "decode_torch_ref_ms": rd_ms,
            "decode_torch_ref_ms_median": med(rd_ms),
            "decode_h100_f32_ms": f32_dec_ms,
            "decode_h100_f32_ms_median": med(f32_dec_ms)}


def bf16_stack(torch, counters, dev, index: int, name: str, cfg: dict,
               f32_ms: float, held) -> dict:
    """The phase-5 stack (same seed, same weights) rounded to bf16: each
    block alone and the stack's output held to the gates above, warm
    forwards in turns with torch_ref bf16."""
    import statistics
    from repro_torch.frontends.optimize import optimize

    gen = torch.Generator(dev).manual_seed(100 + index)
    model = _build_stack(name, cfg, dev, gen)
    shape = REC_SHAPE_BT + (cfg["d_model"],)
    x = torch.randn(*shape, device=dev, generator=gen)
    with torch.no_grad():       # the weights rounded to bf16, held in f32
        model.to(torch.bfloat16).float()
    want32 = optimize(model, shape, backend="torch_ref")(
        x.to(torch.bfloat16).float())
    model.to(torch.bfloat16)
    x16 = x.to(torch.bfloat16)

    sol = optimize(model, shape, backend="h100", dtype="bfloat16")
    by_kind = check_elections(sol, name)
    check_held(sol, name, held, "bfloat16")
    y, launches = _bf16_run(torch, counters, name, lambda: sol(x16))
    _check_finite(torch, name, y, shape)
    ref = optimize(model, shape, backend="torch_ref", dtype="bfloat16")
    want = ref(x16)
    layers = per_layer_errors(torch, model, shape, x16, optimize, "bfloat16")
    worst = max(layers)
    _gate(name, f"layer {layers.index(worst)} on h100 differs from "
          f"torch_ref on the same input by", worst, BF16_ROW[name])
    err_h, err_r = rel_err(y, want32), rel_err(want, want32)
    _gate(name, f"the output's distance from torch_ref f32 (torch_ref "
          f"bf16's: {err_r:.3g}) is", err_h, BF16_FLOOR_FACTOR * err_r)
    prefix = (bf16_rwkv6_prefix(torch, model, shape, x16)
              if name == "rwkv6" else None)
    h_ms, r_ms = _in_turns(torch, lambda: sol(x16), lambda: ref(x16))
    med = statistics.median
    log(f"[bf16] {name}: elections {by_kind}; launches {launches}; each "
        f"layer within {worst:.3g} of torch_ref bf16 (row "
        f"{BF16_ROW[name]}); output from torch_ref f32: h100 bf16 "
        f"{err_h:.3g}, torch_ref bf16 {err_r:.3g} (limit "
        f"{BF16_FLOOR_FACTOR:g}x); warm ms: h100 bf16 {med(h_ms):.2f} "
        f"{[round(v, 2) for v in h_ms]}, torch_ref bf16 {med(r_ms):.2f}, "
        f"h100 f32 (phase 5) {f32_ms:.2f}")
    breakdown = profiled(torch, f"{name} bf16 h100 forward",
                         lambda: sol(x16))
    out = {"config": cfg, "shape": shape, "elections": by_kind,
           "device_breakdown": breakdown,
           "dfp_in_path": dfp_in_path(sol, breakdown, f"{name} bf16"),
           "launches": launches, "per_layer_rel_err": layers,
           "rel_err_f32_h100": err_h, "rel_err_f32_torch_ref": err_r,
           "floor_factor": BF16_FLOOR_FACTOR, "layer_limit": BF16_ROW[name],
           "prefix_floor": prefix,
           "h100_ms": h_ms, "h100_ms_median": med(h_ms),
           "torch_ref_ms": r_ms, "torch_ref_ms_median": med(r_ms),
           "h100_f32_ms_median": f32_ms}
    del model, sol, ref, x, x16, y, want, want32
    return out


def bf16_rwkv6_prefix(torch, model, shape, x16) -> dict:
    """The bf16 floor gate on RWKV6's first BF16_PREFIX_BLOCKS blocks, and
    its control: the same blocks on h100 with the scan's bonus u zeroed
    must lie beyond the limit."""
    import copy
    from torch import nn as tnn
    from repro_torch.frontends.optimize import optimize
    from repro_torch.kernels.rwkv6_scan import ops

    n = BF16_PREFIX_BLOCKS
    sub = tnn.Sequential(*list(model)[:n])
    want32 = optimize(copy.deepcopy(sub).float(), shape,
                      backend="torch_ref")(x16.float())
    err_r = rel_err(optimize(sub, shape, backend="torch_ref",
                             dtype="bfloat16")(x16), want32)
    sol = optimize(sub, shape, backend="h100", dtype="bfloat16")
    err_h = rel_err(sol(x16), want32)
    limit = BF16_FLOOR_FACTOR * err_r
    _gate("rwkv6", f"the first {n} blocks' distance from torch_ref f32 "
          f"(torch_ref bf16's: {err_r:.3g}) is", err_h, limit)
    real = ops.rwkv6_scan
    ops.rwkv6_scan = lambda r, k, v, logw, u, s0, **kw: real(
        r, k, v, logw, torch.zeros_like(u), s0, **kw)
    try:
        err_fault = rel_err(sol(x16), want32)
    finally:
        ops.rwkv6_scan = real
    if not err_fault > limit:
        fail(f"rwkv6 bf16: the first {n} blocks with u zeroed read "
             f"{err_fault:.3g}, within the floor gate's {limit:.3g}")
    log(f"[bf16] rwkv6 first {n} blocks from torch_ref f32: h100 bf16 "
        f"{err_h:.3g}, torch_ref bf16 {err_r:.3g} (limit {limit:.3g}); "
        f"with u zeroed {err_fault:.3g}")
    return {"blocks": n, "rel_err_f32_h100": err_h,
            "rel_err_f32_torch_ref": err_r, "limit": limit,
            "u_zeroed_rel_err_f32": err_fault}


def bf16_cnn(torch, counters, dev, f32_ms: float, held) -> dict:
    """The phase-6 Listing-3 CNN (same seed, same weights) cast to bf16."""
    import statistics
    from repro_torch.frontends.optimize import optimize

    gen = torch.Generator(dev).manual_seed(202)
    model = _build_cnn(torch, "listing3_cnn", dev, gen)
    x = torch.randn(*CNN_SHAPE, device=dev, generator=gen)
    model.to(torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    sol = optimize(model, CNN_SHAPE, backend="h100", dtype="bfloat16")
    by_kind = check_cuda_elected(sol, "listing3_cnn bf16")
    if by_kind.get("avgpool") != {"cuda.avgpool": 2} or \
            set(by_kind.get("linear", {})) != {"cuda.linear"}:
        fail(f"listing3_cnn bf16: elections {by_kind}")
    check_held(sol, "listing3_cnn", held, "bfloat16")
    for n in sol.graph.topo():
        if conv_bias_group(n) and n.impl != "ref.compose":
            fail(f"listing3_cnn bf16: conv bias group {n.name} elected "
                 f"{n.impl}")
    y, launches = _bf16_run(torch, counters, "listing3_cnn",
                            lambda: sol(x16))
    if launches["avgpool"] != 2:
        fail(f"listing3_cnn bf16: {launches['avgpool']} avgpool launches")
    _check_finite(torch, "listing3_cnn", y, (CNN_SHAPE[0], CNN_CLASSES))
    ref = optimize(model, CNN_SHAPE, backend="torch_ref", dtype="bfloat16")
    err = rel_err(y, ref(x16))
    _gate("listing3_cnn", "output differs from torch_ref's by", err,
          BF16_ROW["listing3_cnn"])
    h_ms, r_ms = _in_turns(torch, lambda: sol(x16), lambda: ref(x16))
    med = statistics.median
    log(f"[bf16] listing3_cnn: elections {by_kind}; launches {launches}; "
        f"output within {err:.3g} of torch_ref bf16's scale (row "
        f"{BF16_ROW['listing3_cnn']}); warm ms: h100 bf16 {med(h_ms):.3f} "
        f"{[round(v, 3) for v in h_ms]}, torch_ref bf16 {med(r_ms):.3f}, "
        f"h100 f32 (phase 6) {f32_ms:.3f}")
    breakdown = profiled(torch, "listing3_cnn bf16 h100 forward",
                         lambda: sol(x16), digits=3, calls=CNN_PROFILE_CALLS)
    check_pools_profiled("listing3_cnn bf16", breakdown, med(h_ms))
    out = {"shape": CNN_SHAPE, "elections": by_kind, "launches": launches,
           "device_breakdown": breakdown,
           "rel_err": err, "rel_err_limit": BF16_ROW["listing3_cnn"],
           "h100_ms": h_ms, "h100_ms_median": med(h_ms),
           "torch_ref_ms": r_ms, "torch_ref_ms_median": med(r_ms),
           "h100_f32_ms_median": f32_ms}
    del model, sol, ref, x, x16, y
    return out


def phase_bf16(torch, counters, dev, recurrent, cnn, held) -> dict:
    """The four paths with bf16 weights and inputs through
    ``optimize(..., dtype="bfloat16", backend="h100")`` at the f32 phases'
    widths; ``held``: the node keys of phase 2's bf16 rows."""
    import gc
    results = {"transformer": bf16_transformer(torch, counters, dev, held)}
    gc.collect()
    torch.cuda.empty_cache()
    for i, (name, cfg) in enumerate(STACKS):
        results[name] = bf16_stack(torch, counters, dev, i, name, cfg,
                                   recurrent[name]["h100_ms_median"], held)
        gc.collect()
        torch.cuda.empty_cache()
    results["listing3_cnn"] = bf16_cnn(
        torch, counters, dev, cnn["listing3_cnn"]["h100_ms_median"], held)
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 8: the measured serve
# ---------------------------------------------------------------------------

# the served kernels' impls and the launch counter each moves
SERVED_IMPLS = {"cuda.linear": "matmul", "cuda.matmul": "matmul",
                "cuda.flash_attention": "flash_attention",
                "cuda.decode_attention": "decode_attention",
                "cuda.dfp_fused": "dfp_fused"}
MEASURE_WARMUP, MEASURE_ITERS = 1, 3


def measured_table(cache, tag: str) -> list:
    """One row a measured (op, shape bucket, dtype) of ``cache`` (the
    nearest power of two of each dim, as the cache keys it: 1536 reads
    2048, 151936 reads 131072): each impl's min and mean µs and best
    config, the winner (the least min, as the election takes it) and its
    config; each row logged."""
    groups: dict = {}
    for (op, dt, _bk), bucket, impl, m in cache.entries():
        groups.setdefault((op, bucket, dt), {})[impl] = m
    rows = []
    for (op, bucket, dt), impls in groups.items():
        win = min(impls, key=lambda nm: impls[nm].us)
        row = {"op": op, "shape": bucket, "dtype": dt,
               "impls": {nm: {"min_us": m.us, "mean_us": m.mean_us,
                              "config": m.config} for nm, m in impls.items()},
               "winner": win, "config": impls[win].config}
        rows.append(row)
        text = "; ".join(
            f"{nm} min {v['min_us']:.2f} mean {v['mean_us']:.2f} µs"
            + (f" (best config {v['config']})" if v["config"] else "")
            for nm, v in sorted(row["impls"].items()))
        log(f"[measured] {tag} {op} bucket {'x'.join(str(d) for d in bucket)} "
            f"{dt}: "
            f"{text} → {win}" + (f", pinned {row['config']}"
                                 if row["config"] else ""))
    return rows


def phase_measured_serve(torch, counters, dev, serve, serve_ref,
                         bf16_products) -> dict:
    """Phase 3's model and requests on a strict measured-provenance server,
    with a fresh autotune cache installed for the phase (the cold cache of
    phases 3 and 5-7 comes back in a ``finally``)."""
    import numpy as np
    from repro_torch.backends import h100_spec, registry
    from repro_torch.benchmarks import autotune as drv
    from repro_torch.core import autotune as AT
    from repro_torch.launch.serve import SERVED_KINDS, SolServer

    t_phase = time.perf_counter()
    hw = h100_spec(torch.cuda.get_device_name(0))
    model, cfg = serve_model(torch, dev)
    prompts = _workload(cfg.vocab)
    prev = AT.get_cache()
    AT.set_cache(AT.AutotuneCache())
    try:
        server = SolServer(cfg, model=model, device=dev,
                           strict_provenance=True)
        reqs = [server.submit(p, GEN) for p in prompts]
        t0 = time.perf_counter()
        counts = server.warm_autotune(warmup=MEASURE_WARMUP,
                                      iters=MEASURE_ITERS)
        warm_s = time.perf_counter() - t0
        table = measured_table(AT.get_cache(), "serve")
        log(f"[measured] warm_autotune: {counts['impls']} impl timings "
            f"over {counts['nodes']} (op, shape) keys of {counts['graphs']} "
            f"programs in {warm_s:.1f} s")
        # first pass: opens and audits the buckets (a ProvenanceError
        # fails the run)
        trace = {r.rid: [] for r in reqs}
        t0 = time.perf_counter()
        while server.depth:
            for rid in server.step():
                r = next(q for q in reqs if q.rid == rid)
                trace[rid].append(r.last_logits.copy())
        first_s = time.perf_counter() - t0
        first = [(r.generated, trace[r.rid]) for r in reqs]
        # second pass, measured: counts from 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        _, second, wall = serve_trace(server, prompts, GEN)
        launches = {name: c.launches for name, c in counters.items()}
        tokens = sum(len(t) for t, _ in second)
        summary = server.summary()
        server.close()

        # the elections served, by kind and tier, and every one measured on
        # its exact bucket (the strict audit passed for every bucket)
        served = sorted(server._models)
        by_kind: dict = {}
        elected = set()
        for key, rec in sorted(server.served_elections.items()):
            for kind, impls in rec["by_op"].items():
                for name, n in impls.items():
                    elected.add(name)
                    tier = name.split(".")[0]
                    per = by_kind.setdefault(kind, {})
                    per[tier] = per.get(tier, 0) + n
                    if kind != "fused" and set(
                            rec["provenance"][name]["sources"]) != {
                                "measured"}:
                        fail(f"phase 8 bucket {key} served {kind} → {name} "
                             f"from {rec['provenance'][name]['sources']}")
            model_ = server._models[key]
            viol = server._exact_bucket_violations(model_)
            if viol:
                fail(f"phase 8 bucket {key}: {viol}")
        log(f"[measured] served buckets {served}; elections by kind (cuda / "
            f"ref, summed over the buckets): {by_kind}")
        for impl, counter in SERVED_IMPLS.items():
            used = any(name in elected for name, c in SERVED_IMPLS.items()
                       if c == counter)
            if used and launches[counter] <= 0:
                fail(f"phase 8: {impl} was elected but {counter} did not "
                     f"launch in the measured pass")
            if not used and launches[counter] != 0:
                fail(f"phase 8: {counter} launched {launches[counter]} times "
                     f"with no node electing it")
        log(f"[measured] kernel launches in the measured pass: {launches}")

        # every pinned config of the path against the plain version at its
        # node's shapes (these launches come after the counts were read)
        pins = {}
        gen = torch.Generator(dev).manual_seed(8)
        for key in served:
            for node in server._models[key].graph.topo():
                if node.op not in SERVED_KINDS or \
                        not (node.impl or "").startswith("cuda."):
                    continue
                attr = registry.get_impl(node.impl).tunable.attr
                cfg = node.attrs.get(attr)
                if cfg is None:
                    fail(f"phase 8: {node.name} elects {node.impl} with no "
                         f"pinned config")
                pk = (node_key(node), tuple(cfg))
                if pk in pins:
                    continue
                pins[pk] = hold_config(torch, node,
                                       node_operands(torch, node, gen), hw,
                                       None)
        log(f"[measured] {len(pins)} pinned (node, config) pairs of the "
            f"served buckets held against the plain version: "
            + ", ".join(f"{k[0][0]}{k[0][1:]} {k[1]} {e:.3g}"
                        for k, e in pins.items()))

        # logits at every served step of both passes against phase 4's
        # torch_ref, and the greedy tokens
        worst, ties = 0.0, []
        for got in (first, second):
            for i, ((g_tok, g_log), (r_tok, r_log)) in enumerate(
                    zip(got, serve_ref)):
                for pos, (a, b) in enumerate(zip(g_log, r_log)):
                    scale = float(np.abs(b).max())
                    err = float(np.abs(a - b).max())
                    worst = max(worst, err / scale)
                    if err > LOGIT_RTOL * scale:
                        fail(f"phase 8 request {i} step {pos}: logits differ "
                             f"from torch_ref by {err:.3g} (scale "
                             f"{scale:.3g})")
                    if g_tok[pos] != r_tok[pos]:
                        break
            ties += compare_tokens("measured serve vs torch_ref", got,
                                   serve_ref, lambda row: LOGIT_RTOL
                                   * float(np.abs(row).max()))
        tps = tokens / wall
        log(f"[measured] logits vs torch_ref: worst max|Δ|/max|logit| "
            f"{worst:.3g} (rtol {LOGIT_RTOL}); greedy tokens identical"
            + (f" except near ties {ties}" if ties else ""))
        log(f"[measured] strict measured serve, second pass: {tokens} tokens "
            f"in {1e3 * wall:.2f} ms = {tps:.2f} tok/s; phase 3 (cold cache, "
            f"h100) {serve['h100']['tokens_per_s']:.2f} tok/s, phase 4 "
            f"(torch_ref) {serve['torch_ref']['tokens_per_s']:.2f} tok/s, "
            f"this run; first pass (bucket compiles) {first_s:.2f} s")

        # the driver's tune at the bf16 transformer's product shapes: which
        # impl measurement elects there (no gate on the winner)
        t0 = time.perf_counter()
        bf16_cache = AT.AutotuneCache()
        shapes = {"linear": [], "matmul": []}
        for m, k, n, is_linear in bf16_products:
            shapes["linear" if is_linear else "matmul"].append((m, k, n))
        drv.tune("h100", ("linear", "matmul"), shapes=shapes,
                 dtype="bfloat16", device=dev, cache=bf16_cache,
                 warmup=MEASURE_WARMUP, iters=MEASURE_ITERS)
        bf16_table = measured_table(bf16_cache, "bf16 tune")
        bf16_s = time.perf_counter() - t0
    finally:
        AT.set_cache(prev)
    phase_s = time.perf_counter() - t_phase
    wins = {}
    for row in table + bf16_table:
        k = (row["op"], row["dtype"], row["winner"])
        wins[k] = wins.get(k, 0) + 1
    log(f"[measured] winners by (op, dtype, impl): {wins}; phase 8 took "
        f"{phase_s:.1f} s (warm {warm_s:.1f} s, bf16 tune {bf16_s:.1f} s)")
    return {"warm": counts, "warm_s": warm_s, "first_pass_s": first_s,
            "table": table, "bf16_table": bf16_table, "by_kind": by_kind,
            "buckets": served, "launches": launches,
            "pinned_held": [{"key": k[0], "config": k[1], "max_abs_err": e}
                            for k, e in pins.items()],
            "logit_rel_err": worst, "near_ties": ties, "tokens": tokens,
            "wall_ms": 1e3 * wall, "tokens_per_s": tps,
            "phase3_tokens_per_s": serve["h100"]["tokens_per_s"],
            "phase4_tokens_per_s": serve["torch_ref"]["tokens_per_s"],
            "dmas": summary["dmas"], "forwards": summary["forwards"],
            "phase_s": phase_s, "bf16_tune_s": bf16_s}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.avgpool.kernel import avgpool_cuda
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.dfp_fused.kernel import dfp_fused_triton
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.matmul.kernel import KERNELS, matmul_cuda
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = build.build_all(force=True)
    log(f"[device] built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc)")
    for name, text in sorted(build.BUILD_LOG.items()):
        log(f"[device] source {name}.cu digest {build.digest(name)}")
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        for ln in regs:
            log(f"[device] ptxas {name}: {ln}")
        # the pooling's instances keep every value in registers
        spills = [int(n) for ln in regs for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", ln)]
        if name == "avgpool" and any(spills):
            fail("an avgpool instance spills (ptxas -v above)")

    gen = torch.Generator("cuda").manual_seed(1234)
    kern = phase_kernels(gen)
    # matmul_cuda counts every product; each of its two kernels counts its
    # own launches
    mm = {"matmul": matmul_cuda, "matmul_tc": KERNELS["tensor_core"],
          "matmul_skinny": KERNELS["skinny"]}
    counters = {**mm, "flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda,
                "dfp_fused": dfp_fused_triton}
    held32 = {c["key"] for c in kern["cases"] if c["dtype"] == "float32"}
    serve, serve_ref = phase_serve(torch, counters, torch.device("cuda"),
                                   held32)
    rec_counters = {**mm, "dfp_fused": dfp_fused_triton,
                    "rglru_scan": rglru_scan_cuda,
                    "rwkv6_scan": rwkv6_scan_cuda}
    recurrent = phase_recurrent(torch, rec_counters, torch.device("cuda"),
                                held32)
    cnn_counters = {**mm, "dfp_fused": dfp_fused_triton,
                    "avgpool": avgpool_cuda}
    cnn = phase_cnn(torch, cnn_counters, torch.device("cuda"), held32)
    bf16_counters = {**mm, "flash_attention": flash_attention_cuda,
                     "decode_attention": decode_attention_cuda,
                     "dfp_fused": dfp_fused_triton,
                     "rglru_scan": rglru_scan_cuda,
                     "rwkv6_scan": rwkv6_scan_cuda, "avgpool": avgpool_cuda}
    held = {c["key"] for c in kern["cases"] if c["dtype"] == "bfloat16"}
    bf16 = phase_bf16(torch, bf16_counters, torch.device("cuda"), recurrent,
                      cnn, held)
    gc.collect()
    torch.cuda.empty_cache()
    measured = phase_measured_serve(torch, counters, torch.device("cuda"),
                                    serve, serve_ref, kern["bf16_products"])

    # launches per main path: the served set and one forward of each stack
    # and each CNN in f32; the bf16 paths' runs for the bf16 entries
    by_path = {"serve": serve["launches"]}
    by_path.update({name: r["launches"] for name, r in recurrent.items()})
    by_path.update({name: r["launches"] for name, r in cnn.items()})
    bf16_by_path = {name: r["launches"] for name, r in bf16.items()}
    line = []
    # one entry per kernel and dtype (f32, and bf16 with the suffix _bf16):
    # the matmul rows by the kernel their plan picked
    kernel_rows = {"matmul_tc": ("matmul", "tensor_core"),
                   "matmul_skinny": ("matmul", "skinny")}
    for dtype, suffix, paths_of in (("float32", "", by_path),
                                    ("bfloat16", "_bf16", bf16_by_path)):
        for name in ["matmul_tc", "matmul_skinny", "flash_attention",
                     "decode_attention", "dfp_fused", "rglru_scan",
                     "rwkv6_scan", "avgpool"]:
            case, kernel = kernel_rows.get(name, (name, None))
            rows = [c for c in kern["cases"] if c["name"] == case
                    and c.get("kernel") == kernel and c["dtype"] == dtype]
            rep = next((c for c in rows if c["on_path"]), rows[0])
            paths = {p: n[name] for p, n in paths_of.items() if n.get(name)}
            entry = {
                "name": name + suffix, "dtype": dtype, "route": rep["route"],
                "source": rep["source"], "replaces": rep["replaces"],
                "launches": sum(paths.values()), "launches_by_path": paths,
                "max_abs_err": max(c["max_abs_err"] for c in rows),
                "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"], "shape": rep["shape"],
                "launch_ms": rep["launch_ms"]}
            line.append(entry)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build_log": build.BUILD_LOG,
         "build_digest": {n: build.digest(n) for n in build.BUILD_LOG},
         "kernels": kern["cases"], "plans": kern["plans"],
         "serve": serve,
         "recurrent": recurrent, "cnn": cnn, "bf16": bf16,
         "measured_serve": measured,
         "seconds": time.perf_counter() - t_start},
        indent=1, default=str))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(nvidia_smi())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA H100: it builds the hand-written kernels from this checkout,
holds each one against its plain PyTorch version at the main paths'
shapes, serves a few requests at full Qwen2-1.5B attention width through
``SolServer``, runs the Griffin and RWKV6 block stacks at full width and
three CNNs at ImageNet resolution through ``optimize()``, and checks every
path against the plain path.

    python3 chip_smoke.py          # one CUDA card, run from the repo root

Phases, each failing loudly:

1. device — ``nvidia-smi`` name and power limit; kernel build time.
2. kernels — matmul (serving, LoRA and the recurrent stacks' dense
   shapes, each on the kernel its plan picks: 3xTF32 tensor cores or the
   skinny kernel; one K = 12288 row held to 1e-5 of the output's scale),
   flash attention, decode attention, the generated DFP programs (serving groups and the
   recurrent graphs' gate, mix and group-norm programs), the RG-LRU scan,
   the RWKV6 scan and the average pooling (full width and edge cases)
   against their plain versions (max |error| against the stated
   tolerance) with their device times (cold L2, the host ahead of the
   device), the plain version's, one PyTorch library call's where one
   computes the same function, and the roofline bound of the same work on
   this card (matmul rows also against the tensor cores' 3xTF32 rate);
   beside them the back-to-back launch time, which host launch cost can
   push above the device time.
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
   the same weights.  Warm forward times of both backends and one
   profiled forward.

The second-to-last lines are the card's ``nvidia-smi`` line and a JSON
``kernels`` line; the last line is ``{"ok": true, "device": ...}``.  The
full record goes to ``chiprun_out/chip_smoke.json``.  The script imports
nothing of JAX or of the JAX package ``src/repro``; it exits non-zero,
printing no result, without a CUDA card or without the package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# f32 products accumulate in another order than the plain version; outputs
# are O(1), so agreement to 1e-4 absolute leaves ~100x margin over the
# expected ~1e-6 rounding while catching any indexing or masking fault.
# The pooling sums the plain version's taps in its order: 1e-5.
KERNEL_TOL = {"matmul": 1e-4, "flash_attention": 1e-4,
              "decode_attention": 1e-4, "dfp_fused": 1e-4,
              "rglru_scan": 1e-4, "rwkv6_scan": 1e-4, "avgpool": 1e-5}
# a long f32 product (K 12288) relative to its output's scale: an f32
# product keeps ~1e-6, one TF32 pass ~1e-4
MATMUL_ACCURACY_RTOL = 1e-5
# end-to-end logits through 28 layers: relative to the logits' scale
LOGIT_RTOL = 1e-4

PEAK_F32 = 67e12        # FLOP/s, f32 outside the tensor cores (H100 SXM)
PEAK_3XTF32 = 495e12 / 3    # FLOP/s, f32-accurate products as 3 TF32 passes
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
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.avgpool.kernel import avgpool_cuda
    from repro_torch.kernels.avgpool.ref import avgpool_ref
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ops import _ref_model_layout
    from repro_torch.kernels.dfp_fused.kernel import dfp_fused_triton
    from repro_torch.kernels.dfp_fused.program import Program
    from repro_torch.kernels.dfp_fused.ref import dfp_fused_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.kernel import matmul_cuda, plan
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    cases = []

    def record(name, shape, err, fn, plain, library, flops, nbytes,
               replaces, source, route, on_path=True, peak=PEAK_F32,
               extra=None):
        t = {"": time_ms(fn), "plain_": time_ms(plain)}
        if library is not None:
            t["library_"] = time_ms(library)
        b_ms, b_by = bound(flops, nbytes, peak)
        row = {"name": name, "shape": shape, "route": route,
               "source": source, "replaces": replaces, "max_abs_err": err,
               "tol": KERNEL_TOL[name], "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "on_path": on_path,
               **(extra or {})}
        for pre, v in t.items():
            row[f"{pre}ms"] = v["device"]
            row[f"{pre}launch_ms"] = v["launch"]
        ms, p_ms, lib_ms = row["ms"], row["plain_ms"], row["library_ms"]
        note = "".join(f"; {k} {v:.4g}" if isinstance(v, float)
                       else f"; {k} {v}" for k, v in (extra or {}).items())
        log(f"[kernels] {name} {shape}{'' if on_path else ' (off path)'}: "
            f"max|err| {err:.3g} (tol "
            f"{KERNEL_TOL[name]:g}) device ms: kernel {ms:.4f}, plain "
            f"{p_ms:.4f}, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)}, bound "
            f"{b_ms:.4f} ({b_by}); back-to-back launch ms: kernel "
            f"{row['launch_ms']:.4f}, plain {row['plain_launch_ms']:.4f}"
            f"{note}")
        if not err <= KERNEL_TOL[name]:
            fail(f"{name} {shape} disagrees with its plain version: "
                 f"{err} > {KERNEL_TOL[name]}")
        cases.append(row)

    # matmul: (M, K) @ (K, N); 'oi' cases read an (N, K) weight transposed.
    # Each row names the kernel its plan picks, and its bound takes that
    # kernel's peak: 3xTF32 on the tensor cores, else f32 outside them
    def matmul_case(m, k, n, oi, label="", rtol=None):
        x = randn(m, k)
        w = (randn(n, k, scale=k ** -0.5).T if oi
             else randn(k, n, scale=k ** -0.5))
        y = matmul_cuda(x, w)
        torch.cuda.synchronize()
        want = matmul_ref(x, w)
        err = max_err(y, want)
        rel = err / float(want.abs().max())
        p = plan(m, n, k, x.stride(0), w.stride(0), w.stride(1),
                 x.data_ptr(), w.data_ptr())
        flops, nbytes = 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)
        shape = f"{m}x{k}x{n}{' (out,in)' if oi else ''}{label}"
        record("matmul", shape, err, lambda: matmul_cuda(x, w),
               lambda: matmul_ref(x, w), lambda: torch.matmul(x, w), flops,
               nbytes, "src/repro/kernels/matmul/kernel.py:85",
               "src/repro_torch/kernels/csrc/matmul.cu", "cuda",
               peak=PEAK_3XTF32 if p.kernel == "tensor_core" else PEAK_F32,
               extra={"kernel": p.kernel, "splits": p.splits,
                      "rel_err": rel})
        if rtol is not None and not rel <= rtol:
            fail(f"matmul {shape}: max |error| {rel:.3g} of the output's "
                 f"scale > {rtol}")

    for m, k, n, oi in ((4, 1536, 151936, True), (256, 1536, 1536, False),
                        (256, 1536, 6144, False), (256, 1536, 6144, True),
                        (4, 1536, 1536, False), (4, 6144, 1536, True)):
        matmul_case(m, k, n, oi)

    # flash attention at the prefill bucket: B 4, S 128, H 12, KV 2, hd 128
    b, s, h, kv, hd = 4, 128, 12, 2, 128
    q, k_, v = randn(b, s, h, hd), randn(b, s, kv, hd), randn(b, s, kv, hd)
    o = flash_attention_cuda(q, k_, v, causal=True)
    torch.cuda.synchronize()

    def fa_plain():
        return flash_attention_ref(q.transpose(1, 2), k_.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k_, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        sdpa = lambda: F.scaled_dot_product_attention(     # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    except TypeError:       # an older torch without GQA in SDPA
        ke, ve = (t.repeat_interleave(h // kv, 1) for t in (kt, vt))
        sdpa = lambda: F.scaled_dot_product_attention(     # noqa: E731
            qt, ke, ve, is_causal=True)
    pairs = b * h * s * (s + 1) / 2                        # causal (q, k)
    record("flash_attention", f"B{b} S{s} H{h} KV{kv} hd{hd} causal",
           max_err(o, fa_plain()),
           lambda: flash_attention_cuda(q, k_, v, causal=True), fa_plain,
           sdpa, 4.0 * pairs * hd, 4.0 * (2 * b * s * h * hd
                                          + 2 * b * s * kv * hd),
           "src/repro/kernels/flash_attention/kernel.py:82",
           "src/repro_torch/kernels/csrc/flash_attention.cu", "cuda")

    # decode attention at the decode bucket: cache 128, mixed lens incl. 0
    cache = 128
    lens = torch.tensor([0, 37, 100, 127], dtype=torch.int32, device=dev)
    qd = randn(b, 1, h, hd)
    kc, vc = randn(b, cache, kv, hd), randn(b, cache, kv, hd)
    kn, vn = randn(b, 1, kv, hd), randn(b, 1, kv, hd)
    od = decode_attention_cuda(qd, kc, vc, kn, vn, lens)
    torch.cuda.synchronize()
    plain_d = lambda: _ref_model_layout(qd, kc, vc, kn, vn, lens, 0, 0.0)  # noqa: E731
    if max_err(od[0], vn[0].repeat_interleave(h // kv, 1)) != 0.0:
        fail("decode attention with lens 0 is not exactly v_new")
    rows = int(lens.sum())
    record("decode_attention", f"B{b} cache{cache} H{h} KV{kv} hd{hd} "
           f"lens{lens.tolist()}", max_err(od, plain_d()),
           lambda: decode_attention_cuda(qd, kc, vc, kn, vn, lens), plain_d,
           None, 4.0 * h * hd * (rows + b),
           4.0 * (2 * b * h * hd + 2 * rows * kv * hd + 2 * b * kv * hd)
           + 4.0 * b, "src/repro/kernels/decode_attention/kernel.py:94",
           "src/repro_torch/kernels/csrc/decode_attention.cu", "cuda")

    # DFP programs: the two serving groups and a layernorm group
    dfp_src = "src/repro_torch/kernels/dfp_fused/kernel.py"
    dfp_rep = "src/repro/kernels/dfp_fused/kernel.py:117"
    rows_n = 4 * 128
    programs = [
        ("bias_add+gelu", 6144, Program(
            (("bias", 0, ("op", 0), 1, None),
             ("gelu", 1, ("reg", 0), None)), ("full", "vec"), 1)),
        ("bias_add+add", 1536, Program(
            (("bias", 0, ("op", 0), 1, None),
             ("add", 1, ("reg", 0), ("op", 2), None)),
            ("full", "vec", "full"), 1)),
        ("layernorm+add", 1536, Program(
            (("layernorm", 0, ("op", 0), 1, 2, 1e-5),
             ("add", 1, ("reg", 0), ("op", 3), None)),
            ("full", "vec", "vec", "full"), 1)),
    ]
    for label, d, prog in programs:
        ops = [randn(rows_n, d) if kd == "full" else randn(d)
               for kd in prog.operand_kinds]
        t0 = time.perf_counter()
        y = dfp_fused_triton(prog, ops, (rows_n, d), torch.float32)
        torch.cuda.synchronize()
        log(f"[kernels] dfp_fused {label}: Triton compile + first launch "
            f"{time.perf_counter() - t0:.2f} s")
        err = max_err(y, dfp_fused_ref(prog, ops, (rows_n, d),
                                       torch.float32))
        n_full = prog.operand_kinds.count("full")
        n_vec = prog.operand_kinds.count("vec")
        library = None
        if label == "bias_add+gelu":
            library = lambda: F.gelu(ops[0] + ops[1], approximate="tanh")  # noqa: E731
        record("dfp_fused", f"{label} rows{rows_n} d{d}", err,
               lambda: dfp_fused_triton(prog, ops, (rows_n, d),
                                        torch.float32),
               lambda: dfp_fused_ref(prog, ops, (rows_n, d), torch.float32),
               library, 10.0 * rows_n * d,
               4.0 * ((n_full + 1) * rows_n * d + n_vec * d),
               dfp_rep, dfp_src, "triton")

    # the recurrent slice: LoRA products, the dense products of the RWKV6
    # (d 2048, MLP 6144) and Griffin (d 4096, MLP 12288) forwards on their
    # 2048 rows, a K = 12288 accuracy row, the groups its graphs add, scans
    for m, k, n in ((2048, 2048, 4), (2048, 4, 2048)):
        matmul_case(m, k, n, False, " (LoRA)")
    for m, k, n, oi in ((2048, 2048, 2048, False), (2048, 2048, 6144, True),
                        (2048, 6144, 2048, True), (2048, 4096, 4096, False),
                        (2048, 4096, 12288, True), (2048, 12288, 4096, True)):
        matmul_case(m, k, n, oi)
    matmul_case(256, 12288, 1024, True, " (accuracy)",
                rtol=MATMUL_ACCURACY_RTOL)
    for label, rows_n, d, prog, on_path in recurrent_programs():
        ops = [randn(rows_n, d) if kd == "full" else randn(d)
               for kd in prog.operand_kinds]
        y = dfp_fused_triton(prog, ops, (rows_n, d), torch.float32)
        torch.cuda.synchronize()
        err = max_err(y, dfp_fused_ref(prog, ops, (rows_n, d),
                                       torch.float32))
        n_full = prog.operand_kinds.count("full")
        n_vec = prog.operand_kinds.count("vec")
        record("dfp_fused", f"{label} rows{rows_n} d{d}", err,
               lambda: dfp_fused_triton(prog, ops, (rows_n, d),
                                        torch.float32),
               lambda: dfp_fused_ref(prog, ops, (rows_n, d), torch.float32),
               None, 10.0 * rows_n * d,
               4.0 * ((n_full + 1) * rows_n * d + n_vec * d),
               dfp_rep, dfp_src, "triton", on_path)

    # RG-LRU scan: Griffin's width (B 4, T 512, D 4096) and an edge case
    # (T 1, D not a multiple of 32); a in (0.5, 1), h0 nonzero
    for b_, t_, d_ in ((4, 512, 4096), (3, 1, 24)):
        a = torch.rand(b_, t_, d_, device=dev, generator=gen) * 0.5 + 0.5
        bb, h0 = randn(b_, t_, d_), randn(b_, d_)
        h, last = rglru_scan_cuda(a, bb, h0)
        torch.cuda.synchronize()
        want_h, want_last = rglru_scan_ref(a, bb, h0)
        err = max(max_err(h, want_h), max_err(last, want_last))
        n = b_ * t_ * d_
        record("rglru_scan", f"B{b_} T{t_} D{d_}, h0 nonzero", err,
               lambda: rglru_scan_cuda(a, bb, h0),
               lambda: rglru_scan_ref(a, bb, h0), None, 2.0 * n,
               4.0 * (3 * n + 2 * b_ * d_),
               "src/repro/kernels/rglru_scan/kernel.py:36",
               "src/repro_torch/kernels/csrc/rglru_scan.cu", "cuda")

    # RWKV6 scan: RWKV6-1.6B's heads (B 4, T 512, H 32, hd 64) and an edge
    # case with log decays 0 (no decay) and -50 (exp underflows to 0)
    for b_, t_, h_, hd, extremes in ((4, 512, 32, 64, False),
                                     (1, 3, 2, 8, True)):
        r, k_, v = (randn(b_, t_, h_, hd, scale=0.5) for _ in range(3))
        if extremes:
            logw = torch.where(randn(b_, t_, h_, hd) > 0, 0.0, -50.0)
        else:
            logw = -torch.exp(randn(b_, t_, h_, hd, scale=0.5) - 1.0)
        u, s0 = randn(h_, hd, scale=0.5), randn(b_, h_, hd, hd, scale=0.5)
        o, s_last = rwkv6_scan_cuda(r, k_, v, logw, u, s0)
        torch.cuda.synchronize()
        want_o, want_s = rwkv6_scan_ref(r, k_, v, logw, u, s0)
        err = max(max_err(o, want_o), max_err(s_last, want_s))
        n = b_ * t_ * h_ * hd
        record("rwkv6_scan", f"B{b_} T{t_} H{h_} hd{hd}, s0 nonzero"
               + (", logw in {0, -50}" if extremes else ""), err,
               lambda: rwkv6_scan_cuda(r, k_, v, logw, u, s0),
               lambda: rwkv6_scan_ref(r, k_, v, logw, u, s0), None,
               5.0 * n * hd,
               4.0 * (5 * n + h_ * hd + 2 * b_ * h_ * hd * hd),
               "src/repro/kernels/rwkv6_scan/kernel.py:55",
               "src/repro_torch/kernels/csrc/rwkv6_scan.cu", "cuda")

    # average pooling: the Listing-3 CNN's two pools at (64, 3, 224, 224),
    # then edge cases (k 2 and 3, kh != kw, H or W equal to k, N·C 1,
    # widths no multiple of a warp); F.avg_pool2d is the library call
    for n_, c_, h_, w_, kh, kw, on_path in (
            (64, 32, 224, 224, 3, 3, True), (64, 64, 111, 111, 3, 3, True),
            (3, 5, 17, 45, 2, 2, False), (1, 1, 3, 3, 3, 3, False),
            (2, 3, 9, 40, 2, 3, False), (1, 1, 70, 33, 3, 1, False)):
        x = randn(n_, c_, h_, w_)
        y = avgpool_cuda(x, kh, kw)
        torch.cuda.synchronize()
        out = y.numel()
        record("avgpool", f"({n_}, {c_}, {h_}, {w_}) k{kh}x{kw}",
               max_err(y, avgpool_ref(x, kh, kw)),
               lambda: avgpool_cuda(x, kh, kw),
               lambda: avgpool_ref(x, kh, kw),
               lambda: F.avg_pool2d(x, (kh, kw), stride=1),
               float(kh * kw) * out, 4.0 * (x.numel() + out),
               "src/repro/kernels/avgpool/kernel.py:34",
               "src/repro_torch/kernels/csrc/avgpool.cu", "cuda", on_path)
    return {"cases": cases}


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
FAMILIES = (("tc_kernel", "matmul"), ("skinny_kernel", "matmul"),
            ("reduce_splits", "matmul"),
            ("flash_fwd_kernel", "flash_attention"),
            ("decode_kernel", "decode_attention"), ("dfp_", "dfp_fused"),
            ("rglru_scan_kernel", "rglru_scan"),
            ("rwkv6_scan_kernel", "rwkv6_scan"),
            ("avgpool_kernel", "avgpool"),
            ("conv", "conv"), ("fprop", "conv"),
            ("Memcpy HtoD", "copy to card"), ("Memcpy DtoH", "copy to host"),
            ("Memcpy", "copy on card"), ("Memset", "memset"))


def device_breakdown(torch, run) -> dict:
    """Run ``run()`` under ``torch.profiler`` (CUDA activity only) and
    return the device time per family and the device's busy share: the
    union of device events over the span from the first to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"measured": False}
    busy, (lo, hi) = 0.0, spans[0][:2]
    by_family: dict = {}
    for s, e, name in spans:
        fam = next((f for frag, f in FAMILIES if frag in name), "torch ops")
        by_family[fam] = by_family.get(fam, 0.0) + (e - s) / 1e3
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    return {"measured": True, "events": len(spans), "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "busy_share": busy / span,
            "device_ms_by_family": dict(sorted(
                by_family.items(), key=lambda kv: -kv[1]))}


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


def phase_serve(torch, counters, dev) -> dict:
    import numpy as np
    from repro_torch.frontends import nn
    from repro_torch.launch.serve import ServeConfig, SolServer
    from torch import nn as tnn

    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    kvh = FULL["n_kv_heads"]
    d, heads = FULL["d_model"], FULL["n_heads"]
    model = tnn.Sequential(
        *[nn.transformer_block(d, heads, kvh, device=dev, generator=gen)
          for _ in range(FULL["n_layers"])],
        nn.Linear(d, FULL["vocab"], device=dev, generator=gen))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] model: {n_params / 1e6:.1f} M parameters on the card "
        f"({4 * n_params / 1e9:.2f} GB f32) built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg_kw = {k: v for k, v in FULL.items() if k != "n_kv_heads"}
    cfg = ServeConfig(**cfg_kw, backend="h100")
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
    breakdown = device_breakdown(
        torch, lambda: serve_trace(server, prompts, GEN))
    server.close()
    if breakdown["measured"]:
        fams = ", ".join(f"{k} {v:.2f}" for k, v in
                         breakdown["device_ms_by_family"].items())
        log(f"[profile] h100 serve: device busy {breakdown['busy_ms']:.2f} "
            f"of {breakdown['span_ms']:.2f} ms "
            f"({100 * breakdown['busy_share']:.1f}%); device ms by family: "
            f"{fams}")
    else:
        log("[profile] torch.profiler recorded no device events: device "
            "busy share not measured")

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
            "decode_vs_reforward_near_ties": ties2}


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
    return float((got - want).abs().max() / want.abs().max())


def per_layer_errors(torch, model, shape, x, optimize) -> list:
    """Each block compiled alone on both backends and fed the same input,
    torch_ref's output of the block before: the h100 output's error
    relative to its scale, layer by layer.  This holds every layer's
    kernels to the plain path at full width without the stack's own
    amplification of rounding."""
    out, cur = [], x
    for blk in model:
        h = optimize(blk, shape, backend="h100")(cur)
        cur = optimize(blk, shape, backend="torch_ref")(cur)
        out.append(rel_err(h, cur))
    torch.cuda.synchronize()
    return out


def timed_forwards(torch, sol, x, repeats: int) -> list:
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol(x)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_recurrent(torch, counters, dev) -> dict:
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
        breakdown = device_breakdown(torch, lambda: sol(x))
        if breakdown["measured"]:
            fams = ", ".join(f"{k} {v:.2f}" for k, v in
                             breakdown["device_ms_by_family"].items())
            log(f"[profile] {name} h100 forward: device busy "
                f"{breakdown['busy_ms']:.2f} of {breakdown['span_ms']:.2f} "
                f"ms ({100 * breakdown['busy_share']:.1f}%); device ms by "
                f"family: {fams}")
        else:
            log(f"[profile] {name}: torch.profiler recorded no device "
                f"events: device busy share not measured")
        results[name] = {
            "config": cfg, "shape": shape, "parameters": n_params,
            "optimize_s": compile_s, "elections": by_kind,
            "launches": launches, "first_forward_ms": first_ms,
            "rel_err": err, "rel_err_limit": limit,
            "per_layer_rel_err": layers,
            "output_scale": float(want.abs().max()),
            "h100_ms": h_ms, "h100_ms_median": h_med,
            "torch_ref_ms": r_ms, "torch_ref_ms_median": r_med,
            "device_breakdown": breakdown}
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


def phase_cnn(torch, counters, dev) -> dict:
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
        breakdown = device_breakdown(torch, lambda: sol(x))
        if breakdown["measured"]:
            fams = ", ".join(f"{k} {v:.3f}" for k, v in
                             breakdown["device_ms_by_family"].items())
            log(f"[profile] {name} h100 forward: device busy "
                f"{breakdown['busy_ms']:.3f} of {breakdown['span_ms']:.3f} "
                f"ms ({100 * breakdown['busy_share']:.1f}%); device ms by "
                f"family: {fams}")
        else:
            log(f"[profile] {name}: torch.profiler recorded no device "
                f"events: device busy share not measured")
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

    gen = torch.Generator("cuda").manual_seed(1234)
    kern = phase_kernels(gen)
    # matmul_cuda counts every product; each of its two kernels counts its
    # own launches
    mm = {"matmul": matmul_cuda, "matmul_tc": KERNELS["tensor_core"],
          "matmul_skinny": KERNELS["skinny"]}
    counters = {**mm, "flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda,
                "dfp_fused": dfp_fused_triton}
    serve = phase_serve(torch, counters, torch.device("cuda"))
    rec_counters = {**mm, "dfp_fused": dfp_fused_triton,
                    "rglru_scan": rglru_scan_cuda,
                    "rwkv6_scan": rwkv6_scan_cuda}
    recurrent = phase_recurrent(torch, rec_counters, torch.device("cuda"))
    cnn_counters = {**mm, "dfp_fused": dfp_fused_triton,
                    "avgpool": avgpool_cuda}
    cnn = phase_cnn(torch, cnn_counters, torch.device("cuda"))

    # launches per main path: the served set and one forward of each stack
    # and each CNN
    by_path = {"serve": serve["launches"]}
    by_path.update({name: r["launches"] for name, r in recurrent.items()})
    by_path.update({name: r["launches"] for name, r in cnn.items()})
    line = []
    # one entry per kernel: the matmul rows by the kernel their plan picked
    kernel_rows = {"matmul_tc": ("matmul", "tensor_core"),
                   "matmul_skinny": ("matmul", "skinny")}
    for name in ["matmul_tc", "matmul_skinny", "flash_attention",
                 "decode_attention", "dfp_fused", "rglru_scan", "rwkv6_scan",
                 "avgpool"]:
        case, kernel = kernel_rows.get(name, (name, None))
        rows = [c for c in kern["cases"] if c["name"] == case
                and c.get("kernel") == kernel]
        rep = rows[0]
        paths = {p: n[name] for p, n in by_path.items() if n.get(name)}
        entry = {
            "name": name, "route": rep["route"], "source": rep["source"],
            "replaces": rep["replaces"],
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
         "kernels": kern["cases"], "serve": serve,
         "recurrent": recurrent, "cnn": cnn,
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

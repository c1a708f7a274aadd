#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA H100: it builds the hand-written kernels from this checkout,
holds each one against its plain PyTorch version at the main paths'
shapes in float32, bfloat16 and float16, serves a few requests at full
Qwen2-1.5B attention width through ``SolServer``, runs the Griffin and
RWKV6 block stacks at full width and three CNNs at ImageNet resolution
through ``optimize()``, runs the transformer, both stacks and the Listing-3
CNN again in bf16, serves the transformer once more under a strict
measured-provenance audit, ranks the measured kernels by their distance
from the card's bound, trains three short stacks through the elected
forward and backward impls, serves the transformer again from deploy
artifacts and runs every other kernel through one, serves it on a (2, 2)
mesh of four ranks sharing the card and through a fleet of three replicas
with one replica killed mid-stream, serves the model-zoo backbone
(qwen2-1.5b at full width in bf16 and f32, then the ten reduced configs)
through its prefill and decode steps, trains it through its train step
(the same configs) and its driver, serves and trains it again sharded on
a (2, 2) mesh of four ranks, trains a sharded SOL graph on that mesh,
runs the ``host_cpu`` backend on the host, and checks every path against
the plain path.

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
   the buckets phase 3 opens and at every bucket a replica of phase 13's
   fleet can open (``fleet_buckets``), of both stacks and of the three
   CNNs, and the per-shard programs of phase 12's (2, 2) mesh at those buckets,
   decided by ``shard_graph`` alone: heads 6 and KV heads 1, q 768 and
   k/v 128 features, the row-parallel o and MLP down products, the
   75968-wide vocab shard); then
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
   ``[configs]`` line per kernel).  Phases 3, 5, 6, 7, 12 and 13
   fail on a kernel node of their paths that no row of their dtype holds
   (``node_key``, ``check_held``), phases 14 and 15 on a launch key that
   no row holds (rows at ``backbone_plan_all`` and ``train_plan_all``).
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
   forward (a profile that misses either is taken again, at most
   ``PROFILE_TRIES`` times, and the last one must pass).
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
9. SOL — on phase 8's measurements (the serve's cache and the bf16
   tune's): (a) every cell's fastest impl ranked by measured ÷ bound
   (``repro_torch.core.sol``, the bound at the peak of the unit that runs
   the impl), printed as ``[sol]`` lines; a non-finite ratio fails, and so
   does a ratio below 1.0 with more bytes than the 50 MB L2 (smaller ones
   are printed as L2-warm); (b) ``impl_report(sol=True)`` of every served
   prefill and decode bucket model, where every LINEAR, MATMUL, ATTENTION
   and DECODE_ATTENTION row must be measured on its exact bucket; (c) the
   gap-driven planner (``refine_plan``, top 3 cells, 2 rounds, 24 configs)
   with the real measure, each config it records held to the plain
   version at phase 2's tolerance; (d) the port's benchmark tables
   (``repro_torch.benchmarks.run`` effort, inference, layouts, matmul,
   serving and sol, into ``chiprun_out/BENCH_torch*.json``) must return 0,
   and ``serve_rows`` serves phase 3's model at full width: phase 3's four
   prompts and three more sets of their lengths, ``GEN`` tokens each.
10. training — three f32 stacks at full width, 4 blocks each (RWKV6 1:
   the serve model's transformer block, d 1536 with 12/2 heads; Griffin d
   4096; RWKV6 d 2048 with 32 heads; MLPs ×4, ×3, ×3) on (4, 512, d) through
   ``optimize(..., training=True)``: (a) every backward impl of each
   graph at its own shapes (and ``conv.avgpool_bwd`` at the first
   Listing-3 pool) against autograd of the reference forward in f32
   (1e-5 of each cotangent's scale, 1e-4 for the scans), with its device
   time (cold L2), back-to-back time, plain version's and library call's
   time (autograd of ``F.linear``, SDPA or ``F.avg_pool2d``) and the bound
   at twice the forward's cost terms; (b) the heavy kinds elect no
   ``ref.*`` backward, the matmul (and Griffin's RG-LRU scan) launch
   during a backward; step 0's gradient of every parameter agrees with
   ``torch_ref``'s (h100's backward impls alone, every forward on its
   plain version, within 1e-4 of each gradient's norm; h100 whole within
   the forward kernels' error times the gradients' amplification of an
   input change), with each ``cuda.*`` forward swapped for its plain
   version beside it to show where the gap comes from; 6 AdamW steps
   (``make_sol_train_step``, each stack's ``TRAIN_LR``) on ``h100`` and
   ``torch_ref`` from the same weights agree (each loss within 1e-4, the
   final params within rtol 1e-3, atol 1e-4) with the loss falling; a
   planted product backward whose dw drops the last token must fail every
   one of these gates; (c) median fwd and fwd+bwd times (``train_bench``'s
   calls) and one profiled fwd+bwd; (d) ``python -m
   repro_torch.launch.train --sol`` for each ``--sol-model`` (d 256; the
   three processes side by side): the warm-up, both gates and the
   falling loss.
11. deploy — ``export_artifacts()`` of phase 8's strict measured server
   (one ``torch.export`` artifact a bucket, ``frontends/deploy.py``), then
   ``SolServer(cfg, deployed=..., strict_provenance=True)`` on phase 3's
   requests: tokens equal phase 8's second pass and every served step's
   logits within ``DEPLOY_RTOL`` of its scale; every kernel the buckets
   elect launches through the artifacts (counts from 0, read after the
   pass) and no other; tokens/s of a live strict serve of the same model
   and of the artifact serve in turns; export seconds, blob MB, load
   seconds and host bytes.  The ``repro_torch::matmul`` op's dispatch cost
   against its direct entry at 4x1536x1536.  Then ``deploy``/``load`` of a
   2-block Griffin and RWKV6 at full width (f32, (4, 512, d)) and of the
   Listing-3 CNN in bf16 at (64, 3, 224, 224): each artifact's output
   within ``DEPLOY_RTOL`` of its live model's, its scan or pool launching
   through it; every one of the seven kernels launches through some
   artifact.
12. mesh serve — phase 3's model (the same seed, built on the card by
   each rank) and requests on ``SolServer(ServeConfig(mesh=(2, 2)))``:
   four ranks sharing the one card (``launch.mesh.run_on_mesh``, gloo;
   each rank's output lines prefixed with its rank, every rank joined
   before the parent goes on), two passes, the second counted.  Gates:
   every rank's greedy tokens equal phase 3's (near ties reported), rank
   0's logits at every step within ``LOGIT_RTOL`` of phase 3's scale,
   every served node held by phase 2 and on a ``cuda.*`` impl, and
   matmul, flash attention, decode attention and DFP launched on every
   rank.  Logged: tokens/s, decode step p50 and the all-reduces of a
   decode step; four ranks on one card measure no scaling.
13. fleet — a ``SolFleet`` of 3 replicas of phase 3's model (full width
   and depth) on the card serves phase 3's requests twice over, sampled
   with seeds, and one replica is killed after two ticks
   (``fleet.kill_replay``).  Gates: zero drops, ``kills == 1`` and
   ``respawns == 1``, tokens identical to an undisturbed one-replica
   fleet's, the serve kernels launched, and every node of every bucket
   that any replica of either fleet served (the killed one and the
   respawn included) held by phase 2 and on a ``cuda.*`` impl.  Logged:
   the recovery time (kill to respawn).
14. backbone serve — ``models.backbone`` through ``make_prefill_step`` and
   ``make_decode_step`` on ``make_debug_mesh(1, 1)`` with no device (the
   one-process mesh resolves the card): qwen2-1.5b as published (28
   layers, d 1536, 12 heads, KV 2, hd 128, vocab 151936; random weights,
   generator seed 0 on the card) in bf16 and in f32, batch 4, a 128-token
   prompt prefilled into a fresh cache, 32 greedy decode steps; then the
   ten reduced configs (``get_smoke``) in f32, batch 2, 16 tokens, 8
   steps.  Each run is served on the kernel route (counts from 0 just
   before, read just after) and again with ``plain=True``.  Gates: greedy
   tokens equal (near ties reported), logits within ``BACKBONE_RTOL`` of
   the scale (1e-4 f32, 3e-2 bf16), every decode step's logits equal to
   one forward over the prompt and the fed tokens, the MoE routers
   routing alike on both routes, every launch's (kernel, shape, dtype)
   held by phase 2 (which holds ``backbone_plan_all``'s keys) and the
   launches equal, key for key, to ``backbone_plan``: what
   ``layers.attention_route`` predicts (28 flash launches a prefill and
   28 decode launches a step for qwen2), with ``rglru_scan`` and
   ``rwkv6_scan`` launched by the reduced recurrent configs.  Logged:
   prefill ms, decode step p50, tokens/s and the phase's seconds beside
   the card's name and power limit.
15. backbone train — ``distributed.steps.make_train_step`` on
   ``make_debug_mesh(1, 1)`` with no device given (the card), each run on
   the kernel route and again with ``plain=True`` from the same state
   (``init_train_state``, generator seeded 0) and the same batches
   (``SyntheticTokenDataset(seed=0)``): qwen2-1.5b as published in f32 at
   the JAX driver's defaults (batch 8, seq 128, remat, ZeRO specs, lr
   3e-3), then in bf16 with f32 moments, then the ten reduced configs in
   f32 (batch 2, seq 64, the modality stubs' inputs, no warm-up).  Gates:
   in every f32 run, step 0's loss within ``BB_TRAIN_LOSS0_RTOL`` of the
   plain route's and every gradient leaf within ``BB_TRAIN_GRAD_TOL`` of
   its norm, with planted faults failing that gate (D = Σ dO·O dropped
   from the flash backward on qwen2, the RG-LRU reverse scan's
   coefficients unshifted, RWKV6's du dropped, the MoE combine's backward
   on the wrong slots); the losses of 6 steps within
   ``BB_TRAIN_LOSS_RTOL`` and falling (3 steps in bf16, 2 for each
   reduced config); every launch's (kernel, shape,
   dtype) held by phase 2 and the launches equal, key for key, to
   ``train_plan`` (a forward per layer, again for a macro block's layer
   under remat, the RG-LRU's reverse scan in the backward); then
   ``launch.train.run`` on recurrentgemma's reduced config resuming from
   its checkpoint and ending on an uninterrupted run's loss within
   ``BB_TRAIN_RESUME_RTOL``.  Logged: fwd+bwd ms, AdamW ms, step ms,
   training tokens/s, peak memory and the phase's seconds beside the
   card's name and power limit.
16. mesh backbone — the backbone's sharded steps on a (2, 2) (data,
   model) mesh, four ranks sharing the card over gloo (``run_on_mesh``;
   the parent builds the kernels first and computes the references):
   each rank draws the weights from phase 14's seed and keeps its blocks
   (``jit_serve_steps``' specs), serves its rows (a prefill into a
   sharded cache, greedy decode steps) and takes one ZeRO train step.
   qwen2-1.5b at full width in f32, 8 of its 28 layers (batch 4, a
   128-token prompt, 8 decode steps, train seq 128), then the ten reduced configs (batch 4, seq 64,
   4 decode steps; olmoe and kimi expert-parallel).  Gates against the
   one-process kernel route on the same weights, prompts and batches:
   greedy tokens equal (near ties reported), logits within
   ``BACKBONE_RTOL``, the train step's loss and gradient norm within
   ``BB_TRAIN_LOSS0_RTOL`` and every gradient leaf within
   ``BB_TRAIN_GRAD_TOL`` of its norm (the reference the mean of the two
   data shards' gradients), every new parameter block within
   ``BB_TRAIN_GRAD_TOL`` of a plain AdamW step on the rank's blocks;
   planted faults (the attention's row-parallel all-reduce left out, the
   MoE combine's all-reduce left out: the logits and gradients gates;
   the ZeRO all-gather joined in reverse: the parameters gate) must be
   caught; phase 15's trainer checkpoint restored onto every rank's
   blocks (``shardings=``) equal to its arrays.  Logged: launches of the
   serve and train step summed over the ranks, all-reduces a decode
   step, decode p50 beside one process's, the ZeRO step's parts, the
   phase's seconds.
17. mesh SOL train — phase 10's transformer stack (4 blocks, d 1536,
   12/2 heads, MLP ×4, f32, input (4, 512, 1536), its weights, batch and
   lr) through ``optimize(..., training=True, mesh=)`` on ``h100``, on a
   (2, 2) (data, model) mesh of four gloo ranks sharing the card (the
   parent builds the kernels and computes the one-process ``h100``
   references first), trained by ``make_sol_train_step`` on each rank's
   blocks and rows.  Gates against the one-process run: step 0's loss
   within ``BB_TRAIN_LOSS0_RTOL``, every gathered gradient leaf within
   ``BB_TRAIN_GRAD_TOL`` of its norm, the global gradient norm within
   1e-5, ``TRAIN_STEPS`` losses within ``TRAIN_LOSS_RTOL`` and falling,
   the gathered parameters within ``TRAIN_PARAM_TOL``; phase 10's
   backward impls elected and the matmul launched in a backward; two
   model all-reduces a block in the forward and two in the backward, one
   data mean and one norm all-reduce a step; every launch's (kernel,
   shape) held by phase 2 (which holds ``mesh_sol_train_plan``'s keys).
   Planted faults caught: the column-parallel inputs' backward
   all-reduce left out (gradients), the data mean left out (gradients
   and parameters), the row-parallel forward all-reduce left out (loss).
   Logged: rank 0's step split into fwd+bwd (the model all-reduces
   within it), the gradient mean and AdamW, one process's step, the
   phase's seconds.
18. host_cpu — the small CNN at (8, 3, 224, 224) and phase 3's first two
   blocks at (2, 128, 1536) through ``optimize(..., backend="host_cpu")``
   on the host: ``host_cpu.linear_oi`` and ``host_cpu.conv2d_nchw``
   elected, outputs within 1e-5 of ``torch_ref`` on the host and within
   ``LOGIT_RTOL`` of ``h100`` on the card, a CUDA device refused.

The second-to-last lines are the card's ``nvidia-smi`` line and a JSON
``kernels`` line (an entry per kernel in f32, and one per kernel in bf16
named ``<kernel>_bf16`` with its launches on the bf16 paths); the last line
is ``{"ok": true, "device": ...}``; the ``kernels`` line's launches are
phases 3, 5-7, 10's (its six h100 steps a stack), 11's (its checked
artifact serve pass and one call of each other artifact), 12's (summed
over the ranks, path ``mesh_serve``), 13's (path ``fleet``) and 14's
(paths ``backbone_qwen2``, ``backbone_smoke`` and, in bf16,
``backbone_qwen2_bf16``), 15's kernel-route train steps (paths
``backbone_train_qwen2``, ``backbone_train_smoke`` and, in bf16,
``backbone_train_qwen2_bf16``), 16's (summed over the ranks, path
``mesh_backbone``) and 17's steps (summed over the ranks, path
``mesh_sol_train``).  The
full record goes to ``chiprun_out/chip_smoke.json``.  The script imports
nothing of JAX or of the JAX package ``src/repro``; it exits non-zero,
printing no result, without a CUDA card or without the package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import json
import math
import re
import subprocess
import sys
import time
import types
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


FULL = dict(d_model=1536, n_heads=12, n_kv_heads=2, n_layers=28,
            vocab=151936, max_seq=256, max_batch=4, slots=8)
PROMPT_LENS = (17, 40, 64, 100)
GEN = 16
MESH = (2, 2)                   # phase 12's (data, model) ranks, one card
MESH_TIMEOUT_S = 420
FLEET_REPLICAS = 3


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


def bound(flops: float, nbytes: float, unit: str = "simt"):
    """(ms, "operations" or "bytes"): the roofline bound of the work on
    this card, through ``repro_torch.core.sol`` on the card's spec, its
    operations at the peak of ``unit`` (``registry.UNITS``: 67 TFLOP/s
    SIMT f32, 165 3xTF32, 989 for the 16-bit tensor cores on the SXM
    card), its bytes over 3.35 TB/s."""
    import torch
    from repro_torch.backends import h100_spec
    from repro_torch.core.sol import sol_bound_us
    us, dom = sol_bound_us(h100_spec(torch.cuda.get_device_name(0)), flops,
                           nbytes, unit)
    return 1e-3 * us, "operations" if dom == "compute" else "bytes"


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
    (``tensor16``); its library call runs in the same dtype.  Each row
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
    from repro_torch.kernels.flash_attention.ops import attn_unit
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul.kernel import matmul_cuda, plan
    from repro_torch.kernels.matmul.ops import mm_unit
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.rglru_scan.kernel import (rglru_plan,
                                                       rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_scan.kernel import (MAX_CHUNK, STEP,
                                                       rwkv6_plan,
                                                       rwkv6_scan_cuda)
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    t_phase = time.perf_counter()
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
               replaces, source, route, key, on_path=True, unit="simt",
               extra=None, dtype="float32", within=None):
        t = {"": time_ms(fn), "plain_": time_ms(plain)}
        if library is not None:
            t["library_"] = time_ms(library)
        b_ms, b_by = bound(flops, nbytes, unit)
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
    # Each row names the kernel its plan picks, and its bound takes the
    # impl's unit (``mm_unit``), that kernel's: on the tensor cores 3xTF32
    # (f32) or 16-bit wgmma (bf16, f16), else f32 outside them
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
        shape = f"{m}x{k}x{n}{' (out,in)' if oi else ''}{label}"
        record("matmul", shape, err, lambda: matmul_cuda(x, w),
               lambda: matmul_ref(x, w), lambda: torch.matmul(x, w),
               2.0 * m * k * n, float(size) * (m * k + k * n + m * n),
               "src/repro/kernels/matmul/kernel.py:85", csrc + "matmul.cu",
               "cuda", ("matmul", m, k, n, oi), unit=mm_unit((m, k, n), dt),
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
               unit=attn_unit(None, dt),
               extra={"units": "16-bit mma.sync" if half
                      else "3xTF32 mma.sync"}, dtype=dt, within=within)

    # decode attention, by default at the decode bucket: cache 128, lens
    # 0/37/100/127.  Library yardstick: one SDPA call (GQA, a boolean mask
    # pos <= lens[b]) on a copy of the cache holding the step's own row at
    # lens[b], made outside the timed call
    def decode_case(dt="float32", b=4, cache=128, h=12, kv=2, hd=128,
                    window=0, cap=0.0):
        if (b, cache) == (4, 128):
            lens_l = [0, 37, 100, 127]
        else:       # batch padding, then spread up to a full cache
            lens_l = [0] + [cache * (i + 1) // b for i in range(b - 1)]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        qd = randn(b, 1, h, hd, dt=dt)
        kc, vc = randn(b, cache, kv, hd, dt=dt), randn(b, cache, kv, hd, dt=dt)
        kn, vn = randn(b, 1, kv, hd, dt=dt), randn(b, 1, kv, hd, dt=dt)
        attrs = dict(window=window, cap=cap)
        od = decode_attention_cuda(qd, kc, vc, kn, vn, lens, **attrs)
        torch.cuda.synchronize()
        plain = lambda: _ref_model_layout(qd, kc, vc, kn, vn, lens, window,  # noqa: E731
                                          cap)
        if max_err(od[0], vn[0].repeat_interleave(h // kv, 1)) != 0.0:
            fail(f"decode attention {dt} with lens 0 is not exactly v_new")
        err, within = verdict(od, plain(), dt)
        library = None
        if max(lens_l) < cache and not window and not cap:
            kfull, vfull = kc.clone(), vc.clone()
            rows = torch.arange(b, device=dev)
            kfull[rows, lens.long()] = kn[:, 0]
            vfull[rows, lens.long()] = vn[:, 0]
            qs, ks, vs = (t.transpose(1, 2) for t in (qd, kfull, vfull))
            mask = (torch.arange(cache, device=dev)[None, :]
                    <= lens.long()[:, None])[:, None, None, :]
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
        # the rows this run's lens read: within the window where one is set
        rows_n = int(sum(min(n, window - 1) if window else n
                         for n in lens_l))
        p = decode_plan(b, kv, cache, hd, qd.element_size(),
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
        tags = (f" window{window}" if window else "") + \
            (f" cap{cap:g}" if cap else "")
        record("decode_attention", f"B{b} cache{cache} H{h} KV{kv} hd{hd} "
               f"lens{lens_l}{tags}", err,
               lambda: decode_attention_cuda(qd, kc, vc, kn, vn, lens,
                                             **attrs), plain,
               library, 4.0 * h * hd * (rows_n + b),
               float(qd.element_size()) * (2 * b * h * hd
                                           + 2 * rows_n * kv * hd
                                           + 2 * b * kv * hd) + 4.0 * b,
               "src/repro/kernels/decode_attention/kernel.py:94",
               csrc + "decode_attention.cu", "cuda",
               ("decode_attention", b, cache, h, kv, hd)
               + ((window, cap) if window or cap else ()), dtype=dt,
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
    t0 = time.perf_counter()
    nodes32 = path_nodes(torch, dev, "float32")
    log(f"[kernels] {len(nodes32)} f32 path nodes read in "
        f"{time.perf_counter() - t0:.1f} s")
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
    # every (kernel, shape, dtype) phase 14's backbone launches, as
    # attention_route predicts them
    for dt in ("float32", bf):
        hold(dt, {key: ("backbone", None) for key, d in
                  backbone_plan_all() if d == dt}, " (backbone)")
    # and every one phase 15's training launches (forward, remat
    # recompute and the RG-LRU's reverse scan)
    for dt in ("float32", bf):
        hold(dt, {key: ("train", None) for key, d in
                  train_plan_all() if d == dt}, " (backbone train)")
    # and every one phase 17's ranks launch: the per-shard training graph's
    # forward nodes and its products' dx and dw
    hold("float32", mesh_sol_train_plan(torch), " (mesh SOL train)")
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
    log(f"[kernels] phase 2 took {time.perf_counter() - t_phase:.1f} s, "
        f"{len(cases)} rows")
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
# phases 11-25 of them; none in a fresh process), whatever the host waits
# first, and the profiled Listing-3 forward then showed part of its span
# and one of its two pools or none.  Only events after the last pad count.
# Now and then the loss runs past every pad and into the measured calls, or
# events go missing among the measured calls with the pads recorded: a
# profile that recorded no pad, or that its caller finds incomplete, is
# taken again, at most PROFILE_TRIES times.
PROFILE_PAD = 256
PROFILE_TRIES = 3
PAD_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel


def profile_events(torch, run, calls: int) -> list:
    """The device events, as (start µs, end µs, name), of one
    ``torch.profiler`` session (CUDA activity only) that runs
    ``PROFILE_PAD`` one-cycle ``torch.cuda._sleep`` kernels, then ``run()``
    ``calls`` times back to back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_breakdown(torch, run, calls: int = 1, complete=None) -> dict:
    """Profile ``calls`` calls of ``run()`` behind the pads
    (``profile_events``), taken again while no pad was recorded or, given
    ``complete``, while ``complete(breakdown)`` is false (events of the
    measured calls were lost), and return per call the device time and
    launches per family of the events after the last pad, the span from the
    first of them to the last, and the device's busy share over it: the
    union of device events over that span.  ``pad_events_lost``: the pads
    the kept profile did not record; ``retakes``: the profiles dropped."""
    for take in range(1, PROFILE_TRIES + 1):
        events = profile_events(torch, run, calls)
        pads = [e for e in events if PAD_KERNEL in e[2]]
        breakdown = _breakdown(events, pads, calls, take - 1)
        if not pads:
            why = (f"none of the {PROFILE_PAD} pad kernels was recorded: "
                   f"events of the measured calls may be lost too")
        elif complete is not None and not complete(breakdown):
            why = "events of the measured calls were lost"
        else:
            return breakdown
        if take < PROFILE_TRIES:
            log(f"[profile] {why}, profiling again")
    log(f"[profile] {PROFILE_TRIES} profiles lost events: {why}; the last "
        f"one is kept")
    return breakdown


def _breakdown(events: list, pads: list, calls: int, retakes: int) -> dict:
    """``device_breakdown``'s summary of one profile's ``events``."""
    cut = max((e[1] for e in pads), default=float("-inf"))
    spans = sorted(e for e in events
                   if PAD_KERNEL not in e[2] and e[0] >= cut)
    if not spans:
        return {"measured": False, "retakes": retakes,
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
            "pad_events_lost": PROFILE_PAD - len(pads), "retakes": retakes,
            "span_ms": span / 1e3 / calls, "busy_ms": busy / 1e3 / calls,
            "busy_share": busy / span,
            "device_ms_by_family": dict(sorted(
                by_family.items(), key=lambda kv: -kv[1])),
            "launches_by_family": {k: v / calls for k, v in sorted(
                launches.items(), key=lambda kv: -kv[1])}}


def profiled(torch, label: str, run, digits: int = 2,
             calls: int = 1, complete=None) -> dict:
    """``device_breakdown`` of ``calls`` calls of ``run()``, logged under
    ``label`` per call."""
    breakdown = device_breakdown(torch, run, calls, complete)
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
            f"kernels ahead, {breakdown['pad_events_lost']} not recorded"
            f" ({breakdown['retakes']} profiles retaken)")
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
           "bound_ms": bound(0.0, nbytes)[0],
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


def pools_profiled(breakdown: dict, forward_ms: float) -> bool:
    """The Listing-3 forward's profile shows both pools in every call and
    spans most of the forward: none of its events was lost."""
    pools = breakdown.get("launches_by_family", {}).get("avgpool")
    span = breakdown.get("span_ms", 0.0)
    return pools == 2 and span >= PROFILE_SPAN_SHARE * forward_ms


def check_pools_profiled(name: str, breakdown: dict, forward_ms: float):
    """Fail unless ``pools_profiled``: every retake lost events."""
    if not pools_profiled(breakdown, forward_ms):
        pools = breakdown.get("launches_by_family", {}).get("avgpool")
        span = breakdown.get("span_ms", 0.0)
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
            "decode_vs_reforward_near_ties": ties2}, ref, got


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
        complete = ((lambda b: pools_profiled(b, h_med))
                    if name == "listing3_cnn" else None)
        breakdown = profiled(torch, f"{name} h100 forward", lambda: sol(x),
                             digits=3, calls=CNN_PROFILE_CALLS,
                             complete=complete)
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


def fleet_buckets(server) -> list:
    """Every bucket a replica of phase 13's fleet can open, by
    ``SolServer``'s own rule: its batch buckets times its sequence buckets
    from the shortest prompt's to the longest context's (max(PROMPT_LENS)
    + GEN), for prefill and decode.  How the router splits the requests,
    and what a kill re-queues, decides which of them open."""
    low = server._seq_bucket(min(PROMPT_LENS))
    seqs = [s for s in server._seq_buckets(max(PROMPT_LENS) + GEN)
            if s >= low]
    return [(program, b, s) for program in ("prefill", "decode")
            for b in server._batch_buckets() for s in seqs]


def path_nodes(torch, dev, dtype: str) -> dict:
    """node_key -> (path, node) of every kernel node that a phase runs in
    ``dtype``, read from two-block versions of its paths at full width (a
    path's blocks are alike; nothing is launched).  float32: the serve's
    programs at the buckets phase 3 opens (``serve_buckets``, built by a
    two-layer ``SolServer``) and at those phase 13's fleet can open
    (``fleet_buckets``), both stacks (phase 5), the three CNNs (phase 6)
    and phase 12's per-shard programs.  bfloat16 (phase 7): the transformer's full program and
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
        for key in fleet_buckets(server):
            add(server._model_for(key), f"fleet {key[0]}")
        mesh_graphs = mesh_serve_graphs(lm, server, dev)
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
    if not half:
        for key, g in mesh_graphs:
            add(types.SimpleNamespace(graph=g), f"mesh_serve {key[0]}")
    return out


def mesh_serve_graphs(lm, server, dev) -> list:
    """(bucket key, elected per-shard graph) of the buckets phase 12's
    (2, 2) mesh serve opens, decided from ``shard_graph`` alone (no process
    group): the mesh server's bucket rule, the tagged backend's
    elections."""
    from repro_torch.backends import for_device, get_backend
    from repro_torch.core import passes
    from repro_torch.distributed import sharding as shd
    from repro_torch.frontends import extract

    am = shd.AbstractMesh(MESH)
    bk = shd.mesh_backend(for_device(get_backend("h100"), dev), am)
    d, out = FULL["d_model"], []
    for program, b, s in serve_buckets(server):
        b = max(b, MESH[0])          # the mesh's smallest batch bucket
        g = (extract.extract_prefill(lm, (b, s, d)) if program == "prefill"
             else extract.extract_decode(lm, b, s, d))
        out.append(((program, b, s),
                    passes.run_pipeline(shd.shard_graph(g, am), bk)))
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
                         lambda: sol(x16), digits=3, calls=CNN_PROFILE_CALLS,
                         complete=lambda b: pools_profiled(b, med(h_ms)))
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
                         bf16_products):
    """Phase 3's model and requests on a strict measured-provenance server,
    with a fresh autotune cache installed for the phase (the cold cache of
    phases 3 and 5-7 comes back in a ``finally``).  Returns what phase 9
    reads (the serve's cache, the bf16 tune's cache and the served bucket
    models) and the phase's record."""
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
        cache = AT.get_cache()
        table = measured_table(cache, "serve")
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
    state = {"cache": cache, "bf16_cache": bf16_cache,
             "models": dict(server._models), "server": server,
             "model": model, "cfg": server.cfg, "prompts": prompts,
             "trace": second}
    wins = {}
    for row in table + bf16_table:
        k = (row["op"], row["dtype"], row["winner"])
        wins[k] = wins.get(k, 0) + 1
    log(f"[measured] winners by (op, dtype, impl): {wins}; phase 8 took "
        f"{phase_s:.1f} s (warm {warm_s:.1f} s, bf16 tune {bf16_s:.1f} s)")
    return state, {"warm": counts, "warm_s": warm_s, "first_pass_s": first_s,
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


# ---------------------------------------------------------------------------
# phase 9: SOL gap analysis on phase 8's measurements
# ---------------------------------------------------------------------------

# the H100's L2: a measurement below its bound is possible only where the
# operands fit it (phase 8 times with a warm L2), so a row under 1.0 that
# moves more bytes than this means a count or a peak is wrong
L2_BYTES = 50 * 1024 ** 2
SOL_KINDS = ("linear", "matmul", "attention", "decode_attention")
# serve_rows at full width: phase 3's prompts (seed 7) and three more sets
# of the same lengths, GEN new tokens each: 16 requests, 256 tokens
SERVE_ROWS_SEEDS = (7, 8, 9, 10)


def phase_sol(torch, dev, state) -> dict:
    """(a) the ranked SOL table of phase 8's caches (the serve's and the
    bf16 tune's), (b) ``impl_report(sol=True)`` of every served prefill and
    decode bucket model, (c) the gap-driven planner with the real measure,
    each config it records held to the plain version, (d) the port's
    benchmark tables on the card and ``serve_rows`` at phase 3's width."""
    from repro_torch.backends import h100_spec
    from repro_torch.benchmarks import autotune as drv
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.serving import serve_rows
    from repro_torch.core import autotune as AT
    from repro_torch.core import sol as SOL

    t_phase = time.perf_counter()
    hw = h100_spec(torch.cuda.get_device_name(0))
    cache = AT.AutotuneCache()
    for part in (state["cache"], state["bf16_cache"]):
        for (op, dt, bk), bucket, impl, m in part.entries():
            cache.record(op, bucket, dt, bk, impl, m.us, config=m.config,
                         flops=m.flops, nbytes=m.nbytes, mean_us=m.mean_us)

    # (a) every cell's fastest impl, worst gap first
    ranked = SOL.rank(SOL.cache_rows(cache, best_only=True, device=dev))
    for line in SOL.render(ranked).splitlines():
        log(f"[sol] {line}")
    warm = []
    for r in ranked:
        cell = f"{r.op} {r.dtype} {'x'.join(map(str, r.bucket))} {r.impl}"
        if not math.isfinite(r.ratio):
            fail(f"phase 9: {cell} has a non-finite SOL ratio {r.ratio}")
        if r.ratio < 1.0:
            if r.nbytes > L2_BYTES:
                fail(f"phase 9: {cell} reads {r.us:.2f} µs under its bound "
                     f"{r.bound_us:.2f} µs with {r.nbytes:.3g} bytes, more "
                     f"than the L2 holds: a count or a peak is wrong")
            warm.append(cell)
    log(f"[sol] {len(ranked)} cells; below their bound, L2-warm (operands "
        f"within the {L2_BYTES >> 20} MB L2): {warm or 'none'}")

    # (b) the served bucket models, each node read from its exact bucket
    prev = AT.get_cache()
    AT.set_cache(state["cache"])
    reports = {}
    try:
        for key, model in sorted(state["models"].items()):
            if key[0] not in ("prefill", "decode"):
                continue
            rows = model.impl_report(sol=True)
            bad = [r for r in rows if r["op"] in SOL_KINDS
                   and (r["source"], r["confidence"]) != ("measured",
                                                          "exact")]
            if bad:
                fail(f"phase 9: bucket {key} reports {len(bad)} served "
                     f"node(s) not measured on their exact bucket, e.g. "
                     f"{bad[0]}")
            top = rows[0]
            log(f"[sol] impl_report(sol=True) {key}: {len(rows)} nodes; "
                f"worst {top['node']} {top['impl']} {top['us']:.2f} µs / "
                f"bound {top['bound_us']:.3f} ({top['unit']}) = ratio "
                f"{top['ratio']:.2f}")
            reports[str(key)] = rows
    finally:
        AT.set_cache(prev)

    # (c) the planner on the worst cells, with the real measure
    plans = drv.refine_plan(cache, "h100", top_k=3, rounds=2, budget=24,
                            device=dev)
    gen = torch.Generator(dev).manual_seed(9)
    held = []
    for rep in plans:
        for cfg in rep["recorded"]:
            node, _ = drv._build(rep["op"], rep["bucket"], rep["dtype"], dev)
            node.impl = rep["refined_impl"]
            held.append({"cell": [rep["op"], rep["dtype"], rep["bucket"]],
                         "config": cfg, "max_abs_err": hold_config(
                             torch, node, node_operands(torch, node, gen),
                             hw, cfg)})
        log(f"[sol] plan {rep['op']} {rep['dtype']} "
            f"{'x'.join(map(str, rep['bucket']))}: {rep['impl']} "
            f"{rep['before_us']:.2f} → {rep['after_us']:.2f} µs, ratio "
            f"{rep['before_ratio']:.2f} → {rep['after_ratio']:.2f} (bound "
            f"{rep['bound_us']:.3f} µs); refined {rep['refined_impl']} over "
            f"{rep['rounds']} round(s), {rep['configs_measured']} configs, "
            f"config {rep['config']}, recorded {rep['recorded']}, outside "
            f"the space {rep['outside_space']}, rewrite candidate "
            f"{rep['rewrite_candidate']}"
            + (f"; {rep['note']}" if rep["note"] else ""))
    log(f"[sol] {len(held)} recorded config(s) held to the plain version: "
        + (", ".join(f"{h['cell']} {h['config']} {h['max_abs_err']:.3g}"
                     for h in held) or "none"))

    # (d) the benchmark tables on the card, and the serving rows at full
    # width on phase 3's model
    t0 = time.perf_counter()
    rc = bench_run.main(["effort", "inference", "layouts", "matmul",
                         "serving", "sol", "--json",
                         str(OUT_DIR / "BENCH_torch.json")])
    if rc != 0:
        fail(f"phase 9: repro_torch.benchmarks.run returned {rc}")
    tables_s = time.perf_counter() - t0
    model, cfg = serve_model(torch, dev)
    workload = [(p, GEN) for seed in SERVE_ROWS_SEEDS
                for p in _workload(cfg.vocab, seed)]
    t0 = time.perf_counter()
    full = serve_rows(cfg=cfg, model=model, workload=workload, device=dev)
    for name, us, derived in full:
        log(f"[sol] serve_rows at full width: {name} {us:.1f} µs {derived}")
    phase_s = time.perf_counter() - t_phase
    log(f"[sol] phase 9 took {phase_s:.1f} s (tables {tables_s:.1f} s, "
        f"full-width serve_rows {time.perf_counter() - t0:.1f} s)")
    return {"cells": [r.to_json() for r in ranked], "l2_warm": warm,
            "impl_reports": reports, "plans": plans, "plans_held": held,
            "serve_rows_full": full, "tables_s": tables_s,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 10: training through elected kernels
# ---------------------------------------------------------------------------

# The serve model's widths (Qwen2-1.5B's attention, build_lm's block),
# RecurrentGemma-9B's (src/repro/configs/recurrentgemma_9b.py) and
# RWKV6-1.6B's (src/repro/configs/rwkv6_1_6b.py), as in phases 3 and 5,
# each cut to its TRAIN_BLOCKS blocks so that two backends' training runs
# of all three fit the script's time limit: RWKV6 to 1, whose torch-op
# scan backward (ckpt.rwkv6_scan_bwd) holds the host ≈ 0.6 s a layer
TRAIN_STACKS = (
    ("transformer", dict(d_model=1536, n_heads=12, n_kv_heads=2,
                         mlp_mult=4)),
    ("griffin", dict(d_model=4096, mlp_mult=3)),
    ("rwkv6", dict(d_model=2048, n_heads=32, mlp_mult=3)),
)
TRAIN_BLOCKS = {"transformer": 4, "griffin": 4, "rwkv6": 1}
TRAIN_SHAPE_BT = (4, 512)
TRAIN_STEPS = 6
# h100 against torch_ref from the same weights: each step's loss, relative;
# the final params at tests/test_train_sol.py's own tolerances
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
# Adam steps every element by about lr whatever its gradient's size, so an
# element whose gradient is as small as its rounding can step either way
# and two correct f32 runs part by up to 2·lr a step there.  Each stack's
# lr lies where h100 holds TRAIN_PARAM_TOL against torch_ref and a dw
# missing its last token (``dw_fault``) does not: phase 10 runs that fault
# at this lr and fails if the gate lets it through
TRAIN_LR = {"transformer": 1e-4, "griffin": 1e-4, "rwkv6": 2e-5}
# step 0's gradient of each parameter against torch_ref's, ‖Δ‖ over ‖g‖
# (``grad_gap``).  With every forward on its plain version, h100's backward
# impls alone: at most GRAD_BWD_RTOL.  With its own forward kernels, whose
# f32 rounding (at most MATMUL_ACCURACY_RTOL of their output's scale) the
# stack's gradients amplify: at most that error times the amplification,
# read as torch_ref's own gradient change per unit of a GRAD_NUDGE input
# change.  The planted dw fault must exceed both limits
GRAD_BWD_RTOL = 1e-4
GRAD_NUDGE = 2.0 ** -23
# each backward impl against autograd of the reference forward in f32,
# relative to each cotangent's scale: products and sums in another order
# keep ~1e-6; the scans' recurrences over 512 steps 1e-4
BWD_RTOL = 1e-5
BWD_SCAN_RTOL = 1e-4
HEAVY_KINDS = ("linear", "matmul", "attention", "rglru_scan", "rwkv6_scan")
# the backward impls each stack must elect, by backward kind
TRAIN_BWD = {"transformer": {"linear_bwd": "cuda.linear_bwd",
                             "matmul_bwd": "cuda.matmul_bwd",
                             "attention_bwd": "flash.attention_bwd"},
             "griffin": {"linear_bwd": "cuda.linear_bwd",
                         "matmul_bwd": "cuda.matmul_bwd",
                         "rglru_scan_bwd": "cuda.rglru_scan_bwd"},
             "rwkv6": {"linear_bwd": "cuda.linear_bwd",
                       "matmul_bwd": "cuda.matmul_bwd",
                       "rwkv6_scan_bwd": "ckpt.rwkv6_scan_bwd"}}
# kernels whose launches must rise during a backward, by stack
BWD_KERNELS = {"transformer": ("matmul",), "griffin": ("matmul",
                                                      "rglru_scan"),
               "rwkv6": ("matmul",)}
TRAIN_TIMED = 5          # fwd and fwd+bwd calls timed per stack
AVGPOOL_BWD_SHAPE = (64, 32, 222, 222)   # the first Listing-3 pool's output
TRAIN_CLI_TIMEOUT = 600


def _train_stack(torch, name: str, cfg: dict, dev, gen):
    from repro_torch.frontends import nn
    from torch import nn as tnn
    d = cfg["d_model"]
    if name == "transformer":
        def block():
            return nn.transformer_block(d, cfg["n_heads"], cfg["n_kv_heads"],
                                        cfg["mlp_mult"], device=dev,
                                        generator=gen)
    elif name == "griffin":
        def block():
            return nn.griffin_block(d, cfg["mlp_mult"], device=dev,
                                    generator=gen)
    else:
        def block():
            return nn.rwkv6_block(d, cfg["n_heads"], cfg["mlp_mult"],
                                  device=dev, generator=gen)
    return tnn.Sequential(*[block() for _ in range(TRAIN_BLOCKS[name])])


def bwd_key(n) -> tuple:
    """A backward case: the elected backward impl, the node (a FUSED
    group by its program's ops) and its input shapes."""
    return (n.impl_bwd, n.name if n.name.startswith("fused[")
            else n.op.value, tuple(tuple(i.spec.shape) for i in n.inputs))


def grad_nodes(sol) -> dict:
    """bwd_key -> [first node, nodes with it] of a training graph."""
    out: dict = {}
    for n in sol.graph.topo():
        if getattr(n, "impl_bwd", None):
            out.setdefault(bwd_key(n), [n, 0])[1] += 1
    return out


def library_bwd(torch, node, vals, ct):
    """One PyTorch call's backward computing the node's cotangents, its
    graph built once: autograd of ``F.linear`` (a product), SDPA (causal
    GQA attention) or ``F.avg_pool2d``, in the node's dtype; None where no
    single call computes them (the scans, a DFP group)."""
    import torch.nn.functional as F
    from repro_torch.core.executor import linear_weight_kn
    from repro_torch.core.ir import OpKind
    op = node.op
    if op in (OpKind.LINEAR, OpKind.MATMUL):
        w = vals[1] if op is OpKind.MATMUL else linear_weight_kn(node,
                                                                 vals[1])
        leaves = [vals[0].detach().requires_grad_(True),
                  w.T.detach().requires_grad_(True)] + [
            v.detach().requires_grad_(True) for v in vals[2:]]
        y = F.linear(*leaves)
    elif op is OpKind.ATTENTION and not node.attrs.get("window") \
            and not node.attrs.get("cap"):
        leaves = [v.detach().transpose(1, 2).requires_grad_(True)
                  for v in vals]
        y = F.scaled_dot_product_attention(
            *leaves, is_causal=node.attrs.get("causal", True),
            enable_gqa=True).transpose(1, 2)
    elif op is OpKind.AVGPOOL:
        leaves = [vals[0].detach().requires_grad_(True)]
        (h, w), (oh, ow) = vals[0].shape[2:], node.spec.shape[2:]
        y = F.avg_pool2d(leaves[0], (h - oh + 1, w - ow + 1), stride=1)
    else:
        return None
    return lambda: torch.autograd.grad(y, leaves, ct, retain_graph=True)


def bwd_case(torch, node, count: int, gen, backend, stack: str) -> dict:
    """One backward impl at a path node's shapes: its cotangents against
    the plain version's (``executor.reference_vjp_grad``: autograd of the
    reference forward in f32) relative to each one's scale, its device time
    (cold L2) and back-to-back launch time, the plain version's and the
    library call's, and the bound at twice the forward's cost terms at the
    peak of the unit that runs it."""
    from repro_torch.backends import registry
    from repro_torch.core import executor
    from repro_torch.core.ir import OpKind
    from repro_torch.core.passes import node_roofline_terms
    gi = registry.get_grad_impl(node.impl_bwd)
    if node.op is OpKind.FUSED and node.impl != "cuda.dfp_fused":
        # a group the DFP encoder refuses (Griffin's softplus and √): its
        # constants at their fill, the rest at half scale
        vals = [torch.full(i.spec.shape, i.attrs["fill"], device=gen.device)
                if i.op is OpKind.CONST else
                torch.randn(i.spec.shape, device=gen.device, generator=gen)
                * 0.5 for i in node.inputs]
    else:
        vals = node_operands(torch, node, gen)
    with torch.no_grad():
        out = registry.get_impl(node.impl).fn(node, vals, backend)
    ct = torch.randn(out.shape, device=out.device, generator=gen).to(
        out.dtype)
    res = (vals, out)
    got = gi.fn(node, res, ct, backend)
    want = executor.reference_vjp_grad(node, res, ct, backend)
    torch.cuda.synchronize()
    # relative to each cotangent's scale (absolute where it is all zero)
    errs = [max_err(g, w) / max(float(w.abs().max()), 1.0
                                if not bool(w.any()) else 0.0)
            for g, w in zip(got, want) if w is not None]
    scan = node.op in (OpKind.RGLRU_SCAN, OpKind.RWKV6_SCAN)
    tol = BWD_SCAN_RTOL if scan else BWD_RTOL
    label = f"{gi.name} {stack} {bwd_key(node)[1]} " \
            f"{[tuple(v.shape) for v in vals]}"
    if not max(errs) <= tol:
        fail(f"{label}: cotangents differ from autograd of the reference "
             f"forward by {[f'{e:.3g}' for e in errs]} of their scales "
             f"(rtol {tol})")
    iters, warmup = (5, 1) if scan else (20, 3)
    t = time_ms(lambda: gi.fn(node, res, ct, backend), iters, warmup)
    plain = time_ms(lambda: executor.reference_vjp_grad(node, res, ct,
                                                        backend),
                    iters, warmup)
    lib_fn = library_bwd(torch, node, vals, ct)
    lib = time_ms(lib_fn, iters, warmup)["device"] if lib_fn else None
    unit = gi.unit_of(node)
    flops, nbytes, _ = node_roofline_terms(node, backend.hw, gi.memory, unit)
    b_ms, b_by = bound(2 * flops, 2 * nbytes, unit)
    row = {"impl": gi.name, "stack": stack, "node": bwd_key(node)[1],
           "shapes": [list(v.shape) for v in vals], "per_step": count,
           "rel_err": errs, "rtol": tol, "ms": t["device"],
           "launch_ms": t["launch"], "plain_ms": plain["device"],
           "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
           "unit": unit}
    log(f"[train-bwd] {label} ×{count} a step: {t['device']:.4f} ms "
        f"(back to back {t['launch']:.4f}), bound {b_ms:.4f} ({b_by}, "
        f"{unit}), plain {plain['device']:.4f}, library "
        + (f"{lib:.4f}" if lib is not None else "none")
        + f"; rel err {max(errs):.3g} (rtol {tol})")
    return row


def avgpool_bwd_case(torch, gen, backend) -> dict:
    """``conv.avgpool_bwd`` at the first Listing-3 pool (64, 32, 224,
    224), 3×3."""
    from repro_torch.backends import registry
    from repro_torch.benchmarks.autotune import _node
    node = _node("avgpool", AVGPOOL_BWD_SHAPE)
    node.impl = "cuda.avgpool"
    node.impl_bwd = registry.resolve_grad(backend, node).name
    if node.impl_bwd != "conv.avgpool_bwd":
        fail(f"the Listing-3 pool elects {node.impl_bwd} for its backward")
    return bwd_case(torch, node, 1, gen, backend, "listing3_cnn")


def check_train_elections(sol, name: str) -> dict:
    """The forward elections as phase 5 requires them, every heavy kind's
    backward a non-reference impl, and the stack's expected backward impls
    elected."""
    by_kind = check_cuda_elected(sol, name)
    for kind in HEAVY_KINDS:
        refs = [i for i in by_kind.get(f"{kind}_bwd", {})
                if i.startswith("ref.")]
        if refs:
            fail(f"train {name}: {kind}_bwd elected {refs}")
    for kind, impl in TRAIN_BWD[name].items():
        if set(by_kind.get(kind, {})) != {impl}:
            fail(f"train {name}: {kind} elected {by_kind.get(kind)}, not "
                 f"{impl}")
    return by_kind


def param_grads(torch, fn, params: dict, x, y) -> dict:
    """Step 0's gradient of the MSE loss for every parameter through the
    training lowering ``fn`` (a ``SolModel._fn`` or ``lowered``'s)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = ((fn(leaves, x) - y) ** 2).mean()
    keys = sorted(leaves)
    return dict(zip(keys, torch.autograd.grad(loss,
                                              [leaves[k] for k in keys])))


def grad_gap(got: dict, want: dict) -> dict:
    """Per parameter: ‖got − want‖ over ‖want‖ (``norm``, the gate's), and
    max |got − want| over max |want| (``max``)."""
    out = {}
    for k in sorted(want):
        if got[k].shape != want[k].shape:
            fail(f"gradient of {k}: shape {tuple(got[k].shape)}, torch_ref "
                 f"{tuple(want[k].shape)}")
        d = got[k] - want[k]
        out[k] = {"norm": float(d.norm() / want[k].norm().clamp_min(1e-30)),
                  "max": float(d.abs().max()
                               / want[k].abs().max().clamp_min(1e-30))}
    return out


def lowered(sol, fwd=frozenset(), bwd: bool = False):
    """``sol``'s training lowering with the nodes whose forward impl is in
    ``fwd`` on their op's reference forward, and with ``bwd`` every
    backward on its op's reference backward; the elections stay as they
    were."""
    from repro_torch.backends import registry
    from repro_torch.core.executor import lower_graph
    saved = [(n, n.impl, n.impl_bwd) for n in sol.graph.topo()]
    try:
        for n, impl, impl_bwd in saved:
            if impl in fwd:
                n.impl = registry._REFERENCE_IMPLS[n.op].name
            if bwd and impl_bwd:
                n.impl_bwd = registry._GRAD_REFERENCE_IMPLS[n.op].name
        return lower_graph(sol.graph, sol.backend, differentiable=True)
    finally:
        for n, impl, impl_bwd in saved:
            n.impl, n.impl_bwd = impl, impl_bwd


@contextlib.contextmanager
def dw_fault():
    """``cuda.matmul_bwd`` and ``cuda.linear_bwd`` with a dw that misses the
    last token's row, the ragged-edge fault a product kernel could make:
    planted to show that phase 10's gates catch it (dx is untouched)."""
    from repro_torch.kernels.matmul import grad
    real = grad._dx_dw

    def wrong(x, w, ct, kn, splits):
        x = x.contiguous().clone()
        x.view(-1, x.shape[-1])[-1] = 0
        return real(x, w, ct, kn, splits)
    grad._dx_dw = wrong
    try:
        yield
    finally:
        grad._dx_dw = real


def grad_agreement(torch, name: str, sol, ref, x, y) -> dict:
    """(b) step 0's gradient of every parameter against torch_ref's from
    the same weights (``grad_gap``): h100's backward impls alone (every
    forward on its plain version) within GRAD_BWD_RTOL, and h100 whole
    within its floor (the forward kernels' error times the gradients'
    amplification of it, from torch_ref with its input nudged by
    GRAD_NUDGE); the planted ``dw_fault`` must fail both.  Beside them, to
    show where the gap comes from: h100 with each ``cuda.*`` forward impl
    on its plain version, and with every backward plain."""
    params = sol._params_for_call()
    want = param_grads(torch, ref._fn, ref._params_for_call(), x, y)
    cuda_fwd = sorted({n.impl for n in sol.graph.topo()
                       if (n.impl or "").startswith("cuda.")})
    fns = {"h100": sol._fn}
    fns.update({f"{impl} plain": lowered(sol, fwd={impl})
                for impl in cuda_fwd})
    fns["every forward plain"] = lowered(sol, fwd=set(cuda_fwd))
    fns["every backward plain"] = lowered(sol, bwd=True)
    gaps = {label: grad_gap(param_grads(torch, fn, params, x, y), want)
            for label, fn in fns.items()}
    with dw_fault():
        for label in ("h100", "every forward plain"):
            gaps[f"{label}, dw fault"] = grad_gap(
                param_grads(torch, fns[label], params, x, y), want)
    gen = torch.Generator(x.device).manual_seed(7)
    nudged = x * (1 + GRAD_NUDGE * torch.randn(
        x.shape, device=x.device, generator=gen))
    gaps["torch_ref, input nudged"] = grad_gap(
        param_grads(torch, ref._fn, ref._params_for_call(), nudged, y), want)
    del want
    worst = {}
    for label, gap in gaps.items():
        worst[label] = {m: max(((k, g[m]) for k, g in gap.items()),
                               key=lambda kv: kv[1]) for m in ("norm", "max")}
        log(f"[train-grad] {name} {label}: worst ‖Δ‖/‖g‖ "
            f"{worst[label]['norm'][1]:.3g} ({worst[label]['norm'][0]}), "
            f"worst max|Δ|/max|g| {worst[label]['max'][1]:.3g} "
            f"({worst[label]['max'][0]})")
    amplification = worst["torch_ref, input nudged"]["norm"][1] / GRAD_NUDGE
    floor = amplification * MATMUL_ACCURACY_RTOL
    for label, limit in (("every forward plain", GRAD_BWD_RTOL),
                         ("h100", floor)):
        (k, got), caught = worst[label]["norm"], \
            worst[f"{label}, dw fault"]["norm"][1]
        if not got <= limit:
            fail(f"train {name}: step-0 gradient of {k} ({label}) differs "
                 f"from torch_ref's by {got:.3g} of its norm (limit "
                 f"{limit:.3g})")
        if not caught > limit:
            fail(f"train {name}: the planted dw fault ({label}) moves no "
                 f"step-0 gradient past {limit:.3g} ({caught:.3g})")
    log(f"[train-grad] {name}: backward impls within {GRAD_BWD_RTOL}; "
        f"gradients amplify an input change {amplification:.3g}×, so h100's "
        f"floor is {floor:.3g}")
    return {"bwd_limit": GRAD_BWD_RTOL, "amplification": amplification,
            "floor": floor, "worst": worst, "by_param": gaps}


def train_run(torch, sol, x, y, steps: int, lr: float) -> tuple:
    """``steps`` steps of ``make_sol_train_step`` (AdamW, the cosine
    schedule to ``lr``) from the model's own weights: the losses, each
    step's host ms to its end on the device, and the final parameters."""
    from repro_torch.distributed.steps import StepOptions, \
        make_sol_train_step
    opts = StepOptions(lr=lr, warmup=1, total_steps=steps)
    step_fn, init_state = make_sol_train_step(sol, opts)
    state = init_state()
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"x": x, "y": y})
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
    return losses, step_ms, state["params"]


def train_gap(losses, final, ref_losses, ref_final) -> dict:
    """A training run against torch_ref's from the same weights: each
    step's relative loss difference, the final params' largest |Δ| and
    elements outside TRAIN_PARAM_TOL, and the gate's violations (a loss
    past TRAIN_LOSS_RTOL, a parameter past TRAIN_PARAM_TOL)."""
    bad = [f"step {i} loss {a!r}, torch_ref {b!r}"
           for i, (a, b) in enumerate(zip(losses, ref_losses))
           if not abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)]
    worst, max_abs, outside = "", 0.0, 0
    for k in sorted(ref_final):
        d = (final[k] - ref_final[k]).abs()
        n_out = int((d > TRAIN_PARAM_TOL["atol"]
                     + TRAIN_PARAM_TOL["rtol"] * ref_final[k].abs()).sum())
        if n_out:
            bad.append(f"param {k}: {n_out} elements outside "
                       f"{TRAIN_PARAM_TOL}, max |Δ| {float(d.max()):.3g}")
        outside += n_out
        if float(d.max()) > max_abs:
            worst, max_abs = k, float(d.max())
    return {"loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "max_abs": max_abs, "worst": worst, "outside": outside,
            "violations": bad}


def train_stack(torch, counters, dev, index: int, name: str, cfg: dict,
                backend) -> dict:
    """(a) each backward case of the stack's training graph, (b) step 0's
    gradients and six steps on h100 and torch_ref from the same weights,
    each gate run again on the planted ``dw_fault``, which it must fail,
    (c) fwd and fwd+bwd times and one profiled fwd+bwd."""
    import statistics
    from repro_torch.benchmarks.train_bench import step_fns
    from repro_torch.frontends.optimize import optimize

    gen = torch.Generator(dev).manual_seed(300 + index)
    model = _train_stack(torch, name, cfg, dev, gen)
    shape = TRAIN_SHAPE_BT + (cfg["d_model"],)
    x = torch.randn(shape, device=dev, generator=gen)
    y = torch.randn(shape, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    sol = optimize(model, shape, backend="h100", training=True)
    by_kind = check_train_elections(sol, name)
    log(f"[train] {name}: {TRAIN_BLOCKS[name]} blocks at d "
        f"{cfg['d_model']}, "
        f"{n_params / 1e6:.1f} M parameters, input {shape}; h100 "
        f"elections: {by_kind}")

    # (a) every backward case of the graph at its own shapes
    cases = [bwd_case(torch, n, count, gen, sol.backend, name)
             for n, count in grad_nodes(sol).values()]

    # launches during a backward, apart from its forward's
    fwd, fwd_bwd = step_fns(sol, x, y)
    params = sol._params_for_call()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    for c in counters.values():
        c.launches = 0
    loss = ((sol._fn(leaves, x) - y) ** 2).mean()
    torch.cuda.synchronize()
    fwd_launches = {k: c.launches for k, c in counters.items()}
    for c in counters.values():
        c.launches = 0
    torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    bwd_launches = {k: c.launches for k, c in counters.items()}
    del loss, leaves
    for kernel in BWD_KERNELS[name]:
        if bwd_launches[kernel] <= 0:
            fail(f"train {name}: {kernel} did not launch during backward")
    check_matmul_kernels(f"train {name} backward", bwd_launches)
    log(f"[train] {name} launches of one forward {fwd_launches}, of its "
        f"backward {bwd_launches}")

    # (b) step 0's gradients against torch_ref's
    ref = optimize(model, shape, backend="torch_ref", training=True)
    grads = grad_agreement(torch, name, sol, ref, x, y)

    # (b) the main path's run: counts from 0, the h100 steps, counts read
    lr = TRAIN_LR[name]
    for c in counters.values():
        c.launches = 0
    losses, step_ms, final = train_run(torch, sol, x, y, TRAIN_STEPS, lr)
    launches = {k: c.launches for k, c in counters.items()}
    check_matmul_kernels(f"train {name}", launches,
                         STACK_MATMUL_KERNELS.get(name, ("matmul_tc",)))

    # (c) times: fwd and fwd+bwd in turns, one profiled fwd+bwd
    fwd_ms = timed_calls(torch, fwd, TRAIN_TIMED)
    bwd_ms = timed_calls(torch, fwd_bwd, TRAIN_TIMED)
    breakdown = profiled(torch, f"train {name} h100 fwd+bwd", fwd_bwd)
    del fwd, fwd_bwd, params
    gc.collect()
    torch.cuda.empty_cache()

    ref_losses, ref_step_ms, ref_final = train_run(torch, ref, x, y,
                                                   TRAIN_STEPS, lr)
    if not losses[-1] < losses[0]:
        fail(f"train {name}: loss did not fall: {losses}")
    sound = train_gap(losses, final, ref_losses, ref_final)
    if sound["violations"]:
        fail(f"train {name} at lr {lr}: {sound['violations'][:4]}")
    del final
    with dw_fault():
        f_losses, _, f_final = train_run(torch, sol, x, y, TRAIN_STEPS, lr)
    fault = train_gap(f_losses, f_final, ref_losses, ref_final)
    if not fault["violations"]:
        fail(f"train {name}: the planted dw fault passes the training gate "
             f"at lr {lr} (loss within {fault['loss_rel']:.3g}, params "
             f"within max |Δ| {fault['max_abs']:.3g})")
    del f_final
    log(f"[train] {name}: losses h100 {[round(v, 6) for v in losses]}, "
        f"torch_ref {[round(v, 6) for v in ref_losses]} (worst relative "
        f"{sound['loss_rel']:.3g}, rtol {TRAIN_LOSS_RTOL}); final params "
        f"within max |Δ| {sound['max_abs']:.3g} ({sound['worst']}); the "
        f"planted dw fault: loss {fault['loss_rel']:.3g}, max |Δ| "
        f"{fault['max_abs']:.3g}, {fault['outside']} elements outside "
        f"{TRAIN_PARAM_TOL}; step ms h100 {[round(v, 2) for v in step_ms]}, "
        f"torch_ref {[round(v, 2) for v in ref_step_ms]}; launches in the "
        f"h100 steps {launches}; lr {lr}")
    f_med, b_med = statistics.median(fwd_ms), statistics.median(bwd_ms)
    log(f"[train] {name} h100 median of {TRAIN_TIMED}: fwd {f_med:.2f} ms, "
        f"fwd+bwd {b_med:.2f} ms, ratio {b_med / f_med:.2f}; AdamW step, "
        f"median of {TRAIN_STEPS}: h100 {statistics.median(step_ms):.2f} "
        f"ms, torch_ref {statistics.median(ref_step_ms):.2f} ms")
    out = {"config": cfg, "blocks": TRAIN_BLOCKS[name], "shape": shape,
           "lr": lr, "parameters": n_params, "elections": by_kind,
           "bwd_cases": cases, "fwd_launches": fwd_launches,
           "bwd_launches": bwd_launches, "launches": launches,
           "step0_grads": grads, "losses": losses,
           "torch_ref_losses": ref_losses, "fault_losses": f_losses,
           "agreement": sound, "fault": fault,
           "step_ms": step_ms, "torch_ref_step_ms": ref_step_ms,
           "fwd_ms": fwd_ms, "fwdbwd_ms": bwd_ms, "fwd_ms_median": f_med,
           "fwdbwd_ms_median": b_med, "ratio": b_med / f_med,
           "device_breakdown": breakdown}
    del model, sol, ref, ref_final, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_cli(name: str) -> dict:
    """``python -m repro_torch.launch.train --sol --sol-model name`` (d 256
    on the card): warm-up, both gates, the loss falling; its backward
    elections with their provenance are printed."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--sol",
         "--sol-model", name], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=TRAIN_CLI_TIMEOUT)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[train --sol]")]
    for ln in lines:
        log(f"[train-cli] {ln}")
    if proc.returncode != 0 or "strict provenance clean" not in proc.stdout \
            or "(improved)" not in proc.stdout:
        fail(f"launch.train --sol --sol-model {name} exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    log(f"[train-cli] {name}: both gates passed, the loss fell "
        f"({seconds:.1f} s)")
    return {"seconds": seconds, "lines": lines}


def phase_train(torch, counters, dev) -> dict:
    """Phase 10: each stack's training path, the Listing-3 pool's
    backward, and the training CLI for each zoo block."""
    from repro_torch.backends import for_device, get_backend
    t0 = time.perf_counter()
    backend = for_device(get_backend("h100"), dev)
    gen = torch.Generator(dev).manual_seed(299)
    stacks = {name: train_stack(torch, counters, dev, i, name, cfg, backend)
              for i, (name, cfg) in enumerate(TRAIN_STACKS)}
    pool = avgpool_bwd_case(torch, gen, backend)
    cli = {name: train_cli(name) for name, _ in TRAIN_STACKS}
    log(f"[train] phase 10 took {time.perf_counter() - t0:.1f} s")
    return {"stacks": stacks, "avgpool_bwd": pool, "cli": cli}


# ---------------------------------------------------------------------------
# phase 11: deploy artifacts
# ---------------------------------------------------------------------------

# an artifact against its live model, relative to the output's scale: the
# same impls with the same pinned configs on the same inputs, so bit-equal
# is expected; 1e-6 only admits an f32 rounding step, and any op the
# export lowers another way would show above it
DEPLOY_RTOL = 1e-6
# the recurrent stacks deployed at full width, cut to this depth
DEPLOY_BLOCKS = 2
# the kernels each artifact leg must launch (the serve's are read from its
# elections, as phase 8 reads them)
DEPLOY_KERNELS = {"griffin": ("matmul", "dfp_fused", "rglru_scan"),
                  "rwkv6": ("matmul", "dfp_fused", "rwkv6_scan"),
                  "listing3_cnn_bf16": ("matmul", "avgpool")}
ALL_KERNELS = ("matmul", "flash_attention", "decode_attention", "dfp_fused",
               "rglru_scan", "rwkv6_scan", "avgpool")


def blob_mb(blobs) -> float:
    return sum(len(b) for b in blobs) / 2 ** 20


def deployed_leg(torch, counters, name: str, sol, x) -> dict:
    """``deploy``/``load`` of one live ``SolModel`` on the card: export
    seconds, blob MB, load seconds, the artifact's output against the live
    model's (at most ``DEPLOY_RTOL`` of its scale) and the launches of its
    kernels in one artifact call (counts from 0 just before it)."""
    from repro_torch.frontends import deploy as D
    live = sol(x)
    t0 = time.perf_counter()
    blob = D.deploy(sol)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = D.load(blob, sol.device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if art.impl_report(provenance=True) != sol.impl_report(provenance=True):
        fail(f"deploy {name}: the artifact's election report differs from "
             f"the live model's")
    for c in counters.values():
        c.launches = 0
    y = art(x)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if y.shape != live.shape or y.dtype != live.dtype or \
            not bool(torch.isfinite(y.float()).all()):
        fail(f"deploy {name}: output {tuple(y.shape)} {y.dtype} is not a "
             f"finite {tuple(live.shape)} {live.dtype}")
    err = rel_err(y, live)
    if err > DEPLOY_RTOL:
        fail(f"deploy {name}: the artifact's output lies {err:.3g} of its "
             f"scale from the live model's (limit {DEPLOY_RTOL})")
    for k in DEPLOY_KERNELS[name]:
        if launches[k] <= 0:
            fail(f"deploy {name}: {k} did not launch through the artifact")
    rec = {"export_s": export_s, "blob_mb": blob_mb([blob]),
           "load_s": load_s, "host_bytes": art.host_bytes, "rel_err": err,
           "bit_equal": bool(torch.equal(y, live)), "launches": launches}
    log(f"[deploy] {name}: exported in {export_s:.2f} s, "
        f"{rec['blob_mb']:.1f} MB, loaded in {load_s:.2f} s; output "
        f"{'bit-equal to' if rec['bit_equal'] else f'{err:.3g} from'} the "
        f"live model's; launches through the artifact {launches}")
    return rec


def dispatch_us(torch) -> dict:
    """Back-to-back launch time of the matmul's custom op against its
    direct entry call at the serve's 4x1536x1536 decode product: the op's
    dispatch cost a call."""
    from repro_torch.kernels import library
    from repro_torch.kernels.matmul.ops import matmul
    gen = torch.Generator("cuda").manual_seed(11)
    x = torch.randn(4, 1536, device="cuda", generator=gen)
    w = torch.randn(1536, 1536, device="cuda", generator=gen) / 40.0
    op = time_ms(lambda: library.matmul(x, w, 0), iters=200)["launch"]
    direct = time_ms(lambda: matmul(x, w), iters=200)["launch"]
    return {"op_us": 1e3 * op, "direct_us": 1e3 * direct,
            "dispatch_us": 1e3 * (op - direct)}


def phase_deploy(torch, counters, dev, state) -> dict:
    """The serve leg: ``export_artifacts()`` of phase 8's strict measured
    server, then ``SolServer(deployed=..., strict_provenance=True)`` on
    phase 3's requests, tokens and every served step's logits held to
    phase 8's second pass, the elected kernels' launches read in that
    pass; tokens/s of the artifact serve and a live strict serve of the
    same model in turns.  Then ``deploy``/``load`` of a 2-block Griffin and
    RWKV6 at full width and of the bf16 Listing-3 CNN, each held to its
    live model."""
    import numpy as np
    from repro_torch.core import autotune as AT
    from repro_torch.frontends.optimize import optimize
    from repro_torch.launch.serve import SolServer

    t_phase = time.perf_counter()
    cfg, prompts = state["cfg"], state["prompts"]
    t0 = time.perf_counter()
    arts = state["server"].export_artifacts()
    export_s = time.perf_counter() - t0
    sizes = {str(k): len(b) / 2 ** 20 for k, b in arts.items()}
    t0 = time.perf_counter()
    replay = SolServer(cfg, deployed=arts, device=dev,
                       strict_provenance=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    host_bytes = sum(m.host_bytes for m in replay._models.values())
    log(f"[deploy] serve: {len(arts)} bucket artifacts {sorted(arts)} "
        f"exported in {export_s:.2f} s, {blob_mb(arts.values()):.1f} MB "
        f"({sizes}); loaded and audited (strict, from the manifests) in "
        f"{load_s:.2f} s, {host_bytes / 1e9:.2f} GB of params staged from "
        f"the host")
    del arts
    elected = {name for rec in replay.served_elections.values()
               for impls in rec["by_op"].values() for name in impls}
    for c in counters.values():
        c.launches = 0
    _, got, wall = serve_trace(replay, prompts, GEN)
    launches = {k: c.launches for k, c in counters.items()}
    for impl, counter in SERVED_IMPLS.items():
        used = any(n in elected for n, c in SERVED_IMPLS.items()
                   if c == counter)
        if used and launches[counter] <= 0:
            fail(f"deploy serve: {impl} was elected but {counter} did not "
                 f"launch through the artifacts")
        if not used and launches[counter] != 0:
            fail(f"deploy serve: {counter} launched {launches[counter]} "
                 f"times with no node electing it")
    worst, n_steps = 0.0, 0
    for i, ((g_tok, g_log), (w_tok, w_log)) in enumerate(zip(got,
                                                             state["trace"])):
        if g_tok != w_tok:
            fail(f"deploy serve request {i}: tokens {g_tok} != phase 8's "
                 f"{w_tok}")
        for pos, (a, b) in enumerate(zip(g_log, w_log)):
            err = float(np.abs(a - b).max()) / float(np.abs(b).max())
            worst = max(worst, err)
            n_steps += 1
            if err > DEPLOY_RTOL:
                fail(f"deploy serve request {i} step {pos}: logits lie "
                     f"{err:.3g} of their scale from phase 8's")
    log(f"[deploy] serve through the artifacts: tokens equal phase 8's; "
        f"logits at {n_steps} served steps within {worst:.3g} of their "
        f"scale (limit {DEPLOY_RTOL}); elected {sorted(elected)}; launches "
        f"{launches}")

    # the live strict serve of the same model and the artifact serve, in
    # turns (live, artifact, artifact, live), on phase 8's measurements
    prev = AT.get_cache()
    AT.set_cache(state["cache"])
    try:
        live = SolServer(cfg, model=state["model"], device=dev,
                         strict_provenance=True)
        serve_trace(live, prompts, GEN)         # opens its buckets
        walls = {"live": [], "artifact": []}
        for which in ("live", "artifact", "artifact", "live"):
            reqs, _, w = serve_trace(live if which == "live" else replay,
                                     prompts, GEN)
            walls[which].append(sum(len(r.generated) for r in reqs) / w)
        live.close()
    finally:
        AT.set_cache(prev)
    replay.close()
    tps = {k: sum(v) / len(v) for k, v in walls.items()}
    log(f"[deploy] tokens/s in turns (live, artifact, artifact, live): live "
        f"{[round(v, 2) for v in walls['live']]} mean {tps['live']:.2f}, "
        f"artifact {[round(v, 2) for v in walls['artifact']]} mean "
        f"{tps['artifact']:.2f}; the checked artifact pass "
        f"{sum(len(t) for t, _ in got) / wall:.2f}")
    # the replay and the live serve no longer need their card memory
    del live, replay
    state.pop("server")
    state["models"].clear()
    gc.collect()
    torch.cuda.empty_cache()
    disp = dispatch_us(torch)
    log(f"[deploy] 4x1536x1536 product back to back: the custom op "
        f"{disp['op_us']:.2f} µs a call, the direct entry "
        f"{disp['direct_us']:.2f} µs: dispatch {disp['dispatch_us']:.2f} µs")

    # the kernels off the serving path, each through an artifact
    legs = {}
    for index, (name, cfg_) in enumerate(STACKS):
        gen = torch.Generator(dev).manual_seed(300 + index)
        cut = dict(cfg_, layers=DEPLOY_BLOCKS)
        model = _build_stack(name, cut, dev, gen)
        shape = REC_SHAPE_BT + (cut["d_model"],)
        x = torch.randn(*shape, device=dev, generator=gen)
        sol = optimize(model, shape, backend="h100")
        check_elections(sol, name)
        legs[name] = deployed_leg(torch, counters, name, sol, x)
        del model, sol, x
    gen = torch.Generator(dev).manual_seed(302)
    model = _build_cnn(torch, "listing3_cnn", dev, gen).to(torch.bfloat16)
    x16 = torch.randn(*CNN_SHAPE, device=dev, generator=gen).to(
        torch.bfloat16)
    sol = optimize(model, CNN_SHAPE, backend="h100", dtype="bfloat16")
    if sol.impl_report(by_kind=True).get("avgpool") != {"cuda.avgpool": 2}:
        fail(f"deploy listing3_cnn bf16: elections "
             f"{sol.impl_report(by_kind=True)}")
    legs["listing3_cnn_bf16"] = deployed_leg(torch, counters,
                                             "listing3_cnn_bf16", sol, x16)
    moved = {k for leg in [launches] + [r["launches"] for r in legs.values()]
             for k, n in leg.items() if n > 0}
    missing = sorted(set(ALL_KERNELS) - moved)
    if missing:
        fail(f"deploy: {missing} launched through no artifact")
    phase_s = time.perf_counter() - t_phase
    log(f"[deploy] phase 11 took {phase_s:.1f} s")
    return {"serve": {"export_s": export_s, "blob_mb": sizes,
                      "load_s": load_s, "host_bytes": host_bytes,
                      "logit_rel_err": worst, "steps": n_steps,
                      "launches": launches, "elected": sorted(elected),
                      "tokens_per_s": walls, "tokens_per_s_mean": tps},
            "dispatch": disp, "legs": legs, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 12: the mesh serve, four ranks on the one card
# ---------------------------------------------------------------------------

SERVE_KERNELS = ("matmul", "flash_attention", "decode_attention", "dfp_fused")


def serve_counters():
    """The serve's kernel counters: ``matmul_cuda`` counts every product,
    each of its two kernels its own launches."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.dfp_fused.kernel import dfp_fused_triton
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.matmul.kernel import KERNELS, matmul_cuda
    return {"matmul": matmul_cuda, "matmul_tc": KERNELS["tensor_core"],
            "matmul_skinny": KERNELS["skinny"],
            "flash_attention": flash_attention_cuda,
            "decode_attention": decode_attention_cuda,
            "dfp_fused": dfp_fused_triton}


def mesh_serve_rank(mesh, prompts, held) -> dict:
    """One rank of phase 12 (run by ``run_on_mesh``): phase 3's weights
    built on the card from the same seed, served on the mesh twice; the
    second pass is counted and timed.  Fails the rank (and so the run) on
    a node phase 2 did not hold, an election off the kernels, a serve
    kernel that did not launch or a copy count off one per forward."""
    import torch
    from repro_torch.core.ir import OpKind
    from repro_torch.launch.serve import SolServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model, cfg = serve_model(torch, mesh.device)
    server = SolServer(dataclasses.replace(cfg, mesh=tuple(mesh.sizes)),
                       model=model, device=mesh.device)
    counters = serve_counters()
    calls = {}

    def reset_counts():
        for c in counters.values():
            c.launches = 0
        calls.update(mesh.calls)

    got, m = measured_serve(server, prompts, reset_counts)
    launches = {name: c.launches for name, c in counters.items()}
    collectives = {k: v - calls[k] for k, v in mesh.calls.items()}
    s = server.summary()
    for key, sol in sorted(server._models.items()):
        check_held(sol, f"mesh bucket {key}", held, "float32")
    for key, rec in sorted(server.served_elections.items()):
        for kind in CUDA_KINDS:
            for impl in rec["by_op"].get(kind, {}):
                if not impl.startswith("cuda."):
                    fail(f"mesh bucket {key}: {kind} elected {impl}")
    if s["dmas"] != s["forwards"]:
        fail("mesh serve: more than one packed copy per forward")
    check_matmul_kernels("mesh serve", launches)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"mesh serve: {name} was not launched on rank {mesh.rank}")
    dec = [sol for key, sol in server._models.items() if key[0] == "decode"]
    psum = sum(1 for n in dec[0].graph.topo() if n.attrs.get("psum_axes"))
    gathers = len(dec[0].graph.outputs)
    shapes = sorted({(n.op.value, tuple(n.spec.shape))
                     for n in dec[0].graph.topo()
                     if n.op in (OpKind.DECODE_ATTENTION,)})
    print(f"[mesh] {mesh}: {m['tokens_per_s']:.2f} tok/s, decode step p50 "
          f"{m['decode_p50_ms']:.2f} ms, {psum} all-reduces and one "
          f"all-gather (of {gathers} outputs) a decode step, collectives "
          f"in the pass {collectives}; launches {launches}; decode "
          f"attention at {shapes}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    server.close()
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "tokens": [t for t, _ in got],
            "trace": got if mesh.rank == 0 else None,
            "launches": launches, "tokens_per_s": m["tokens_per_s"],
            "decode_p50_ms": m["decode_p50_ms"],
            "first_pass_s": m["first_pass_s"],
            "all_reduce_per_decode_step": psum,
            "gathers_per_forward": gathers, "collectives": collectives,
            "buckets": sorted(server._models), "summary": s}


def phase_mesh_serve(torch, serve_got, held) -> dict:
    """Phase 12: phase 3's model and requests on a (2, 2) mesh, four ranks
    on the one card (``run_on_mesh``, gloo); every rank's tokens equal
    phase 3's (near ties reported) and rank 0's logits at every step within
    ``LOGIT_RTOL`` of phase 3's scale."""
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_on_mesh

    t_phase = time.perf_counter()
    build.build_all()                 # the ranks load what the parent built
    prompts = _workload(FULL["vocab"])
    ranks = run_on_mesh(mesh_serve_rank, *MESH, device="cuda",
                        dist_backend="gloo", timeout_s=MESH_TIMEOUT_S,
                        args=(prompts, held))
    got = ranks[0]["trace"]
    worst = 0.0
    for i, ((g_tok, g_log), (r_tok, r_log)) in enumerate(zip(got,
                                                             serve_got)):
        for pos, (a, b) in enumerate(zip(g_log, r_log)):
            scale = float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            worst = max(worst, err / scale)
            if err > LOGIT_RTOL * scale:
                fail(f"mesh serve request {i} step {pos}: logits differ by "
                     f"{err:.3g} from phase 3's (scale {scale:.3g})")
            if g_tok[pos] != r_tok[pos]:
                break
    ties = compare_tokens("mesh serve vs phase 3", got, serve_got,
                          lambda row: LOGIT_RTOL * float(np.abs(row).max()))
    for r in ranks[1:]:
        if r["tokens"] != ranks[0]["tokens"]:
            fail(f"mesh serve: rank {r['rank']}'s tokens differ from rank "
                 f"0's")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    phase_s = time.perf_counter() - t_phase
    log(f"[mesh] (2, 2) on one card: tokens equal phase 3's"
        + (f" except near ties {ties}" if ties else "")
        + f" on every rank; logits worst {worst:.3g} of scale (rtol "
        f"{LOGIT_RTOL}); rank 0 {ranks[0]['tokens_per_s']:.2f} tok/s, "
        f"decode step p50 {ranks[0]['decode_p50_ms']:.2f} ms, "
        f"{ranks[0]['all_reduce_per_decode_step']} all-reduces a decode "
        f"step; launches summed over ranks {launches}; phase 12 took "
        f"{phase_s:.1f} s (four ranks share the card: no scaling measured)")
    for r in ranks:
        r.pop("trace", None)
    return {"ranks": ranks, "launches": launches, "logit_rel_err": worst,
            "near_ties": ties, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 13: the fleet, three replicas on the card, one kill
# ---------------------------------------------------------------------------

def phase_fleet(torch, dev, held) -> dict:
    """Phase 13: a ``SolFleet`` of 3 replicas of phase 3's model (its
    weights, full width and depth) on the card serves phase 3's requests
    twice over, sampled with seeds, with one kill after two ticks, then an
    undisturbed one-replica fleet serves them again (``kill_replay``).
    Every request completes (zero drops), ``kills == 1`` and
    ``respawns == 1``, and the tokens equal the undisturbed fleet's.  Each
    replica of either fleet is audited as it leaves (``on_leave``): every
    kernel node of every bucket it compiled was held by phase 2, and every
    served kind elected a ``cuda.*`` impl.  The serve kernels' launches
    are counted over both fleets' runs."""
    from repro_torch.launch.fleet import kill_replay
    from repro_torch.launch.serve import SamplingParams

    t_phase = time.perf_counter()
    model, cfg = serve_model(torch, dev)
    prompts = _workload(cfg.vocab) * 2
    workload = [(p, GEN, SamplingParams(temperature=0.8, seed=1000 + i))
                for i, p in enumerate(prompts)]
    audited = {}

    def audit(rep):
        server = rep.server
        name = f"fleet {len(audited)} (replica {rep.id})"
        for key, sol in sorted(server._models.items()):
            check_held(sol, f"{name} bucket {key}", held, "float32")
        for key, rec in sorted(server.served_elections.items()):
            for kind in CUDA_KINDS:
                for impl in rec["by_op"].get(kind, {}):
                    if not impl.startswith("cuda."):
                        fail(f"{name} bucket {key}: {kind} elected {impl}")
        audited[name] = sorted(server._models)

    counters = serve_counters()
    for c in counters.values():
        c.launches = 0
    n = FLEET_REPLICAS
    s = kill_replay(cfg, model, workload, replicas=n, kill_at_tick=2,
                    device=dev, on_leave=audit)
    launches = {name: c.launches for name, c in counters.items()}
    if s["dropped"]:
        fail(f"fleet: requests {s['dropped']} dropped after the kill")
    if s["kills"] != 1 or s["respawns"] != 1:
        fail(f"fleet: kills {s['kills']}, respawns {s['respawns']}, not 1 "
             f"and 1")
    if s["diverged"]:
        fail(f"fleet: tokens of requests {s['diverged']} differ from the "
             f"undisturbed fleet's")
    # the drilled fleet's replicas and its respawn, then the baseline's one
    if len(audited) != n + 2:
        fail(f"fleet: {len(audited)} replicas audited, not {n + 2}")
    check_matmul_kernels("fleet", launches)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"fleet: {name} was not launched")
    buckets = sorted({tuple(k) for keys in audited.values() for k in keys})
    phase_s = time.perf_counter() - t_phase
    rec = {"replicas": n, "requests": len(workload), "killed": s["killed"],
           "requeued": s["requeued"], "kills": s["kills"],
           "respawns": s["respawns"], "recovery_s": s["recovery_s"]["max"],
           "tokens_per_s": s["tokens_per_s"], "ticks": s["ticks"],
           "served_by": s["served_by"], "audited": audited,
           "launches": launches, "phase_s": phase_s}
    log(f"[fleet] {n} replicas of the {cfg.n_layers}-block model: "
        f"{len(workload)} "
        f"requests, {s['tokens']} tokens in {s['ticks']} ticks "
        f"({s['tokens_per_s']:.2f} tok/s); killed replica {s['killed']} at "
        f"tick 2, {s['requeued']} requests re-queued, 0 dropped, respawns "
        f"{s['respawns']}, recovery {1e3 * s['recovery_s']['max']:.1f} ms; "
        f"tokens identical to an undisturbed one-replica fleet's; "
        f"{len(audited)} replicas audited over buckets {buckets}, every "
        f"node held by phase 2 and on cuda.*; launches over both fleets "
        f"{launches}; phase 13 took {phase_s:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 14: the model-zoo backbone served through its steps
# ---------------------------------------------------------------------------

# qwen2-1.5b as published (src/repro_torch/configs/qwen2_1_5b.py,
# arXiv:2407.10671): 28 layers, d 1536, 12 heads, KV 2, hd 128, d_ff 8960,
# vocab 151936, tied embeddings, QKV bias; random weights from a generator
# seeded 0 on the card, in the config's bf16 and again in f32
BACKBONE_ARCH = "qwen2_1_5b"
BACKBONE_BATCH, BACKBONE_PROMPT, BACKBONE_GEN = 4, 128, 32
# the ten reduced configs (get_smoke) in f32: batch, prompt, decode steps;
# their caches (prompt + steps) stay shorter than the reduced window (32),
# so no local layer's cache is a ring and every decode takes the kernel
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_GEN = 2, 16, 8
# kernel route vs plain route, and decode vs forward, relative to the
# logits' scale: README's conformance rows
BACKBONE_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}
BACKBONE_KERNELS = ("flash_attention", "decode_attention", "rglru_scan",
                    "rwkv6_scan")


def backbone_runs() -> list:
    """(path, config, batch, prompt, steps) of every phase-14 run."""
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke
    qwen = get_config(BACKBONE_ARCH)
    runs = [("backbone_qwen2_bf16", qwen),
            ("backbone_qwen2", dataclasses.replace(qwen, dtype="float32"))]
    runs = [(p, c, BACKBONE_BATCH, BACKBONE_PROMPT, BACKBONE_GEN)
            for p, c in runs]
    return runs + [("backbone_smoke", get_smoke(a), SMOKE_BATCH,
                    SMOKE_PROMPT, SMOKE_GEN) for a in ARCH_IDS]


def _prefill_len(cfg, prompt: int) -> int:
    return prompt + (cfg.n_patches if cfg.frontend == "vision" else 0)


def backbone_plan(cfg, b: int, prompt: int, steps: int, *,
                  forward: bool = False) -> dict:
    """(kernel key, dtype) -> launches of one kernel-route serve (a
    prefill that fills the cache, the encoder once more for the decode,
    ``steps`` decode steps), or with ``forward`` of its checking forward
    over the prompt and the fed tokens, as ``layers.attention_route``
    predicts them; the scans run in f32 in every dtype."""
    from repro_torch.models import backbone as B
    from repro_torch.models import layers as L
    plan: dict = {}

    def add(key, dt, n=1):
        plan[(key, dt)] = plan.get((key, dt), 0) + n

    dt, s = cfg.dtype, _prefill_len(cfg, prompt)
    seq = s + steps if forward else s
    heads = (cfg.n_heads, cfg.n_kv, cfg.hd)
    for kind in B.layer_kinds(cfg):
        window = cfg.window if kind == "local" else 0
        if kind == "rglru":
            add(("rglru_scan", b, seq, cfg.drnn), "float32")
        elif kind == "rwkv":
            h = cfg.d_model // cfg.rwkv_head_dim
            add(("rwkv6_scan", b, seq, h, cfg.rwkv_head_dim), "float32")
        elif L.attention_route(cfg, kind, "prefill", dt) == "kernel":
            add(("flash_attention", b, seq, *heads, True, window,
                 float(cfg.softcap_attn)), dt)
    if cfg.enc_dec is not None and \
            L.attention_route(cfg, "enc", "prefill", dt) == "kernel":
        add(("flash_attention", b, cfg.enc_dec.enc_seq, *heads, False, 0,
             0.0), dt, cfg.enc_dec.n_enc_layers * (1 if forward else 2))
    if forward:
        return plan
    for kind in B.layer_kinds(cfg):
        if kind not in ("attn", "local"):
            continue
        window = cfg.window if kind == "local" else 0
        rows = min(s + steps, window) if window else s + steps
        if L.attention_route(cfg, kind, "decode", dt,
                             cache_len=rows) == "kernel":
            cap = float(cfg.softcap_attn)
            add(("decode_attention", b, rows, *heads)
                + ((window, cap) if window or cap else ()), dt, steps)
    return plan


def backbone_plan_all() -> list:
    """Every (kernel key, dtype) phase 14 launches."""
    keys = set()
    for _, cfg, b, prompt, steps in backbone_runs():
        for forward in (False, True):
            keys |= set(backbone_plan(cfg, b, prompt, steps,
                                      forward=forward))
    return sorted(keys, key=repr)


@contextlib.contextmanager
def kernel_shapes(seen: dict):
    """Count each kernel launch by (kernel key, dtype) in ``seen`` while
    the block runs: the five kernel functions the public entries call are
    wrapped (each still counts its own launches).  A matmul key is
    ``node_key``'s: (M, K, N, the right operand a transposed view)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.matmul import ops as mops
    from repro_torch.kernels.rglru_scan import ops as gops
    from repro_torch.kernels.rwkv6_scan import ops as wops

    def flash_key(q, k, v, *, causal=True, window=0, cap=0.0, **_):
        b, s, h, hd = q.shape
        return ("flash_attention", b, s, h, k.shape[2], hd, bool(causal),
                int(window), float(cap))

    def decode_key(q, k, v, k_new, v_new, lens, *, window=0, cap=0.0, **_):
        b, _, h, hd = q.shape
        return (("decode_attention", b, k.shape[1], h, k.shape[2], hd)
                + ((int(window), float(cap)) if window or cap else ()))

    spied = [(fops, "flash_attention_cuda", flash_key),
             (dops, "decode_attention_cuda", decode_key),
             (gops, "rglru_scan_cuda",
              lambda a, *_, **__: ("rglru_scan", *a.shape)),
             (wops, "rwkv6_scan_cuda",
              lambda r, *_, **__: ("rwkv6_scan", *r.shape)),
             (mops, "matmul_cuda",
              lambda a, b, **__: ("matmul", *a.shape, b.shape[1],
                                  not b.is_contiguous()))]
    saved = []
    for mod, name, key_of in spied:
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _key_of=key_of, **kw):
            k = (_key_of(*a, **kw), str(a[0].dtype).replace("torch.", ""))
            seen[k] = seen.get(k, 0) + 1
            return _orig(*a, **kw)

        saved.append((mod, name, orig))
        setattr(mod, name, wrapped)
    try:
        yield seen
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


@contextlib.contextmanager
def moe_routes(routes: list):
    """Append each MoE router call's (top-k ids, gates) to ``routes``."""
    from repro_torch.models import layers as L
    orig = L.moe_routing

    def spy(p, x, moe_cfg):
        gates, topw, topi = orig(p, x, moe_cfg)
        routes.append((topi.cpu(), gates.cpu()))
        return gates, topw, topi

    L.moe_routing = spy
    try:
        yield routes
    finally:
        L.moe_routing = orig


def backbone_inputs(torch, cfg, b: int, prompt: int, seed: int) -> dict:
    """Prompt tokens and the modality stubs' embeddings, from ``seed`` on
    the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (b, prompt), generator=g,
                                   device="cuda")}
    if cfg.frontend == "vision":
        out["patches"] = 0.1 * torch.randn(b, cfg.n_patches, cfg.d_model,
                                           generator=g, device="cuda")
    if cfg.frontend == "audio":
        out["frames"] = 0.1 * torch.randn(b, cfg.enc_dec.enc_seq,
                                          cfg.d_model, generator=g,
                                          device="cuda")
    return out


def backbone_serve(torch, cfg, params, batch: dict, steps: int,
                   plain: bool, max_seq: int = 0) -> dict:
    """A prefill that fills a fresh cache, then ``steps`` greedy decode
    steps, through ``make_prefill_step`` / ``make_decode_step`` on
    ``make_debug_mesh(1, 1)`` with no device given (the card).  Returns
    the tokens (B, steps + 1), the logits each token was taken from, the
    prefill's and each step's wall ms (synchronized).  The cache holds
    ``max_seq`` rows (default: the prefill and the steps)."""
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import backbone as B

    mesh = make_debug_mesh(1, 1)
    if mesh.device.type != "cuda":
        fail(f"make_debug_mesh(1, 1) resolved {mesh.device}, not the card")
    prefill = make_prefill_step(mesh, cfg, plain=plain)
    decode = make_decode_step(mesh, cfg, plain=plain)
    b = batch["tokens"].shape[0]
    s = _prefill_len(cfg, batch["tokens"].shape[1])
    cache = B.init_cache(cfg, b, max_seq or s + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    row = logits[:, -1]
    tok = row.argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    enc_out = None
    if cfg.enc_dec is not None:
        with torch.inference_mode():
            enc_out = B.run_encoder(cfg, params, batch["frames"],
                                    plain=plain)
    rows, toks, step_ms = [row], [tok], []
    for j in range(steps):
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, tok[:, None], s + j, enc_out)
        row = lg[:, 0]
        tok = row.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        rows.append(row)
        toks.append(tok)
    return {"tokens": torch.stack(toks, 1).cpu(),
            "logits": torch.stack(rows, 1).float().cpu(),
            "prefill_ms": prefill_ms, "step_ms": step_ms}


def _as_requests(run: dict) -> list:
    """compare_tokens' layout: per sequence (tokens, logits rows)."""
    return [(run["tokens"][i].tolist(), run["logits"][i].numpy())
            for i in range(run["tokens"].shape[0])]


def backbone_agreement(name: str, got: dict, ref: dict, rtol: float):
    """Greedy tokens equal (near ties reported); logits within ``rtol`` of
    the reference's scale at every step up to a sequence's first
    differing token.  Returns (worst relative error, near ties)."""
    worst = 0.0
    for i in range(got["tokens"].shape[0]):
        for j in range(got["tokens"].shape[1]):
            g, r = got["logits"][i, j], ref["logits"][i, j]
            scale = float(r.abs().max())
            err = float((g - r).abs().max())
            worst = max(worst, err / scale)
            if err > rtol * scale:
                fail(f"{name}: sequence {i} step {j}: logits differ by "
                     f"{err:.3g} (scale {scale:.3g}, rtol {rtol})")
            if got["tokens"][i, j] != ref["tokens"][i, j]:
                break
    ties = compare_tokens(name, _as_requests(got), _as_requests(ref),
                          lambda row: rtol * float(abs(row).max()))
    return worst, ties


def decode_vs_forward(torch, name: str, cfg, params, batch: dict,
                      run: dict, rtol: float) -> float:
    """Decode step t's logits against one kernel-route forward over the
    prompt and the tokens fed to steps 0..t-1 (causal: its row at the
    step's position).  Returns the worst relative error."""
    from repro_torch.models import backbone as B
    steps = run["tokens"].shape[1] - 1
    fed = run["tokens"][:, :steps].to("cuda")
    full = dict(batch, tokens=torch.cat([batch["tokens"], fed], 1))
    with torch.inference_mode():
        logits, _ = B.forward(cfg, params, full)
    s = _prefill_len(cfg, batch["tokens"].shape[1])
    want = logits[:, s - 1:].float().cpu()
    worst = 0.0
    for j in range(steps + 1):
        err = float((run["logits"][:, j] - want[:, j]).abs().max())
        scale = float(want[:, j].abs().max())
        worst = max(worst, err / scale)
        if err > rtol * scale:
            fail(f"{name}: decode step {j} differs from the forward by "
                 f"{err:.3g} (scale {scale:.3g}, rtol {rtol})")
    return worst


def compare_routes(name: str, got: list, ref: list, upto: int) -> list:
    """The MoE routers' top-k ids of two runs, call by call over their
    first ``upto`` calls: equal, or the reference's gates at a differing
    token hold a near tie (k-th and next gate within 1e-5).  Returns the
    near ties."""
    ties = []
    for c, ((gi, _), (ri, rg)) in enumerate(zip(got[:upto], ref[:upto])):
        if torch_equal(gi, ri):
            continue
        k = ri.shape[-1]
        diff = (gi != ri).any(-1)
        top = rg.sort(-1, descending=True).values[..., k - 1:k + 1]
        gap = float((top[..., 0] - top[..., 1])[diff].min())
        if gap >= 1e-5:
            fail(f"{name}: MoE call {c} routes differently on the two "
                 f"routes (top-k gap {gap:.3g})")
        ties.append({"call": c, "gap": gap})
    return ties


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def phase_backbone(torch, counters: dict, held: set) -> dict:
    """Phase 14: the backbone served through ``make_prefill_step`` and
    ``make_decode_step`` on the one-process mesh's default device (the
    card): qwen2-1.5b at full width in bf16 and f32 (batch 4, a 128-token
    prompt, 32 greedy decode steps), then each of the ten reduced configs
    in f32 (batch 2, 16 tokens, 8 steps).  Each run is served on the
    kernel route (counts from 0 just before, read just after) and again
    with ``plain=True``.  Gates: tokens equal (near ties reported),
    logits within ``BACKBONE_RTOL`` of the scale, each decode step equal
    to a forward over its prefix, the MoE routers routing alike, every
    launch's (kernel, shape, dtype) held by phase 2 and the launches
    equal, key for key, to ``backbone_plan`` (``attention_route``'s
    prediction)."""
    import statistics

    from repro_torch.models import backbone as B

    t_phase = time.perf_counter()
    rec: dict = {"runs": {}, "launches": {}}
    for path, cfg, b, prompt, steps in backbone_runs():
        t_run = time.perf_counter()
        gen = torch.Generator("cuda").manual_seed(0)
        params = B.init_params(cfg, gen)
        batch = backbone_inputs(torch, cfg, b, prompt, seed=7)
        rtol = BACKBONE_RTOL[cfg.dtype]
        if path != "backbone_smoke":      # cuBLAS handles and heuristics, library loads
            backbone_serve(torch, cfg, params, batch, 2, plain=False,
                           max_seq=_prefill_len(cfg, prompt) + steps)
        seen, routes, ref_routes = {}, [], []
        for c in counters.values():
            c.launches = 0
        with kernel_shapes(seen), moe_routes(routes):
            got = backbone_serve(torch, cfg, params, batch, steps,
                                 plain=False)
        launches = {k: c.launches for k, c in counters.items()}
        with moe_routes(ref_routes):
            ref = backbone_serve(torch, cfg, params, batch, steps,
                                 plain=True)
        plan = backbone_plan(cfg, b, prompt, steps)
        if seen != plan:
            fail(f"{path} {cfg.name}: launches {sorted(seen.items())} are "
                 f"not attention_route's {sorted(plan.items())}")
        missing = [k for k in seen if k not in held]
        if missing:
            fail(f"{path} {cfg.name}: phase 2 held no row at {missing}")
        worst, ties = backbone_agreement(f"{cfg.name} {cfg.dtype} kernel vs "
                                         f"plain route", got, ref, rtol)
        # the steps before a sequence's first differing token see the
        # same inputs on both routes
        same = next((j for j in range(got["tokens"].shape[1])
                     if not torch_equal(got["tokens"][:, j],
                                        ref["tokens"][:, j])),
                    got["tokens"].shape[1])
        n_moe = sum(B._is_moe_layer(cfg, i, k)
                    for i, k in enumerate(B.layer_kinds(cfg)))
        route_ties = compare_routes(f"{cfg.name}", routes, ref_routes,
                                    n_moe * (same + 1))
        if n_moe and len(routes) != n_moe * (steps + 1):
            fail(f"{cfg.name}: {len(routes)} MoE router calls, not "
                 f"{n_moe * (steps + 1)}")
        fwd_seen: dict = {}
        with kernel_shapes(fwd_seen):
            dvf = decode_vs_forward(torch, f"{cfg.name} {cfg.dtype}", cfg,
                                    params, batch, got, rtol)
        fwd_plan = backbone_plan(cfg, b, prompt, steps, forward=True)
        if fwd_seen != fwd_plan:
            fail(f"{cfg.name}: the checking forward launched "
                 f"{sorted(fwd_seen.items())}, not attention_route's "
                 f"{sorted(fwd_plan.items())}")
        missing = [k for k in fwd_seen if k not in held]
        if missing:
            fail(f"{cfg.name}: phase 2 held no row at {missing}")
        for name in BACKBONE_KERNELS:
            want = sum(n for (key, _), n in plan.items() if key[0] == name)
            if launches[name] != want:
                fail(f"{cfg.name}: {name} launched {launches[name]} times, "
                     f"attention_route predicts {want}")
        p50 = statistics.median(got["step_ms"])
        decode_s = 1e-3 * sum(got["step_ms"])
        r = {"config": cfg.name, "dtype": cfg.dtype, "batch": b,
             "prompt": prompt, "steps": steps, "launches": launches,
             "shapes": {repr(k): n for k, n in sorted(seen.items(),
                                                      key=repr)},
             "logit_rel_err": worst, "near_ties": ties,
             "route_near_ties": route_ties, "moe_calls": len(routes),
             "decode_vs_forward_rel_err": dvf,
             "prefill_ms": got["prefill_ms"], "decode_p50_ms": p50,
             "decode_tokens_per_s": b * steps / decode_s,
             "tokens_per_s": b * (steps + 1)
             / (decode_s + 1e-3 * got["prefill_ms"]),
             "plain_prefill_ms": ref["prefill_ms"],
             "plain_decode_p50_ms": statistics.median(ref["step_ms"]),
             "seconds": time.perf_counter() - t_run}
        rec["runs"][f"{path}/{cfg.name}"] = r
        total = rec["launches"].setdefault(path, {})
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        log(f"[backbone] {cfg.name} {cfg.dtype} ({cfg.n_layers} layers, d "
            f"{cfg.d_model}) B{b} prompt {prompt} + {steps} steps: prefill "
            f"{r['prefill_ms']:.2f} ms, decode step p50 {p50:.2f} ms, "
            f"{r['decode_tokens_per_s']:.2f} decode tok/s, "
            f"{r['tokens_per_s']:.2f} tok/s with the prefill (plain route: "
            f"prefill {r['plain_prefill_ms']:.2f} ms, step p50 "
            f"{r['plain_decode_p50_ms']:.2f} ms); launches {launches} = "
            f"attention_route's; kernel vs plain logits {worst:.3g} of the "
            f"scale, decode vs forward {dvf:.3g} (rtol {rtol}); tokens "
            f"equal" + (f" except near ties {ties}" if ties else "")
            + (f"; {len(routes)} MoE router calls alike"
               + (f" except near ties {route_ties}" if route_ties else "")
               if n_moe else "") + f"; {r['seconds']:.1f} s")
        del params, got, ref
        gc.collect()
        torch.cuda.empty_cache()
    smoke = rec["launches"].get("backbone_smoke", {})
    for name in ("rglru_scan", "rwkv6_scan"):
        if smoke.get(name, 0) <= 0:
            fail(f"backbone_smoke: {name} was not launched")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[backbone] phase 14 took {rec['phase_s']:.1f} s; "
        f"{nvidia_smi()}")
    return rec


# ---------------------------------------------------------------------------
# phase 15: the model-zoo backbone trained through its train step
# ---------------------------------------------------------------------------

# qwen2-1.5b as published (phase 14's config) at the JAX driver's defaults
# (repro.launch.train: batch 8, seq 128, remat, ZeRO specs, lr 3e-3, a
# warm-up of steps // 10), batches from SyntheticTokenDataset(seed=0)
BB_TRAIN_BATCH, BB_TRAIN_SEQ, BB_TRAIN_LR = 8, 128, 3e-3
BB_TRAIN_STEPS = {"float32": 6, "bfloat16": 3}
# the ten reduced configs in f32: batch 2, 2 steps with no warm-up (the
# first update moves the weights, so step 1's loss reads the backward);
# seq 64 puts the reduced window (32) to work on the local layers, and
# its 128 tokens fill whole MoE groups (64)
SMOKE_TRAIN_BATCH, SMOKE_TRAIN_SEQ, SMOKE_TRAIN_STEPS = 2, 64, 2
# kernel route vs plain route.  Step 0: the loss (f32 sums over the same
# values in another order: ~1e-7) and each gradient leaf's largest
# element error against the leaf's norm (the kernels' f32 rounding
# carried through the backward: qwen2-1.5b read 9.18e-07, the flash
# backward without D 2.89).  Later steps: AdamW divides by √v, so where a
# gradient element is near zero a rounding difference can flip the sign
# of a whole lr-sized update; bf16 at README's bf16 row.
BB_TRAIN_LOSS0_RTOL = 1e-5
BB_TRAIN_GRAD_TOL = 1e-5
BB_TRAIN_LOSS_RTOL = {"float32": 1e-3, "bfloat16": 3e-2}
BB_TRAIN_RESUME_RTOL = 1e-5
BB_TRAIN_KERNELS = ("flash_attention", "rglru_scan", "rwkv6_scan")


def train_runs() -> list:
    """(path, config, batch, seq, steps) of every phase-15 run."""
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke
    qwen = get_config(BACKBONE_ARCH)
    return ([("backbone_train_qwen2",
              dataclasses.replace(qwen, dtype="float32"), BB_TRAIN_BATCH,
              BB_TRAIN_SEQ, BB_TRAIN_STEPS["float32"]),
             ("backbone_train_qwen2_bf16", qwen, BB_TRAIN_BATCH, BB_TRAIN_SEQ,
              BB_TRAIN_STEPS["bfloat16"])]
            + [("backbone_train_smoke", get_smoke(a), SMOKE_TRAIN_BATCH,
                SMOKE_TRAIN_SEQ, SMOKE_TRAIN_STEPS) for a in ARCH_IDS])


def train_plan(cfg, b: int, seq: int, steps: int, *,
               remat: bool = True) -> dict:
    """(kernel key, dtype) -> launches of ``steps`` kernel-route train
    steps over ``seq`` positions (patches included), as
    ``layers.attention_route`` predicts them: a forward per layer, again
    for a layer of a macro block under remat (its recompute), and the
    RG-LRU's reverse scan in the backward; the encoder runs once; the
    scans run in f32 in every dtype."""
    from repro_torch.models import backbone as B
    from repro_torch.models import layers as L
    plan: dict = {}

    def add(key, dt, n):
        plan[(key, dt)] = plan.get((key, dt), 0) + n * steps

    n_head, n_macro, _ = B.macro_split(cfg)
    macro_end = n_head + n_macro * len(cfg.layer_pattern)
    heads = (cfg.n_heads, cfg.n_kv, cfg.hd)
    for i, kind in enumerate(B.layer_kinds(cfg)):
        fwd = 2 if remat and n_head <= i < macro_end else 1
        if kind == "rglru":
            add(("rglru_scan", b, seq, cfg.drnn), "float32", fwd + 1)
        elif kind == "rwkv":
            add(("rwkv6_scan", b, seq, cfg.d_model // cfg.rwkv_head_dim,
                 cfg.rwkv_head_dim), "float32", fwd)
        elif L.attention_route(cfg, kind, "prefill", cfg.dtype) == "kernel":
            window = cfg.window if kind == "local" else 0
            add(("flash_attention", b, seq, *heads, True, window,
                 float(cfg.softcap_attn)), cfg.dtype, fwd)
    if cfg.enc_dec is not None and \
            L.attention_route(cfg, "enc", "prefill", cfg.dtype) == "kernel":
        add(("flash_attention", b, cfg.enc_dec.enc_seq, *heads, False, 0,
             0.0), cfg.dtype, cfg.enc_dec.n_enc_layers)
    return plan


def train_plan_all() -> list:
    """Every (kernel key, dtype) phase 15 launches."""
    keys = set()
    for _, cfg, b, seq, steps in train_runs():
        keys |= set(train_plan(cfg, b, seq, steps))
    return sorted(keys, key=repr)


def train_batches(torch, cfg, b: int, seq: int, steps: int) -> list:
    """``steps`` batches of ``SyntheticTokenDataset(seed=0)`` on the card,
    ``seq`` positions each (the patches first for a vision config), with
    the modality stubs' inputs from a generator seeded 7."""
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    n_tok = seq - (cfg.n_patches if cfg.frontend == "vision" else 0)
    ds = SyntheticTokenDataset(DataConfig(seed=0, vocab=cfg.vocab,
                                          seq_len=n_tok, global_batch=b))
    g = torch.Generator("cuda").manual_seed(7)
    out = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in ds.batch(step).items()}
        if cfg.frontend == "vision":
            batch["patches"] = 0.1 * torch.randn(
                b, cfg.n_patches, cfg.d_model, generator=g, device="cuda")
        if cfg.frontend == "audio":
            batch["frames"] = 0.1 * torch.randn(
                b, cfg.enc_dec.enc_seq, cfg.d_model, generator=g,
                device="cuda")
        out.append(batch)
    return out


def step0_grads(torch, cfg, params, batch, plain: bool) -> tuple:
    """(loss, {path: gradient}, fwd+bwd ms) of ``loss_fn`` with remat at
    ``params``."""
    from repro_torch.models import backbone as B
    live = B.tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, leaves = zip(*B.tree_leaves(live))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, _ = B.loss_fn(cfg, live, batch, remat=True, plain=plain)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return float(total.detach()), {p: torch.zeros_like(x) if g is None else g
                          for p, x, g in zip(paths, leaves, grads)}, ms


@contextlib.contextmanager
def planted(owner, name: str, value):
    """``owner.name`` replaced by ``value`` for the block (a planted
    fault)."""
    orig = inspect.getattr_static(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def planted_faults(torch, cfg) -> list:
    """(label, planted fault) of the backwards that ``cfg``'s kernel route
    runs: the flash backward without D = Σ dO·O (qwen2-1.5b), the RG-LRU's
    reverse scan with its coefficients unshifted (a_t where a_{t+1}
    belongs), RWKV6's backward without the bonus u's gradient, the MoE
    combine's backward reading each expert's slots one place over."""
    from repro_torch.kernels.rglru_scan import grad as RG
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rwkv6_scan import grad as RW
    from repro_torch.models import flash as FL
    from repro_torch.models import layers as L

    def rglru_unshifted(a, h0, h, ct, **_):
        af = a.float()
        g = rglru_scan(af.flip(1), ct.float().flip(1),
                       torch.zeros_like(h0, dtype=torch.float32))[0].flip(1)
        h_prev = torch.cat([h0.float()[:, None], h.float()[:, :-1]], 1)
        return g * h_prev, g, af[:, 0] * g[:, 0]

    rwkv_vjp = RW.rwkv6_scan_vjp

    def rwkv_without_du(*args, **kw):
        dr, dk, dv, dw, du, ds0 = rwkv_vjp(*args, **kw)
        return dr, dk, dv, dw, torch.zeros_like(du), ds0

    def scatter_next_slots(ctx, ct):
        (slot_tok,) = ctx.saved_tensors
        return L._gather(ct, slot_tok.roll(1, dims=-1)), None, None

    faults = {
        "qwen2-1.5b": ("the flash backward without D = Σ dO·O",
                       planted(FL, "row_dsum", lambda dog, og:
                               torch.zeros_like(dog[..., 0]))),
        "recurrentgemma-9b-smoke": (
            "the RG-LRU reverse scan with unshifted coefficients",
            planted(RG, "rglru_scan_vjp", rglru_unshifted)),
        "rwkv6-1.6b-smoke": ("the RWKV6 backward without du",
                             planted(RW, "rwkv6_scan_vjp", rwkv_without_du)),
        "olmoe-1b-7b-smoke": (
            "the MoE combine's backward on the next slots",
            planted(L._MoEScatter, "backward",
                    staticmethod(scatter_next_slots))),
    }
    return [faults[cfg.name]] if cfg.name in faults else []


def grad_gate(torch, cfg, params, batch) -> tuple:
    """Step 0 on both routes from ``params``: the kernel route's loss
    within ``BB_TRAIN_LOSS0_RTOL`` of the plain route's and each gradient
    leaf within ``BB_TRAIN_GRAD_TOL`` of its norm; each of
    ``planted_faults`` planted on the kernel route must fail that gate.
    Returns (readings, the plain route's gradients)."""
    loss_k, g_k, fb_ms = step0_grads(torch, cfg, params, batch, False)
    loss_p, g_p, fb_plain_ms = step0_grads(torch, cfg, params, batch, True)
    rel0 = abs(loss_k - loss_p) / abs(loss_p)
    if not rel0 <= BB_TRAIN_LOSS0_RTOL:
        fail(f"{cfg.name}: step-0 loss {loss_k} vs plain {loss_p} "
             f"({rel0:.3g})")
    gap, at = leaf_gap(g_k, g_p)
    if not gap <= BB_TRAIN_GRAD_TOL:
        fail(f"{cfg.name}: step-0 gradient {at} differs from the plain "
             f"route's by {gap:.3g} of its norm")
    del g_k
    r = {"step0_loss_rel_err": rel0, "step0_grad_gap": gap,
         "step0_grad_gap_at": "/".join(map(str, at or ())),
         "fwd_bwd_ms": fb_ms, "plain_fwd_bwd_ms": fb_plain_ms,
         "faults": {}}
    for label, fault in planted_faults(torch, cfg):
        with fault:
            _, g_f, _ = step0_grads(torch, cfg, params, batch, False)
        fault_gap, fault_at = leaf_gap(g_f, g_p)
        del g_f
        if fault_gap <= BB_TRAIN_GRAD_TOL:
            fail(f"{cfg.name}: {label} passed the gradient gate "
                 f"({fault_gap:.3g})")
        r["faults"][label] = {"grad_gap": fault_gap,
                              "at": "/".join(map(str, fault_at))}
    return r, g_p


def leaf_gap(got: dict, want: dict) -> tuple:
    """(worst max |Δ| / ‖want‖ over the leaves, its path)."""
    worst, at = 0.0, None
    for path, w in want.items():
        norm = float(w.float().norm())
        err = float((got[path].float() - w.float()).abs().max())
        r = err / max(norm, 1e-30)
        if r > worst:
            worst, at = r, path
    return worst, at


def train_route(torch, cfg, opts, batches, plain: bool,
                counters=None, seen=None) -> dict:
    """``make_train_step`` on ``make_debug_mesh(1, 1)`` with no device
    given (the card) from ``init_train_state`` (generator seeded 0) over
    ``batches``; with ``counters`` they are zeroed just before the steps
    and read just after, with ``seen`` every launch's key is counted.
    Returns the losses, grad norms, each step's wall ms and the
    launches."""
    from repro_torch.distributed.steps import (init_train_state,
                                               make_train_step)
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(1, 1)
    if mesh.device.type != "cuda":
        fail(f"make_debug_mesh(1, 1) resolved {mesh.device}, not the card")
    step, _ = make_train_step(mesh, cfg, opts, plain=plain)
    state = init_train_state(cfg, opts, torch.Generator("cuda").manual_seed(0))
    for c in (counters or {}).values():
        c.launches = 0
    losses, gnorms, ms = [], [], []
    with (kernel_shapes(seen) if seen is not None
          else contextlib.nullcontext()):
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            gnorms.append(float(metrics["grad_norm"]))
    launches = {k: c.launches for k, c in (counters or {}).items()}
    del state
    return {"losses": losses, "grad_norms": gnorms, "step_ms": ms,
            "launches": launches}


def check_losses(name: str, got: list, ref: list, rtol0: float,
                 rtol: float) -> list:
    """Relative loss differences, step 0 within ``rtol0``, the rest within
    ``rtol``; both routes' losses must be finite."""
    rels = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if not (math.isfinite(g) and math.isfinite(r)):
            fail(f"{name}: step {i} loss {g} (plain {r}) is not finite")
        rels.append(abs(g - r) / abs(r))
        if rels[-1] > (rtol0 if i == 0 else rtol):
            fail(f"{name}: step {i} loss {g} differs from the plain "
                 f"route's {r} by {rels[-1]:.3g} relative")
    return rels


def train_driver(torch) -> dict:
    """``launch.train.run`` in-process on the card: recurrentgemma's
    reduced config for 6 steps with a checkpoint every 2, the same run
    again (resumes at step 6, trains nothing), then with step 6's
    checkpoint removed (resumes at step 4 on the same schedule): its last
    loss against the uninterrupted run's."""
    import shutil

    from repro_torch.launch import train as T
    ckpt = OUT_DIR / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "recurrentgemma-9b", "--smoke", "--steps", "6",
            "--ckpt-interval", "2", "--log-every", "1", "--ckpt-dir",
            str(ckpt)]
    whole = T.run(argv)
    again = T.run(argv)
    shutil.rmtree(ckpt / "step_00000006")
    rest = T.run(argv)
    if (whole["start"], len(whole["losses"])) != (0, 6):
        fail(f"train CLI: the first run trained {whole}")
    if again["start"] != 6 or again["losses"]:
        fail(f"train CLI: the second run did not resume at step 6 with "
             f"nothing to train: {again}")
    if rest["start"] != 4 or len(rest["losses"]) != 2:
        fail(f"train CLI: the third run did not resume at step 4: {rest}")
    rel = abs(rest["losses"][-1] - whole["losses"][-1]) / \
        abs(whole["losses"][-1])
    if rel > BB_TRAIN_RESUME_RTOL:
        fail(f"train CLI: the resumed run ends at {rest['losses'][-1]}, "
             f"the uninterrupted one at {whole['losses'][-1]} ({rel:.3g})")
    # the checkpoint stays for phase 16, which restores it onto the mesh
    return {"resumed": rest["losses"], "whole": whole["losses"],
            "resume_rel_err": rel, "ckpt_dir": str(ckpt)}


def phase_train_backbone(torch, counters: dict, held: set) -> dict:
    """Phase 15: the backbone trained through ``make_train_step`` on the
    one-process mesh's default device (the card), each run on the kernel
    route and again with ``plain=True`` from the same state and batches.
    Every f32 run first passes ``grad_gate`` (step 0's loss and every
    gradient leaf, and its planted faults failing).  qwen2-1.5b in f32:
    six steps with the losses within ``BB_TRAIN_LOSS_RTOL`` and the last
    three's mean below the first three's; qwen2-1.5b in bf16 with f32
    moments, three steps; the ten reduced configs, two steps with no
    warm-up, so step 1's loss follows the first update; every launch's key
    held by phase 2 and the launches equal, key for key, to
    ``train_plan``; the driver ``launch.train`` resuming from its
    checkpoint."""
    import statistics

    from repro_torch.distributed.steps import StepOptions
    from repro_torch.models import backbone as B
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

    t_phase = time.perf_counter()
    rec: dict = {"runs": {}, "launches": {}}
    for path, cfg, b, seq, steps in train_runs():
        t_run = time.perf_counter()
        full = path != "backbone_train_smoke"
        # the JAX driver's warm-up for qwen2-1.5b, none for the reduced
        # configs (their two steps)
        opts = StepOptions(lr=BB_TRAIN_LR, warmup=max(steps // 10, 1)
                           if full else 0, total_steps=steps)
        batches = train_batches(torch, cfg, b, seq, steps)
        r: dict = {"config": cfg.name, "dtype": cfg.dtype, "batch": b,
                   "seq": seq, "steps": steps}
        if path == "backbone_train_qwen2":
            torch.cuda.reset_peak_memory_stats()
        if cfg.dtype == "float32":
            params = B.init_params(cfg, torch.Generator("cuda").manual_seed(0))
            if full:
                step0_grads(torch, cfg, params, batches[0], False)  # warm-up
            gate, g_p = grad_gate(torch, cfg, params, batches[0])
            r.update(gate)
        if path == "backbone_train_qwen2":
            # one AdamW update over the whole tree, timed alone
            grads = B.tree_map_with_path(lambda path, _: g_p[path], params)
            ocfg = AdamWConfig(lr=BB_TRAIN_LR)
            opt = init_opt_state(params, ocfg)
            lr = torch.tensor(BB_TRAIN_LR, device="cuda")
            adamw_update(params, grads, opt, ocfg, lr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            adamw_update(params, grads, opt, ocfg, lr)
            torch.cuda.synchronize()
            r["adamw_ms"] = 1e3 * (time.perf_counter() - t0)
            del grads, opt
        if cfg.dtype == "float32":
            del params, g_p
            gc.collect()
            torch.cuda.empty_cache()
        seen: dict = {}
        got = train_route(torch, cfg, opts, batches, False, counters, seen)
        ref = train_route(torch, cfg, opts, batches, True)
        launches = got["launches"]
        plan = train_plan(cfg, b, seq, steps)
        if seen != plan:
            fail(f"{path} {cfg.name}: launches {sorted(seen.items())} are "
                 f"not attention_route's {sorted(plan.items())}")
        missing = [k for k in seen if k not in held]
        if missing:
            fail(f"{path} {cfg.name}: phase 2 held no row at {missing}")
        for name in BB_TRAIN_KERNELS:
            want = sum(n for (key, _), n in plan.items() if key[0] == name)
            if launches[name] != want:
                fail(f"{cfg.name}: {name} launched {launches[name]} times, "
                     f"the plan says {want}")
        rels = check_losses(f"{path} {cfg.name}", got["losses"],
                            ref["losses"], BB_TRAIN_LOSS0_RTOL
                            if cfg.dtype == "float32"
                            else BB_TRAIN_LOSS_RTOL["bfloat16"],
                            BB_TRAIN_LOSS_RTOL[cfg.dtype])
        if path == "backbone_train_qwen2":
            for name, run in (("kernel", got), ("plain", ref)):
                ls = run["losses"]
                if not statistics.mean(ls[-3:]) < statistics.mean(ls[:3]):
                    fail(f"{cfg.name} {name} route: the loss did not fall "
                         f"({ls})")
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        warm = got["step_ms"][1:] or got["step_ms"]
        step_ms = statistics.median(warm)
        r.update({"losses": got["losses"], "plain_losses": ref["losses"],
                  "loss_rel_err": rels, "grad_norms": got["grad_norms"],
                  "plain_grad_norms": ref["grad_norms"],
                  "step_ms": got["step_ms"],
                  "plain_step_ms": ref["step_ms"], "launches": launches,
                  "shapes": {repr(k): n for k, n in sorted(
                      seen.items(), key=repr)},
                  "tokens_per_s": b * seq / (1e-3 * step_ms),
                  "plain_tokens_per_s": b * seq / (1e-3 * statistics.median(
                      ref["step_ms"][1:] or ref["step_ms"])),
                  "seconds": time.perf_counter() - t_run})
        rec["runs"][f"{path}/{cfg.name}"] = r
        total = rec["launches"].setdefault(path, {})
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        extra = ""
        if "step0_grad_gap" in r:
            faults = "".join(f"; {label}: {f['grad_gap']:.3g} at {f['at']}"
                             for label, f in r["faults"].items())
            extra = (f"; step 0: loss {r['step0_loss_rel_err']:.3g}, "
                     f"gradients {r['step0_grad_gap']:.3g} of the norm at "
                     f"{r['step0_grad_gap_at']}{faults}")
        if path == "backbone_train_qwen2":
            extra += (f"; fwd+bwd {r['fwd_bwd_ms']:.2f} ms (plain "
                      f"{r['plain_fwd_bwd_ms']:.2f}), AdamW "
                      f"{r['adamw_ms']:.2f} ms; peak {r['peak_gb']:.2f} GB")
        log(f"[train-backbone] {cfg.name} {cfg.dtype} ({cfg.n_layers} "
            f"layers, d {cfg.d_model}) B{b} S{seq}, {steps} steps: losses "
            f"{[round(x, 5) for x in got['losses']]} (plain "
            f"{[round(x, 5) for x in ref['losses']]}, worst "
            f"{max(rels):.3g}); step {step_ms:.2f} ms, "
            f"{r['tokens_per_s']:.1f} tokens/s (plain "
            f"{r['plain_tokens_per_s']:.1f}); launches {launches} = "
            f"the plan{extra}; {r['seconds']:.1f} s")
        del got, ref, batches
        gc.collect()
        torch.cuda.empty_cache()
    smoke = rec["launches"].get("backbone_train_smoke", {})
    for name in BB_TRAIN_KERNELS:
        if smoke.get(name, 0) <= 0:
            fail(f"backbone_train_smoke: {name} was not launched")
    rec["cli"] = train_driver(torch)
    log(f"[train-backbone] launch.train: recurrentgemma smoke resumed at "
        f"step 4, last loss {rec['cli']['resumed'][-1]:.6f} vs "
        f"uninterrupted {rec['cli']['whole'][-1]:.6f} "
        f"({rec['cli']['resume_rel_err']:.3g})")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[train-backbone] phase 15 took {rec['phase_s']:.1f} s; "
        f"{nvidia_smi()}")
    return rec


# ---------------------------------------------------------------------------
# phase 16: the backbone sharded on a (data, model) mesh, four ranks on the
# one card
# ---------------------------------------------------------------------------

# qwen2-1.5b at its published widths in f32 (phase 14's config, 12 heads
# and 2 KV heads: whole heads on each model rank) cut to MB_QWEN_LAYERS of
# its 28 layers so that the script fits its time limit, batch 4 (2 rows a
# data rank), a 128-token prompt and 8 greedy decode steps, one train step
# at seq 128; the ten reduced configs at batch 4, seq 64 (patches
# included), 4 decode steps, one train step
MB_BATCH = 4
MB_QWEN = (128, 8)
MB_QWEN_LAYERS = 8
MB_SMOKE = (64, 4)
MB_KERNELS = ("flash_attention", "decode_attention", "rglru_scan",
              "rwkv6_scan")
MB_TIMEOUT_S = 600
# the prefill's logits held whole at its last positions
MB_PREFILL_ROWS = 8


def mesh_backbone_runs() -> list:
    """(config, prompt, decode steps, train seq) of every phase-16 run."""
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke
    qwen = dataclasses.replace(get_config(BACKBONE_ARCH), dtype="float32",
                               n_layers=MB_QWEN_LAYERS)
    return ([(qwen, *MB_QWEN, MB_QWEN[0])]
            + [(get_smoke(a), *MB_SMOKE, MB_SMOKE[0]) for a in ARCH_IDS])


def _cpu_tree(tree):
    from repro_torch.models import backbone as B
    return B.tree_map(lambda x: x.detach().cpu(), tree)


def shard_mean_grads(torch, cfg, params, batch) -> tuple:
    """The one-process kernel route's step-0 loss and gradients, each the
    mean over the two halves of ``batch`` (the data shards' rows, the
    mean the mesh's train step takes), and the gradients' global norm
    (summed in f64)."""
    losses, total = [], None
    for d in range(2):
        half = {k: v[d * MB_BATCH // 2:(d + 1) * MB_BATCH // 2]
                for k, v in batch.items()}
        loss, grads, _ = step0_grads(torch, cfg, params, half, False)
        losses.append(loss)
        total = grads if total is None else {
            k: total[k] + g for k, g in grads.items()}
        del grads
    grads = {k: g / 2 for k, g in total.items()}
    norm = math.sqrt(sum(float(torch.sum(torch.square(g.double())))
                         for g in grads.values()))
    return sum(losses) / 2, grads, norm


@contextlib.contextmanager
def zero_step_split(torch, split: dict):
    """The parts of a ZeRO train step timed into ``split`` (ms, each
    between two ``cuda.synchronize``): the data-mean all-reduces of the
    gradients and the loss (``steps._data_mean``, host copies included),
    the whole ZeRO update (``steps._zero_update``), and inside it AdamW
    on the blocks (``adamw_update``) and the flat all-gather of the new
    blocks (``_flat_collective``, to the host)."""
    from repro_torch.distributed import steps as ST

    def timed(key, fn, when=lambda *a: True):
        def run(*args, **kw):
            if not when(*args):
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + 1e3 * (time.perf_counter()
                                                      - t0)
            return out
        return run

    with planted(ST, "_data_mean", timed("data_mean_all_reduce_ms",
                                         ST._data_mean)), \
            planted(ST, "_zero_update", timed("zero_update_ms",
                                              ST._zero_update)), \
            planted(ST, "adamw_update", timed("adamw_blocks_ms",
                                              ST.adamw_update)), \
            planted(ST, "_flat_collective", timed(
                "all_gather_ms", ST._flat_collective,
                lambda mesh, tensors, op, axes: op == "all_gather")):
        yield


def reversed_gather(fn):
    """``steps._flat_collective`` with the all-gathered blocks joined in
    reverse rank order (a planted fault of the ZeRO update)."""
    def run(mesh, tensors, op, axes):
        out = fn(mesh, tensors, op, axes)
        return [t.flip(0) for t in out] if op == "all_gather" else out
    return run


def mesh_backbone_rank(mesh, cases, ckpt_dir, plant) -> dict:
    """One rank of phase 16 (run by ``run_on_mesh``): each run's weights
    drawn on the card from phase 14's seed and cut to this rank's blocks
    (``jit_serve_steps``' specs).  First the gates' own passes: the
    step-0 gradients' blocks (``make_grad_step``) held to the one-process
    reference the parent saved, and from them the new parameters' blocks
    a plain AdamW step (``adamw_update`` leaf by leaf, clipped by the
    parent's global norm) gives.  Then the kernels' counts are zeroed,
    this rank's rows of the batch served (prefill into a sharded cache,
    greedy decode steps) and trained (one ``make_train_step`` step with
    ZeRO, its parts timed), and the counts read; the step's new parameter
    blocks are held to those AdamW blocks.  ``plant``: (label, run index,
    "layers" or "steps", attribute) of the planted faults, each run again
    with that function of ``models.layers`` the identity or that
    collective of ``distributed.steps`` joining its blocks in reverse.
    Then phase 15's trainer checkpoint restored onto this rank's blocks."""
    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.distributed import ctx
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
    from repro_torch.models import backbone as B
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda,
                "rglru_scan": rglru_scan_cuda, "rwkv6_scan": rwkv6_scan_cuda}
    dev = mesh.device
    rows = S.NamedSharding(mesh, S.P("data"))

    def cut(batch):
        return {k: rows.shard(v).to(dev) for k, v in batch.items()}

    def serve(cfg, params, batch, gen, cspecs):
        decode = ST.make_decode_step(mesh, cfg, cache_specs=cspecs)
        prefill = ST.make_prefill_step(mesh, cfg, cache_specs=cspecs)
        b = batch["tokens"].shape[0]
        s = _prefill_len(cfg, batch["tokens"].shape[1])
        cache = S.shard_tree(mesh, B.init_cache(cfg, MB_BATCH, s + gen),
                             cspecs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cache)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        enc_out = None
        if cfg.enc_dec is not None:
            with torch.inference_mode(), ctx.use_mesh(mesh):
                enc_out = B.run_encoder(cfg, params, batch["frames"])
        out_rows, toks, step_ms, reduces = [logits[:, -1]], [tok], [], []
        for j in range(gen):
            calls = mesh.calls["all_reduce"]
            t0 = time.perf_counter()
            lg, cache = decode(params, cache, tok[:, None], s + j, enc_out)
            tok = lg[:, 0].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            reduces.append(mesh.calls["all_reduce"] - calls)
            out_rows.append(lg[:, 0])
            toks.append(tok)
        return {"tokens": torch.stack(toks, 1).cpu(),
                "logits": torch.stack(out_rows, 1).float().cpu(),
                "prefill_logits": logits[:, -MB_PREFILL_ROWS:].float().cpu(),
                "prefill_ms": prefill_ms, "step_ms": step_ms,
                "all_reduce_per_step": reduces, "batch": b}

    def worst_leaf(pairs):
        """The largest (max |got - want| / ‖want‖, path) over the pairs; a
        non-finite value is infinitely far."""
        worst, at = 0.0, None
        for path, got, want in pairs:
            err = float((got.float() - want.float()).abs().max())
            r = err / max(float(want.float().norm()), 1e-30)
            if not math.isfinite(r):
                r = math.inf
            if r > worst or at is None:
                worst, at = r, "/".join(map(str, path))
        return worst, at

    def grad_gap(cfg, grads, ref_file):
        ref = torch.load(ref_file, mmap=True, weights_only=True)
        specs = dict(B.tree_leaves(S.param_specs(mesh, cfg,
                                                 B.param_specs(cfg)),
                                   leaf=S.P))

        def pairs():
            for path, g in B.tree_leaves(grads):
                want = ref["/".join(map(str, path))]
                block = want[S.NamedSharding(mesh, specs[path]).index(
                    want.shape)]
                yield path, g.cpu(), block
        return worst_leaf(pairs())

    def adamw_blocks(params, grads, gnorm):
        """{path: new block} (on the host) of one plain AdamW step from
        zero moments on this rank's blocks."""
        ocfg = AdamWConfig(lr=BB_TRAIN_LR)
        lr = cosine_schedule(torch.zeros((), dtype=torch.int32, device=dev),
                             peak_lr=BB_TRAIN_LR, warmup=0, total=1)
        norm = torch.tensor(gnorm, dtype=torch.float32, device=dev)
        out = {}
        for (path, p), (_, g) in zip(B.tree_leaves(params),
                                     B.tree_leaves(grads)):
            z = torch.zeros(p.shape, dtype=torch.float32, device=dev)
            new, _, _ = adamw_update(
                {"w": p}, {"w": g}, {"m": {"w": z}, "v": {"w": z},
                                     "step": torch.zeros(
                                         (), dtype=torch.int32,
                                         device=dev)}, ocfg, lr, gnorm=norm)
            out[path] = new["w"].cpu()
        return out

    def param_gap(new_params, want):
        return worst_leaf((path, p, want[path].to(dev))
                          for path, p in B.tree_leaves(new_params))

    def fresh_state(cfg, params, specs):
        zeros = {k: B.tree_map(
            lambda leaf, spec: torch.zeros(
                S.local_shape(mesh, tuple(leaf.shape), spec), device=dev),
            B.param_specs(cfg), specs["opt"][k]) for k in ("m", "v")}
        return {"params": params, "opt": {**zeros, "step": torch.zeros(
            (), dtype=torch.int32, device=dev)},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def fault(owner: str, name: str):
        if owner == "steps":
            return ST, name, reversed_gather(getattr(ST, name))
        return L, name, (lambda y: y)

    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "runs": [],
           "faults": {}}
    total = {k: 0 for k in counters}
    for i, case in enumerate(cases):
        t_run = time.perf_counter()
        cfg, gen = case["cfg"], case["gen"]
        opts = ST.StepOptions(lr=BB_TRAIN_LR, warmup=0, total_steps=1)
        step, specs = ST.make_train_step(mesh, cfg, opts)
        _, pspecs, cspecs = ST.jit_serve_steps(
            mesh, cfg, MB_BATCH, _prefill_len(cfg, case["prompt"]) + gen)
        full = B.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        params = S.shard_tree(mesh, full, pspecs)
        del full
        torch.cuda.empty_cache()
        batch, tbatch = cut(case["batch"]), cut(case["train_batch"])
        # the gates' own passes, outside the counted window
        _, _, grads = ST.make_grad_step(mesh, cfg, opts)(params, tbatch)
        gap, at = grad_gap(cfg, grads, case["grads_file"])
        want = adamw_blocks(params, grads, case["grad_norm"])
        del grads
        torch.cuda.empty_cache()
        state = fresh_state(cfg, params, specs)
        for c in counters.values():
            c.launches = 0
        served = serve(cfg, params, batch, gen, cspecs)
        split: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with zero_step_split(torch, split):
            new, metrics = step(state, tbatch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: c.launches for k, c in counters.items()}
        for k, n in launches.items():
            total[k] += n
        pgap, pat = param_gap(new["params"], want)
        print(f"[mesh-backbone] {cfg.name}: served (prefill "
              f"{served['prefill_ms']:.1f} ms), gradients {gap:.3g} and new "
              f"parameters {pgap:.3g} of the norm, train step "
              f"{step_ms:.1f} ms {split}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"{time.perf_counter() - t_run:.1f} s", flush=True)
        del new, state
        rec = {"config": cfg.name, "train_loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "grad_gap": gap,
               "grad_gap_at": at, "param_gap": pgap, "param_gap_at": pat,
               "train_step_ms": step_ms, "step_split_ms": split,
               "launches": launches, **served,
               "seconds": time.perf_counter() - t_run}
        for label, run, owner, name, _ in plant:
            if run != i:
                continue
            with planted(*fault(owner, name)):
                faulty = serve(cfg, params, batch, 0, cspecs)
                _, _, fg = ST.make_grad_step(mesh, cfg, opts)(params,
                                                               tbatch)
                fgap = grad_gap(cfg, fg, case["grads_file"])
                del fg
                fnew, _ = step(fresh_state(cfg, params, specs), tbatch)
            out["faults"][label] = {
                "config": cfg.name,
                "prefill_logits": faulty["prefill_logits"],
                "grad_gap": fgap,
                "param_gap": param_gap(fnew["params"], want)}
            del fnew
        out["runs"].append(rec)
        del params, want
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
    out["launches"] = total
    # phase 15's trainer checkpoint onto this rank's blocks
    from repro_torch.configs import get_smoke
    cfg = get_smoke("recurrentgemma-9b")
    opts = ST.StepOptions()
    shapes = ST.train_state_shapes(cfg, opts)
    specs = ST.make_train_state_specs(mesh, cfg, opts)
    local = restore_checkpoint(ckpt_dir, shapes,
                               shardings=S.named(mesh, specs))
    whole = restore_checkpoint(ckpt_dir, B.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype), shapes))
    wants = dict(B.tree_leaves(whole))
    sp = dict(B.tree_leaves(specs, leaf=S.P))
    same = all(torch.equal(leaf.cpu(), S.NamedSharding(mesh, sp[path])
                           .shard(wants[path]))
               for path, leaf in B.tree_leaves(local))
    out["restore"] = {"leaves": len(wants), "equal": same,
                      "device": str(next(iter(B.tree_leaves(local)))[1]
                                    .device)}
    return out


def phase_mesh_backbone(torch, ckpt_dir) -> dict:
    """Phase 16: the backbone's sharded steps on a (2, 2) mesh, four ranks
    on the one card (``run_on_mesh``, gloo), held to the one-process
    kernel route on the same weights (phase 14's seed), prompts and
    batches, computed here first: qwen2-1.5b at full width in f32 (8 of
    its 28 layers) and the ten reduced configs.  Gates: greedy tokens equal (near ties
    reported) and logits within ``BACKBONE_RTOL`` of the scale; one train
    step with ZeRO: its loss and gradient norm within
    ``BB_TRAIN_LOSS0_RTOL`` of the one-process step-0 values, every
    gradient block (from the gate's own pass) within ``BB_TRAIN_GRAD_TOL``
    of its leaf's norm, and every new parameter block within
    ``BB_TRAIN_GRAD_TOL`` of a plain AdamW step on the rank's blocks;
    three planted faults (the attention's row-parallel all-reduce left
    out on qwen2's reduced config, the MoE combine's on olmoe's: the
    logits and gradients gates; the ZeRO all-gather joined in reverse on
    qwen2's reduced config: the parameters gate) caught; phase 15's
    trainer checkpoint restored onto the ranks' blocks equal to its global
    arrays.  Logged: launches summed over the ranks (serve and train step
    alone), all-reduces a decode step, qwen2's train step split into its
    data-mean all-reduce, AdamW on the blocks and all-gather, the phase's
    seconds."""
    import os
    import shutil
    import statistics
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import backbone as B

    t_phase = time.perf_counter()
    build.build_all()                 # the ranks load what the parent built
    tmp = Path(tempfile.mkdtemp(prefix="sol_mesh_backbone_"))
    cases, refs = [], []
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    try:
        for i, (cfg, prompt, gen, seq) in enumerate(mesh_backbone_runs()):
            params = B.init_params(cfg,
                                   torch.Generator("cuda").manual_seed(0))
            batch = backbone_inputs(torch, cfg, MB_BATCH, prompt, seed=7)
            ref = backbone_serve(torch, cfg, params, batch, gen,
                                 plain=False)
            with torch.inference_mode():
                ref["prefill_logits"] = B.prefill(cfg, params, batch)[0][
                    :, -MB_PREFILL_ROWS:].float().cpu()
            tb = train_batches(torch, cfg, MB_BATCH, seq, 1)[0]
            loss, grads, norm = shard_mean_grads(torch, cfg, params, tb)
            path = tmp / f"grads_{i}.pt"
            torch.save({"/".join(map(str, k)): g.cpu()
                        for k, g in grads.items()}, path)
            del params, grads
            gc.collect()
            torch.cuda.empty_cache()
            ref["loss"], ref["grad_norm"] = loss, norm
            refs.append(ref)
            log(f"[mesh-backbone] {cfg.name}: one-process reference in "
                f"{time.perf_counter() - t_phase:.1f} s")
            cases.append({"cfg": cfg, "prompt": prompt, "gen": gen,
                          "batch": _cpu_tree(batch),
                          "train_batch": _cpu_tree(tb),
                          "grads_file": str(path), "grad_norm": norm})
        ref_s = time.perf_counter() - t_phase
        names = [c["cfg"].name for c in cases]
        # (label, run, owner and function of the fault: a models.layers
        # function made the identity, a distributed.steps collective
        # joining its blocks in reverse; the gates that must catch it)
        plant = [("the attention's row-parallel all-reduce left out",
                  names.index("qwen2-1.5b-smoke"), "layers", "_reduce_attn",
                  ("prefill", "gradients")),
                 ("the MoE combine's all-reduce left out",
                  names.index("olmoe-1b-7b-smoke"), "layers", "_moe_combine",
                  ("prefill", "gradients")),
                 ("the ZeRO all-gather's blocks joined in reverse",
                  names.index("qwen2-1.5b-smoke"), "steps",
                  "_flat_collective", ("parameters",))]
        t0 = time.perf_counter()
        # four ranks share the card: segments that grow in place keep
        # their freed blocks usable across shapes
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        ranks = run_on_mesh(mesh_backbone_rank, *MESH, device="cuda",
                            dist_backend="gloo", timeout_s=MB_TIMEOUT_S,
                            args=(cases, ckpt_dir, plant))
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    rec: dict = {"runs": {}, "faults": {}, "reference_s": ref_s,
                 "ranks_s": ranks_s}
    for i, (case, ref) in enumerate(zip(cases, refs)):
        cfg = case["cfg"]
        per = [r["runs"][i] for r in ranks]
        got = {}
        for key in ("tokens", "logits", "prefill_logits"):
            parts = [None, None]
            for r, run in zip(ranks, per):
                parts[r["coords"]["data"]] = run[key]
            got[key] = torch.cat(parts, 0)
        for r, run in zip(ranks, per):
            d = r["coords"]["data"]
            if not torch.equal(run["tokens"], got["tokens"][
                    d * MB_BATCH // 2:(d + 1) * MB_BATCH // 2]):
                fail(f"mesh backbone {cfg.name}: rank {r['rank']}'s tokens "
                     f"differ from its data shard's")
        rtol = BACKBONE_RTOL[cfg.dtype]
        worst, ties = backbone_agreement(
            f"mesh backbone {cfg.name} vs one process", got, ref, rtol)
        pre = float((got["prefill_logits"] - ref["prefill_logits"]).abs()
                    .max() / ref["prefill_logits"].abs().max())
        if pre > rtol:
            fail(f"mesh backbone {cfg.name}: prefill logits {pre:.3g} of "
                 f"the scale from one process's")
        loss_rel = max(abs(run["train_loss"] - ref["loss"]) / abs(ref["loss"])
                       for run in per)
        if not loss_rel <= BB_TRAIN_LOSS0_RTOL:
            fail(f"mesh backbone {cfg.name}: the train step's loss "
                 f"{per[0]['train_loss']} vs one process {ref['loss']} "
                 f"({loss_rel:.3g})")
        norm_rel = max(abs(run["grad_norm"] - ref["grad_norm"])
                       / ref["grad_norm"] for run in per)
        if not norm_rel <= BB_TRAIN_LOSS0_RTOL:
            fail(f"mesh backbone {cfg.name}: the train step's gradient "
                 f"norm {per[0]['grad_norm']} vs one process "
                 f"{ref['grad_norm']} ({norm_rel:.3g})")
        gap = max(run["grad_gap"] for run in per)
        at = max(per, key=lambda run: run["grad_gap"])["grad_gap_at"]
        if not gap <= BB_TRAIN_GRAD_TOL:
            fail(f"mesh backbone {cfg.name}: gradient {at} differs by "
                 f"{gap:.3g} of its norm from one process's")
        pgap = max(run["param_gap"] for run in per)
        pat = max(per, key=lambda run: run["param_gap"])["param_gap_at"]
        if not pgap <= BB_TRAIN_GRAD_TOL:
            fail(f"mesh backbone {cfg.name}: the train step's new parameter "
                 f"{pat} differs by {pgap:.3g} of its norm from AdamW's on "
                 f"the rank's blocks")
        r0 = per[0]
        p50 = statistics.median(r0["step_ms"]) if r0["step_ms"] else 0.0
        launches = {k: sum(run["launches"][k] for run in per)
                    for k in MB_KERNELS}
        r = {"config": cfg.name, "prefill_rel_err": pre,
             "logit_rel_err": worst, "near_ties": ties,
             "loss_rel_err": loss_rel, "grad_norm_rel_err": norm_rel,
             "grad_gap": gap, "grad_gap_at": at, "param_gap": pgap,
             "param_gap_at": pat, "train_step_split_ms": r0["step_split_ms"],
             "prefill_ms": r0["prefill_ms"], "decode_p50_ms": p50,
             "ref_decode_p50_ms": statistics.median(ref["step_ms"]),
             "train_step_ms": max(run["train_step_ms"] for run in per),
             "all_reduce_per_decode_step": r0["all_reduce_per_step"][0]
             if r0["all_reduce_per_step"] else 0,
             "launches": launches,
             "seconds": max(run["seconds"] for run in per)}
        rec["runs"][cfg.name] = r
        log(f"[mesh-backbone] {cfg.name} ({cfg.n_layers} layers, d "
            f"{cfg.d_model}) on (2, 2): prefill {pre:.3g}, decode logits "
            f"{worst:.3g} of the scale (rtol {rtol}), tokens equal"
            + (f" except near ties {ties}" if ties else "")
            + f"; train step: loss {loss_rel:.3g}, gradient norm "
            f"{norm_rel:.3g}, gradients {gap:.3g} of the norm at {at}, new "
            f"parameters {pgap:.3g} at {pat}; prefill {r['prefill_ms']:.2f} ms, decode step "
            f"p50 {p50:.2f} ms (one process {r['ref_decode_p50_ms']:.2f}),"
            f" {r['all_reduce_per_decode_step']} all-reduces a decode "
            f"step, train step {r['train_step_ms']:.2f} ms (rank 0: "
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        sorted(r0["step_split_ms"].items()))
            + "); launches "
            f"{launches}; {r['seconds']:.1f} s")
    for label, i, _, _, must in plant:
        case, ref = cases[i], refs[i]
        parts = [None, None]
        for rk in ranks:
            parts[rk["coords"]["data"]] = rk["faults"][label][
                "prefill_logits"]
        seen = {
            "prefill": float((torch.cat(parts, 0) - ref["prefill_logits"])
                             .abs().max() / ref["prefill_logits"].abs()
                             .max()),
            "gradients": max(rk["faults"][label]["grad_gap"][0]
                             for rk in ranks),
            "parameters": max(rk["faults"][label]["param_gap"][0]
                              for rk in ranks)}
        limit = {"prefill": BACKBONE_RTOL["float32"],
                 "gradients": BB_TRAIN_GRAD_TOL,
                 "parameters": BB_TRAIN_GRAD_TOL}
        passed = [g for g in must if not seen[g] > limit[g]]
        if passed:
            fail(f"mesh backbone: {label} passed the {passed} gates "
                 f"({seen})")
        rec["faults"][label] = {"config": case["cfg"].name, **seen}
        log(f"[mesh-backbone] planted: {label} on {case['cfg'].name}: "
            f"prefill {seen['prefill']:.3g}, gradients "
            f"{seen['gradients']:.3g}, new parameters "
            f"{seen['parameters']:.3g} of the norm: caught by {must}")
    for rk in ranks:
        if not rk["restore"]["equal"]:
            fail(f"mesh backbone: rank {rk['rank']} restored phase 15's "
                 f"checkpoint into blocks that differ from its arrays")
    rec["restore"] = ranks[0]["restore"]
    rec["launches"] = {k: sum(rk["launches"][k] for rk in ranks)
                       for k in MB_KERNELS}
    for name in MB_KERNELS:
        if rec["launches"][name] <= 0:
            fail(f"mesh backbone: {name} was not launched on the ranks")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh-backbone] phase 15's trainer checkpoint ({rec['restore']['leaves']}"
        f" leaves) restored onto every rank's blocks equal; launches summed "
        f"over the ranks {rec['launches']}; reference {ref_s:.1f} s, ranks "
        f"{ranks_s:.1f} s; phase 16 took {rec['phase_s']:.1f} s (four "
        f"ranks share the card: no scaling measured); {nvidia_smi()}")
    return rec

# ---------------------------------------------------------------------------
# phase 17: a sharded SOL graph trained on a (data, model) mesh, four ranks
# on the one card
# ---------------------------------------------------------------------------

# phase 10's transformer stack (4 blocks, d 1536, 12/2 heads, MLP ×4) with
# its weights and batch (phase 10's first generator, seed 300), its lr and
# steps, through optimize(..., training=True, mesh=) on (2, 2): 2 rows a
# data rank, heads 6 and KV heads 1, q 768 and k/v 128 features and an MLP
# of 3072 a model rank
MST_NAME = "transformer"
MST_SEED = 300
MST_TIMEOUT_S = 420
MST_KERNELS = ("matmul", "matmul_tc", "matmul_skinny", "flash_attention",
               "dfp_fused")
# all-reduces a block: forward after the row-parallel o and down products,
# backward where the replicated input enters the column-parallel q/k/v
# and up products
MST_REDUCES_A_BLOCK = 2


def mesh_sol_train_inputs(torch, dev):
    """Phase 10's transformer stack on ``dev``, its input and its target,
    drawn from phase 10's generator."""
    cfg = dict(TRAIN_STACKS)[MST_NAME]
    shape = TRAIN_SHAPE_BT + (cfg["d_model"],)
    gen = torch.Generator(dev).manual_seed(MST_SEED)
    model = _train_stack(torch, MST_NAME, cfg, dev, gen)
    x = torch.randn(shape, device=dev, generator=gen)
    y = torch.randn(shape, device=dev, generator=gen)
    return model, x, y


def mesh_sol_train_plan(torch) -> dict:
    """Key -> (path, node) of every kernel launch of phase 17's ranks, by
    ``node_key``: the ``cuda.*`` forwards of the per-shard training graph
    (decided by ``shard_graph`` on an abstract (2, 2) mesh, nothing
    launched) and the dx and dw products of each ``cuda.linear_bwd`` and
    ``cuda.matmul_bwd`` node, as ``kernels/matmul/grad._dx_dw`` runs them:
    dx = ct @ wᵀ (a transposed view of a (K, N) weight), dw = xᵀ @ ct or
    ctᵀ @ x in the weight's layout, each left operand copied contiguous."""
    from repro_torch.backends import for_device, get_backend
    from repro_torch.core import passes
    from repro_torch.core.ir import OpKind
    from repro_torch.distributed import sharding as shd
    from repro_torch.frontends.extract import extract

    cfg = dict(TRAIN_STACKS)[MST_NAME]
    model = _train_stack(torch, MST_NAME, cfg, "meta", None)
    shape = TRAIN_SHAPE_BT + (cfg["d_model"],)
    am = shd.AbstractMesh(MESH)
    bk = shd.mesh_backend(for_device(get_backend("h100"),
                                     torch.device("cuda")), am)
    g = passes.run_pipeline(shd.shard_graph(extract(model, shape), am), bk,
                            training=True)
    out: dict = {}
    for n in g.topo():
        if (n.impl or "").startswith("cuda."):
            out.setdefault(node_key(n), ("mesh_sol_train", n))
        if n.impl_bwd in ("cuda.linear_bwd", "cuda.matmul_bwd"):
            x, w = n.inputs[0].spec.shape, n.inputs[1].spec.shape
            m, k, nout = math.prod(x[:-1]), x[-1], n.spec.shape[-1]
            kn = n.op is OpKind.MATMUL or w[0] != n.attrs["out_features"]
            dw = (("matmul", k, m, nout, False) if kn
                  else ("matmul", nout, m, k, False))
            for key in (("matmul", m, nout, k, kn), dw):
                out.setdefault(key, ("mesh_sol_train backward", None))
    return out


@contextlib.contextmanager
def all_reduce_tally(torch, mesh, counts: dict, ms: dict, where: dict):
    """Count (``counts``) and time (``ms``, between two ``cuda.
    synchronize``) each all-reduce of ``mesh`` that crosses ranks by
    (``where["part"]``, axes) while the block runs."""
    real = mesh.all_reduce

    def counted(t, axes):
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if mesh.span(names) == 1:
            return real(t, axes)
        key = (where["part"], "+".join(a for a in mesh.axis_names
                                       if a in names))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, axes)
        torch.cuda.synchronize()
        counts[key] = counts.get(key, 0) + 1
        ms[key] = ms.get(key, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out
    mesh.all_reduce = counted
    try:
        yield
    finally:
        del mesh.all_reduce


@contextlib.contextmanager
def sol_step_parts(torch, split: dict, where: dict):
    """A mesh SOL train step's parts timed into ``split`` (ms, each between
    two ``cuda.synchronize``): the one all-reduce of the gradients and the
    loss over ``data`` (``steps._data_mean``, host copies included) and
    the update (``steps._global_norm``, whose all-reduce over ``model``
    it includes, and ``adamw_update`` on the blocks); ``where["part"]``
    names the part running, for ``all_reduce_tally``."""
    from repro_torch.distributed import steps as ST

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            where["part"], t0 = key, time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                where["part"] = "graph"
                split[key] = split.get(key, 0.0) + 1e3 * (
                    time.perf_counter() - t0)
        return run

    with planted(ST, "_data_mean", timed("data_mean", ST._data_mean)), \
            planted(ST, "_global_norm", timed("update", ST._global_norm)), \
            planted(ST, "adamw_update", timed("update", ST.adamw_update)):
        yield


def mesh_sol_train_rank(mesh, ref_file, ref, held) -> dict:
    """One rank of phase 17 (run by ``run_on_mesh``): phase 10's stack and
    batch drawn on the card, compiled for training on the mesh, this
    rank's rows cut from the batch.  The gates' own passes first: step 0's
    loss and gradients (``make_sol_grad_step``), gathered
    (``gather_sol_tree``) and held on rank 0 to the one-process reference
    in ``ref_file``, the global gradient norm, and one forward and its
    backward with their all-reduces counted and the backward's launches.
    Then the counts are zeroed, ``TRAIN_STEPS`` steps of
    ``make_sol_train_step`` run (each step's parts timed, its all-reduces
    counted, every kernel launch recorded by key) and the counts read; the
    gathered parameters are held on rank 0 to the reference.  Then three
    planted faults, each run again through the gate it must fail."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import steps as ST
    from repro_torch.frontends.optimize import optimize
    from repro_torch.kernels.dfp_fused.kernel import dfp_fused_triton
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.matmul.kernel import KERNELS, matmul_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"matmul": matmul_cuda, "matmul_tc": KERNELS["tensor_core"],
                "matmul_skinny": KERNELS["skinny"],
                "flash_attention": flash_attention_cuda,
                "dfp_fused": dfp_fused_triton}
    name = f"mesh SOL train rank {mesh.rank}"
    t_rank = time.perf_counter()
    model, x, y = mesh_sol_train_inputs(torch, mesh.device)
    sol = optimize(model, tuple(x.shape), backend="h100", training=True,
                   mesh=mesh)
    del model
    by_kind = check_train_elections(sol, MST_NAME)
    check_held(sol, name, held, "float32")
    batch = S.shard_tree(mesh, {"x": x, "y": y}, ST.sol_batch_specs(sol))
    del x, y
    params = sol._params_for_call()
    lr = TRAIN_LR[MST_NAME]
    opts = ST.StepOptions(lr=lr, warmup=1, total_steps=TRAIN_STEPS)
    want = (torch.load(ref_file, mmap=True, weights_only=True)
            if mesh.rank == 0 else None)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "elections": by_kind, "faults": {}}

    def grad_gate() -> dict:
        """Step 0's loss, the global gradient norm and (rank 0) the worst
        gathered gradient leaf's max |Δ| over its reference's norm."""
        loss, grads = ST.make_sol_grad_step(sol)(params, batch)
        norm = float(ST._global_norm(mesh, grads, sol.graph.param_specs))
        whole = ST.gather_sol_tree(sol, grads)
        del grads
        rec = {"loss": float(loss), "grad_norm": norm}
        if want is not None:
            rec["grad_gap"], rec["grad_gap_at"] = leaf_gap(
                {k: v.cpu() for k, v in whole.items()}, want["grads"])
        return rec

    def train(counts=None, ms=None, split=None):
        """``TRAIN_STEPS`` steps from the model's blocks: the losses, each
        step's ms, and on rank 0 ``train_gap`` against the reference."""
        step, init = ST.make_sol_train_step(sol, opts)
        state, losses, step_ms = init(), [], []
        where = {"part": "graph"}
        tally = (all_reduce_tally(torch, mesh, counts, ms, where)
                 if counts is not None else contextlib.nullcontext())
        parts = (sol_step_parts(torch, split, where)
                 if split is not None else contextlib.nullcontext())
        with tally, parts:
            for _ in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(float(metrics["loss"]))
        whole = ST.gather_sol_tree(sol, state["params"])
        del state
        rec = {"losses": losses, "step_ms": step_ms}
        if want is not None:
            rec["gap"] = train_gap(losses, {k: v.cpu() for k, v in
                                            whole.items()},
                                   ref["losses"], want["params"])
        return rec

    out["gate"] = grad_gate()
    # one forward and its backward: their all-reduces, the backward's
    # launches
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    counts, ms = {}, {}
    where = {"part": "forward"}
    with all_reduce_tally(torch, mesh, counts, ms, where):
        loss = ST.mse(sol._fn(live, batch["x"]), batch)
        for c in counters.values():
            c.launches = 0
        where["part"] = "backward"
        torch.autograd.grad(loss, list(live.values()))
        torch.cuda.synchronize()
    del loss, live
    out["bwd_launches"] = {k: c.launches for k, c in counters.items()}
    out["fwd_bwd_reduces"] = counts
    for kernel in BWD_KERNELS[MST_NAME]:
        if out["bwd_launches"][kernel] <= 0:
            fail(f"{name}: {kernel} did not launch during backward")

    # the main path's run: counts from 0, the steps, counts read
    for c in counters.values():
        c.launches = 0
    keys: dict = {}
    counts, ms, split = {}, {}, {}
    with kernel_shapes(keys):
        run = train(counts, ms, split)
    out["launches"] = {k: c.launches for k, c in counters.items()}
    check_matmul_kernels(name, out["launches"], ("matmul_tc",))
    missing = sorted({k for k, dt in keys if k not in held}, key=repr)
    if missing:
        fail(f"{name}: phase 2 held no float32 row at {missing}")
    out.update(train=run, keys={repr(k): n for k, n in keys.items()},
               step_reduces=counts, reduce_ms=ms, split_ms=split)
    print(f"[mesh-sol-train] losses {[round(v, 6) for v in run['losses']]},"
          f" step ms {[round(v, 1) for v in run['step_ms']]}, parts "
          f"{ {k: round(v, 1) for k, v in split.items()} }, all-reduces "
          f"{counts} in { {k: round(v, 1) for k, v in ms.items()} } ms; "
          f"{time.perf_counter() - t_rank:.1f} s", flush=True)

    # the planted faults, each through its gate
    with planted(collectives, "copy_over", lambda t, mesh_, axes: t):
        out["faults"]["copy"] = grad_gate()
    with planted(ST, "_data_mean", lambda mesh_, tree: tree):
        out["faults"]["data_mean"] = {**grad_gate(), **train()}
    with planted(collectives, "reduce_over", lambda t, mesh_, axes: t):
        out["faults"]["reduce"] = grad_gate()
    out["seconds"] = time.perf_counter() - t_rank
    return out


def phase_mesh_sol_train(torch, held, dev) -> dict:
    """Phase 17: phase 10's transformer stack trained as a sharded SOL
    graph on a (2, 2) mesh, four ranks on the one card (``run_on_mesh``,
    gloo), held to the one-process ``h100`` kernel route on the same
    weights and batch, computed here first.  Gates: step 0's loss within
    ``BB_TRAIN_LOSS0_RTOL``, every gathered gradient leaf within
    ``BB_TRAIN_GRAD_TOL`` of its norm and the global gradient norm within
    1e-5; ``TRAIN_STEPS`` AdamW steps at ``TRAIN_LR`` each within
    ``TRAIN_LOSS_RTOL`` and falling, the gathered parameters within
    ``TRAIN_PARAM_TOL``; phase 10's backward impls elected and the matmul
    launched in a backward; two model all-reduces a block in the forward
    and two in the backward, one data mean and one norm all-reduce a
    step; every launch's key held by phase 2.  Planted faults: the
    column-parallel inputs' backward all-reduce left out (the gradients
    gate), the data mean left out (gradients and parameters), the
    row-parallel forward all-reduce left out (the loss).  Logged: rank 0's
    step split into fwd+bwd (the model all-reduces within it), the data
    mean and AdamW, beside one process's step, and the phase's
    seconds."""
    import os
    import shutil
    import statistics
    import tempfile

    from repro_torch.distributed import steps as ST
    from repro_torch.frontends.optimize import optimize
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_on_mesh

    t_phase = time.perf_counter()
    build.build_all()                 # the ranks load what the parent built
    model, x, y = mesh_sol_train_inputs(torch, dev)
    sol = optimize(model, tuple(x.shape), backend="h100", training=True,
                   device=dev)
    loss0, grads = ST.make_sol_grad_step(sol)(sol._params_for_call(),
                                              {"x": x, "y": y})
    norm = math.sqrt(sum(float(torch.sum(torch.square(g.double())))
                         for g in grads.values()))
    losses, step_ms, final = train_run(torch, sol, x, y, TRAIN_STEPS,
                                       TRAIN_LR[MST_NAME])
    tmp = Path(tempfile.mkdtemp(prefix="sol_mesh_train_"))
    ref_file = tmp / "reference.pt"
    torch.save({"grads": {k: g.cpu() for k, g in grads.items()},
                "params": {k: p.cpu() for k, p in final.items()}}, ref_file)
    del model, x, y, sol, grads, final
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    ref = {"loss": float(loss0), "grad_norm": norm, "losses": losses}
    try:
        t0 = time.perf_counter()
        ranks = run_on_mesh(mesh_sol_train_rank, *MESH, device=dev.type,
                            dist_backend="gloo", timeout_s=MST_TIMEOUT_S,
                            args=(str(ref_file), ref, held))
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    blocks = TRAIN_BLOCKS[MST_NAME]

    def loss_rel(v):
        return abs(v - ref["loss"]) / abs(ref["loss"])

    # gradients, loss and norm (every rank's loss and norm: the global ones)
    gate = r0["gate"]
    worst_loss = max(loss_rel(rk["gate"]["loss"]) for rk in ranks)
    worst_norm = max(abs(rk["gate"]["grad_norm"] - norm) / norm
                     for rk in ranks)
    if not worst_loss <= BB_TRAIN_LOSS0_RTOL:
        fail(f"mesh SOL train: step 0's loss {gate['loss']!r} vs one "
             f"process {ref['loss']!r} ({worst_loss:.3g})")
    if not gate["grad_gap"] <= BB_TRAIN_GRAD_TOL:
        fail(f"mesh SOL train: gradient {gate['grad_gap_at']} differs by "
             f"{gate['grad_gap']:.3g} of its norm from one process's")
    if not worst_norm <= 1e-5:
        fail(f"mesh SOL train: global gradient norm {gate['grad_norm']!r} "
             f"vs one process {norm!r} ({worst_norm:.3g})")
    # the steps
    run = r0["train"]
    if run["gap"]["violations"]:
        fail(f"mesh SOL train: {run['gap']['violations'][:4]}")
    if not run["losses"][-1] < run["losses"][0]:
        fail(f"mesh SOL train: loss did not fall: {run['losses']}")
    for rk in ranks:
        if rk["train"]["losses"] != run["losses"]:
            fail(f"mesh SOL train: rank {rk['rank']}'s losses "
                 f"{rk['train']['losses']} differ from rank 0's")
    # the all-reduces
    per_block = {("forward", "model"): MST_REDUCES_A_BLOCK * blocks,
                 ("backward", "model"): MST_REDUCES_A_BLOCK * blocks}
    per_step = {("graph", "model"): 2 * MST_REDUCES_A_BLOCK * blocks,
                ("data_mean", "data"): 1, ("update", "model"): 1}
    for rk in ranks:
        if rk["fwd_bwd_reduces"] != per_block:
            fail(f"mesh SOL train: rank {rk['rank']}'s forward and backward "
                 f"all-reduce {rk['fwd_bwd_reduces']}, not {per_block}")
        steps_seen = {k: v / TRAIN_STEPS for k, v in
                      rk["step_reduces"].items()}
        if steps_seen != per_step:
            fail(f"mesh SOL train: rank {rk['rank']}'s steps all-reduce "
                 f"{steps_seen} a step, not {per_step}")
    # the planted faults
    f = r0["faults"]
    seen = {"the backward all-reduce left out: gradients":
            (f["copy"]["grad_gap"], BB_TRAIN_GRAD_TOL),
            "the data mean left out: gradients":
            (f["data_mean"]["grad_gap"], BB_TRAIN_GRAD_TOL),
            "the data mean left out: parameters":
            (float(len(f["data_mean"]["gap"]["violations"])), 0.0),
            "the forward all-reduce left out: loss":
            (max(loss_rel(rk["faults"]["reduce"]["loss"]) for rk in ranks),
             BB_TRAIN_LOSS0_RTOL)}
    for label, (value, limit) in seen.items():
        if not value > limit:
            fail(f"mesh SOL train: {label} passed its gate ({value:.3g}, "
                 f"limit {limit})")
    launches = {k: sum(rk["launches"][k] for rk in ranks)
                for k in MST_KERNELS}
    for kernel in ("matmul", "flash_attention", "dfp_fused"):
        if launches[kernel] <= 0:
            fail(f"mesh SOL train: {kernel} was not launched on the ranks")
    split = r0["split_ms"]
    step_total = sum(r0["train"]["step_ms"])
    model_ms = r0["reduce_ms"].get(("graph", "model"), 0.0)
    parts = {"step_ms": step_total / TRAIN_STEPS,
             "fwd_bwd_ms": (step_total - split["data_mean"]
                            - split["update"]) / TRAIN_STEPS,
             "model_all_reduce_ms": model_ms / TRAIN_STEPS,
             "data_mean_ms": split["data_mean"] / TRAIN_STEPS,
             "adamw_ms": split["update"] / TRAIN_STEPS}
    phase_s = time.perf_counter() - t_phase
    rec = {"loss_rel_err": worst_loss, "grad_gap": gate["grad_gap"],
           "grad_gap_at": gate["grad_gap_at"], "grad_norm_rel_err": worst_norm,
           "losses": run["losses"], "ref_losses": losses,
           "train_gap": run["gap"], "faults": {k: v for k, (v, _) in
                                               seen.items()},
           "elections": r0["elections"], "bwd_launches": r0["bwd_launches"],
           "reduces_a_step": {"+".join(k): v / TRAIN_STEPS for k, v in
                              r0["step_reduces"].items()},
           "launches": launches, "keys": r0["keys"],
           "rank0_step_ms": r0["train"]["step_ms"], "rank0_parts": parts,
           "ref_step_ms": step_ms, "reference_s": ref_s, "ranks_s": ranks_s,
           "rank_s": [rk["seconds"] for rk in ranks], "phase_s": phase_s}
    cfg = dict(TRAIN_STACKS)[MST_NAME]
    log(f"[mesh-sol-train] {blocks} x transformer_block({cfg['d_model']}, "
        f"{cfg['n_heads']}/{cfg['n_kv_heads']}) on {MESH}, input "
        f"{TRAIN_SHAPE_BT + (cfg['d_model'],)}: step 0 loss "
        f"{worst_loss:.3g}, gradients {gate['grad_gap']:.3g} of the norm at "
        f"{gate['grad_gap_at']}, norm {worst_norm:.3g}; losses "
        f"{[round(v, 6) for v in run['losses']]} (one process "
        f"{[round(v, 6) for v in losses]}, worst {run['gap']['loss_rel']:.3g}),"
        f" final parameters within max |Δ| {run['gap']['max_abs']:.3g} "
        f"({run['gap']['worst']}); all-reduces a step "
        f"{rec['reduces_a_step']}; faults caught: "
        + ", ".join(f"{k} {v:.3g}" for k, v in rec["faults"].items()))
    log(f"[mesh-sol-train] rank 0 step {parts['step_ms']:.2f} ms (mean of "
        f"{TRAIN_STEPS}): fwd+bwd {parts['fwd_bwd_ms']:.2f} (of which model "
        f"all-reduces {parts['model_all_reduce_ms']:.2f}), gradient mean "
        f"{parts['data_mean_ms']:.2f}, AdamW with the norm "
        f"{parts['adamw_ms']:.2f}; one process {statistics.median(step_ms):.2f}"
        f" ms (median); launches summed over the ranks {launches}; reference "
        f"{ref_s:.1f} s, ranks {ranks_s:.1f} s; phase 17 took {phase_s:.1f} s"
        f" (four ranks share the card: no scaling measured); {nvidia_smi()}")
    return rec


# ---------------------------------------------------------------------------
# phase 18: the host_cpu backend on the card machine's host
# ---------------------------------------------------------------------------

HOST_CNN_SHAPE = (8, 3, 224, 224)
HOST_LM_SHAPE = (2, 128, 1536)
HOST_RTOL = 1e-5            # against torch_ref on the host: the f32 row
HOST_IMPLS = {"host_cpu.linear_oi", "host_cpu.conv2d_nchw"}


def phase_host_cpu(torch, dev) -> dict:
    """Phase 18: the small CNN (seeded on the card, ``HOST_CNN_SHAPE``) and
    phase 3's first two blocks (its generator, drawn in its order) through
    ``optimize(..., backend="host_cpu")`` with no device: on the host.
    Gates: both tier-0 impls elected, every output within ``HOST_RTOL`` of
    ``torch_ref`` on the host and within ``LOGIT_RTOL`` of ``h100`` on the
    card (of the output's scale), and a CUDA device refused."""
    import copy

    from repro_torch.frontends import nn
    from repro_torch.frontends.optimize import optimize
    from torch import nn as tnn

    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    d, heads, kvh = FULL["d_model"], FULL["n_heads"], FULL["n_kv_heads"]
    blocks = tnn.Sequential(*[nn.transformer_block(d, heads, kvh, device=dev,
                                                   generator=gen)
                              for _ in range(2)])
    cnn = nn.small_cnn(device=dev, generator=gen).eval()
    rec, elected = {}, set()
    for name, module, shape in (("small_cnn", cnn, HOST_CNN_SHAPE),
                                ("transformer_2_blocks", blocks,
                                 HOST_LM_SHAPE)):
        x = torch.randn(shape, device=dev, generator=gen)
        on_host = copy.deepcopy(module).to("cpu")
        host = optimize(on_host, shape, backend="host_cpu")
        if host.device.type != "cpu":
            fail(f"host_cpu {name} compiled for {host.device}")
        t0 = time.perf_counter()
        got = host(x.cpu())
        host_ms = 1e3 * (time.perf_counter() - t0)
        want = optimize(on_host, shape, backend="torch_ref",
                        device="cpu")(x.cpu())
        card = optimize(module, shape, backend="h100", device=dev)(x).cpu()
        err_ref, err_card = rel_err(got, want), rel_err(got, card)
        if not err_ref <= HOST_RTOL:
            fail(f"host_cpu {name}: {err_ref:.3g} of the scale from "
                 f"torch_ref on the host")
        if not err_card <= LOGIT_RTOL:
            fail(f"host_cpu {name}: {err_card:.3g} of the scale from h100 "
                 f"on the card")
        report = host.impl_report()
        elected |= set(report)
        rec[name] = {"shape": shape, "elections": report,
                     "vs_torch_ref": err_ref, "vs_h100": err_card,
                     "host_ms": host_ms}
        log(f"[host_cpu] {name} {shape}: {report}; {err_ref:.3g} of the scale "
            f"from torch_ref (host), {err_card:.3g} from h100 (card); one "
            f"host forward {host_ms:.1f} ms")
    if not HOST_IMPLS <= elected:
        fail(f"host_cpu elected {sorted(elected)}, not {sorted(HOST_IMPLS)}")
    try:
        optimize(cnn, HOST_CNN_SHAPE, backend="host_cpu", device="cuda")
    except ValueError as err:
        rec["refused"] = str(err)
    else:
        fail("host_cpu compiled for the card")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[host_cpu] the card refused ({rec['refused']}); phase 18 took "
        f"{rec['phase_s']:.1f} s")
    return rec


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
    marks = [("start", t_start)]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = build.build_all(force=True)
    mark("1 build")
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
    mark("2 kernels")
    # matmul_cuda counts every product; each of its two kernels counts its
    # own launches
    mm = {"matmul": matmul_cuda, "matmul_tc": KERNELS["tensor_core"],
          "matmul_skinny": KERNELS["skinny"]}
    counters = serve_counters()
    held32 = {c["key"] for c in kern["cases"] if c["dtype"] == "float32"}
    serve, serve_ref, serve_got = phase_serve(
        torch, counters, torch.device("cuda"), held32)
    mark("3-4 serve")
    rec_counters = {**mm, "dfp_fused": dfp_fused_triton,
                    "rglru_scan": rglru_scan_cuda,
                    "rwkv6_scan": rwkv6_scan_cuda}
    recurrent = phase_recurrent(torch, rec_counters, torch.device("cuda"),
                                held32)
    mark("5 recurrent")
    cnn_counters = {**mm, "dfp_fused": dfp_fused_triton,
                    "avgpool": avgpool_cuda}
    cnn = phase_cnn(torch, cnn_counters, torch.device("cuda"), held32)
    mark("6 cnn")
    bf16_counters = {**mm, "flash_attention": flash_attention_cuda,
                     "decode_attention": decode_attention_cuda,
                     "dfp_fused": dfp_fused_triton,
                     "rglru_scan": rglru_scan_cuda,
                     "rwkv6_scan": rwkv6_scan_cuda, "avgpool": avgpool_cuda}
    held = {c["key"] for c in kern["cases"] if c["dtype"] == "bfloat16"}
    bf16 = phase_bf16(torch, bf16_counters, torch.device("cuda"), recurrent,
                      cnn, held)
    mark("7 bf16")
    gc.collect()
    torch.cuda.empty_cache()
    measured_state, measured = phase_measured_serve(
        torch, counters, torch.device("cuda"), serve, serve_ref,
        kern["bf16_products"])
    mark("8 measured serve")
    sol = phase_sol(torch, torch.device("cuda"), measured_state)
    mark("9 sol")
    gc.collect()
    torch.cuda.empty_cache()
    train_counters = {**mm, "flash_attention": flash_attention_cuda,
                      "dfp_fused": dfp_fused_triton,
                      "rglru_scan": rglru_scan_cuda,
                      "rwkv6_scan": rwkv6_scan_cuda}
    train = phase_train(torch, train_counters, torch.device("cuda"))
    mark("10 train")
    gc.collect()
    torch.cuda.empty_cache()
    deploy = phase_deploy(torch, bf16_counters, torch.device("cuda"),
                          measured_state)
    mark("11 deploy")
    del measured_state
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh_serve(torch, serve_got, held32)
    mark("12 mesh")
    del serve_got
    fleet = phase_fleet(torch, torch.device("cuda"), held32)
    mark("13 fleet")
    gc.collect()
    torch.cuda.empty_cache()
    backbone = phase_backbone(
        torch, {"flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda,
                "rglru_scan": rglru_scan_cuda,
                "rwkv6_scan": rwkv6_scan_cuda},
        {(c["key"], c["dtype"]) for c in kern["cases"]})
    mark("14 backbone")

    gc.collect()
    torch.cuda.empty_cache()
    train_backbone = phase_train_backbone(
        torch, {"flash_attention": flash_attention_cuda,
                "rglru_scan": rglru_scan_cuda,
                "rwkv6_scan": rwkv6_scan_cuda},
        {(c["key"], c["dtype"]) for c in kern["cases"]})
    mark("15 backbone train")

    gc.collect()
    torch.cuda.empty_cache()
    mesh_backbone = phase_mesh_backbone(torch, train_backbone["cli"]
                                        ["ckpt_dir"])
    import shutil
    shutil.rmtree(train_backbone["cli"]["ckpt_dir"], ignore_errors=True)
    mark("16 mesh backbone")
    gc.collect()
    torch.cuda.empty_cache()
    mesh_sol_train = phase_mesh_sol_train(torch, held32,
                                          torch.device("cuda"))
    mark("17 mesh SOL train")
    host_cpu = phase_host_cpu(torch, torch.device("cuda"))
    mark("18 host_cpu")

    # launches per main path: the served set and one forward of each stack
    # and each CNN in f32; the bf16 paths' runs for the bf16 entries
    by_path = {"serve": serve["launches"]}
    by_path.update({name: r["launches"] for name, r in recurrent.items()})
    by_path.update({name: r["launches"] for name, r in cnn.items()})
    by_path.update({f"train_{name}": r["launches"]
                    for name, r in train["stacks"].items()})
    by_path["deploy_serve"] = deploy["serve"]["launches"]
    by_path.update({f"deploy_{name}": deploy["legs"][name]["launches"]
                    for name, _ in STACKS})
    by_path["mesh_serve"] = mesh["launches"]
    by_path["fleet"] = fleet["launches"]
    by_path["backbone_qwen2"] = backbone["launches"]["backbone_qwen2"]
    by_path["backbone_smoke"] = backbone["launches"]["backbone_smoke"]
    for path in ("backbone_train_qwen2", "backbone_train_smoke"):
        by_path[path] = train_backbone["launches"][path]
    by_path["mesh_backbone"] = mesh_backbone["launches"]
    by_path["mesh_sol_train"] = mesh_sol_train["launches"]
    bf16_by_path = {name: r["launches"] for name, r in bf16.items()}
    bf16_by_path["deploy_listing3_cnn"] = \
        deploy["legs"]["listing3_cnn_bf16"]["launches"]
    bf16_by_path["backbone_qwen2_bf16"] = \
        backbone["launches"]["backbone_qwen2_bf16"]
    bf16_by_path["backbone_train_qwen2_bf16"] = \
        train_backbone["launches"]["backbone_train_qwen2_bf16"]
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
    phase_seconds = {name: round(t - marks[i][1], 1)
                     for i, (name, t) in enumerate(marks[1:])}
    log(f"[phases] seconds by phase: {phase_seconds}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build_log": build.BUILD_LOG,
         "build_digest": {n: build.digest(n) for n in build.BUILD_LOG},
         "kernels": kern["cases"], "plans": kern["plans"],
         "serve": serve,
         "recurrent": recurrent, "cnn": cnn, "bf16": bf16,
         "measured_serve": measured, "sol": sol, "train": train,
         "deploy": deploy, "mesh_serve": mesh, "fleet": fleet,
         "backbone": backbone, "train_backbone": train_backbone,
         "mesh_backbone": mesh_backbone, "mesh_sol_train": mesh_sol_train,
         "host_cpu": host_cpu, "phase_seconds": phase_seconds,
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

"""SOL serving: continuous batching on the elected graph, with the forward
split into a prefill program and a single-token decode program
(counterpart of ``repro.launch.serve``).

Every forward goes through ``frontends/optimize.SolModel``, so the impls
that serve traffic are the impls the election chose: on the ``h100``
backend, the hand-written CUDA and Triton kernels.

* **prefill** (``extract_prefill``) — one forward over the whole prompt;
  every attention layer's (k, v) rows join the outputs and seed the
  request's KV slot.
* **decode** (``extract_decode``) — one token per resident request against
  its cached keys/values through ``DECODE_ATTENTION``.
* ``ServeConfig(decode=False)`` re-runs the whole context every step (the
  baseline the decode program is checked against).

:class:`SlotArena` keeps each request's tokens and KV rows on the host in an
``AsyncQueue``-backed arena (paper Sec. IV-C), as the JAX design does: each
decode step gathers every resident cache and stages it to the card with the
step's other inputs as ONE packed copy (``runtime/packed``), so
``dmas == forwards``.  Batches pad to pow2 (batch, seq) buckets, each bucket
compiling its own program once; a power of two is its own autotune bucket,
so every served shape hits its measurements exactly.

**Provenance enforcement.**  ``warm_autotune`` measures every admissible
impl of every LINEAR/MATMUL/ATTENTION/DECODE_ATTENTION node (each
``Tunable`` space swept, ``core.measure.sweep_node``) for every prefill and
decode bucket the workload can open, into the process-wide autotune cache.
With ``strict_provenance`` a bucket model whose served-kind elections did
not come from measurements of that node's exact bucket raises
:class:`ProvenanceError` instead of serving roofline guesses.

**Deploy artifacts** (paper Sec. III-C).  ``export_artifacts`` deploys
every bucket model the server compiled (``frontends/deploy.py``);
``SolServer(deployed={key: blob})`` serves from those artifacts alone: a
bucket with no artifact raises ``KeyError`` instead of compiling, the
strict audit reads each artifact's manifest, and there are no live graphs
to warm.

**Mesh serving.**  ``ServeConfig(mesh=(data, model))`` serves one model
across the ranks of the process group this process joined
(``launch.mesh.make_debug_mesh``; ``run_on_mesh`` starts them): every
bucket model compiles with ``mesh=`` (per-shard shapes, row-parallel
all-reduces, gathered outputs), every autotune key carries the mesh tag,
and the smallest batch bucket is the data axis's size, so the batch always
shards.  Every rank runs the same scheduler and arena on the same requests;
the outputs are gathered, so the arenas stay identical (the JAX design
keeps the arena and scheduler host-global too).  Mesh models are served
live: ``export_artifacts`` refuses them.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh 2,2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --fleet 3
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import io
import json
import sys
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn as tnn

from ..backends import for_device, get_backend
from ..core import autotune as AT
from ..core import measure, passes
from ..core.executor import TORCH_DTYPES
from ..core.ir import OpKind
from ..frontends import nn
from ..frontends.extract import extract, extract_decode, extract_prefill
from ..frontends.offload import DeviceLike, resolve_device
from ..frontends.optimize import (SolModel, compile_graph,
                                  provenance_violations)
from ..runtime import packed
from ..runtime.async_queue import AsyncQueue

TOKEN_BYTES = 4                    # int32 tokens in the slot arena
KV_BYTES = 4                       # float32 cache rows in the slot arena
MIN_SEQ_BUCKET = 8                 # smallest padded sequence bucket
SERVED_KINDS = (OpKind.LINEAR, OpKind.MATMUL, OpKind.ATTENTION,
                OpKind.DECODE_ATTENTION)


class ProvenanceError(RuntimeError):
    """A bucket model would serve elections that did not come from
    autotune measurements of its exact buckets."""


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy: ``temperature <= 0`` is greedy argmax;
    otherwise temperature, top-k and top-p truncation, sampled with the
    request's own numpy generator seeded from ``seed``."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature {self.temperature} must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"top_k {self.top_k} must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p {self.top_p} must be in (0, 1]")


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - np.max(z)
    e = np.exp(z)
    return e / e.sum()


def sample_token(logits: np.ndarray,
                 params: Optional[SamplingParams] = None,
                 rng: Optional[np.random.Generator] = None) -> int:
    """Host-side logits→token step, float64 throughout, so the sampled
    distribution is a pure function of the logits bits."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    if params is None or params.temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits / params.temperature
    if params.top_k:
        k = min(params.top_k, z.size)
        kth = np.partition(z, -k)[-k]
        z = np.where(z < kth, -np.inf, z)
    p = _softmax(z)
    if params.top_p < 1.0:
        order = np.argsort(-z, kind="stable")
        csum = np.cumsum(p[order])
        keep = order[: min(z.size, int(np.searchsorted(csum, params.top_p))
                           + 1)]
        masked = np.full_like(z, -np.inf)
        masked[keep] = z[keep]
        p = _softmax(masked)
    if rng is None:
        raise ValueError("temperature sampling needs the request's rng")
    return int(rng.choice(p.size, p=p))


# ---------------------------------------------------------------------------
# serving model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Shape of the served LM + scheduler limits.  ``max_seq`` must be a
    power of two (it is the largest sequence bucket).  ``mesh`` is the
    (data, model) rank grid; (1, 1) serves on one device."""

    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    vocab: int = 128
    max_seq: int = 64              # per-request context bound (pow2)
    max_batch: int = 4             # requests per forward step
    slots: int = 8                 # KV-slot arena size (resident requests)
    backend: str = "h100"
    seed: int = 0
    decode: bool = True            # incremental KV-cache decode program
    mesh: Tuple[int, int] = (1, 1)

    def __post_init__(self):
        if self.max_seq != AT.ceil_pow2(self.max_seq):
            raise ValueError(f"max_seq {self.max_seq} must be a power of "
                             f"two (it is the largest sequence bucket)")
        if self.max_batch < 1 or self.slots < 1:
            raise ValueError("max_batch and slots must be >= 1")
        if len(self.mesh) != 2 or any(int(a) < 1 for a in self.mesh):
            raise ValueError(f"mesh {self.mesh} must be two positive axis "
                             f"sizes (data, model)")


def build_lm(cfg: ServeConfig, *, n_kv_heads: Optional[int] = None,
             device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> tnn.Sequential:
    """The served module: pre-norm transformer blocks + LM head, plain
    framework modules (the server never calls their eager forward).
    ``device=None`` is the CUDA card unless the CPU was selected; weights
    come from ``generator``, by default one seeded with ``cfg.seed`` on
    that device (``"meta"`` gives the shapes alone, with no weights)."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(cfg.seed)
    blocks = [nn.transformer_block(cfg.d_model, cfg.n_heads, n_kv_heads,
                                   device=dev, generator=generator)
              for _ in range(cfg.n_layers)]
    return tnn.Sequential(*blocks, nn.Linear(cfg.d_model, cfg.vocab,
                                             device=dev, generator=generator))


def embedding_table(cfg: ServeConfig) -> np.ndarray:
    """Deterministic host-side token embedding — the same numpy draw as the
    JAX package, bit for bit.  Read-only and drawn once per (seed, vocab,
    d_model): every server of a fleet, a respawn included, shares it."""
    return _embedding(cfg.seed, cfg.vocab, cfg.d_model)


@functools.lru_cache(maxsize=2)
def _embedding(seed: int, vocab: int, d_model: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((vocab, d_model)) * 0.25).astype(np.float32)
    table.setflags(write=False)
    return table


def validate_prompt(cfg: ServeConfig, prompt: Sequence[int]) -> np.ndarray:
    """Admission-time prompt validation."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if prompt.size == 0:
        raise ValueError("empty prompt")
    if prompt.size >= cfg.max_seq:
        raise ValueError(f"prompt of {prompt.size} tokens leaves no "
                         f"room to decode within max_seq={cfg.max_seq}")
    if np.any(prompt < 0) or np.any(prompt >= cfg.vocab):
        raise ValueError("prompt token out of vocabulary range")
    return prompt


# ---------------------------------------------------------------------------
# requests + KV-slot arena
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                       # int32 (L,)
    max_new_tokens: int
    submitted: float
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    rng: Optional[np.random.Generator] = None
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    phase: str = "pending"                   # pending|prefill|decode|done
    first_token_time: Optional[float] = None
    finished_time: Optional[float] = None
    last_served_step: int = -1
    served_steps: List[int] = dataclasses.field(default_factory=list)
    last_logits: Optional[np.ndarray] = None

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return self.phase == "done"

    @property
    def cache_len(self) -> int:
        """Cached rows: every token but the newest, ``length - 1``."""
        return self.length - 1


class SlotArena:
    """Per-request slots backed by the async queue's virtual allocator
    (paper Sec. IV-C): a token region of ``max_seq`` int32s and, with
    ``kv_row_shapes``, one KV region per cached tensor in a single
    allocation.  Admission, append and eviction are enqueued operations."""

    def __init__(self, queue: AsyncQueue, n_slots: int, max_seq: int,
                 kv_row_shapes: Optional[Sequence[Tuple[int, ...]]] = None):
        self.queue = queue
        self.max_seq = max_seq
        self._free = list(range(n_slots - 1, -1, -1))
        self._ptr: Dict[int, Any] = {}
        self._len: Dict[int, int] = {}
        self.kv_row_shapes = [tuple(s) for s in (kv_row_shapes or [])]
        self._row_bytes = [int(np.prod(s)) * KV_BYTES
                           for s in self.kv_row_shapes]
        self._kv_offs: List[int] = []
        total = 0
        for rb in self._row_bytes:
            self._kv_offs.append(total)
            total += max_seq * rb
        self._kv_total = total
        self._kv_ptr: Dict[int, Any] = {}

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def resident(self) -> int:
        return len(self._ptr)

    def admit(self, tokens: np.ndarray) -> Optional[int]:
        """Allocate a slot and stage the prompt into it; None when full."""
        if not self._free:
            return None
        tokens = np.ascontiguousarray(tokens, np.int32)
        if len(tokens) > self.max_seq:
            raise ValueError(f"prompt of {len(tokens)} tokens exceeds the "
                             f"{self.max_seq}-token slot")
        slot = self._free.pop()
        ptr = self.queue.malloc_async(self.max_seq * TOKEN_BYTES)
        self.queue.memcpy_async(ptr, tokens)
        self._ptr[slot] = ptr
        self._len[slot] = len(tokens)
        if self._kv_total:
            self._kv_ptr[slot] = self.queue.malloc_async(self._kv_total)
        return slot

    def append(self, slot: int, token: int) -> None:
        n = self._len[slot]
        if n >= self.max_seq:
            raise ValueError(f"slot {slot} is full ({n} tokens)")
        self.queue.memcpy_async(self._ptr[slot] + n * TOKEN_BYTES,
                                np.asarray([token], np.int32))
        self._len[slot] = n + 1

    def tokens(self, slot: int) -> np.ndarray:
        """The slot's context; ``synchronize`` the queue first."""
        buf = self.queue.allocator.resolve(self._ptr[slot])
        n = self._len[slot]
        return buf[:n * TOKEN_BYTES].view(np.int32).copy()

    def write_kv_rows(self, slot: int, tensor: int, start_row: int,
                      rows: np.ndarray) -> None:
        """Stage rows ``[start_row, start_row + n)`` of one cached tensor."""
        rows = np.ascontiguousarray(rows, np.float32)
        n = rows.shape[0]
        if start_row + n > self.max_seq:
            raise ValueError(f"KV write [{start_row}, {start_row + n}) "
                             f"overflows the {self.max_seq}-row slot")
        rb = self._row_bytes[tensor]
        self.queue.memcpy_async(
            self._kv_ptr[slot] + self._kv_offs[tensor] + start_row * rb,
            rows)

    def kv_rows(self, slot: int, tensor: int, n_rows: int) -> np.ndarray:
        """The first ``n_rows`` rows of one cached tensor; ``synchronize``
        first."""
        buf = self.queue.allocator.resolve(self._kv_ptr[slot])
        off = self._kv_offs[tensor]
        rb = self._row_bytes[tensor]
        return (buf[off: off + n_rows * rb].view(np.float32)
                .reshape((n_rows,) + self.kv_row_shapes[tensor]).copy())

    def evict(self, slot: int) -> None:
        self.queue.free_async(self._ptr.pop(slot))
        kv = self._kv_ptr.pop(slot, None)
        if kv is not None:
            self.queue.free_async(kv)
        del self._len[slot]
        self._free.append(slot)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class SolServer:
    """Continuous-batching server over the SOL pipeline.

    Bucket-model keys are ``(program, batch_bucket, seq_bucket)`` with
    ``program`` one of ``"prefill"``, ``"decode"`` (seq = padded cache
    length) and ``"full"`` (``decode=False``).  ``device=None`` serves on
    the CUDA card and raises when there is none; ``device="cpu"`` serves on
    the CPU, where every kernel runs its plain version.
    ``strict_provenance``: every bucket model's served-kind elections must
    come from measurements of their exact buckets (``warm_autotune``),
    else compiling the bucket raises :class:`ProvenanceError`.
    ``deployed`` switches the server to artifact mode: a map of those keys
    to deploy blobs or ``DeployedModel``s (loaded on ``device``); a bucket
    outside it raises ``KeyError`` instead of compiling a live model, and
    the strict audit reads each artifact's manifest."""

    def __init__(self, cfg: Optional[ServeConfig] = None,
                 model: Optional[tnn.Module] = None, *,
                 deployed: Optional[Dict[Tuple, Any]] = None,
                 device: DeviceLike = None,
                 strict_provenance: bool = False):
        self.cfg = cfg or ServeConfig()
        self.strict_provenance = strict_provenance
        # mesh mode: every bucket compiles sharded and every autotune key
        # carries the mesh tag, so measurements, pinned configs and strict
        # provenance hold on per-shard shapes
        self.mesh = None
        self._min_batch = 1
        if tuple(self.cfg.mesh) != (1, 1):
            from ..distributed import sharding as shd
            from .mesh import make_debug_mesh
            self.mesh = make_debug_mesh(*(int(a) for a in self.cfg.mesh),
                                        device=device)
            if device is None:
                device = packed.replicated(self.mesh)
            # the smallest batch bucket that still shards the batch dim
            self._min_batch = shd.axis_size(self.mesh, shd.dp_axes(self.mesh))
        self.device = resolve_device(device)
        self.backend = for_device(get_backend(self.cfg.backend), self.device)
        if self.mesh is not None:
            self.backend = shd.mesh_backend(self.backend, self.mesh)
        self.embed = embedding_table(self.cfg)
        self.queue = AsyncQueue()
        self._models: Dict[Tuple, Any] = {}
        self.served_elections: Dict[Tuple, Dict[str, Any]] = {}
        self._deploy_only = deployed is not None
        loaded: Dict[Tuple, Any] = {}
        if deployed is not None:
            from ..frontends import deploy as D
            loaded = {tuple(k): D.load(a, self.device)
                      if isinstance(a, bytes) else a
                      for k, a in deployed.items()}
        self.model = model if model is not None else (
            None if self._deploy_only else build_lm(self.cfg,
                                                    device=self.device))
        self._kv_row_shapes = (self._kv_rows(loaded) if self.cfg.decode
                               else [])
        self.arena = SlotArena(self.queue, self.cfg.slots, self.cfg.max_seq,
                               kv_row_shapes=self._kv_row_shapes)
        for key, m in loaded.items():
            self._models[key] = self._audit(m, key)
        self._pending: "deque[Request]" = deque()
        self._active: List[Request] = []
        self._finished: List[Request] = []
        self._next_rid = 0
        self._step = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self.stats = {"steps": 0, "forwards": 0, "dmas": 0, "tokens": 0,
                      "prefills": 0, "decodes": 0, "admitted": 0,
                      "evicted": 0, "buckets": {},
                      "forward_ms": {"prefill": [], "decode": [],
                                     "full": []}}

    def _kv_rows(self, loaded: Dict[Tuple, Any]) -> List[Tuple[int, ...]]:
        """The arena's KV row shapes: the decode program's cache inputs,
        read from a decode artifact's input specs when serving artifacts
        alone, else from a decode extraction of the model (built on the
        meta device when there is none: shapes without weights)."""
        if self.model is None:
            dec = [m for k, m in sorted(loaded.items()) if k[0] == "decode"]
            if dec:
                return [tuple(shape[2:]) for shape, _ in dec[0].inputs[2:]]
        model = self.model if self.model is not None else build_lm(
            self.cfg, device="meta")
        g = extract_decode(model, 1, self.cfg.max_seq, self.cfg.d_model)
        return [tuple(n.spec.shape[2:]) for n in g.inputs[2:]]

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None) -> Request:
        prompt = validate_prompt(self.cfg, prompt)
        sampling = sampling or SamplingParams()
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max(1, int(max_new_tokens)),
                      submitted=time.perf_counter(), sampling=sampling,
                      rng=np.random.default_rng(sampling.seed))
        self._next_rid += 1
        self._pending.append(req)
        return req

    def step(self) -> List[int]:
        """One scheduler tick: admit → select the least-recently-served
        batch → prefill forward for new admissions and decode forward for
        residents (one packed copy each) → sample/append/evict."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        while self._pending and self.arena.free_slots:
            req = self._pending.popleft()
            req.slot = self.arena.admit(req.prompt)
            req.phase = "prefill"
            self._active.append(req)
            self.stats["admitted"] += 1
        if not self._active:
            return []
        batch = sorted(self._active,
                       key=lambda r: (r.last_served_step, r.rid)
                       )[: self.cfg.max_batch]
        self.queue.synchronize()
        self._step += 1
        self.stats["steps"] += 1
        if self.cfg.decode:
            results = (self._forward_prefill(
                           [r for r in batch if r.phase == "prefill"])
                       + self._forward_decode(
                           [r for r in batch if r.phase == "decode"]))
        else:
            results = self._forward_full(batch)
        now = time.perf_counter()
        for req, row in results:
            req.last_logits = row
            tok = sample_token(row, req.sampling, req.rng)
            if req.phase == "prefill":
                req.first_token_time = now
                req.phase = "decode"
                self.stats["prefills"] += 1
            else:
                self.stats["decodes"] += 1
            req.generated.append(tok)
            req.last_served_step = self._step
            req.served_steps.append(self._step)
            self.stats["tokens"] += 1
            if (len(req.generated) >= req.max_new_tokens
                    or req.length >= self.cfg.max_seq):
                req.phase = "done"
                req.finished_time = now
                self.arena.evict(req.slot)
                req.slot = None
                self.stats["evicted"] += 1
                self._active.remove(req)
                self._finished.append(req)
            else:
                self.arena.append(req.slot, tok)
        self._t_last = time.perf_counter()
        return [r.rid for r in batch]

    # -- the three forward programs ------------------------------------------

    def _embedded_rows(self, reqs: List[Request], bb: int, sb: int
                       ) -> List[np.ndarray]:
        rows = []
        for r in reqs:
            t = self.arena.tokens(r.slot)
            padded = np.zeros(sb, np.int32)
            padded[: len(t)] = t
            rows.append(self.embed[padded])            # (sb, d_model) f32
        for _ in range(bb - len(reqs)):
            rows.append(np.zeros((sb, self.cfg.d_model), np.float32))
        return rows

    def _last_rows(self, logits: torch.Tensor, lens: List[int]
                   ) -> np.ndarray:
        """Each request's last-position logits, gathered on the device so
        only those rows cross to the host."""
        idx = torch.as_tensor([n - 1 for n in lens], device=logits.device)
        rows = torch.arange(len(lens), device=logits.device)
        return _host(logits[rows, idx])

    def _run(self, key: Tuple, *staged):
        t0 = time.perf_counter()
        self.stats["dmas"] += 1
        self.stats["forwards"] += 1
        outs = self._model_for(key)(*staged)
        return outs, t0

    def _done(self, program: str, t0: float) -> None:
        self.stats["forward_ms"][program].append(
            1e3 * (time.perf_counter() - t0))

    def _forward_full(self, batch: List[Request]
                      ) -> List[Tuple[Request, np.ndarray]]:
        """Baseline (``decode=False``): every step re-runs the whole resident
        context through the plain forward graph."""
        lens = [r.length for r in batch]
        bb, sb = self._bucket(len(batch), max(lens))
        x = packed.stage_batch(self._embedded_rows(batch, bb, sb),
                               self.device)    # ONE DMA
        logits, t0 = self._run(("full", bb, sb), x)
        rows = self._last_rows(logits, lens)
        self._done("full", t0)
        self._bucket_stat(f"{bb}x{sb}")
        return [(r, rows[i]) for i, r in enumerate(batch)]

    def _forward_prefill(self, reqs: List[Request]
                         ) -> List[Tuple[Request, np.ndarray]]:
        """Prompt forward: the first token's logits AND the (k, v) rows that
        seed each request's KV slot."""
        if not reqs:
            return []
        lens = [r.length for r in reqs]
        bb, sb = self._bucket(len(reqs), max(lens))
        x = packed.stage_batch(self._embedded_rows(reqs, bb, sb),
                               self.device)    # ONE DMA
        outs, t0 = self._run(("prefill", bb, sb), x)
        rows = self._last_rows(outs[0], lens)
        kv = [_host(o[: len(reqs)]) for o in outs[1:]]  # (n, sb, KV, hd)
        self._done("prefill", t0)
        results = []
        for i, r in enumerate(reqs):
            for t in range(len(kv)):
                self.arena.write_kv_rows(r.slot, t, 0, kv[t][i, : lens[i]])
            results.append((r, rows[i]))
        self._bucket_stat(f"{bb}x{sb}")
        return results

    def _forward_decode(self, reqs: List[Request]
                        ) -> List[Tuple[Request, np.ndarray]]:
        """One token per resident request: gather each cache from its arena
        slot, pad to the (batch, cache) bucket, stage everything as ONE
        packed copy, and append the returned (k, v) rows at ``lens[b]``."""
        if not reqs:
            return []
        lens = [r.cache_len for r in reqs]
        db, cb = self._bucket(len(reqs), max(lens))
        x = np.zeros((db, 1, self.cfg.d_model), np.float32)
        lens_arr = np.zeros((db,), np.int32)
        caches = [np.zeros((db, cb) + shape, np.float32)
                  for shape in self._kv_row_shapes]
        for i, r in enumerate(reqs):
            x[i, 0] = self.embed[r.generated[-1]]
            lens_arr[i] = lens[i]
            for t in range(len(caches)):
                caches[t][i, : lens[i]] = self.arena.kv_rows(
                    r.slot, t, lens[i])
        staged = packed.stage_inputs([x, lens_arr] + caches,
                                     self.device)    # ONE DMA
        outs, t0 = self._run(("decode", db, cb), *staged)
        logits = _host(outs[0][: len(reqs), 0])       # (n, vocab)
        new_rows = [_host(o[: len(reqs), 0]) for o in outs[1:]]
        self._done("decode", t0)
        results = []
        for i, r in enumerate(reqs):
            for t in range(len(new_rows)):
                self.arena.write_kv_rows(r.slot, t, lens[i],
                                         new_rows[t][i: i + 1])
            results.append((r, logits[i]))
        self._bucket_stat(f"d{db}x{cb}")
        return results

    def _bucket_stat(self, key: str) -> None:
        self.stats["buckets"][key] = self.stats["buckets"].get(key, 0) + 1

    def run(self, max_steps: int = 100_000) -> Dict[str, Any]:
        while self._pending or self._active:
            if self._step >= max_steps:
                raise RuntimeError(f"serving exceeded {max_steps} steps "
                                   f"with requests still in flight")
            self.step()
        return self.summary()

    def close(self) -> None:
        self.queue.close()

    @property
    def depth(self) -> int:
        return len(self._pending) + len(self._active)

    @property
    def in_flight(self) -> List[Request]:
        return list(self._pending) + list(self._active)

    # -- buckets + models ----------------------------------------------------

    def _bucket(self, n_rows: int, max_len: int) -> Tuple[int, int]:
        """The (batch, seq) pow2 bucket a batch is padded to; for decode,
        ``max_len`` is the longest resident cache length."""
        return (AT.ceil_pow2(max(n_rows, self._min_batch)),
                self._seq_bucket(max_len))

    def _seq_bucket(self, max_len: int) -> int:
        return min(self.cfg.max_seq,
                   max(min(MIN_SEQ_BUCKET, self.cfg.max_seq),
                       AT.ceil_pow2(max_len)))

    def _seq_buckets(self, max_len: int) -> List[int]:
        """Every sequence bucket up to the one ``max_len`` opens."""
        out, s = [], min(MIN_SEQ_BUCKET, self.cfg.max_seq)
        while s <= self._seq_bucket(max_len):
            out.append(s)
            s *= 2
        return out

    def _batch_buckets(self) -> List[int]:
        """Every batch bucket up to ``max_batch``'s."""
        out, b = [], AT.ceil_pow2(self._min_batch)
        while b <= AT.ceil_pow2(max(self.cfg.max_batch, self._min_batch)):
            out.append(b)
            b *= 2
        return out

    def _workload_maxima(self, max_len: Optional[int] = None
                         ) -> Tuple[int, int]:
        """(longest prompt, longest total context) the current workload can
        produce; the prefill and decode bucket spaces derive from them."""
        if max_len is not None:
            return max_len, max_len
        reqs = list(self._pending) + self._active
        if not reqs:
            raise ValueError("no requests to derive the bucket space "
                             "from; pass max_len explicitly")
        prompts = [len(r.prompt) for r in reqs]
        totals = [min(self.cfg.max_seq, r.length
                      + (r.max_new_tokens - len(r.generated)))
                  for r in reqs]
        return max(prompts), max(totals)

    def bucket_space(self, max_len: Optional[int] = None
                     ) -> List[Tuple[int, int]]:
        """Every (batch, seq) bucket the current workload can open through
        the full re-forward program (``decode=False``)."""
        _, max_total = self._workload_maxima(max_len)
        return [(b, s) for b in self._batch_buckets()
                for s in self._seq_buckets(max_total)]

    def _warm_graphs(self, max_len: Optional[int]) -> Iterator:
        """Every program graph whose buckets the workload can open: the
        plain forward per (batch, seq) bucket with ``decode=False``;
        otherwise the prefill program per (batch, prompt) bucket and the
        decode program per (batch, cache) bucket (a cache peaks one row
        short of the total context: the newest token is never cached)."""
        d = self.cfg.d_model
        if not self.cfg.decode:
            for bb, sb in self.bucket_space(max_len):
                yield extract(self.model, (bb, sb, d))
            return
        max_prompt, max_total = self._workload_maxima(max_len)
        for bb in self._batch_buckets():
            for sb in self._seq_buckets(max_prompt):
                yield extract_prefill(self.model, (bb, sb, d))
        for db in self._batch_buckets():
            for cb in self._seq_buckets(max(1, max_total - 1)):
                yield extract_decode(self.model, db, cb, d)

    def _model_for(self, key: Tuple):
        m = self._models.get(key)
        if m is not None:
            return m
        if self._deploy_only:
            raise KeyError(
                f"bucket {key} is not among the deployed artifacts "
                f"{sorted(self._models)}: deploy-mode serving never falls "
                f"back to a live compile")
        program, b, s = key
        d = self.cfg.d_model
        if program == "full":
            g = extract(self.model, (b, s, d))
        elif program == "prefill":
            g = extract_prefill(self.model, (b, s, d))
        else:
            g = extract_decode(self.model, b, s, d)
        sol = compile_graph(self.model, g, self.backend,
                            device=self.device, mesh=self.mesh)
        self._models[key] = self._audit(sol, key)
        return sol

    def _audit(self, model, key: Tuple):
        """Record which impls the bucket model serves, per served kind and
        for the FUSED groups, and under ``strict_provenance`` enforce that
        every served-kind election was measured on its exact bucket."""
        served = tuple(k.value for k in SERVED_KINDS)
        kinds = served + (OpKind.FUSED.value,)
        by_kind = model.impl_report(by_kind=True)
        prov = model.impl_report(provenance=True)
        self.served_elections[key] = {
            "by_op": {k: dict(v) for k, v in by_kind.items() if k in kinds},
            "provenance": prov,
        }
        if self.strict_provenance:
            # an artifact's manifest holds its provenance; the exact-bucket
            # check reads a live graph against the live cache
            viol = provenance_violations(by_kind, prov, kinds=served)
            if isinstance(model, SolModel):
                viol += self._exact_bucket_violations(model)
            if viol:
                raise ProvenanceError(
                    f"bucket {key} would serve unmeasured elections (warm "
                    f"the autotune cache first): {viol}")
        return model

    def _exact_bucket_violations(self, model: SolModel) -> List[str]:
        """An election can carry 'measured' provenance through the cache's
        nearest-bucket lookup, timings of another shape.  Strict serving
        wants every served-kind node's exact bucket measured (a request
        that opens a new bucket needs another ``warm_autotune()``, which
        skips the buckets already measured)."""
        cache = AT.get_cache()
        out = []
        for node in model.graph.topo():
            if node.op not in SERVED_KINDS:
                continue
            shape = AT.node_shape(node)
            if not cache.has_bucket(node.op.value, shape, node.spec.dtype,
                                    self.backend.cache_name):
                out.append(f"{node.op.value}@{shape}: measured via "
                           f"nearest-bucket fallback, not this bucket")
        return out

    def export_artifacts(self) -> Dict[Tuple, bytes]:
        """Deploy every live bucket model (Sec. III-C); the blobs feed
        ``SolServer(deployed=...)``.  Input specs come from each program's
        graph, so the multi-input decode program exports as the others
        do."""
        from ..frontends import deploy as D
        if self.mesh is not None:
            raise RuntimeError(
                "export_artifacts: mesh-compiled bucket models hold per-shard "
                "parameters and gather across ranks, which a one-device "
                "artifact cannot replay: serve them live, or serve with "
                "mesh=(1, 1) to export")
        return {key: D.deploy(m) for key, m in self._models.items()
                if isinstance(m, SolModel)}

    # -- autotune warmup -----------------------------------------------------

    def warm_autotune(self, max_len: Optional[int] = None, *,
                      warmup: int = 1, iters: int = 3) -> Dict[str, int]:
        """Measure every admissible impl of every served-kind node, each
        ``Tunable`` space swept, for every prefill and decode bucket the
        workload (or ``max_len``) can open, into the process-wide cache
        (``autotune.get_cache()``: install another with
        ``autotune.set_cache`` before warming).  (op, shape, dtype) keys
        already measured are skipped."""
        if self._deploy_only:
            raise RuntimeError("deploy-mode serving has no live graphs to "
                               "warm; tune before deploying instead")
        cache = AT.get_cache()
        counts = {"nodes": 0, "impls": 0, "skipped": 0, "graphs": 0}
        seen = set()
        if self.mesh is not None and self.mesh.rank != 0:
            # rank 0 measures for the mesh (one card's timings elect for
            # every rank, as one controller would); the others take its
            # records, so every rank elects alike
            counts = self._share_measurements(cache, counts)
            return counts
        for g in self._warm_graphs(max_len):
            counts["graphs"] += 1
            if self.mesh is not None:
                # partition before the pipeline, as the serving compile
                # does: measurements key on per-shard shapes
                from ..distributed.sharding import shard_graph
                g = shard_graph(g, self.mesh)
            g = passes.run_pipeline(g, self.backend)
            for node in g.topo():
                if node.op not in SERVED_KINDS:
                    continue
                shape = AT.node_shape(node)
                key = (node.op.value, shape, node.spec.dtype)
                if key in seen:
                    continue
                seen.add(key)
                if cache.has_bucket(node.op.value, shape, node.spec.dtype,
                                    self.backend.cache_name):
                    counts["skipped"] += 1
                    continue
                counts["nodes"] += 1
                counts["impls"] += len(_measure_node(
                    node, self.backend, cache, self.device, warmup=warmup,
                    iters=iters))
        if self.mesh is not None:
            counts = self._share_measurements(cache, counts)
        return counts

    def _share_measurements(self, cache: AT.AutotuneCache,
                            counts: Dict[str, int]) -> Dict[str, int]:
        """Rank 0's cache and counts, broadcast to every rank of the mesh
        and merged into each rank's cache."""
        import torch.distributed as dist
        box = [(cache.to_json(), counts) if self.mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        doc, counts = box[0]
        if self.mesh.rank != 0:
            cache.merge(doc)
        return dict(counts)

    # -- reporting -----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        done = self._finished
        lat = [1e3 * (r.finished_time - r.submitted) for r in done
               if r.finished_time is not None]
        ttft = [1e3 * (r.first_token_time - r.submitted) for r in done
                if r.first_token_time is not None]
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        return {
            "mode": "decode" if self.cfg.decode else "reforward",
            "mesh": list(self.cfg.mesh),
            "device": str(self.device),
            "backend": self.backend.name,
            "requests": len(done),
            "tokens": self.stats["tokens"],
            "tokens_per_s": self.stats["tokens"] / wall if wall else 0.0,
            "steps": self.stats["steps"],
            "forwards": self.stats["forwards"],
            "dmas": self.stats["dmas"],
            "prefills": self.stats["prefills"],
            "decodes": self.stats["decodes"],
            "latency_ms": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
            "ttft_ms": {"p50": pct(ttft, 50), "p99": pct(ttft, 99)},
            "forward_ms": {p: {"p50": pct(v, 50), "n": len(v)}
                           for p, v in self.stats["forward_ms"].items()},
            "buckets": dict(self.stats["buckets"]),
            "queue": self.queue.stats(),
        }


def _measure_node(node, backend, cache: AT.AutotuneCache,
                  device: torch.device, *, warmup: int, iters: int
                  ) -> List[measure.ImplMeasurement]:
    """Time every admissible impl of one node (every tunable config)
    through the shared sweep (``core.measure.sweep_node``, the driver's
    path) on operands drawn on ``device`` in the node's dtypes.  An integer
    input (the decode program's ``lens``) takes the worst case: every row
    attends a full cache."""
    gen = torch.Generator(device).manual_seed(0)
    vals = []
    for inp in node.inputs:
        dt = TORCH_DTYPES[inp.spec.dtype]
        if not dt.is_floating_point:
            fill = (node.inputs[1].spec.shape[1]
                    if node.op is OpKind.DECODE_ATTENTION else 1)
            vals.append(torch.full(inp.spec.shape, fill, dtype=dt,
                                   device=device))
        else:
            vals.append(torch.randn(inp.spec.shape, generator=gen,
                                    device=device).to(dt))
    return measure.sweep_node(node, vals, backend, cache, warmup=warmup,
                              iters=iters)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def smoke_workload(cfg: ServeConfig, n_requests: int, gen: int,
                   seed: int = 1) -> List[Tuple[np.ndarray, int]]:
    hi = min(24, cfg.max_seq - gen - 1)    # prompts leave room to decode
    if hi <= 4:
        raise ValueError(f"gen={gen} leaves no room for prompts within "
                         f"max_seq={cfg.max_seq}")
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(4, hi)),
                          dtype=np.int32), gen) for _ in range(n_requests)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model, a few requests, elections printed, "
                         "then the strict measured-provenance leg and the "
                         "deploy round-trip leg")
    ap.add_argument("--backend", default="h100")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=6)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--no-decode", action="store_true",
                    help="serve with the full re-forward baseline")
    ap.add_argument("--json", help="write the serve summary to this path")
    ap.add_argument("--no-deploy-roundtrip", action="store_true",
                    help="skip the artifact round-trip leg of --smoke")
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL",
                    help="serve across data·model ranks (started here, "
                         "one process each; rank 0's report is printed)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through a SolFleet of N replicas with one "
                         "injected mid-stream kill, tokens checked against "
                         "an undisturbed fleet (launch/fleet.py)")
    args = ap.parse_args(argv)
    try:
        mesh = tuple(int(a) for a in args.mesh.split(","))
        if len(mesh) != 2:
            raise ValueError
    except ValueError:
        print(f"--mesh wants 'data,model' (got {args.mesh!r})",
              file=sys.stderr)
        return 2

    if args.smoke:
        cfg = ServeConfig(d_model=32, n_heads=2, n_layers=1, vocab=64,
                          max_seq=32, max_batch=4, slots=4,
                          backend=args.backend, decode=not args.no_decode,
                          mesh=mesh)
        args.requests, args.gen = min(args.requests, 6), min(args.gen, 6)
    else:
        cfg = ServeConfig(d_model=args.d_model, n_heads=args.n_heads,
                          n_layers=args.layers, vocab=args.vocab,
                          max_seq=args.max_seq, max_batch=args.max_batch,
                          slots=args.slots, backend=args.backend,
                          decode=not args.no_decode, mesh=mesh)
    if args.fleet:
        if args.fleet < 1 or mesh != (1, 1):
            print("--fleet wants N >= 1 replicas on mesh 1,1",
                  file=sys.stderr)
            return 2
        return _fleet_smoke(cfg, args.fleet,
                            max(args.requests, 4 * args.fleet), args.gen,
                            args.device)
    if mesh == (1, 1):
        return _cli(args, cfg)
    from .mesh import run_on_mesh
    dev = resolve_device(args.device)     # no card: raise before any rank
    if dev.type == "cuda":
        from ..kernels import build
        build.build_all()                 # once, before the ranks load it
    # gloo: the CPU, and ranks sharing one card (NCCL refuses two ranks on
    # one device)
    rcs = run_on_mesh(_cli_rank, *mesh, device=dev.type, dist_backend="gloo",
                      timeout_s=900, args=(args, cfg))
    return max(rcs)


def _cli_rank(mesh, args, cfg: ServeConfig) -> int:
    """One rank of ``--mesh``: the same serve on every rank, rank 0's
    report printed."""
    if mesh.rank != 0:
        sys.stdout = io.StringIO()
        args.json = None            # rank 0 writes the summary
    return _cli(args, cfg)


def _cli(args, cfg: ServeConfig) -> int:
    """The serve, then with ``--smoke`` the strict leg and (on one device)
    the deploy round-trip leg."""
    workload = smoke_workload(cfg, args.requests, args.gen)
    server = SolServer(cfg, device=args.device)
    for prompt, g in workload:
        server.submit(prompt, g)
    summary = server.run()
    server.close()
    print(f"[serve] {summary['device']} backend={summary['backend']} "
          f"mesh={summary['mesh']} mode={summary['mode']}: "
          f"{summary['requests']} requests, "
          f"{summary['tokens']} tokens in {summary['steps']} steps / "
          f"{summary['forwards']} forwards ({summary['tokens_per_s']:.1f} "
          f"tok/s, one packed copy per forward: {summary['dmas']})")
    print(f"[serve] ttft p50 = {summary['ttft_ms']['p50']:.1f} ms; buckets "
          f"{summary['buckets']}")
    for bucket, rec in sorted(server.served_elections.items()):
        for kind, impls in sorted(rec["by_op"].items()):
            print(f"[serve] bucket {bucket} {kind} → {impls}")
    if summary["dmas"] != summary["forwards"]:
        return 1
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"[serve] wrote {args.json}")
    if not args.smoke:
        return 0
    rc, strict = _strict_leg(cfg, args.device, workload, server)
    if rc or args.no_deploy_roundtrip:
        return rc
    if tuple(cfg.mesh) != (1, 1):
        print("[serve] mesh run: the deploy round-trip leg is skipped "
              "(mesh models are served live, not exported)")
        return rc
    return _deploy_leg(cfg, args.device, workload, strict)


def _fleet_smoke(cfg: ServeConfig, n_replicas: int, n_requests: int,
                 gen: int, device) -> int:
    """``--fleet N``: the workload through a ``SolFleet`` of N
    strict-provenance replicas with ONE injected mid-stream kill, then an
    undisturbed one-replica fleet on the same weights and seeds
    (``fleet.kill_replay``): every request must complete, re-queued ones
    included, with identical tokens."""
    from .fleet import kill_replay

    model = build_lm(cfg, device=resolve_device(device))
    workload = [(p, g, SamplingParams(temperature=0.8, seed=1000 + i))
                for i, (p, g) in enumerate(
                    smoke_workload(cfg, n_requests, gen))]
    t0 = time.perf_counter()
    warm = SolServer(cfg, model, device=device)
    for p, g, _ in workload:
        warm.submit(p, g)
    counts = warm.warm_autotune()
    warm.close()
    print(f"[fleet] autotune warmup on {cfg.backend}: {counts['impls']} "
          f"impl timings over {counts['nodes']} keys ({counts['skipped']} "
          f"already cached) in {time.perf_counter() - t0:.1f} s, shared by "
          f"all {n_replicas} replicas")
    s = kill_replay(cfg, model, workload, replicas=n_replicas,
                    device=device, strict_provenance=True)
    print(f"[fleet] injected kill of replica {s['killed']} at tick 2; "
          f"{s['requests']} requests, {s['tokens']} tokens over "
          f"{s['replicas']} replicas in {s['ticks']} ticks "
          f"({s['tokens_per_s']:.1f} tok/s); requeued={s['requeued']} "
          f"respawns={s['respawns']} recovery="
          f"{s['recovery_s']['max'] * 1e3:.1f} ms; served_by="
          f"{s['served_by']}")
    if s["dropped"]:
        print(f"[fleet] DROPPED requests after the kill: {s['dropped']}",
              file=sys.stderr)
        return 1
    if s["diverged"]:
        print(f"[fleet] tokens DIVERGED from the undisturbed fleet for "
              f"{s['diverged']}", file=sys.stderr)
        return 1
    print(f"[fleet] every request completed after the kill with tokens "
          f"identical to an undisturbed fleet's")
    return 0


def _strict_leg(cfg: ServeConfig, device, workload, cold
                ) -> Tuple[int, "SolServer"]:
    """The same workload on a strict-provenance server after
    ``warm_autotune``: every served election must come from measurements
    of its exact bucket, and the tokens must equal the cold server's.
    Returns the exit code and the strict server."""
    server = SolServer(cfg, model=cold.model, device=device,
                       strict_provenance=True)
    reqs = [server.submit(p, g) for p, g in workload]
    t0 = time.perf_counter()
    counts = server.warm_autotune()
    print(f"[serve] strict: autotune warmup on {cfg.backend}: "
          f"{counts['impls']} impl timings over {counts['nodes']} (op, "
          f"shape) keys of {counts['graphs']} programs ({counts['skipped']} "
          f"already cached) in {time.perf_counter() - t0:.1f} s")
    summary = server.run()
    server.close()
    failures = []
    for bucket, rec in sorted(server.served_elections.items()):
        prov = rec["provenance"]
        for kind, impls in sorted(rec["by_op"].items()):
            if kind == OpKind.FUSED.value:
                continue
            for name in impls:
                entry = prov.get(name, {})
                srcs = entry.get("sources", {})
                pins = entry.get("pinned", "")
                print(f"[serve] strict: bucket {bucket} {kind} → {name} "
                      f"sources={srcs}" + (f" pinned={pins}" if pins else ""))
                if set(srcs) - {"measured"} or not srcs:
                    failures.append(f"{bucket}:{kind}->{name}:{srcs}")
    if failures:
        print(f"[serve] unmeasured elections served: {failures}",
              file=sys.stderr)
        return 1, server
    cold_tokens = {r.rid: r.generated for r in cold._finished}
    if any(r.generated != cold_tokens[r.rid] for r in reqs):
        print("[serve] strict: tokens differ from the cold server's",
              file=sys.stderr)
        return 1, server
    print(f"[serve] strict: {summary['tokens']} tokens, every served "
          f"election measured on its exact bucket, tokens equal to the cold "
          f"server's")
    return 0, server


def _deploy_leg(cfg: ServeConfig, device, workload, live) -> int:
    """Deploy every bucket model of the strict server and replay the
    workload from the artifacts alone, under the strict audit of their
    manifests: the tokens must equal the live server's."""
    t0 = time.perf_counter()
    arts = live.export_artifacts()
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay = SolServer(cfg, deployed=arts, device=device,
                       strict_provenance=True)
    load_s = time.perf_counter() - t0
    reqs = [replay.submit(p, g) for p, g in workload]
    replay.run()
    replay.close()
    live_by_rid = {r.rid: r for r in live._finished}
    for r in reqs:
        want = live_by_rid[r.rid]
        if r.generated != want.generated:
            print(f"[serve] deploy round-trip DIVERGED for request {r.rid}: "
                  f"{r.generated} != {want.generated}", file=sys.stderr)
            return 1
    worst = max(float(np.abs(r.last_logits
                             - live_by_rid[r.rid].last_logits).max())
                for r in reqs)
    mb = sum(len(b) for b in arts.values()) / 2**20
    print(f"[serve] deploy round-trip: {len(arts)} bucket artifacts "
          f"({mb:.2f} MB, exported in {export_s:.2f} s, loaded in "
          f"{load_s:.2f} s) served {len(reqs)} requests with the live "
          f"server's tokens under the strict audit (last logits max|Δ| "
          f"{worst:.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Autotune cache and the Tunable protocol (counterpart of
``repro.core.autotune``).

The election pass (``core.passes.elect_implementations``) prefers measured
timings from this cache and falls back to the (optionally calibrated)
roofline when the cache is cold.  ``core.measure.sweep_node`` fills it: the
offline driver ``repro_torch.benchmarks.autotune`` and
``SolServer.warm_autotune`` time every admissible impl of a node, each
impl's declared :class:`Tunable` config space swept, and record the best
time with the winning config; the election re-pins that config on the node
when the measurement wins.  ``repro_torch.benchmarks.calibrate`` fits the
cache's calibration section.  The file format is the JAX package's
(schema 1).

Cache keying — (op kind, canonicalized shape bucket, dtype, backend, impl):

* shapes canonicalize to nearest-power-of-two buckets per dim;
* unseen buckets resolve by nearest-bucket lookup (L1 distance in
  log2-space among same-rank buckets);
* LINEAR/MATMUL key on (M, K, N), DECODE_ATTENTION on (B, S, H, hd) of the
  cache, every other op on its output shape.

``save`` is atomic (tmp file + ``os.replace``), and a file whose ``schema``
differs from :data:`SCHEMA_VERSION` is ignored on load (``stale=True``).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

# process-wide cache consulted by the election pass; empty unless the user
# opts in via SOL_AUTOTUNE_CACHE or set_cache()/load_cache()
_CACHE: Optional["AutotuneCache"] = None

EntryKey = Tuple[str, str, str]                  # (op, dtype, backend)
Bucket = Tuple[int, ...]
Config = Tuple[int, ...]                         # one tunable kernel config


@dataclasses.dataclass(frozen=True)
class Tunable:
    """A kernel impl's tuning declaration.

    ``attr``  — the ``node.attrs`` key configs are pinned under, one per
                kernel family (``'cuda_mm_block'``, ...).
    ``space`` — ``space(node, hw) -> [config, ...]``: candidate configs for
                one node on one ``HardwareSpec``; may be empty.
    ``bind``  — optional override of the default pin/clear behaviour.
    ``refine``— optional override of :meth:`refine_space`, the
                neighbourhood a gap-driven planner probes around a winning
                config (families whose configs must stay legal override
                it).
    """

    attr: str
    space: Callable[[object, object], Sequence[Config]]
    bind: Optional[Callable[[object, Optional[Config]], None]] = None
    refine: Optional[Callable[[object, object, Config],
                              Sequence[Config]]] = None

    def tune_space(self, node, hw) -> List[Config]:
        return [tuple(int(d) for d in cfg) for cfg in self.space(node, hw)]

    def bind_config(self, node, cfg: Optional[Config]) -> None:
        if self.bind is not None:
            self.bind(node, cfg)
        elif cfg is None:
            node.attrs.pop(self.attr, None)
        else:
            node.attrs[self.attr] = tuple(int(d) for d in cfg)

    def refine_space(self, node, hw, winning_cfg: Config) -> List[Config]:
        """Candidate configs around ``winning_cfg``, minus the winner and
        the initial ``tune_space`` (already measured).  The default probes
        every combination of halving, keeping and doubling each dimension;
        ``refine`` replaces that neighbourhood."""
        win = tuple(int(d) for d in winning_cfg)
        if self.refine is not None:
            cands = [tuple(int(d) for d in c)
                     for c in self.refine(node, hw, win)]
        else:
            axes = [sorted({max(1, d // 2), d, 2 * d}) for d in win]
            cands = [c for c in itertools.product(*axes) if c != win]
        seen = set(self.tune_space(node, hw)) | {win}
        out: List[Config] = []
        for c in cands:
            if c not in seen and all(d >= 1 for d in c):
                seen.add(c)
                out.append(c)
        return out


def bucket_dim(d: int) -> int:
    """Nearest power of two (ties round up via round-half-even on the log)."""
    if d <= 1:
        return 1
    return 2 ** int(round(math.log2(d)))


def bucket_shape(shape: Tuple[int, ...]) -> Bucket:
    return tuple(bucket_dim(int(d)) for d in shape)


def ceil_pow2(d: int) -> int:
    """Smallest power of two >= ``d`` — the serving bucket (a server pads a
    request up, never truncates it, and a power of two is its own cache
    bucket)."""
    if d <= 1:
        return 1
    return 2 ** math.ceil(math.log2(d))


def pad_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """Per-dim ``ceil_pow2`` — the shape a served batch is padded to."""
    return tuple(ceil_pow2(int(d)) for d in shape)


def node_shape(node) -> Optional[Tuple[int, ...]]:
    """The shape a node is keyed under.  LINEAR/MATMUL → (M, K, N) with
    leading batch dims folded into M; DECODE_ATTENTION → (B, S, H, hd) from
    the KV-cache operand; everything else → the output shape."""
    from .ir import OpKind
    if node.op is OpKind.DECODE_ATTENTION:
        if len(node.inputs) < 2 or len(node.spec.shape) != 4:
            return tuple(node.spec.shape) or None
        b, _one, h, hd = node.spec.shape
        s = node.inputs[1].spec.shape[1]          # k_cache is (B, S, KV, hd)
        return (b, s, h, hd)
    if node.op in (OpKind.LINEAR, OpKind.MATMUL):
        xs = node.inputs[0].spec.shape if node.inputs else ()
        if not xs or not node.spec.shape:
            return None
        m = 1
        for d in xs[:-1]:
            m *= d
        return (m, xs[-1], node.spec.shape[-1])
    return tuple(node.spec.shape) or None


@dataclasses.dataclass
class Measurement:
    us: float                                    # best measured time
    config: Optional[Tuple[int, ...]] = None     # winning tunable config
    flops: float = 0.0
    nbytes: float = 0.0
    mean_us: float = 0.0

    def to_json(self) -> dict:
        d = {"us": self.us}
        if self.config is not None:
            d["config"] = list(self.config)
        if self.flops:
            d["flops"] = self.flops
        if self.nbytes:
            d["nbytes"] = self.nbytes
        if self.mean_us:
            d["mean_us"] = self.mean_us
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Measurement":
        cfg = d.get("config")
        return cls(us=float(d["us"]),
                   config=tuple(cfg) if cfg else None,
                   flops=float(d.get("flops", 0.0)),
                   nbytes=float(d.get("nbytes", 0.0)),
                   mean_us=float(d.get("mean_us", 0.0)))


class AutotuneCache:
    """Persistent per-(op, shape bucket, dtype, backend, impl) timings."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.stale = False      # a schema-mismatched file was ignored on load
        self._entries: Dict[EntryKey, Dict[Bucket, Dict[str, Measurement]]] = {}
        self._calibration: Dict[Tuple[str, str], Dict[str, float]] = {}

    def record(self, op: str, shape: Tuple[int, ...], dtype: str,
               backend: str, impl: str, us: float, *,
               config: Optional[Tuple[int, ...]] = None,
               flops: float = 0.0, nbytes: float = 0.0,
               mean_us: float = 0.0) -> None:
        """Keep the best (lowest) time per (key, bucket, impl)."""
        per = self._entries.setdefault((op, dtype, backend), {}) \
                           .setdefault(bucket_shape(shape), {})
        prev = per.get(impl)
        if prev is None or us < prev.us:
            per[impl] = Measurement(us=float(us),
                                    config=tuple(config) if config else None,
                                    flops=float(flops), nbytes=float(nbytes),
                                    mean_us=float(mean_us))

    def lookup(self, op: str, shape: Optional[Tuple[int, ...]], dtype: str,
               backend: str) -> Dict[str, Measurement]:
        """Measurements for the exact bucket, else the nearest same-rank
        bucket (L1 in log2-space), else {}."""
        return self.lookup_with_confidence(op, shape, dtype, backend)[0]

    def lookup_with_confidence(self, op: str,
                               shape: Optional[Tuple[int, ...]], dtype: str,
                               backend: str
                               ) -> Tuple[Dict[str, Measurement], str]:
        """Like :meth:`lookup`, plus where the hit came from: ``"exact"``
        (the shape's own bucket), ``"nearest"`` (another same-rank bucket, a
        neighbourhood estimate) or ``""`` (a miss)."""
        if shape is None:
            return {}, ""
        buckets = self._entries.get((op, dtype, backend))
        if not buckets:
            return {}, ""
        want = bucket_shape(shape)
        if want in buckets:
            return dict(buckets[want]), "exact"
        same_rank = [b for b in buckets if len(b) == len(want)]
        if not same_rank:
            return {}, ""

        def dist(b: Bucket) -> float:
            return sum(abs(math.log2(x) - math.log2(y))
                       for x, y in zip(b, want))

        return dict(buckets[min(same_rank, key=dist)]), "nearest"

    def has_bucket(self, op: str, shape: Tuple[int, ...], dtype: str,
                   backend: str) -> bool:
        """Whether the EXACT bucket of ``shape`` holds measurements."""
        buckets = self._entries.get((op, dtype, backend))
        return bool(buckets) and bucket_shape(shape) in buckets

    def entries(self) -> List[Tuple[EntryKey, Bucket, str, Measurement]]:
        """Every (key, bucket, impl, measurement), sorted: what the
        calibration fit and the reports iterate."""
        out = []
        for key, buckets in sorted(self._entries.items()):
            for bucket, impls in sorted(buckets.items()):
                for impl, m in sorted(impls.items()):
                    out.append((key, bucket, impl, m))
        return out

    def __len__(self) -> int:
        return sum(len(impls) for buckets in self._entries.values()
                   for impls in buckets.values())

    def set_calibration(self, backend: str, op: str,
                        coeffs: Dict[str, float]) -> None:
        self._calibration[(backend, op)] = dict(coeffs)

    def calibration(self, backend: str, op: str) -> Optional[Dict[str, float]]:
        return self._calibration.get((backend, op))

    def calibrations(self) -> Dict[Tuple[str, str], Dict[str, float]]:
        return dict(self._calibration)

    def to_json(self) -> dict:
        entries = {}
        for (op, dtype, backend), buckets in sorted(self._entries.items()):
            for bucket, impls in sorted(buckets.items()):
                key = "|".join((op, dtype, backend,
                                "x".join(str(d) for d in bucket)))
                entries[key] = {impl: m.to_json()
                                for impl, m in sorted(impls.items())}
        calibration: Dict[str, Dict[str, dict]] = {}
        for (backend, op), coeffs in sorted(self._calibration.items()):
            calibration.setdefault(backend, {})[op] = coeffs
        return {"schema": SCHEMA_VERSION, "entries": entries,
                "calibration": calibration}

    def save(self, path: Optional[str] = None) -> str:
        """Atomic write: a tmp file in the target directory, then
        ``os.replace`` — readers never observe a torn cache."""
        path = path or self.path
        if not path:
            raise ValueError("no cache path given")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.path = path
        return path

    @classmethod
    def load(cls, path: str) -> "AutotuneCache":
        """A missing file, or one of another schema version, yields an empty
        cache (``stale=True`` for the latter) rather than an error."""
        cache = cls(path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cache
        if doc.get("schema") != SCHEMA_VERSION:
            cache.stale = True
            return cache
        cache.merge(doc)
        return cache

    def merge(self, doc: dict) -> None:
        """Take in the entries and calibrations of a :meth:`to_json`
        document, keeping the best time per (key, bucket, impl) as
        :meth:`record` does; a calibration in ``doc`` replaces this
        cache's."""
        for key, impls in doc.get("entries", {}).items():
            parts = key.split("|")
            if len(parts) != 4:
                continue
            op, dtype, backend, bucket_s = parts
            bucket = tuple(int(d) for d in bucket_s.split("x"))
            per = self._entries.setdefault((op, dtype, backend), {}) \
                               .setdefault(bucket, {})
            for impl, m in impls.items():
                m = Measurement.from_json(m)
                prev = per.get(impl)
                if prev is None or m.us < prev.us:
                    per[impl] = m
        for backend, ops in doc.get("calibration", {}).items():
            for op, coeffs in ops.items():
                self._calibration[(backend, op)] = {
                    k: float(v) for k, v in coeffs.items()}


def get_cache() -> AutotuneCache:
    """The cache the election pass consults.  Starts empty; a warm cache is
    an explicit opt-in (SOL_AUTOTUNE_CACHE, or set_cache/load_cache), so
    elections stay deterministic by default."""
    global _CACHE
    if _CACHE is None:
        path = os.environ.get("SOL_AUTOTUNE_CACHE")
        _CACHE = AutotuneCache.load(path) if path else AutotuneCache()
    return _CACHE


def set_cache(cache: Optional[AutotuneCache]) -> Optional[AutotuneCache]:
    global _CACHE
    _CACHE = cache
    return cache


def load_cache(path: str) -> AutotuneCache:
    """Load ``path`` and install it as the process-wide cache."""
    return set_cache(AutotuneCache.load(path))

"""Serving fleet: N replica ``SolServer``s behind a request router with a
watcher-driven replica lifecycle (counterpart of ``repro.launch.fleet``).

One ``SolServer`` is one *replica*; the failure domain is the replica.
:class:`SolFleet` turns N of them into one front end:

* **Router**: ``submit`` parks requests in a fleet-level queue; ``tick``
  dispatches them to the replica with the lowest score, queue depth
  (in-flight / slots) plus the replica's TTFT EWMA over the fastest one's,
  so slow replicas receive less traffic.
* **Watcher tick**: every tick steps each live replica and feeds its step
  clock into ``runtime/straggler.StragglerMonitor``.  ``rebalance`` drains
  the replica's router share (after ``drain_cooldown`` ticks it rejoins
  under fresh monitor stats); ``evict`` drains, evicts and respawns it.
  A replica's first ``join_grace`` serving steps (bucket compiles) are not
  judged, and each step clock is clamped to ``spike_clip ×`` the fleet
  baseline before it is recorded, so a one-off spike cannot evict.
* **Respawn**: replacements come up through
  ``runtime/failures.run_with_restart``, building the model from the
  fleet's checkpoint of its parameters (``checkpoint/manager``, restored
  on a bring-up failure); the warmed autotune cache is process-wide, so a
  respawned replica serves strict provenance without measuring again.
  Replica ids are never reused.
* **Re-queue**: a dead replica's in-flight requests go back to the FRONT of
  the router queue with their original ``SamplingParams``; every replica
  serves the same weights and sampling is a pure function of (logits,
  seed), so completed output is token-identical to an undisturbed run and
  nothing is dropped.
* **Autoscaling**: a backlog above ``scale_up_backlog ×`` live capacity
  for ``scale_up_ticks`` ticks spawns a replica (up to ``max_replicas``);
  a sustained empty backlog with spare capacity retires the least-loaded
  one (down to ``min_replicas``).
* **Fault injection**: ``SolFleet(failure_sim=...)`` checks a
  ``FailureSimulator`` each tick inside each replica's step, and ``kill()``
  kills a replica directly: it drops the replica object and re-queues its
  requests; no process or signal is involved.  ``kill_replay`` is the
  drill: one kill mid-stream, then the tokens against an undisturbed
  one-replica fleet's.

The replicas are in-process servers on the fleet's device, stepped in turn
by ``tick()``, which keeps the policy deterministic.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --fleet 3
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager, save_checkpoint
from ..frontends.nn import MultiHeadAttention
from ..frontends.offload import DeviceLike, resolve_device
from ..runtime.failures import (FailureSimulator, ReplicaFailure,
                                run_with_restart)
from ..runtime.straggler import StragglerMonitor
from .serve import (Request, SamplingParams, ServeConfig, SolServer,
                    build_lm, validate_prompt)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet sizing + watcher/router/autoscaler policy knobs."""

    n_replicas: int = 3            # desired size at bootstrap
    min_replicas: int = 1
    max_replicas: int = 8
    # router
    ttft_alpha: float = 0.2        # per-replica TTFT EWMA smoothing
    # straggler watcher (feeds runtime/straggler.StragglerMonitor)
    alpha: float = 0.2
    threshold: float = 2.0
    evict_threshold: float = 4.0
    warmup_steps: int = 10
    join_grace: int = 5            # a fresh replica's first serving steps
    #                                are compile warmup — not health-judged
    spike_clip: float = 5.0        # clamp a step clock to clip × the
    #                                FLEET baseline before the monitor
    drain_cooldown: int = 8        # ticks a rebalance-drain lasts
    drain_grace: int = 16          # ticks an evict-drain may take before
    #                                resident requests are re-queued
    # autoscaling: admission pressure on the fleet queue
    scale_up_backlog: float = 1.0  # backlog > factor·live·slots → pressure
    scale_up_ticks: int = 3
    scale_down_ticks: int = 10
    max_restarts: int = 10         # respawn retries (run_with_restart)

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.n_replicas
                <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= n_replicas <= max_replicas, "
                f"got {self.min_replicas}/{self.n_replicas}/"
                f"{self.max_replicas}")


@dataclasses.dataclass
class FleetRequest:
    """The router-level handle: survives replica death (the per-replica
    ``Request`` handle is replaced on re-queue, the fleet one persists)."""

    fid: int
    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingParams
    submitted: float
    replica: Optional[int] = None            # current replica id
    handle: Optional[Request] = None         # replica-level request
    generated: Optional[List[int]] = None    # set on completion
    requeues: int = 0
    first_token_time: Optional[float] = None
    finished_time: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.generated is not None


@dataclasses.dataclass
class Replica:
    """One fleet member.  ``id`` is fleet-unique and never reused — a
    respawn is a NEW member (fresh straggler stats, fresh server)."""

    id: int
    server: SolServer
    state: str = "up"              # up | draining | retiring
    drain_reason: str = ""         # rebalance | evict (while draining)
    drained_at: int = 0            # tick the drain started
    ttft_ewma: float = 0.0         # replica-local TTFT (router signal)
    serving_steps: int = 0         # steps that actually served work
    served: int = 0                # fleet requests completed here
    assigned: Dict[int, FleetRequest] = dataclasses.field(
        default_factory=dict)


class SolFleet:
    """N ``SolServer`` replicas, one router, one watcher loop."""

    def __init__(self, cfg: Optional[ServeConfig] = None,
                 fleet: Optional[FleetConfig] = None, *,
                 model=None,
                 device: DeviceLike = None,
                 strict_provenance: bool = False,
                 failure_sim: Optional[FailureSimulator] = None,
                 respawn_sim: Optional[FailureSimulator] = None,
                 restartable: Optional[
                     Callable[[BaseException], bool]] = None,
                 ckpt_dir: Optional[str] = None,
                 step_time_fn: Optional[
                     Callable[[Replica, float], float]] = None,
                 on_leave: Optional[Callable[[Replica], None]] = None):
        """``model`` gives the fleet's weights (else ``build_lm(cfg)``);
        replicas rebuild its module with its attention's KV head count.
        ``device=None`` serves on the CUDA card.  ``on_leave`` sees every
        replica as it leaves the fleet (killed, evicted, retired or closed
        with the fleet), before its server is closed."""
        self.cfg = cfg or ServeConfig()
        self.device = resolve_device(device)
        self.fleet_cfg = fleet or FleetConfig()
        self.strict_provenance = strict_provenance
        self.failure_sim = failure_sim
        self.respawn_sim = respawn_sim
        self._restartable = restartable or (
            lambda e: isinstance(e, ReplicaFailure))
        # test/benchmark hook: transform a replica's measured step clock
        # before it reaches the monitor (e.g. inflate one replica to force
        # a straggler verdict deterministically)
        self._step_time_fn = step_time_fn
        self._on_leave = on_leave
        # fleet-shared weights: every replica (and every respawn) loads
        # THIS state dict, which is what makes re-queued requests
        # token-identical wherever they land
        src = model if model is not None else build_lm(
            self.cfg, device=self.device)
        self._kv_heads = next((m.n_kv_heads for m in src.modules()
                               if isinstance(m, MultiHeadAttention)), None)
        # a host snapshot: replicas never alias the caller's tensors
        self._params = {k: v.detach().to("cpu", copy=True).numpy()
                        for k, v in src.state_dict().items()}
        self._own_ckpt_dir = ckpt_dir is None
        self._ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="sol_fleet_")
        save_checkpoint(self._ckpt_dir, 0, self._params)
        # interval is effectively ∞: run_with_restart's post-step
        # maybe_save must never try to serialize a live server object —
        # the params checkpoint written above is the restore source
        self._ckpt = CheckpointManager(self._ckpt_dir, interval=1 << 30,
                                       keep=2)
        f = self.fleet_cfg
        self.monitor = StragglerMonitor(
            0, alpha=f.alpha, threshold=f.threshold,
            evict_threshold=f.evict_threshold,
            warmup_steps=f.warmup_steps)
        self.replicas: Dict[int, Replica] = {}
        self._next_replica = 0
        self._desired = f.n_replicas
        self.pending: Deque[FleetRequest] = deque()
        self._requests: List[FleetRequest] = []
        self._next_fid = 0
        self._tick = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._pressure_up = 0
        self._pressure_down = 0
        self.events: List[Dict[str, Any]] = []
        self.stats = {"ticks": 0, "kills": 0, "respawns": 0,
                      "requeued": 0, "evicted": 0, "drained": 0,
                      "rejoined": 0, "scale_ups": 0, "scale_downs": 0}
        for _ in range(f.n_replicas):
            self._spawn(reason="bootstrap")

    # -- membership ----------------------------------------------------------

    def _build_server(self, step: int, params) -> SolServer:
        """The respawn step function (``run_with_restart``): params in,
        audited replica server out.  A bring-up failure restores params
        from the fleet checkpoint and retries; the autotune cache needs no
        restore — it is process-wide and keyed on the mesh-tagged
        ``Backend.cache_name``, so strict provenance holds without
        re-measuring."""
        m = build_lm(self.cfg, n_kv_heads=self._kv_heads, device="meta")
        m.load_state_dict({k: torch.from_numpy(v).to(self.device)
                           for k, v in params.items()}, assign=True)
        return SolServer(self.cfg, m, device=self.device,
                         strict_provenance=self.strict_provenance)

    def _spawn(self, *, reason: str) -> Replica:
        server, report = run_with_restart(
            self._build_server, self._params, 1, self._ckpt,
            failure_sim=None if reason == "bootstrap" else self.respawn_sim,
            max_restarts=self.fleet_cfg.max_restarts,
            restartable=self._restartable)
        rid = self._next_replica
        self._next_replica += 1
        rep = Replica(id=rid, server=server)
        self.replicas[rid] = rep
        self._event("spawn" if reason == "bootstrap" else "respawn",
                    replica=rid, reason=reason, restarts=report.restarts)
        if reason != "bootstrap":
            self.stats["respawns"] += 1
        return rep

    def _remove(self, rep: Replica, *, event: str, **kw) -> None:
        """Common corpse-handling: monitor id retired (stale EWMA must not
        skew the fleet baseline), server closed, membership dropped."""
        self.monitor.retire(rep.id)
        if self._on_leave is not None:
            self._on_leave(rep)
        try:
            rep.server.close()
        except Exception:
            pass                     # a dead replica's queue may be broken
        self.replicas.pop(rep.id, None)
        self._event(event, replica=rep.id, **kw)

    def _on_replica_failure(self, rep: Replica, err: BaseException) -> None:
        """Replica death: re-queue its in-flight requests at the front of
        the router queue (original ``SamplingParams`` seeds → the re-run
        is token-identical), then drop the corpse.  The watcher phase of
        the next tick respawns up to the desired size."""
        self.stats["kills"] += 1
        self._requeue_in_flight(rep)
        self._remove(rep, event="kill", error=type(err).__name__)

    def _requeue_in_flight(self, rep: Replica) -> None:
        live = [f for f in rep.assigned.values() if not f.done]
        for freq in sorted(live, key=lambda f: f.fid, reverse=True):
            freq.handle = None
            freq.replica = None
            freq.requeues += 1
            self.stats["requeued"] += 1
            self.pending.appendleft(freq)
            self._event("requeue", fid=freq.fid, from_replica=rep.id)
        rep.assigned.clear()

    def kill(self, replica_id: Optional[int] = None, *,
             error: Optional[BaseException] = None) -> int:
        """Fault injection: kill one replica (default: the busiest) as if
        its step had raised: the replica object is dropped and its
        in-flight requests re-queued.  Used by the ``--fleet`` smoke and
        the benchmark's injected-kill replay."""
        if replica_id is not None:
            rep = self.replicas.get(replica_id)
        else:
            rep = max(self.replicas.values(),
                      key=lambda r: (r.server.depth, -r.id), default=None)
        if rep is None:
            raise ValueError(f"no replica to kill (id={replica_id})")
        rid = rep.id
        self._on_replica_failure(rep, error
                                 or ReplicaFailure("injected kill"))
        return rid

    # -- router --------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None) -> FleetRequest:
        prompt = validate_prompt(self.cfg, prompt)
        freq = FleetRequest(fid=self._next_fid, prompt=prompt,
                            max_new_tokens=max(1, int(max_new_tokens)),
                            sampling=sampling or SamplingParams(),
                            submitted=time.perf_counter())
        self._next_fid += 1
        self._requests.append(freq)
        self.pending.append(freq)
        return freq

    def _routable(self) -> List[Replica]:
        return [r for r in self.replicas.values() if r.state == "up"]

    def router_score(self, rep: Replica) -> float:
        """Lower is better: normalized queue depth plus the replica's
        TTFT-EWMA excess over the fastest replica's — a straggler that the
        monitor has not yet flagged already gets organically less
        traffic."""
        depth = rep.server.depth / max(1, self.cfg.slots)
        ewmas = [r.ttft_ewma for r in self._routable() if r.ttft_ewma > 0]
        base = min(ewmas) if ewmas else 0.0
        ttft = (rep.ttft_ewma / base - 1.0) \
            if base > 0 and rep.ttft_ewma > 0 else 0.0
        return depth + ttft

    def _route(self) -> None:
        while self.pending:
            cands = [r for r in self._routable()
                     if r.server.depth < self.cfg.slots]
            if not cands:
                return               # saturated: backlog = admission pressure
            rep = min(cands, key=lambda r: (self.router_score(r), r.id))
            freq = self.pending.popleft()
            freq.handle = rep.server.submit(freq.prompt,
                                            freq.max_new_tokens,
                                            sampling=freq.sampling)
            freq.replica = rep.id
            rep.assigned[freq.fid] = freq

    def _harvest(self, rep: Replica) -> None:
        f = self.fleet_cfg
        for fid in list(rep.assigned):
            freq = rep.assigned[fid]
            h = freq.handle
            if (freq.first_token_time is None
                    and h.first_token_time is not None):
                freq.first_token_time = h.first_token_time
                # replica-LOCAL ttft (replica submit → first token) is the
                # router's speed signal, unpolluted by fleet queueing
                local = h.first_token_time - h.submitted
                rep.ttft_ewma = local if rep.ttft_ewma == 0 else \
                    (1 - f.ttft_alpha) * rep.ttft_ewma + f.ttft_alpha * local
            if h.done:
                freq.generated = list(h.generated)
                freq.finished_time = h.finished_time
                rep.served += 1
                del rep.assigned[fid]

    # -- the watcher tick ----------------------------------------------------

    def tick(self) -> List[int]:
        """One watcher tick: route → step every replica (its step clock
        feeds the straggler monitor; a restartable exception is replica
        death) → harvest → membership policy (drain/evict/respawn) →
        autoscale.  Returns the ids of replicas that served work."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._tick += 1
        self.stats["ticks"] += 1
        self._route()
        f = self.fleet_cfg
        times: Dict[int, float] = {}
        stepped: List[int] = []
        for rep in list(self.replicas.values()):
            t0 = time.perf_counter()
            try:
                if self.failure_sim is not None:
                    # a tick scheduled in the simulator kills the first
                    # replica whose step scope checks it (ids ascend)
                    self.failure_sim.check(self._tick)
                served = rep.server.step()
            except Exception as e:
                if not self._restartable(e):
                    raise
                self._on_replica_failure(rep, e)
                continue
            if served:
                dt = time.perf_counter() - t0
                if self._step_time_fn is not None:
                    dt = self._step_time_fn(rep, dt)
                rep.serving_steps += 1
                stepped.append(rep.id)
                if rep.serving_steps > f.join_grace:
                    # spike clip vs the FLEET baseline: no single sample
                    # may record above clip × fleet-normal, so a one-off
                    # compile/GC spike cannot trip an evict (one clamped
                    # sample moves the EWMA to at most 1 + α(clip-1) ×
                    # baseline, under the rebalance threshold) while a
                    # genuine straggler's EWMA still converges to its
                    # clamped ratio and crosses ``evict_threshold``.
                    base = self.monitor.baseline()
                    if f.spike_clip > 0 and base > 0:
                        dt = min(dt, f.spike_clip * base)
                    times[rep.id] = dt
            self._harvest(rep)
        if times:
            # idle replicas contribute no sample: a drained replica's ~0s
            # no-op step must not make busy replicas look like stragglers
            self.monitor.record_step(times)
        self._apply_watcher_policy()
        self._autoscale()
        self._t_last = time.perf_counter()
        return stepped

    def _apply_watcher_policy(self) -> None:
        f = self.fleet_cfg
        flags = self.monitor.flagged()
        for rep in list(self.replicas.values()):
            verdict = flags.get(rep.id)
            if rep.state == "up" and verdict in ("rebalance", "evict"):
                rep.state = "draining"
                rep.drain_reason = verdict
                rep.drained_at = self._tick
                self.stats["drained"] += 1
                self._event("drain", replica=rep.id, verdict=verdict)
            elif (rep.state == "draining"
                    and rep.drain_reason == "rebalance"):
                if verdict == "evict":
                    rep.drain_reason = "evict"   # escalate mid-drain
                    self._event("drain", replica=rep.id, verdict="evict")
                elif self._tick - rep.drained_at >= f.drain_cooldown:
                    # second chance: rejoin under FRESH monitor stats
                    # (retire + auto-register) — if it is still slow it
                    # will be re-flagged after warmup_steps samples
                    self.monitor.retire(rep.id)
                    rep.state, rep.drain_reason = "up", ""
                    self.stats["rejoined"] += 1
                    self._event("rejoin", replica=rep.id)
            if rep.state == "draining" and rep.drain_reason == "evict":
                drained = rep.server.depth == 0
                if drained or self._tick - rep.drained_at >= f.drain_grace:
                    if not drained:      # grace expired: re-queue the rest
                        self._requeue_in_flight(rep)
                    self.stats["evicted"] += 1
                    self._remove(rep, event="evict", drained=drained)
            elif rep.state == "retiring" and rep.server.depth == 0:
                self._remove(rep, event="retire")
        # converge membership toward the desired size (replaces dead and
        # evicted replicas; retiring ones no longer count)
        while len([r for r in self.replicas.values()
                   if r.state != "retiring"]) < self._desired:
            self._spawn(reason="replace")

    def _autoscale(self) -> None:
        """Admission-pressure policy: the fleet queue is what requests
        wait in when every routable replica is slot-saturated, so its
        sustained depth is the scale-up signal; a sustained empty queue
        with spare slot capacity scales down."""
        f = self.fleet_cfg
        live = self._routable()
        capacity = max(1, len(live)) * self.cfg.slots
        backlog = len(self.pending)
        in_flight = sum(r.server.depth for r in live)
        if backlog > f.scale_up_backlog * capacity:
            self._pressure_up += 1
            self._pressure_down = 0
        elif (backlog == 0 and len(live) > 1
                and in_flight <= (len(live) - 1) * self.cfg.slots // 2):
            self._pressure_down += 1
            self._pressure_up = 0
        else:
            self._pressure_up = self._pressure_down = 0
        if (self._pressure_up >= f.scale_up_ticks
                and self._desired < f.max_replicas):
            self._desired += 1
            self._pressure_up = 0
            self.stats["scale_ups"] += 1
            self._event("scale_up", desired=self._desired)
            self._spawn(reason="autoscale")
        if (self._pressure_down >= f.scale_down_ticks
                and self._desired > f.min_replicas and live):
            self._desired -= 1
            self._pressure_down = 0
            self.stats["scale_downs"] += 1
            victim = min(live, key=lambda r: (r.server.depth, -r.id))
            victim.state = "retiring"
            self._event("scale_down", replica=victim.id,
                        desired=self._desired)

    # -- driving -------------------------------------------------------------

    def run(self, max_ticks: int = 100_000) -> Dict[str, Any]:
        """Tick until every submitted request has completed."""
        start = self._tick
        while self.pending or any(r.assigned
                                  for r in self.replicas.values()):
            if self._tick - start >= max_ticks:
                raise RuntimeError(f"fleet exceeded {max_ticks} ticks with "
                                   f"requests still in flight")
            self.tick()
        return self.summary()

    def close(self) -> None:
        for rep in list(self.replicas.values()):
            if self._on_leave is not None:
                self._on_leave(rep)
            try:
                rep.server.close()
            except Exception:
                pass
        self.replicas.clear()
        self._ckpt.wait()
        if self._own_ckpt_dir:
            shutil.rmtree(self._ckpt_dir, ignore_errors=True)

    def warm_autotune(self, max_len: Optional[int] = None, *,
                      warmup: int = 1, iters: int = 3) -> Dict[str, int]:
        """Warm the election cache for every bucket the fleet workload can
        produce.  Measurements land in the process-wide autotune cache
        keyed on the (mesh-tagged) ``Backend.cache_name``, so ONE warming
        covers every replica — including any respawned later onto the same
        mesh shape, which is why respawn never re-measures."""
        if max_len is None:
            live = [fr for fr in self._requests if not fr.done]
            if not live:
                raise ValueError("no requests to derive the bucket space "
                                 "from; pass max_len explicitly")
            max_len = max(min(self.cfg.max_seq,
                              len(fr.prompt) + fr.max_new_tokens)
                          for fr in live)
        rep = next(iter(self.replicas.values()), None)
        if rep is None:
            raise RuntimeError("fleet has no replicas to warm through")
        return rep.server.warm_autotune(max_len, warmup=warmup,
                                        iters=iters)

    # -- reporting -----------------------------------------------------------

    def _event(self, kind: str, **kw) -> None:
        self.events.append({"t": time.perf_counter(), "tick": self._tick,
                            "event": kind, **kw})

    def recovery_times(self) -> List[float]:
        """Seconds from each kill/evict to the respawn that replaced it
        (event-log pairing, in order)."""
        out = []
        deaths: Deque[float] = deque()
        for ev in self.events:
            if ev["event"] in ("kill", "evict"):
                deaths.append(ev["t"])
            elif ev["event"] == "respawn" and deaths:
                out.append(ev["t"] - deaths.popleft())
        return out

    def summary(self) -> Dict[str, Any]:
        done = [fr for fr in self._requests if fr.done]
        lat = [1e3 * (fr.finished_time - fr.submitted) for fr in done
               if fr.finished_time is not None]
        ttft = [1e3 * (fr.first_token_time - fr.submitted) for fr in done
                if fr.first_token_time is not None]
        tokens = sum(len(fr.generated) for fr in done)
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        recov = self.recovery_times()
        return {
            "replicas": len(self.replicas),
            "desired": self._desired,
            "requests": len(done),
            "in_flight": len(self._requests) - len(done),
            "tokens": tokens,
            "tokens_per_s": tokens / wall if wall else 0.0,
            "ticks": self.stats["ticks"],
            "latency_ms": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
            "ttft_ms": {"p50": pct(ttft, 50), "p99": pct(ttft, 99)},
            "requeued": self.stats["requeued"],
            "kills": self.stats["kills"],
            "evicted": self.stats["evicted"],
            "respawns": self.stats["respawns"],
            "drained": self.stats["drained"],
            "rejoined": self.stats["rejoined"],
            "scale_ups": self.stats["scale_ups"],
            "scale_downs": self.stats["scale_downs"],
            "recovery_s": {"max": max(recov) if recov else 0.0,
                           "events": len(recov)},
            "served_by": {r.id: r.served
                          for r in self.replicas.values()},
        }


def kill_replay(cfg: ServeConfig, model, workload: Sequence[Tuple[
        Sequence[int], int, SamplingParams]], *, replicas: int = 3,
                kill_at_tick: int = 2, rate: int = 0, verify: bool = True,
                device: DeviceLike = None, strict_provenance: bool = False,
                on_leave: Optional[Callable[[Replica], None]] = None
                ) -> Dict[str, Any]:
    """The fleet's fault drill: ``workload`` ((prompt, max_new_tokens,
    sampling) triples) through a fixed-size fleet of ``replicas`` on
    ``model``'s weights, ``rate`` arrivals a watcher tick (0: all at
    once), one replica killed once ``kill_at_tick`` ticks have run; with
    ``verify``, the same workload again through an undisturbed one-replica
    fleet.  Returns the drilled fleet's ``summary`` plus ``killed`` (the
    replica id), ``dropped`` (fids that never completed) and ``diverged``
    (fids whose tokens differ from the undisturbed fleet's; None without
    ``verify``).  ``on_leave`` goes to both fleets."""

    def replay(n: int, kill: bool):
        fleet = SolFleet(cfg, FleetConfig(n_replicas=n, min_replicas=n,
                                          max_replicas=n),
                         model=model, device=device,
                         strict_provenance=strict_provenance,
                         on_leave=on_leave)
        try:
            todo, reqs, killed = deque(workload), [], None
            while todo or (kill and killed is None):
                for _ in range(min(rate or len(todo), len(todo))):
                    p, g, sp = todo.popleft()
                    reqs.append(fleet.submit(p, g, sampling=sp))
                if (kill and killed is None
                        and fleet.stats["ticks"] >= kill_at_tick):
                    killed = fleet.kill()
                fleet.tick()
            summary = fleet.run()
        finally:
            fleet.close()
        return reqs, summary, killed

    reqs, summary, killed = replay(replicas, kill=True)
    diverged = None
    if verify:
        base, _, _ = replay(1, kill=False)
        diverged = [r.fid for r, b in zip(reqs, base)
                    if r.generated != b.generated]
    return {**summary, "killed": killed,
            "dropped": [r.fid for r in reqs if r.generated is None],
            "diverged": diverged}

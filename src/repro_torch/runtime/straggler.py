"""Straggler detection (counterpart of ``repro.runtime.straggler``).

The monitor tracks a rolling per-step latency per host (an EWMA) and flags
hosts whose EWMA exceeds ``threshold ×`` the fleet baseline: ``rebalance``
(shrink the host's share) or, past ``evict_threshold``, ``evict`` (treat
it as failed).  Membership is dynamic: ``record_step`` registers host ids
it has not seen (a respawned or autoscaled replica arrives with a fresh
id), and ``retire`` drops an evicted host so its stale EWMA stops skewing
the baseline.

``launch/fleet.SolFleet`` drives it as its per-replica health watcher:
each watcher tick feeds every replica's step clock into ``record_step``;
``rebalance`` drains the replica's router share, ``evict`` drains, evicts
and respawns it.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List


@dataclasses.dataclass
class HostStats:
    ewma: float = 0.0
    steps: int = 0


class StragglerMonitor:
    def __init__(self, n_hosts: int = 0, *, alpha: float = 0.2,
                 threshold: float = 1.5, evict_threshold: float = 3.0,
                 warmup_steps: int = 5):
        self.hosts: Dict[int, HostStats] = {
            i: HostStats() for i in range(n_hosts)}
        self.alpha = alpha
        self.threshold = threshold
        self.evict_threshold = evict_threshold
        self.warmup = warmup_steps
        self.history: List[Dict[int, float]] = []

    def record_step(self, times: Dict[int, float]) -> None:
        """Fold one step's per-host clocks into the EWMAs, registering
        unknown host ids on first sight."""
        self.history.append(dict(times))
        for h, t in times.items():
            st = self.hosts.setdefault(h, HostStats())
            st.ewma = t if st.steps == 0 else \
                (1 - self.alpha) * st.ewma + self.alpha * t
            st.steps += 1

    def retire(self, host: int) -> None:
        """Forget a host: its EWMA stops feeding the baseline, and a later
        registration under the same id starts fresh (unknown ids: no-op)."""
        self.hosts.pop(host, None)

    def baseline(self) -> float:
        """Robust fleet baseline: the lower quartile of host EWMAs (the
        median is dragged up when several hosts straggle).  The fleet
        watcher clips raw step clocks against it before recording."""
        vals = sorted(s.ewma for s in self.hosts.values() if s.steps > 0)
        if not vals:
            return 0.0
        if len(vals) < 4:
            return vals[0]
        return statistics.quantiles(vals, n=4)[0]

    def flagged(self) -> Dict[int, str]:
        """host -> 'rebalance' | 'evict'."""
        med = self.baseline()
        out: Dict[int, str] = {}
        if med <= 0:
            return out
        for h, st in self.hosts.items():
            if st.steps < self.warmup:
                continue
            r = st.ewma / med
            if r >= self.evict_threshold:
                out[h] = "evict"
            elif r >= self.threshold:
                out[h] = "rebalance"
        return out

    def microbatch_shares(self, base: int = 1) -> Dict[int, float]:
        """Work shares inversely proportional to EWMA latency (bounded to
        [0.5, 1]); a host with no samples or a zero EWMA keeps the full
        share."""
        med = self.baseline()
        shares = {}
        for h, st in self.hosts.items():
            if st.steps == 0 or med == 0 or st.ewma <= 0:
                shares[h] = 1.0
            else:
                shares[h] = max(0.5, min(1.0, med / st.ewma))
        return shares

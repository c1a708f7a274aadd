"""Replica failures and checkpoint/restart (counterpart of
``repro.runtime.failures``).

``run_with_restart`` drives a step function through failures: on a
*restartable* failure the state is restored from the last checkpoint and
the run resumes from the restored step.  What counts as restartable is a
property of the exception TYPE, not its message: anything raising
:class:`ReplicaFailure` (or passing an injected ``restartable=``
predicate) takes the restore path; everything else propagates.

Serving: ``launch/fleet.SolFleet`` treats a restartable exception out of
a replica's step as replica death, re-queues the replica's in-flight
requests (with their original sampling seeds, so completed output is
token-identical to an undisturbed run) and respawns the replica through
``run_with_restart`` from the fleet's checkpoint of the model's
parameters.  The autotune cache needs no restore: it is process-wide and
keyed on the (mesh-tagged) backend name, so a respawned replica re-enters
strict-provenance serving without measuring again.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, List, Optional, Tuple


class ReplicaFailure(RuntimeError):
    """A replica died: injected by :class:`FailureSimulator`, or raised by
    a real failure path (device loss, out of memory, a collective timing
    out).  Restart logic keys on this TYPE."""


@dataclasses.dataclass
class RestartReport:
    total_steps: int
    restarts: int
    recovered_steps: List[int]


class FailureSimulator:
    """Deterministic injected failures for testing restart logic.

    A step fires AT MOST ONCE over the simulator's lifetime, whichever path
    triggers it: a scheduled step is consumed when it fires, and a
    probabilistic (``p_fail``) firing consumes the step too, so a replayed
    step never fails again."""

    def __init__(self, fail_at_steps: Optional[List[int]] = None,
                 p_fail: float = 0.0, seed: int = 0):
        self.fail_at = set(fail_at_steps or [])
        self.p = p_fail
        self.rng = random.Random(seed)
        self.failures: List[int] = []
        self._fired: set = set()

    def check(self, step: int) -> None:
        if step in self._fired:
            return
        if step in self.fail_at or (self.p and self.rng.random() < self.p):
            self.fail_at.discard(step)
            self._fired.add(step)
            self.failures.append(step)
            raise ReplicaFailure(f"injected node failure at step {step}")


def _default_restartable(e: BaseException) -> bool:
    return isinstance(e, ReplicaFailure)


def run_with_restart(step_fn: Callable[[int, Any], Any],
                     init_state: Any,
                     n_steps: int,
                     ckpt,                       # CheckpointManager
                     failure_sim: Optional[FailureSimulator] = None,
                     max_restarts: int = 10,
                     restartable: Optional[
                         Callable[[BaseException], bool]] = None
                     ) -> Tuple[Any, RestartReport]:
    """Run ``state = step_fn(step, state)`` for ``n_steps`` with
    checkpointing and restart on failure.  ``restartable`` decides which
    exceptions take the restore path (default: ``isinstance(e,
    ReplicaFailure)``); others propagate unchanged."""
    state = init_state
    step = 0
    restarts = 0
    recovered: List[int] = []
    is_restartable = restartable or _default_restartable
    while step < n_steps:
        try:
            if failure_sim is not None:
                failure_sim.check(step)
            state = step_fn(step, state)
            step += 1
            ckpt.maybe_save(step, state)
        except Exception as e:
            if not is_restartable(e) or restarts >= max_restarts:
                raise
            restarts += 1
            ckpt.wait()
            restored_step, restored = ckpt.restore_latest(state)
            if restored is None:
                state, step = init_state, 0
            else:
                state, step = restored, restored_step
            recovered.append(step)
    ckpt.wait()
    return state, RestartReport(step, restarts, recovered)

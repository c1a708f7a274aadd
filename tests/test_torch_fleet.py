"""The port's serving fleet and fault tolerance on the CPU, as
``tests/test_fleet.py`` and ``tests/test_fault_tolerance.py`` hold the JAX
package's: a mid-stream kill keeps every request's tokens identical to an
undisturbed run, respawns go through ``run_with_restart``, the watcher
evicts a sustained straggler (and not a one-off spike), admission pressure
scales the fleet; checkpoints round-trip, publish atomically, keep the last
k, refuse a shape mismatch, and interchange with the JAX package's in both
directions.  A kill drops a replica object: no process or signal is
involved."""
import multiprocessing
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.benchmarks import serving
from repro_torch.core import autotune as AT
from repro_torch.frontends.offload import NoDeviceError
from repro_torch.launch import serve as tserve
from repro_torch.launch.fleet import FleetConfig, SolFleet, kill_replay
from repro_torch.launch.serve import SamplingParams, ServeConfig, build_lm
from repro_torch.runtime import (FailureSimulator, ReplicaFailure,
                                 StragglerMonitor, run_with_restart)


def tiny_cfg(**kw) -> ServeConfig:
    base = dict(d_model=32, n_heads=2, n_layers=1, vocab=64, max_seq=32,
                max_batch=4, slots=6, backend="h100")
    base.update(kw)
    return ServeConfig(**base)


def workload(cfg, n, gen=4, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(4, 12)),
                          dtype=np.int32), gen,
             SamplingParams(temperature=0.8, seed=1000 + i))
            for i in range(n)]


def fleet(cfg, fleet_cfg, **kw) -> SolFleet:
    return SolFleet(cfg, fleet_cfg, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _local_cache():
    prev = AT._CACHE
    AT.set_cache(AT.AutotuneCache())
    yield
    AT.set_cache(prev)


# ---------------------------------------------------------------------------
# kill → re-queue → token identity
# ---------------------------------------------------------------------------

def test_fleet_kill_midstream_token_identical():
    """Kill the busiest replica mid-stream: every request completes and the
    tokens equal an undisturbed one-replica run's on the same weights."""
    cfg = tiny_cfg()
    model = build_lm(cfg, device="cpu")
    work = workload(cfg, 12)
    f = fleet(cfg, FleetConfig(n_replicas=3), model=model)
    reqs = [f.submit(p, g, sampling=sp) for p, g, sp in work]
    f.tick()
    f.tick()
    killed = f.kill()
    s = f.run()
    f.close()
    assert all(r.done for r in reqs)
    assert s["requeued"] >= 1 and s["kills"] == 1 and s["respawns"] == 1
    assert killed not in {ev.get("replica") for ev in f.events
                          if ev["event"] == "respawn"}
    assert sum(r.requeues for r in reqs) == s["requeued"]
    assert f.recovery_times() and s["recovery_s"]["events"] == 1

    base = fleet(cfg, FleetConfig(n_replicas=1), model=model)
    breqs = [base.submit(p, g, sampling=sp) for p, g, sp in work]
    base.run()
    base.close()
    assert [r.generated for r in reqs] == [b.generated for b in breqs]
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("rate", [0, 2])
def test_kill_replay_drill(rate):
    """The drill the serve CLI, the benchmark rows and the card smoke
    share: one kill mid-stream (all requests at once, or arriving ``rate``
    a tick), no drops, tokens equal the undisturbed fleet's, and every
    replica of both fleets (the killed one and the respawn included) is
    seen leaving, with the bucket models it compiled."""
    cfg = tiny_cfg()
    model = build_lm(cfg, device="cpu")
    left = []

    def on_leave(rep):
        left.append((rep.id, sorted(rep.server._models)))

    s = kill_replay(cfg, model, workload(cfg, 12), replicas=3,
                    kill_at_tick=2, rate=rate, device="cpu",
                    on_leave=on_leave)
    assert s["dropped"] == [] and s["diverged"] == []
    assert s["kills"] == 1 and s["respawns"] == 1 and s["requeued"] >= 1
    assert s["requests"] == 12
    # the drilled fleet's 3 replicas and its respawn, then the baseline's 1
    assert [i for i, _ in left][-1] == 0 and len(left) == 5
    seen = dict(left[:-1])
    assert seen[s["killed"]] and left[-1][1]   # both served before leaving
    assert not multiprocessing.active_children()


def test_fleet_respawn_goes_through_run_with_restart():
    cfg = tiny_cfg()
    f = fleet(cfg, FleetConfig(n_replicas=2),
              respawn_sim=FailureSimulator(fail_at_steps=[0]))
    reqs = [f.submit(p, g, sampling=sp) for p, g, sp in workload(cfg, 6)]
    f.tick()
    f.kill()
    f.run()
    f.close()
    assert all(r.done for r in reqs)
    respawns = [ev for ev in f.events if ev["event"] == "respawn"]
    assert len(respawns) == 1 and respawns[0]["restarts"] == 1


def test_fleet_failure_sim_kills_inside_a_replica_step():
    cfg = tiny_cfg()
    f = fleet(cfg, FleetConfig(n_replicas=2),
              failure_sim=FailureSimulator(fail_at_steps=[2]))
    reqs = [f.submit(p, g, sampling=sp) for p, g, sp in workload(cfg, 6)]
    s = f.run()
    f.close()
    assert all(r.done for r in reqs)
    assert s["kills"] == 1 and s["respawns"] == 1


def test_fleet_replicas_serve_the_model_weights():
    """Every replica, the respawn included, serves the fleet's weights: a
    GQA model (2 KV heads of 4) keeps its shape through the checkpoint."""
    cfg = tiny_cfg(n_heads=4)
    model = build_lm(cfg, n_kv_heads=2, device="cpu")
    f = fleet(cfg, FleetConfig(n_replicas=2), model=model)
    f.kill(0)
    f.tick()
    want = model.state_dict()
    for rep in f.replicas.values():
        got = rep.server.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    f.close()


# ---------------------------------------------------------------------------
# watcher: evict → respawn without re-measuring
# ---------------------------------------------------------------------------

def test_monitor_evict_respawns_without_rewarming(monkeypatch):
    from repro_torch.core import measure

    cfg = tiny_cfg()
    fleet_cfg = FleetConfig(n_replicas=3, warmup_steps=2, join_grace=0,
                            spike_clip=0.0, drain_cooldown=2, drain_grace=4)

    def slow_replica_0(rep, dt):
        return 100.0 if rep.id == 0 else 1.0

    f = fleet(cfg, fleet_cfg, strict_provenance=True,
              step_time_fn=slow_replica_0)
    reqs = [f.submit(p, g, sampling=sp)
            for p, g, sp in workload(cfg, 16, gen=6)]
    f.warm_autotune()

    def no_more_measuring(*a, **kw):
        raise AssertionError("respawn re-measured: sweep_node called "
                             "after warm_autotune")
    monkeypatch.setattr(measure, "sweep_node", no_more_measuring)
    s = f.run()
    f.close()
    assert all(r.done for r in reqs)
    assert s["evicted"] >= 1 and s["respawns"] >= 1
    assert 0 not in f.replicas
    evs = [ev["event"] for ev in f.events if ev.get("replica") == 0]
    assert "drain" in evs and "evict" in evs


def test_one_off_spike_does_not_evict():
    cfg = tiny_cfg()
    spiked = []

    def spike_once(rep, dt):
        if rep.id == 0 and rep.serving_steps >= 2 and not spiked:
            spiked.append(rep.id)
            return 1000.0
        return 1.0

    f = fleet(cfg, FleetConfig(n_replicas=3, join_grace=1, warmup_steps=2),
              step_time_fn=spike_once)
    reqs = [f.submit(p, g, sampling=sp)
            for p, g, sp in workload(cfg, 16, gen=6)]
    s = f.run()
    f.close()
    assert all(r.done for r in reqs)
    assert spiked == [0]
    assert s["drained"] == 0 and s["evicted"] == 0 and s["respawns"] == 0


def test_admission_pressure_scales_up_then_down():
    cfg = tiny_cfg(max_batch=2, slots=3)
    f = fleet(cfg, FleetConfig(n_replicas=1, min_replicas=1, max_replicas=3,
                               scale_up_ticks=2, scale_down_ticks=3))
    reqs = [f.submit(p, g, sampling=sp) for p, g, sp in workload(cfg, 30)]
    f.run()
    assert all(r.done for r in reqs)
    assert f.stats["scale_ups"] >= 1 and len(f.replicas) >= 2
    for _ in range(20):
        f.tick()
    f.close()
    assert f.stats["scale_downs"] >= 1


@pytest.mark.parametrize("kw", [dict(n_replicas=2, min_replicas=3),
                                dict(n_replicas=5, max_replicas=4),
                                dict(n_replicas=0)])
def test_fleet_config_validates_sizing(kw):
    with pytest.raises(ValueError):
        FleetConfig(**kw)


def test_serve_cli_fleet_smoke():
    assert tserve.main(["--smoke", "--device", "cpu", "--fleet", "3"]) == 0


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    """The fleet's and the mesh's entry points run on the card unless
    asked for the CPU; with no card they raise before any work."""
    from repro_torch.launch import mesh as tmesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        SolFleet(tiny_cfg(), FleetConfig(n_replicas=1))
    with pytest.raises(NoDeviceError):
        serving.fleet_rows()
    with pytest.raises(NoDeviceError):
        serving.mesh_scaling_rows()
    for argv in (["--smoke", "--fleet", "2"], ["--smoke", "--mesh", "2,2"]):
        with pytest.raises(NoDeviceError):
            tserve.main(argv)
    with pytest.raises(NoDeviceError):
        tmesh.run_on_mesh(print, 2, 1, device="cuda", dist_backend="gloo")
    assert not multiprocessing.active_children()


def test_fleet_removes_its_own_checkpoint_dir():
    f = fleet(tiny_cfg(), FleetConfig(n_replicas=1))
    d = f._ckpt_dir
    assert latest_step(d) == 0
    f.close()
    assert not os.path.exists(d)


# ---------------------------------------------------------------------------
# checkpoints and restart
# ---------------------------------------------------------------------------

def _state(x=0.0):
    return {"w": torch.full((4, 4), x), "opt": {"m": torch.zeros((4, 4))},
            "step": torch.tensor(0)}


def test_checkpoint_roundtrip(tmp_path):
    s = {"a": torch.arange(12.0).reshape(3, 4),
         "nested": {"b": torch.ones((2,), dtype=torch.int32)},
         "c": np.arange(3, dtype=np.int64), "h": torch.ones(2).bfloat16()}
    save_checkpoint(str(tmp_path), 5, s)
    like = {"a": torch.empty(3, 4), "nested": {"b": torch.empty(
        2, dtype=torch.int32)}, "c": np.zeros(3, np.int64),
        "h": torch.empty(2, dtype=torch.bfloat16)}
    r = restore_checkpoint(str(tmp_path), like)
    assert torch.equal(r["a"], s["a"])
    assert torch.equal(r["nested"]["b"], s["nested"]["b"])
    np.testing.assert_array_equal(r["c"], s["c"])
    assert r["h"].dtype == torch.bfloat16 and torch.equal(r["h"], s["h"])


def test_checkpoint_manifest_last_atomicity(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state(1.0))
    (tmp_path / "step_00000099.tmp").mkdir()
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_gc_keeps_last_k(tmp_path):
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), step, _state(step), keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2 and steps[-1] == "step_00000005"


def test_restore_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"w": torch.empty(3, 3)})


def test_checkpoint_manager_saves_async_and_restores(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), interval=2, keep=2)
    assert not ckpt.maybe_save(1, _state(1.0))
    state = _state(2.0)
    assert ckpt.maybe_save(2, state)
    state["w"] += 5.0                 # after the snapshot: not in the file
    ckpt.wait()
    step, r = ckpt.restore_latest(_state())
    assert step == 2 and ckpt.saved_steps == [2]
    assert torch.equal(r["w"], torch.full((4, 4), 2.0))


def _jax_tree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "nested": {"b": jnp.ones((2,), jnp.int32)},
            "list": [jnp.full((2, 2), 3.0), jnp.zeros((1,))]}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _jax_tree()
    jckpt.save_checkpoint(str(tmp_path), 3, tree)
    like = {"a": torch.empty(3, 4), "nested": {"b": torch.empty(
        2, dtype=torch.int32)}, "list": [torch.empty(2, 2), torch.empty(1)]}
    r = restore_checkpoint(str(tmp_path), like)
    np.testing.assert_array_equal(r["a"].numpy(), np.asarray(tree["a"]))
    np.testing.assert_array_equal(r["nested"]["b"].numpy(),
                                  np.asarray(tree["nested"]["b"]))
    for got, want in zip(r["list"], tree["list"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _jax_tree()
    save_checkpoint(str(tmp_path), 4, {
        "a": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones((2,), dtype=torch.int32)},
        "list": [torch.full((2, 2), 3.0), torch.zeros((1,))]})
    r = jckpt.restore_checkpoint(str(tmp_path), jax.eval_shape(lambda: tree))
    for got, want in zip(jax.tree.leaves(r), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert jckpt.latest_step(str(tmp_path)) == 4


def test_run_with_restart_recovers(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), interval=5, keep=3)
    trace = []

    def step_fn(step, state):
        trace.append(step)
        return {**state, "w": state["w"] + 1.0,
                "step": torch.tensor(step + 1)}

    sim = FailureSimulator(fail_at_steps=[7, 13])
    final, report = run_with_restart(step_fn, _state(), 20, ckpt, sim)
    assert report.restarts == 2 and report.total_steps == 20
    assert set(range(20)).issubset(set(trace))
    assert all(s % 5 == 0 for s in report.recovered_steps)
    assert float(final["w"].mean()) == 20.0


def test_restart_gates_on_exception_type_not_message(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), interval=2, keep=2)
    died = []

    def step_fn(step, state):
        if step == 3 and not died:
            died.append(step)
            raise ReplicaFailure("device lost: mesh shard 3 unreachable")
        return {**state, "w": state["w"] + 1.0}

    _, report = run_with_restart(step_fn, _state(), 6, ckpt)
    assert report.restarts == 1 and report.total_steps == 6
    assert died == [3]


def test_restart_respects_injected_restartable_predicate(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), interval=2, keep=2)
    died = []

    def step_fn(step, state):
        if step == 2 and not died:
            died.append(step)
            raise TimeoutError("collective timed out")
        return state

    _, report = run_with_restart(
        step_fn, _state(), 5, ckpt,
        restartable=lambda e: isinstance(e, (ReplicaFailure, TimeoutError)))
    assert report.restarts == 1


def test_restart_propagates_non_restartable(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), interval=2, keep=2)

    def step_fn(step, state):
        if step == 2:
            raise ValueError("NaN loss")
        return state

    with pytest.raises(ValueError, match="NaN loss"):
        run_with_restart(step_fn, _state(), 5, ckpt)


def test_failure_simulator_fires_each_step_at_most_once(tmp_path):
    sim = FailureSimulator(fail_at_steps=[3], p_fail=1.0, seed=0)
    ckpt = CheckpointManager(str(tmp_path), interval=1, keep=2)
    _, report = run_with_restart(lambda s, st: st, _state(), 6, ckpt,
                                 failure_sim=sim, max_restarts=10)
    assert report.total_steps == 6
    assert sorted(sim.failures) == [0, 1, 2, 3, 4, 5]
    assert report.restarts == 6
    sim2 = FailureSimulator(fail_at_steps=[2], p_fail=1.0, seed=0)
    with pytest.raises(ReplicaFailure):
        sim2.check(2)
    sim2.check(2)


def test_failure_simulator_matches_jax():
    """The same seed draws the same failures in both packages."""
    from repro.runtime import FailureSimulator as JaxSim
    fired = []
    for sim in (FailureSimulator(p_fail=0.3, seed=7), JaxSim(p_fail=0.3,
                                                               seed=7)):
        for step in range(40):
            try:
                sim.check(step)
            except Exception:
                pass
        fired.append(sim.failures)
    assert fired[0] == fired[1] and fired[0]


# ---------------------------------------------------------------------------
# the straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_and_rebalances():
    mon = StragglerMonitor(n_hosts=4, warmup_steps=3)
    for _ in range(10):
        mon.record_step({0: 1.0, 1: 1.05, 2: 1.9, 3: 4.0})
    flags = mon.flagged()
    assert flags.get(2) == "rebalance" and flags.get(3) == "evict"
    assert 0 not in flags and 1 not in flags
    shares = mon.microbatch_shares()
    assert shares[3] < shares[0]


def test_straggler_auto_registers_unknown_hosts():
    mon = StragglerMonitor(warmup_steps=2)
    mon.record_step({7: 1.0, 42: 1.1})
    assert set(mon.hosts) == {7, 42}
    for _ in range(5):
        mon.record_step({7: 1.0, 42: 1.0, 43: 6.0})
    assert mon.flagged().get(43) == "evict"


def test_straggler_retire_drops_stale_stats():
    mon = StragglerMonitor(n_hosts=3, warmup_steps=2)
    for _ in range(5):
        mon.record_step({0: 1.0, 1: 1.0, 2: 9.0})
    assert mon.flagged().get(2) == "evict"
    mon.retire(2)
    assert 2 not in mon.hosts and 2 not in mon.flagged()
    mon.retire(99)
    mon.record_step({0: 1.0, 1: 1.0, 2: 1.0})
    assert mon.hosts[2].steps == 1 and mon.hosts[2].ewma == 1.0


def test_straggler_zero_ewma_keeps_full_share():
    mon = StragglerMonitor(n_hosts=2)
    mon.record_step({0: 0.0, 1: 1.0})
    shares = mon.microbatch_shares()
    assert shares[0] == 1.0 and 0.5 <= shares[1] <= 1.0


def test_straggler_monitor_matches_jax():
    from repro.runtime import StragglerMonitor as JaxMonitor
    rng = np.random.default_rng(0)
    steps = [{h: float(rng.uniform(0.5, 1.5) * (4 if h == 5 else 1))
              for h in range(6)} for _ in range(12)]
    a, b = StragglerMonitor(warmup_steps=3), JaxMonitor(warmup_steps=3)
    for t in steps:
        a.record_step(t)
        b.record_step(t)
    assert a.flagged() == b.flagged()
    assert a.baseline() == b.baseline()
    assert a.microbatch_shares() == b.microbatch_shares()

"""The backbone trainer's data pipeline, input specs and driver, on the CPU.

* ``data.SyntheticTokenDataset`` batches equal the JAX package's exactly
  (both draw from ``default_rng(SeedSequence([seed, step, sample]))``);
  the prefetching ``DataLoader`` yields them in step order from
  ``start_step`` and stops its thread on ``close``.
* ``launch.specs``' meta-tensor stand-ins have the shapes and dtypes of
  JAX's ``ShapeDtypeStruct``s for every config and shape cell.
* The port's versions of the JAX package's end-to-end training tests
  (``tests/test_system.py``): the loss falls on four families, two and
  four microbatches track the single batch, bf16 gradient compression
  trains, and a checkpoint restores the state to continue from.
* ``python -m repro_torch.launch.train`` without ``--sol``: trains and
  prints "improved" on the CPU, raises ``NoDeviceError`` without
  ``--device`` on a machine with no card, resumes from its checkpoint
  (a resumed run ends on the loss of an uninterrupted one, within 1e-5
  relative), and refuses the production mesh naming what waits.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke as jget_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenDataset as JSyntheticTokenDataset
from repro.launch import specs as JSP
from repro.models.config import SHAPES as JSHAPES
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data import (DataConfig, DataLoader, SyntheticTokenDataset,
                              make_batch_shapes)
from repro_torch.distributed.steps import (StepOptions, init_train_state,
                                           make_train_step)
from repro_torch.launch import specs as TSP
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import backbone as TB
from repro_torch.models.config import SHAPES

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these steps are many small ops, and torch's
    default thread count in each of several test workers oversubscribes
    the cores (a 12-step RWKV6 run took 80 s instead of 2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the data pipeline ------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 512, 32, 4),
                                                  (7, 151936, 129, 3)])
def test_synthetic_batches_equal_jax(seed, vocab, seq, batch):
    t = SyntheticTokenDataset(DataConfig(seed=seed, vocab=vocab, seq_len=seq,
                                         global_batch=batch))
    j = JSyntheticTokenDataset(JDataConfig(seed=seed, vocab=vocab,
                                           seq_len=seq, global_batch=batch))
    for step in (0, 1, 17):
        got, want = t.batch(step), j.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == np.int32 == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(t.batch(0)["tokens"], t.batch(1)["tokens"])


def test_loader_prefetches_in_step_order_from_its_start():
    ds = SyntheticTokenDataset(DataConfig(vocab=100, seq_len=8,
                                          global_batch=2, prefetch=2))
    loader = DataLoader(ds, start_step=5, extras={"tag": 1})
    try:
        for step in (5, 6, 7):
            b = next(loader)
            np.testing.assert_array_equal(b["tokens"],
                                          ds.batch(step)["tokens"])
            assert b["tag"] == 1 and loader.step == step + 1
    finally:
        loader.close()
    assert not loader._thread.is_alive()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    jc, tc = jget_smoke(arch), get_smoke(arch)
    got = TSP.input_specs(tc, SHAPES[shape])
    want = JSP.input_specs(jc, JSHAPES[shape])

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k],
                                                          prefix + (k,))]
        if isinstance(tree, (tuple, list)):
            return [x for i, v in enumerate(tree) for x in flat(v,
                                                                prefix + (i,))]
        return [(prefix, tuple(tree.shape), str(tree.dtype).replace(
            "torch.", ""))]
    assert flat(got) == flat(want)
    assert TSP.cell_is_applicable(tc, SHAPES[shape])[0] == \
        JSP.cell_is_applicable(jc, JSHAPES[shape])[0]
    if SHAPES[shape].kind == "train":
        assert flat(make_batch_shapes(tc, SHAPES[shape])) == \
            flat(want["batch"])


# -- training (the port's versions of tests/test_system.py's) -----------------

def _run_training(arch, steps=12, microbatch=1, compression="none"):
    cfg = get_smoke(arch)
    opts = StepOptions(remat=False, microbatch=microbatch,
                       grad_compression=compression, zero=False,
                       lr=3e-3, warmup=2, total_steps=steps)
    step_fn, _ = make_train_step(make_debug_mesh(1, 1, device="cpu"), cfg,
                                 opts)
    state = init_train_state(cfg, opts, torch.Generator().manual_seed(0),
                             "cpu")
    ds = SyntheticTokenDataset(DataConfig(seed=0, vocab=cfg.vocab,
                                          seq_len=32, global_batch=4))
    losses = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    return losses


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "olmoe-1b-7b"])
def test_training_improves_loss(arch):
    losses = _run_training(arch)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_microbatch_accumulation_consistent():
    """Gradient accumulation (4 microbatches) tracks the single batch."""
    l1 = _run_training("qwen2-1.5b", steps=8, microbatch=1)
    l4 = _run_training("qwen2-1.5b", steps=8, microbatch=4)
    assert all(np.isfinite(l4))
    assert abs(l1[0] - l4[0]) < 1e-5 * abs(l1[0])   # the same first loss
    assert np.mean(l4[-2:]) < l4[0]


def test_bf16_grad_compression_trains():
    losses = _run_training("qwen2-1.5b", steps=8, compression="bf16")
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_checkpoint_resume_training(tmp_path):
    """Stop training mid-way, restore, continue: the restored state equals
    the saved one and the next step's loss is finite."""
    cfg = get_smoke("qwen2-1.5b")
    opts = StepOptions(remat=False, zero=False, lr=1e-3, warmup=1,
                       total_steps=10)
    step_fn, _ = make_train_step(make_debug_mesh(1, 1, device="cpu"), cfg,
                                 opts)
    state = init_train_state(cfg, opts, torch.Generator().manual_seed(0),
                             "cpu")
    ds = SyntheticTokenDataset(DataConfig(seed=0, vocab=cfg.vocab,
                                          seq_len=16, global_batch=2))
    ckpt = CheckpointManager(str(tmp_path), interval=3)
    for step in range(6):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(step).items()}
        state, _ = step_fn(state, batch)
        ckpt.maybe_save(step + 1, state, block=True)
    restored_step, restored = ckpt.restore_latest(state)
    assert restored_step == 6
    for (path, a), (_, b) in zip(TB.tree_leaves(restored),
                                 TB.tree_leaves(state)):
        assert torch.equal(a, b), path
    batch = {k: torch.from_numpy(v) for k, v in ds.batch(6).items()}
    _, m2 = step_fn(restored, batch)
    assert np.isfinite(float(m2["loss"]))


# -- the driver -------------------------------------------------------------

def _train_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_train_cli_trains_the_backbone_on_cpu(tmp_path):
    out = _train_cli("--smoke", "--device", "cpu", "--steps", "6",
                     "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] qwen2-1.5b-smoke" in out.stdout
    assert "(improved)" in out.stdout


def test_train_cli_without_a_device_raises_no_device_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver trains on it")
    out = _train_cli("--smoke", "--steps", "2", "--ckpt-dir", str(tmp_path))
    assert out.returncode != 0
    assert "NoDeviceError" in out.stderr


def test_train_resumes_where_an_uninterrupted_run_ends(tmp_path):
    """6 steps with a checkpoint every 2, the same again (resumes at step
    6, trains nothing), then with step 6's checkpoint removed: the run
    resumes at step 4 and its last loss equals the uninterrupted run's
    within 1e-5 relative."""
    argv = ["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--steps", "6",
            "--ckpt-interval", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    whole = T.run(argv)
    assert whole["start"] == 0 and len(whole["losses"]) == 6
    again = T.run(argv)
    assert again["start"] == 6 and again["losses"] == []
    shutil.rmtree(tmp_path / "step_00000006")
    rest = T.run(argv)
    assert rest["start"] == 4 and len(rest["losses"]) == 2
    for got, want in zip(rest["losses"], whole["losses"][4:]):
        assert abs(got - want) <= 1e-5 * abs(want)


def test_train_refuses_the_production_mesh_naming_what_waits(tmp_path):
    """Body rewritten, name kept: the production mesh comes from
    ``make_production_mesh``, which needs a process group of world size
    256 and names it."""
    with pytest.raises(RuntimeError, match="world size 256"):
        T.run(["--smoke", "--device", "cpu", "--production-mesh",
               "--ckpt-dir", str(tmp_path)])

"""The port's serving slice on the CPU: greedy tokens equal the JAX
package's ``SolServer`` on the same weights and prompts, decode equals the
re-forward, one packed copy per forward, strict measured provenance after
``warm_autotune`` (and its refusals: a cold cache, a bucket measured only
nearby), the card is the default device (and its absence raises), and the
port imports neither ``jax`` nor ``repro``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

from repro.core import autotune as JAT
from repro.frontends import nn as jnn
from repro.launch import serve as jserve
from repro_torch.convert import load_numpy_state_dict
from repro_torch.core import autotune as TAT
from repro_torch.frontends import nn
from repro_torch.frontends.offload import NoDeviceError
from repro_torch.frontends.optimize import optimize
from repro_torch.launch import serve as tserve
from repro_torch.runtime import packed
from repro_torch.runtime.async_queue import AsyncQueue

ROOT = Path(__file__).resolve().parents[1]
D, H, KV, LAYERS, VOCAB = 64, 4, 2, 2, 128


@pytest.fixture(autouse=True)
def _empty_port_autotune_cache():
    prev = TAT._CACHE
    TAT.set_cache(TAT.AutotuneCache())
    yield
    TAT.set_cache(prev)


def _cfg(mod, **kw):
    base = dict(d_model=D, n_heads=H, n_layers=LAYERS, vocab=VOCAB,
                max_seq=32, max_batch=2, slots=3)
    base.update(kw)
    return mod.ServeConfig(**base)


def models(seed: int = 0):
    jm = jnn.Sequential(*[jnn.transformer_block(D, H, n_kv_heads=KV)
                          for _ in range(LAYERS)], jnn.Linear(D, VOCAB))
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
          for k, v in jm.named_parameters().items()}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    tm = tnn.Sequential(*[nn.transformer_block(D, H, KV, device="cpu")
                          for _ in range(LAYERS)],
                        nn.Linear(D, VOCAB, device="cpu"))
    load_numpy_state_dict(tm, sd)
    return jm, tm


def _prompts(n: int = 5, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(3, 14)), dtype=np.int32)
            for _ in range(n)]


def _serve(server, prompts, gen=6):
    reqs = [server.submit(p, gen) for p in prompts]
    server.run()
    server.close()
    return reqs


@pytest.mark.parametrize("backend", ["h100", "torch_ref"])
def test_greedy_tokens_equal_jax_server(backend):
    jm, tm = models()
    prompts = _prompts()
    jreqs = _serve(jserve.SolServer(_cfg(jserve, backend="xla"), model=jm),
                   prompts)
    server = tserve.SolServer(_cfg(tserve, backend=backend), model=tm,
                              device="cpu")
    treqs = _serve(server, prompts)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    for t, j in zip(treqs, jreqs):
        np.testing.assert_allclose(t.last_logits, j.last_logits,
                                   rtol=1e-5, atol=1e-5)
    s = server.summary()
    assert s["dmas"] == s["forwards"] and s["tokens"] == 6 * len(prompts)
    assert s["device"] == "cpu" and s["backend"] == backend


def test_decode_program_equals_reforward():
    _, tm = models(2)
    prompts = _prompts(4, seed=3)
    dec = _serve(tserve.SolServer(_cfg(tserve), model=tm, device="cpu"),
                 prompts, gen=8)
    full = _serve(tserve.SolServer(_cfg(tserve, decode=False), model=tm,
                                   device="cpu"), prompts, gen=8)
    assert [r.generated for r in dec] == [r.generated for r in full]
    for a, b in zip(dec, full):
        np.testing.assert_allclose(a.last_logits, b.last_logits,
                                   rtol=1e-5, atol=1e-5)


def test_served_elections_record_kernels_per_bucket():
    _, tm = models()
    server = tserve.SolServer(_cfg(tserve), model=tm, device="cpu")
    _serve(server, _prompts(3))
    kinds = set()
    for key, rec in server.served_elections.items():
        for kind, impls in rec["by_op"].items():
            kinds.add(kind)
            assert all(i.startswith("cuda.") for i in impls), (key, kind)
    assert kinds == {"linear", "matmul", "attention", "decode_attention",
                     "fused"}
    assert {k[0] for k in server.served_elections} == {"prefill", "decode"}


def test_embedding_and_sampling_equal_jax():
    cfg = _cfg(tserve)
    np.testing.assert_array_equal(tserve.embedding_table(cfg),
                                  jserve.embedding_table(_cfg(jserve)))
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(VOCAB).astype(np.float32)
    for sp in [dict(), dict(temperature=0.7, top_k=10, seed=3),
               dict(temperature=1.0, top_p=0.8, seed=4)]:
        a = tserve.sample_token(logits, tserve.SamplingParams(**sp),
                                np.random.default_rng(sp.get("seed", 0)))
        b = jserve.sample_token(logits, jserve.SamplingParams(**sp),
                                np.random.default_rng(sp.get("seed", 0)))
        assert a == b


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        tserve.SolServer(_cfg(tserve))
    with pytest.raises(NoDeviceError):
        optimize(nn.Linear(4, 4, device="cpu"), (2, 4))
    with pytest.raises(NoDeviceError):
        tserve.main(["--smoke"])


def test_later_slices_refuse_loudly():
    with pytest.raises(NotImplementedError):
        tserve.SolServer(_cfg(tserve, mesh=(2, 1)), device="cpu")
    with pytest.raises(NotImplementedError):
        tserve.SolServer(_cfg(tserve), deployed={}, device="cpu")


def test_smoke_cli_on_cpu(capsys):
    assert tserve.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cuda.decode_attention" in out and "one packed copy" in out


SERVED = ("linear", "matmul", "attention", "decode_attention")


def test_strict_serving_after_warm_autotune_is_measured_and_token_equal():
    _, tm = models()
    prompts = _prompts(3)
    cold = _serve(tserve.SolServer(_cfg(tserve), model=tm, device="cpu"),
                  prompts)
    server = tserve.SolServer(_cfg(tserve), model=tm, device="cpu",
                              strict_provenance=True)
    reqs = [server.submit(p, 6) for p in prompts]
    counts = server.warm_autotune(warmup=0, iters=1)
    assert counts["nodes"] > 0 and counts["impls"] >= counts["nodes"]
    server.run()
    server.close()
    assert {k[0] for k in server.served_elections} == {"prefill", "decode"}
    for key, rec in server.served_elections.items():
        model = server._models[key]
        assert model.check_provenance(kinds=SERVED) == []
        assert server._exact_bucket_violations(model) == []
        for kind in SERVED:
            for name in rec["by_op"].get(kind, {}):
                assert set(rec["provenance"][name]["sources"]) == \
                    {"measured"}, (key, kind, name)
    assert [r.generated for r in reqs] == [r.generated for r in cold]


def test_strict_provenance_cold_cache_is_loud():
    _, tm = models()
    server = tserve.SolServer(_cfg(tserve), model=tm, device="cpu",
                              strict_provenance=True)
    server.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(tserve.ProvenanceError, match="unmeasured"):
        server.run()
    server.close()


def test_strict_provenance_rejects_nearest_bucket_fallback():
    """'measured' provenance through the nearest-bucket lookup is another
    shape's timing: the strict server refuses it, and a second warm (which
    skips the buckets already measured) unblocks the run."""
    _, tm = models()
    server = tserve.SolServer(_cfg(tserve), model=tm, device="cpu",
                              strict_provenance=True)
    server.submit([1, 2, 3, 4], max_new_tokens=2)
    server.warm_autotune(warmup=0, iters=1)          # seq bucket 8 only
    server.submit(list(range(1, 13)), max_new_tokens=2)   # opens seq 16
    with pytest.raises(tserve.ProvenanceError, match="nearest-bucket"):
        server.run()
    again = server.warm_autotune(warmup=0, iters=1)
    assert again["nodes"] > 0 and again["skipped"] > 0
    server.run()
    assert len(server._finished) == 2 and all(r.done for r in server._finished)
    server.close()


def test_warm_autotune_opens_the_workload_buckets_and_skips_measured_ones():
    _, tm = models()
    server = tserve.SolServer(_cfg(tserve, max_batch=4), model=tm,
                              device="cpu")
    with pytest.raises(ValueError):
        server.warm_autotune()                      # nothing to derive from
    server.submit(list(range(1, 11)), max_new_tokens=8)
    assert server._workload_maxima() == (10, 18)
    assert server._batch_buckets() == [1, 2, 4]
    assert server._seq_buckets(10) == [8, 16]
    assert server.bucket_space() == [(b, s) for b in (1, 2, 4)
                                     for s in (8, 16, 32)]
    graphs = list(server._warm_graphs(None))
    # prefill at seq 8 and 16; decode caches reach 17 rows: 8, 16 and 32
    assert len(graphs) == 3 * 2 + 3 * 3
    first = server.warm_autotune(warmup=0, iters=1)
    again = server.warm_autotune(warmup=0, iters=1)
    assert first["graphs"] == again["graphs"] == len(graphs)
    assert again["nodes"] == 0 and again["skipped"] >= first["nodes"] > 0
    cache = TAT.get_cache()
    for (op, dtype, backend), bucket, impl, m in cache.entries():
        assert backend == "h100" and dtype == "float32"
        assert m.mean_us >= m.us > 0.0
    server.close()


def test_strict_smoke_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] strict: autotune warmup" in out.stdout
    assert "every served election measured on its exact bucket" in out.stdout
    strict = [ln for ln in out.stdout.splitlines()
              if ln.startswith("[serve] strict: bucket")]
    assert strict and all("sources={'measured'" in ln for ln in strict)


def test_packed_staging_is_one_copy_of_views():
    packed.reset_transfer_stats()
    x = np.arange(12, dtype=np.float32).reshape(2, 1, 6)
    lens = np.array([3, 0], np.int32)
    cache = np.ones((2, 4, 2, 3), np.float32)
    outs = packed.stage_inputs([x, lens, cache], torch.device("cpu"))
    assert [o.dtype for o in outs] == [torch.float32, torch.int32,
                                       torch.float32]
    for o, a in zip(outs, [x, lens, cache]):
        np.testing.assert_array_equal(o.numpy(), a)
    base = outs[0].untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base for o in outs)
    batch = packed.stage_batch([np.full((4, 3), i, np.float32)
                                for i in range(3)], torch.device("cpu"))
    assert batch.shape == (3, 4, 3) and float(batch[2].sum()) == 24.0
    assert packed.TRANSFER_STATS["packed_dmas"] == 2
    with pytest.raises(ValueError):
        packed.stage_batch([np.zeros(2), np.zeros(3)], torch.device("cpu"))


def test_slot_arena_kv_rows_round_trip():
    q = AsyncQueue()
    arena = tserve.SlotArena(q, 2, 8, kv_row_shapes=[(2, 3), (2, 3)])
    slot = arena.admit(np.array([1, 2, 3], np.int32))
    rows = np.arange(18, dtype=np.float32).reshape(3, 2, 3)
    arena.write_kv_rows(slot, 1, 0, rows)
    arena.append(slot, 9)
    q.synchronize()
    np.testing.assert_array_equal(arena.kv_rows(slot, 1, 3), rows)
    np.testing.assert_array_equal(arena.tokens(slot), [1, 2, 3, 9])
    with pytest.raises(ValueError):
        arena.write_kv_rows(slot, 0, 7, rows)
    arena.evict(slot)
    q.close()


def test_autotune_cache_reads_the_jax_file_format(tmp_path):
    jc = JAT.AutotuneCache()
    jc.record("matmul", (64, 128, 256), "float32", "h100", "cuda.matmul",
              12.5, config=(64, 64, 16), flops=4.2e6)
    path = jc.save(str(tmp_path / "cache.json"))
    tc = TAT.AutotuneCache.load(path)
    got = tc.lookup("matmul", (60, 130, 250), "float32", "h100")
    assert got["cuda.matmul"].us == 12.5
    assert got["cuda.matmul"].config == (64, 64, 16)
    assert tc.to_json() == jc.to_json()
    doc = json.loads(Path(path).read_text())
    doc["schema"] = 99
    Path(path).write_text(json.dumps(doc))
    assert TAT.AutotuneCache.load(path).stale
    assert TAT.ceil_pow2(100) == 128 and TAT.bucket_dim(100) == 128
    assert TAT.pad_shape((3, 100)) == (4, 128)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("torch_*.py"))
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []

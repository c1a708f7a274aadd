"""Checkpoints on disk (counterpart of ``repro.checkpoint.manager``), in the
JAX package's format, so a checkpoint written by one package restores in
the other:

* ``step_XXXXXXXX/`` holds one ``.npy`` per leaf, named by the first 16
  hex digits of the sha1 of the leaf's "/"-joined path (dict keys, sorted,
  and sequence indices: the paths JAX's pytree flattening gives), and a
  ``manifest.json`` of ``{"step", "arrays": {path: {"file", "shape",
  "dtype"}}, "time"}``;
* the files are written into ``step_XXXXXXXX.tmp``, the manifest last,
  and the directory is published by one atomic rename, so a failure
  mid-save never leaves a torn checkpoint visible;
* keep-last-k garbage collection, and :class:`CheckpointManager` saves
  asynchronously: a host snapshot on the caller's thread, the files
  written on another.

A tree is nested dicts, lists and tuples whose leaves are torch tensors,
numpy arrays or numbers.  NumPy has no bfloat16: a bf16 tensor is written
as its ``uint16`` bit pattern under dtype ``"bfloat16"``.

On a mesh of ranks a checkpoint still holds global arrays: with
``shardings`` (``distributed.sharding.named`` of the tree's specs)
:meth:`CheckpointManager.maybe_save` gathers every rank's blocks once and
rank 0 writes them, and :func:`restore_checkpoint` (and
:meth:`CheckpointManager.restore_latest`) has each rank read the global
arrays and keep its own block, so a checkpoint written on one process
restores onto a (2, 2) mesh and back (JAX's elastic re-shard).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's pytree order: dict keys sorted, sequence
    entries by index; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(tree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, leaves, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return leaves["/".join(prefix)]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype its manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().copy(), "bfloat16"
        arr = t.numpy().copy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _leaf_name(name: str) -> str:
    return hashlib.sha1(name.encode()).hexdigest()[:16] + ".npy"


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    """Write ``tree`` as ``step_XXXXXXXX`` and keep the last ``keep``."""
    base = Path(ckpt_dir)
    tmp = base / f"step_{step:08d}.tmp"
    final = base / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "arrays": {},
                                "time": time.time()}
    for name, leaf in _flatten(tree):
        arr, dtype = _to_host(leaf)
        fname = _leaf_name(name)
        np.save(tmp / fname, arr)
        manifest["arrays"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    with (tmp / "manifest.json").open("w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    _gc(base, keep)
    return str(final)


def _gc(base: Path, keep: int) -> None:
    steps = sorted(p for p in base.glob("step_????????") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(base.glob("step_????????"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _like(arr: np.ndarray, dtype: str, leaf) -> Any:
    """The stored array as ``leaf`` is: a tensor on its device in its
    dtype, else a numpy array in the leaf's dtype (or the stored one)."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(arr)
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    want = getattr(leaf, "dtype", None)
    if dtype == "bfloat16":
        arr = torch.from_numpy(arr).view(torch.bfloat16).float().numpy()
    return np.asarray(arr, dtype=np.dtype(str(want)) if want is not None
                      and not isinstance(want, torch.dtype) else None)


def restore_checkpoint(ckpt_dir: str, tree_like: Any,
                       step: Optional[int] = None,
                       shardings: Any = None) -> Any:
    """Restore into the structure of ``tree_like``, whose leaves give each
    array's global shape (and its type, device and dtype); a shape that
    differs from the stored one raises ``ValueError``.  With
    ``shardings`` (a tree of ``NamedSharding``) each leaf is this rank's
    block of the stored array, on the mesh's device."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    placed = None if shardings is None else dict(_flatten(shardings))
    leaves = {}
    for name, leaf in _flatten(tree_like):
        if name not in manifest["arrays"]:
            raise KeyError(f"checkpoint missing array {name}")
        info = manifest["arrays"][name]
        arr = np.load(d / info["file"], mmap_mode="r")
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(
                f"{name}: checkpoint shape {arr.shape} != "
                f"{tuple(leaf.shape)}")
        if placed is not None:
            sh = placed[name]
            t = torch.from_numpy(np.array(arr[sh.index(arr.shape)]))
            if info["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            leaves[name] = t.to(device=sh.mesh.device, dtype=leaf.dtype)
        else:
            leaves[name] = _like(np.array(arr), info["dtype"], leaf)
    return _unflatten(tree_like, leaves)


class CheckpointManager:
    """Asynchronous checkpointing with restart and resume."""

    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    def maybe_save(self, step: int, tree: Any, block: bool = False,
                   shardings: Any = None) -> bool:
        """Save ``tree`` at every ``interval``-th step.  With
        ``shardings`` the leaves are this rank's blocks: every rank calls,
        the global arrays are gathered on this thread (a collective) and
        rank 0 writes them."""
        if step % self.interval:
            return False
        self.wait()
        if shardings is not None:
            placed = dict(_flatten(shardings))
            tree = _unflatten(tree, {name: placed[name].gather(leaf)
                                     for name, leaf in _flatten(tree)})
            if next(iter(placed.values())).mesh.rank != 0:
                return True
        # a consistent host snapshot on this thread; the files on another
        host = _unflatten(tree, {name: _snapshot(leaf)
                                 for name, leaf in _flatten(tree)})

        def work():
            save_checkpoint(self.ckpt_dir, step, host, keep=self.keep)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like: Any, shardings: Any = None):
        """(step, tree) of the newest checkpoint, or (None, None); with
        ``shardings`` this rank's blocks (:func:`restore_checkpoint`)."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.ckpt_dir, tree_like, step=step,
                                        shardings=shardings)

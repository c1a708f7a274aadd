"""Device meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A :class:`Mesh` is this process's view of a (data, model) grid of ranks:
the axis sizes and names, this rank's coordinates (rank = row-major over
the axes, rank = d·model + m, as ``jax.make_mesh`` lays devices out), the
device it runs on, and one process group per slice of every axis subset,
made with ``torch.distributed.new_group`` on every rank in the same order.
Its collectives are what a sharded graph needs: ``all_reduce`` for the
row-parallel products (``psum_axes``) and ``all_gather`` for the outputs.
A gloo group moves CUDA tensors through host copies.

A mesh's device is the card unless the caller asks for another
(``device="cpu"``): it resolves through ``frontends.offload.resolve_device``,
so with no card and no such request it raises ``NoDeviceError``.
:func:`make_debug_mesh` and :func:`make_production_mesh` read the process
group this process joined and raise when its world size is not the mesh's;
under a group the mesh's device is the one asked for, else the one
``run_on_mesh`` gave the rank, else the card torch has current.
:func:`run_on_mesh` starts the ranks itself: ``data·model`` spawned
processes that meet through a file store in a fresh temporary directory
(no TCP port is picked), each running ``fn(mesh, *args)``; it returns each
rank's result and raises when any rank failed or timed out, having killed
and reaped every child it started.
"""
from __future__ import annotations

import datetime
import itertools
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..frontends.offload import DeviceLike, resolve_device


class Mesh:
    """The rank grid as this process sees it."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, device: DeviceLike = None,
                 backend: str = "gloo"):
        self.sizes = tuple(int(s) for s in sizes)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.device = resolve_device(device)
        self.backend = backend
        self.coords = dict(zip(self.axis_names, _coords(rank, self.sizes)))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        # collectives issued (span-1 no-ops excluded): what a step costs
        self.calls = {"all_reduce": 0, "all_gather": 0}
        if self.size > 1:
            self._make_groups()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank} at {self.coords}, "
                f"{self.device})")

    def _make_groups(self) -> None:
        """One group per slice of every non-empty axis subset, created on
        every rank in one order (``new_group`` is collective); this rank
        keeps the group of its own slice."""
        n = len(self.sizes)
        for k in range(1, n + 1):
            for sub in itertools.combinations(range(n), k):
                rest = [i for i in range(n) if i not in sub]
                for fixed in itertools.product(
                        *[range(self.sizes[i]) for i in rest]):
                    ranks = []
                    for free in itertools.product(
                            *[range(self.sizes[i]) for i in sub]):
                        c = [0] * n
                        for i, v in zip(rest, fixed):
                            c[i] = v
                        for i, v in zip(sub, free):
                            c[i] = v
                        ranks.append(_rank_of(c, self.sizes))
                    g = dist.new_group(sorted(ranks), backend=self.backend)
                    if self.rank in ranks:
                        self._groups[tuple(self.axis_names[i]
                                           for i in sub)] = g

    def group(self, axes) -> Any:
        """The group of this rank's slice along ``axes`` (names in mesh
        order or not); ranks in it ascend with the slice's row-major
        coordinates."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def coords_of(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names, _coords(rank, self.sizes)))

    def span(self, axes) -> int:
        """The number of ranks in a slice along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = 1
        for a in axes:
            out *= self.shape[a]
        return out

    def _host(self, t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """gloo moves host tensors: a CUDA tensor crosses through a copy."""
        moved = self.backend == "gloo" and t.device.type != "cpu"
        return (t.to("cpu") if moved else t.contiguous()), moved

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over the ranks of this rank's ``axes`` slice."""
        if self.span(axes) == 1:
            return t
        self.calls["all_reduce"] += 1
        buf, moved = self._host(t)
        buf = buf.clone() if buf is t else buf
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group(axes))
        return buf.to(t.device) if moved else buf

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This slice's blocks of ``t`` joined along ``dim``, in the
        slice's row-major order (the order ``shard_slices`` cuts in)."""
        n = self.span(axes)
        if n == 1:
            return t
        self.calls["all_gather"] += 1
        buf, moved = self._host(t)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=self.group(axes))
        out = torch.cat(parts, dim=dim)
        return out.to(t.device) if moved else out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def _coords(rank: int, sizes: Sequence[int]) -> List[int]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


_MESHES: Dict[Tuple, Mesh] = {}


def _mesh(sizes: Tuple[int, ...], axes: Tuple[str, ...],
          device: DeviceLike = None) -> Mesh:
    """The mesh of this process group with ``sizes`` on ``device``; made
    once per group and device (its sub-groups are collective to create).
    With no group a one-process mesh stands alone."""
    need = 1
    for s in sizes:
        need *= s
    if not dist.is_available() or not dist.is_initialized():
        if need == 1:
            return Mesh(sizes, axes, device=device)
        raise RuntimeError(
            f"mesh {sizes} needs a process group of world size {need}, and "
            f"this process joined none: start the ranks with "
            f"launch.mesh.run_on_mesh (or torch.distributed."
            f"init_process_group with world_size={need})")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"mesh {sizes} needs world size {need}, the process group has "
            f"{world}")
    if device is None:
        device = _RANK_DEVICE.get("device") or "cuda"
    dev = resolve_device(device)
    key = (sizes, axes, id(dist.group.WORLD), dev)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = Mesh(sizes, axes, dist.get_rank(), dev,
                    dist.get_backend())
        _MESHES[key] = mesh
    return mesh


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh over the joined process group, whose world size
    must be ``data·model``; on ``device``, the card unless asked
    otherwise."""
    return _mesh((int(data), int(model)), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The (data 16, model 16) pod, or (pod 2, data 16, model 16)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


# the device each rank of run_on_mesh serves on (the mesh's staging target)
_RANK_DEVICE: Dict[str, torch.device] = {}


class _Prefixed:
    """A text stream that starts every line it writes with ``prefix``."""

    def __init__(self, stream, prefix: str):
        self._stream, self._prefix, self._at_start = stream, prefix, True

    def write(self, s: str) -> int:
        out = []
        for piece in s.splitlines(keepends=True):
            if self._at_start:
                out.append(self._prefix)
            out.append(piece)
            self._at_start = piece.endswith("\n")
        self._stream.write("".join(out))
        self._stream.flush()
        return len(s)

    def flush(self) -> None:
        self._stream.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


def _rank_main(fn: Callable, args: tuple, rank: int, data: int, model: int,
               device: str, dist_backend: str, store: str,
               timeout_s: float, out_dir: str) -> None:
    """One rank: join the group, build the mesh, run ``fn``, write its
    result (or the traceback) to ``out_dir``."""
    sys.stdout = _Prefixed(sys.stdout, f"[rank {rank}] ")
    sys.stderr = _Prefixed(sys.stderr, f"[rank {rank}] ")
    torch.set_num_threads(1)
    # every rank runs on this host: gloo's pairs meet on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _RANK_DEVICE["device"] = dev
        dist.init_process_group(
            dist_backend, init_method=f"file://{store}",
            world_size=data * model, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(make_debug_mesh(data, model), *args)
        except BaseException:
            # report before the group closes: the peers fail on the closed
            # connection next, and the parent stops this rank on theirs
            _exit_failed(rank, out_dir)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        _exit_failed(rank, out_dir)


def _exit_failed(rank: int, out_dir: str) -> None:
    """Publish the traceback in flight as ``error_<rank>.txt`` (written
    whole, then renamed: the parent never reads half of it) and exit 1."""
    path = os.path.join(out_dir, f"error_{rank}.txt")
    with open(path + ".tmp", "w") as f:
        f.write(traceback.format_exc())
    os.replace(path + ".tmp", path)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)


def run_on_mesh(fn: Callable, data: int, model: int, *, device: str,
                dist_backend: str, timeout_s: float = 120.0,
                args: tuple = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``data·model`` spawned ranks and return
    their results in rank order.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function).  ``dist_backend`` is the caller's choice:
    ``"gloo"`` on the CPU, and on a card that several ranks share (NCCL
    refuses two ranks on one device).  A rank that raises, dies or outlives
    ``timeout_s`` fails the run: every child still running is killed, each
    one is reaped, and ``RuntimeError`` carries the ranks' tracebacks."""
    resolve_device(device)          # no card: raise before any rank starts
    world = int(data) * int(model)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="sol_mesh_")
    procs = []
    try:
        for r in range(world):
            p = ctx.Process(
                target=_rank_main, name=f"sol-rank-{r}",
                args=(fn, tuple(args), r, int(data), int(model), device,
                      dist_backend, os.path.join(tmp, "store"), timeout_s,
                      tmp))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        live = list(procs)
        while live:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            mpc.wait([p.sentinel for p in live], timeout=left)
            live = [p for p in live if p.is_alive()]
            if any(p.exitcode not in (None, 0) for p in procs):
                break                   # one rank failed: stop the others
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"error_{r}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (" (killed at the time limit)"
                                 if time.monotonic() >= deadline else ""))
        if errors:
            raise RuntimeError(f"run_on_mesh({data}, {model}) failed:\n"
                               + "\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)

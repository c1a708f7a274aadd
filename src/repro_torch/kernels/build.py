"""Build the CUDA C++ kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so <name>.cu

No PyTorch header is included, so a build takes seconds.  The libraries go
to ``build/repro_torch/`` at the root of the checkout; the file name carries
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads from disk.  The first use builds every source, one
``nvcc`` process each, all started together.  A failed build raises with
the compiler's output: nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}          # source name → nvcc's output
BUILD_SECONDS: Dict[str, float] = {}    # source name → build wall time


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of repro_torch build on a machine with the CUDA "
                       "toolkit")


def digest(name: str) -> str:
    """Hash of the flags, the shared headers and ``csrc/<name>.cu``: it
    names the library, so a log can say which source a run built."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{digest(name)}.so"


def _spawn(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.sol_target = (tmp, out)            # type: ignore[attr-defined]
    return proc


def build_all(force: bool = False) -> Dict[str, float]:
    """Build every source that has no library for its current hash (all of
    them with ``force``), in parallel; returns seconds per source built."""
    with _lock:
        todo = [n for n in sources() if force or not _lib_path(n).is_file()]
        t0 = time.perf_counter()
        procs = {n: _spawn(n) for n in todo}
        failed = []
        for n, proc in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[n] = log
            BUILD_SECONDS[n] = time.perf_counter() - t0
            tmp, out = proc.sol_target
            if proc.returncode != 0:
                failed.append(f"{n}.cu:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return {n: BUILD_SECONDS[n] for n in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not _lib_path(name).is_file():
        build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.sol_error_string.restype = ctypes.c_char_p
            lib.sol_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return _libs[name]


def entry(name: str, fn_name: str, argtypes) -> tuple:
    """(library, function) of the export ``fn_name`` of ``csrc/<name>.cu``,
    its argument types set at first use."""
    lib = library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


_SMS: Dict[int, int] = {}


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev`` (a ``torch.device``), which
    the launch plans take; read once a device."""
    import torch
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = lib.sol_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

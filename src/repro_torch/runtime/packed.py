"""Packed host→device staging (paper Sec. IV-C, the VEO-udma mechanism;
counterpart of ``repro.runtime.packed``).

"We gather multiple adjacent memcopies and group them together … many small
tensors can be packed into a big data segment to speed up transfers."

Each call packs its host arrays into ONE pinned host buffer (128-byte
aligned slots), moves it with ONE ``non_blocking`` host→device copy on the
current stream, and hands back views of the device buffer — no per-array
copies on either side.  PyTorch's host allocator keeps the pinned buffer
alive until the copy that reads it has finished.  On a CPU device the
buffer itself is returned, unpinned, and no copy happens.

``transfer`` applies the paper's policy split, as the JAX package does: a
singleton, or a batch under ``LATENCY_THRESHOLD_BYTES``, goes direct (one
copy an array, latency first); anything larger goes as one packed copy.
NumPy has no bfloat16, so a bf16 array crosses as its ``uint16`` bit
pattern; the caller views the device tensor back as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

LATENCY_THRESHOLD_BYTES = 1 << 14     # smaller batches go direct

# transfer accounting: how many packed and direct DMAs were issued and how
# many host bytes crossed
TRANSFER_STATS = {"packed_dmas": 0, "direct_dmas": 0, "bytes": 0}

_ALIGN = 128

_TORCH_OF = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64,
             np.dtype(np.float16): torch.float16,
             np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.uint16): torch.uint16,
             np.dtype(np.uint8): torch.uint8,
             np.dtype(np.bool_): torch.bool}


def reset_transfer_stats() -> Dict[str, int]:
    prev = dict(TRANSFER_STATS)
    TRANSFER_STATS.update(packed_dmas=0, direct_dmas=0, bytes=0)
    return prev


def replicated(mesh) -> torch.device:
    """The staging target of a mesh server: every rank stages the whole
    packed batch to its own device in one copy (so ``dmas == forwards``
    holds per rank), and the sharded model slices its local block there;
    the counterpart of a fully replicated sharding."""
    return mesh.device


def _pack(arrays: Sequence[np.ndarray], device: torch.device
          ) -> Tuple[torch.Tensor, List[Tuple[Tuple[int, ...], np.dtype, int]]]:
    """One staging buffer holding every array, moved to ``device`` in one
    copy; returns the device buffer and each array's (shape, dtype,
    offset)."""
    layout = []
    total = 0
    for a in arrays:
        off = (total + _ALIGN - 1) & ~(_ALIGN - 1)
        layout.append((tuple(a.shape), a.dtype, off))
        total = off + a.nbytes
    host = torch.empty(max(total, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    hv = host.numpy()
    for a, (_, _, off) in zip(arrays, layout):
        hv[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
    TRANSFER_STATS["packed_dmas"] += 1
    TRANSFER_STATS["bytes"] += total
    buf = host.to(device, non_blocking=True) if device.type != "cpu" else host
    return buf, layout


def _view(buf: torch.Tensor, shape: Tuple[int, ...], dtype: np.dtype,
          off: int) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return buf[off:off + n].view(_TORCH_OF[dtype]).view(shape)


def transfer(arrays: Sequence[np.ndarray],
             device: torch.device) -> List[torch.Tensor]:
    """Stage host arrays on ``device`` by the policy split: a singleton or
    a batch under ``LATENCY_THRESHOLD_BYTES`` one direct copy an array,
    else ONE packed copy (the device tensors are views of its buffer)."""
    arrays = [np.asarray(a, order="C") for a in arrays]     # keeps 0-d
    total = sum(a.nbytes for a in arrays)
    if len(arrays) == 1 or total < LATENCY_THRESHOLD_BYTES:
        TRANSFER_STATS["direct_dmas"] += len(arrays)
        TRANSFER_STATS["bytes"] += total
        return [torch.from_numpy(a).to(device, copy=True) for a in arrays]
    buf, layout = _pack(arrays, device)
    return [_view(buf, *entry) for entry in layout]


def stage_inputs(arrays: Sequence[np.ndarray],
                 device: torch.device) -> List[torch.Tensor]:
    """Stage a heterogeneous input set (token rows, int32 lengths, KV
    caches) host→device as ONE packed DMA, returned as device views."""
    if not arrays:
        raise ValueError("stage_inputs needs at least one array")
    arrays = [np.ascontiguousarray(a) for a in arrays]
    buf, layout = _pack(arrays, device)
    return [_view(buf, *entry) for entry in layout]


def stage_batch(rows: Sequence[np.ndarray],
                device: torch.device) -> torch.Tensor:
    """Stage a serving batch host→device as ONE DMA; the rows land
    back-to-back, so the stacked (n, *row) batch is a view of the device
    buffer."""
    if not rows:
        raise ValueError("stage_batch needs at least one row")
    rows = [np.ascontiguousarray(r) for r in rows]
    if len({r.shape for r in rows}) > 1 or len({r.dtype for r in rows}) > 1:
        raise ValueError(
            f"stage_batch needs uniform rows, got shapes "
            f"{sorted({r.shape for r in rows})} — pad to a common bucket "
            f"first")
    stacked = np.stack(rows)
    buf, layout = _pack([stacked], device)
    return _view(buf, *layout[0])

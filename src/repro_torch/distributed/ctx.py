"""Activation-sharding context (counterpart of ``repro.distributed.ctx``):
model code places sharding constraints without threading a mesh through
every layer.

``use_mesh(mesh)`` makes ``mesh`` the active one for the block it
guards.  ``constrain(x, ("dp", None, "model"))`` is the identity with no
active mesh or a one-process mesh, as JAX's is with no mesh.  On a larger
mesh it raises ``NotImplementedError``: placing an activation on a mesh is
the sharded backbone's execution, which waits for ROADMAP §1 item 7.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

_state = threading.local()


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh of this thread inside the block."""
    prev = _mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def mesh_size(mesh) -> int:
    """The number of devices of a mesh (anything with ``shape``, axis
    name → size)."""
    n = 1
    for size in mesh.shape.values():
        n *= int(size)
    return n


def constrain(x: torch.Tensor, spec: Sequence) -> torch.Tensor:
    """``x`` placed as ``spec`` says on the active mesh: the identity with
    no mesh or a mesh of one device."""
    mesh: Optional[object] = _mesh()
    if mesh is None or mesh_size(mesh) == 1:
        return x
    raise NotImplementedError(
        f"constrain on a mesh of {dict(mesh.shape)}: the sharded "
        f"backbone's execution waits for ROADMAP §1 item 7")

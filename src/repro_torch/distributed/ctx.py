"""Activation-sharding context (counterpart of ``repro.distributed.ctx``):
model code places sharding constraints without threading a mesh through
every layer.

``use_mesh(mesh)`` makes ``mesh`` the active one for the block it
guards.  ``constrain(x, ("dp", None, "model"))`` is the identity with no
active mesh or a one-process mesh, as JAX's is with no mesh, and on a
``launch.mesh.Mesh`` of several ranks too: each rank's program already
holds its blocks, and the layers place their activations with the
explicit collectives of ``distributed.collectives``, so a constraint
never changes a value or a shape, as in JAX.  An abstract mesh of
several devices has no process groups to run on and raises
``ValueError``.
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
    no mesh, a mesh of one device or a mesh of ranks; an abstract mesh of
    several devices raises ``ValueError``."""
    mesh: Optional[object] = _mesh()
    if mesh is not None and mesh_size(mesh) > 1 \
            and not hasattr(mesh, "all_reduce"):
        raise ValueError(
            f"constrain on {mesh!r}: placing an activation needs a mesh "
            f"with process groups (launch.mesh.make_debug_mesh), not an "
            f"abstract one")
    return x

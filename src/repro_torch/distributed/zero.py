"""ZeRO-1 specs (counterpart of ``repro.distributed.zero``): the optimizer
moments sharded over the data-parallel axes on top of the parameters'
tensor parallelism.

For each moment the largest dim not already sharded whose size divides
the data-parallel world takes the data-parallel axes.  On one process
every spec places the whole tensor; on a mesh of ranks the train step
(``distributed.steps``) runs each moment's update on its block and
all-gathers the new parameter over the data-parallel axes.
"""
from __future__ import annotations

from typing import Any, Tuple

from ..models.backbone import tree_map
from .sharding import P, axis_size, dp_axes


def zero_spec(mesh, spec: P, shape: Tuple[int, ...]) -> P:
    dp = dp_axes(mesh)
    n = axis_size(mesh, dp)
    if n <= 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    # the largest unsharded dim that divides the data-parallel world
    best, best_size = -1, 0
    for i, (s, dim) in enumerate(zip(parts, shape)):
        if s is None and dim % n == 0 and dim > best_size:
            best, best_size = i, dim
    if best < 0:
        return spec
    parts[best] = dp if len(dp) > 1 else dp[0]
    return P(*parts)


def zero_opt_specs(mesh, param_spec_tree, params_shape_tree) -> Any:
    """The moments' specs ``{"m", "v", "step"}`` for parameters of
    ``params_shape_tree`` (meta tensors) under ``param_spec_tree``."""
    moment = tree_map(lambda leaf, spec: zero_spec(mesh, spec,
                                                   tuple(leaf.shape)),
                      params_shape_tree, param_spec_tree)
    return {"m": moment, "v": moment, "step": P()}

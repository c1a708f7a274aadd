"""Carry parameters from the JAX package into the port's modules.

The JAX frontend's ``named_parameters()`` and the port's ``state_dict()``
use the same dotted names and layouts (Linear weights (out, in), Conv2d
weights (out, in/groups, kh, kw), BatchNorm2d running stats; attention,
RG-LRU and RWKV6 projections and LoRA factors (in, out)), so a checkpoint
moves over name for name.  The caller turns the JAX arrays into numpy
first (``np.asarray``); this module imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn as tnn


def load_numpy_state_dict(model: tnn.Module,
                          sd: Dict[str, np.ndarray]) -> tnn.Module:
    """Copy ``{dotted name: array}`` into ``model``'s parameters and buffers
    in place, on their device and in their dtype.  Every name must exist on
    both sides with the same shape, except a batch norm's
    ``num_batches_tracked``, which the JAX modules lack."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    # torch's batch norms count their training steps in a buffer the JAX
    # modules do not have; it is no weight, so it is left as it is
    for prefix, mod in model.named_modules():
        if isinstance(mod, tnn.modules.batchnorm._BatchNorm):
            own.pop(f"{prefix}.num_batches_tracked" if prefix
                    else "num_batches_tracked", None)
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, arr in sd.items():
            dst = own[name]
            src = torch.tensor(np.asarray(arr))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src.to(dtype=dst.dtype))
    return model

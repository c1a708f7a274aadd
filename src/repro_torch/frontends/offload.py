"""Device selection and staging (paper Sec. V; counterpart of
``repro.frontends.offload``).

``sol.device.set(KIND, IDX)`` once; SOL stages parameters and inputs to the
target device and runs there.  The port's default device is the CUDA card:
an entry point runs on the CPU only when the caller asks for it
(``device.set("cpu")`` or ``device="cpu"``), and with no card and no such
request it raises instead of carrying on on the CPU.

Modes: ``'native'`` returns device tensors (the framework shares the
device's memory space); ``'transparent'`` returns host numpy arrays, the
framework never learning the device exists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


class NoDeviceError(RuntimeError):
    """The requested CUDA device does not exist on this machine."""


@dataclasses.dataclass
class _DeviceState:
    kind: str = "cuda"
    index: int = 0
    mode: str = "native"       # 'native' | 'transparent'


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on: ``device`` when given, else
    the device API's current selection (``cuda`` unless set).  A CUDA device
    with no card raises :class:`NoDeviceError`."""
    if device is None:
        st = api.state
        device = st.kind if st.kind == "cpu" else f"{st.kind}:{st.index}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                f"device {dev} requested but no CUDA device is available; "
                f"pass device='cpu' (or device.set('cpu')) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _DeviceAPI:
    """sol.device — the paper's one-call device selection."""

    def __init__(self):
        self.state = _DeviceState()
        self.transfer_stats = {"staged_params": 0}

    def set(self, kind: str, index: int = 0, *,
            mode: str = "transparent") -> None:
        self.state = _DeviceState(kind, index, mode)

    def stage_params(self, params: Dict[str, torch.Tensor],
                     dev: torch.device) -> Dict[str, torch.Tensor]:
        """Parameters on ``dev``: tensors already there are used in place
        (shared storage); the rest are copied once per call of this
        method — the SolModel caches the result."""
        out = {}
        for k, v in params.items():
            v = v.detach()
            out[k] = v if v.device == dev else v.to(dev)
        self.transfer_stats["staged_params"] += len(params)
        return out

    @staticmethod
    def stage_input(x: Any, dev: torch.device) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x if x.device == dev else x.to(dev)

    def fetch_output(self, y: torch.Tensor) -> Any:
        if self.state.mode == "transparent":
            return y.detach().cpu().numpy()
        return y


api = _DeviceAPI()
device = api

from .async_queue import (AsyncQueue, UseAfterFreeError, VirtualAllocator,
                          VirtualPtr)
from .failures import (FailureSimulator, ReplicaFailure, RestartReport,
                       run_with_restart)
from .packed import stage_batch, stage_inputs, transfer
from .straggler import StragglerMonitor

__all__ = ["AsyncQueue", "UseAfterFreeError", "VirtualAllocator",
           "VirtualPtr", "stage_batch", "stage_inputs", "transfer",
           "StragglerMonitor", "FailureSimulator", "ReplicaFailure",
           "RestartReport", "run_with_restart"]

from .async_queue import (AsyncQueue, UseAfterFreeError, VirtualAllocator,
                          VirtualPtr)
from .packed import stage_batch, stage_inputs, transfer

__all__ = ["AsyncQueue", "UseAfterFreeError", "VirtualAllocator",
           "VirtualPtr", "stage_batch", "stage_inputs", "transfer"]

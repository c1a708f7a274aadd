"""The SOL runtime's asynchronous execution queue (paper Sec. IV-C).

The paper's design, reproduced:

  * a device-side execution queue mimicking CUDA streams, operated by a
    host thread so that enqueue never blocks;
  * **asynchronous malloc/free via 64-bit virtual pointers**: allocation
    returns immediately with a token whose first 32 bits are a unique
    reference number and second 32 bits an offset, so virtual pointers
    support ordinary pointer arithmetic while the real allocation happens
    later, in queue order — removing the malloc/free synchronization points;
  * adjacent small memcopies are gathered and grouped (see ``packed.py``).

The code is framework-neutral (numpy and the standard library only); the
port keeps its own copy so that ``repro_torch`` never imports ``repro``.
PyTorch's CUDA caching allocator and streams play the device-side role;
this module is the host-side model of the paper's mechanism that the
serving ``SlotArena`` runs on.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

_REF_BITS = 32
_OFF_MASK = (1 << _REF_BITS) - 1


class UseAfterFreeError(RuntimeError):
    """A virtual pointer was dereferenced (or double-freed) after its
    allocation was released — the async-malloc analogue of a dangling CUDA
    pointer.  Carries the offending ref number so the failing allocation is
    identifiable from the message alone."""

    def __init__(self, ref: int, action: str):
        self.ref = ref
        super().__init__(
            f"virtual ref {ref} used after free (or never allocated) "
            f"during {action}")


@dataclasses.dataclass(frozen=True)
class VirtualPtr:
    """64-bit virtual pointer: (ref << 32) | offset."""

    raw: int

    @property
    def ref(self) -> int:
        return self.raw >> _REF_BITS

    @property
    def offset(self) -> int:
        return self.raw & _OFF_MASK

    def __add__(self, delta: int) -> "VirtualPtr":
        off = self.offset + delta
        if off < 0 or off > _OFF_MASK:
            raise ValueError("virtual pointer offset out of 32-bit range")
        return VirtualPtr((self.ref << _REF_BITS) | off)

    def __sub__(self, delta: int) -> "VirtualPtr":
        return self.__add__(-delta)


class VirtualAllocator:
    """Async malloc/free: returns virtual pointers immediately; the backing
    buffers materialize when the queue executes the allocation."""

    def __init__(self):
        self._next_ref = 1
        self._buffers: Dict[int, Optional[np.ndarray]] = {}
        self._sizes: Dict[int, int] = {}
        self._lock = threading.Lock()

    def malloc(self, nbytes: int) -> VirtualPtr:
        with self._lock:
            ref = self._next_ref
            self._next_ref += 1
            self._buffers[ref] = None      # not yet materialized
            self._sizes[ref] = nbytes
        return VirtualPtr(ref << _REF_BITS)

    def materialize(self, ptr: VirtualPtr) -> None:
        with self._lock:
            if ptr.ref not in self._sizes:
                raise UseAfterFreeError(ptr.ref, "materialize")
            if self._buffers.get(ptr.ref) is None:
                self._buffers[ptr.ref] = np.zeros(self._sizes[ptr.ref],
                                                  np.uint8)

    def resolve(self, ptr: VirtualPtr) -> np.ndarray:
        self.materialize(ptr)
        with self._lock:
            buf = self._buffers.get(ptr.ref)
        if buf is None:
            raise UseAfterFreeError(ptr.ref, "resolve")
        return buf[ptr.offset:]

    def free(self, ptr: VirtualPtr) -> None:
        # async free: dropped when the queue drains past this point; freeing
        # a ref that was never allocated (or already freed) is a bug in the
        # caller's pointer bookkeeping and must not pass silently
        with self._lock:
            if ptr.ref not in self._sizes:
                raise UseAfterFreeError(ptr.ref, "free")
            self._buffers.pop(ptr.ref, None)
            self._sizes.pop(ptr.ref, None)

    @property
    def live_refs(self) -> int:
        with self._lock:
            return len(self._buffers)


@dataclasses.dataclass
class _QueueItem:
    kind: str                  # 'malloc' | 'free' | 'memcpy' | 'kernel' | 'sync'
    fn: Optional[Callable[[], Any]]
    event: Optional[threading.Event]


class AsyncQueue:
    """Ordered async execution queue (CUDA-stream-like)."""

    def __init__(self, allocator: Optional[VirtualAllocator] = None):
        self.allocator = allocator or VirtualAllocator()
        self._q: "queue.Queue[_QueueItem]" = queue.Queue()
        self._stats = {"enqueued": 0, "executed": 0, "max_depth": 0,
                       "errors": 0}
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self) -> None:
        # A failing kernel/memcpy must not kill the worker: the queue keeps
        # draining (so later synchronize()/close() never deadlock on an event
        # nobody will set) and the first error is parked for the next
        # synchronize() to re-raise on the calling thread.
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                if item.fn is not None:
                    item.fn()
            except BaseException as e:           # noqa: BLE001 — parked
                self._stats["errors"] += 1
                with self._error_lock:
                    if self._error is None:      # first error wins
                        self._error = e
            finally:
                self._stats["executed"] += 1
                if item.event is not None:
                    item.event.set()

    def _enqueue(self, kind: str, fn: Optional[Callable[[], Any]] = None,
                 event: Optional[threading.Event] = None) -> None:
        self._stats["enqueued"] += 1
        self._stats["max_depth"] = max(self._stats["max_depth"],
                                       self._q.qsize() + 1)
        self._q.put(_QueueItem(kind, fn, event))

    # -- paper API ----------------------------------------------------------
    def malloc_async(self, nbytes: int) -> VirtualPtr:
        ptr = self.allocator.malloc(nbytes)
        self._enqueue("malloc", lambda: self.allocator.materialize(ptr))
        return ptr

    def free_async(self, ptr: VirtualPtr) -> None:
        self._enqueue("free", lambda: self.allocator.free(ptr))

    def memcpy_async(self, dst: VirtualPtr, src: np.ndarray) -> None:
        # Snapshot the source bytes AT ENQUEUE TIME.  ``ascontiguousarray``
        # is a no-op for contiguous inputs, returning the caller's own array
        # — copying it later on the worker thread would let a caller that
        # mutates ``src`` after enqueue corrupt the transfer in flight.
        snap = np.ascontiguousarray(src)
        if snap.base is not None or snap is src:
            snap = snap.copy()
        flat = snap.view(np.uint8).reshape(-1)

        def copy():
            self.allocator.resolve(dst)[:flat.size] = flat
        self._enqueue("memcpy", copy)

    def launch(self, fn: Callable[[], Any]) -> None:
        self._enqueue("kernel", fn)

    def synchronize(self) -> None:
        """Barrier.  If any queued operation failed since the last barrier,
        the first stored error is re-raised here, on the caller's thread —
        the CUDA-style deferred error report."""
        ev = threading.Event()
        self._enqueue("sync", None, ev)
        ev.wait()
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def pending_error(self) -> Optional[BaseException]:
        """The parked error the next synchronize() would raise (or None)."""
        with self._error_lock:
            return self._error

    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def close(self) -> None:
        """Drain and stop the worker.  Never hangs and never raises: a
        parked error stays retrievable via ``pending_error()`` but must not
        turn shutdown into a deadlock or a throw."""
        ev = threading.Event()
        self._enqueue("sync", None, ev)
        ev.wait(timeout=5.0)
        self._stop.set()
        self._worker.join(timeout=5.0)

from .registry import (Backend, HardwareSpec, Impl, available_backends,
                       candidates, get_backend, get_impl, h100_spec,
                       register_backend, register_impl,
                       register_reference_impl, register_shared_impl, resolve)

__all__ = ["Backend", "HardwareSpec", "Impl", "available_backends",
           "candidates", "get_backend", "get_impl", "h100_spec",
           "register_backend", "register_impl", "register_reference_impl",
           "register_shared_impl", "resolve"]

from .registry import (Backend, HardwareSpec, Impl, available_backends,
                       candidates, for_device, get_backend, get_impl,
                       h100_spec, register_backend, register_impl,
                       register_reference_impl, register_shared_impl, resolve,
                       set_layout_preference)
from . import host_cpu as _host_cpu   # registers the host_cpu backend

__all__ = ["Backend", "HardwareSpec", "Impl", "available_backends",
           "candidates", "for_device", "get_backend", "get_impl",
           "h100_spec", "register_backend", "register_impl",
           "register_reference_impl", "register_shared_impl", "resolve",
           "set_layout_preference"]

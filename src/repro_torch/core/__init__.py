"""SOL core for PyTorch: graph IR, compiler passes, autotune cache and the
reference executor."""
from . import autotune, ir, passes

__all__ = ["autotune", "ir", "passes"]

"""repro_torch — the SOL reproduction ported to PyTorch and CUDA on an
NVIDIA H100.  It mirrors ``repro`` (the JAX/TPU package, kept as the
reference) module for module and imports neither ``jax`` nor ``repro``."""

__version__ = "0.1.0"

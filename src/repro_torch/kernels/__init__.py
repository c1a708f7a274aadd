"""Hand-written Hopper kernels for SOL's hot layers.  Each family is a
subpackage, the counterpart of ``repro.kernels.<family>``:

  kernel.py — the launching wrapper (CUDA C++ through ctypes, or Triton);
              builds at first use, never at import
  ops.py    — public entry + dispatch-table registration; a CPU tensor takes
              the plain version, a CUDA tensor the kernel
  ref.py    — the plain PyTorch version the tests and ``chip_smoke.py``
              hold the kernel to

CUDA sources live in ``csrc/`` and are built by ``build.py``.
"""

"""isvins_tpu_torch — the PyTorch/CUDA port of the isvins_tpu VIO engine.

The JAX package `isvins_tpu` stays the reference; this package mirrors its
layout (geom, factors, solver, ops, estimator, initial, utils, parallel)
with the same module and function names, on torch tensors. The TPU Pallas
kernels of the steady frame path are hand-written CUDA for Hopper under
`csrc/`, bound through ctypes in `ops/`.

This package never imports jax or isvins_tpu.
"""

__all__ = ["device"]

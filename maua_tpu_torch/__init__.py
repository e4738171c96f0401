"""maua_tpu_torch: the PyTorch / CUDA port of maua_tpu for NVIDIA Hopper.

Module names follow `maua_tpu`, so each module's counterpart there is
easy to find; the JAX package is the reference the port is tested
against. The port imports torch, numpy and scipy, never jax or
maua_tpu. Tensors are NCHW inside; entry points run on `cuda` unless
the caller passes another device. Hand-written kernels live in
`csrc/` (CUDA C++, built with nvcc, bound with ctypes) and are wrapped
in `kernels/`.
"""

__version__ = "0.1.0"

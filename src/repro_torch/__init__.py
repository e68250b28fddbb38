"""repro_torch: the CluSD retrieval system in PyTorch, for one NVIDIA H100.

A second package beside the JAX package `repro`, laid out module for
module like it. It imports torch and numpy, never jax and never `repro`:
what it needs from `repro` it keeps as its own copy. The JAX package is
the reference; tests/test_torch_*.py hold every ported piece against it
on the same inputs.

Every entry point takes `device=None`, which means the CUDA card
(repro_torch.device). The Pallas kernels of the serving path are CUDA
C++ kernels for sm_90a under csrc/, bound through ctypes
(repro_torch.kernels).
"""

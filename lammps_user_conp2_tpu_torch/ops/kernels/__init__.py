"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

The port's counterpart of the JAX package's ``ops/pallas``.  Each wrapper
launches its kernel for a CUDA float32 tensor, takes the plain version for
a CPU tensor, and raises for anything else.
"""

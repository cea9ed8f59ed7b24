"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

The port's counterpart of the JAX package's ``ops/pallas``.  Every wrapper
routes by the device and dtype of its input alone (``build.kernel_route``):

* a CUDA float32 tensor launches the hand kernel;
* a CUDA float64 tensor takes the plain version, on the device (the
  kernels are float32 only; the JAX package likewise runs its XLA branch
  in float64), inside the step's CUDA graphs like any other op;
* a CPU tensor takes the plain version;
* a CUDA tensor of any other dtype raises TypeError.

A kernel that fails to build or to launch raises: nothing falls back.
"""

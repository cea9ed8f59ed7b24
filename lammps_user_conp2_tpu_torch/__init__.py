"""PyTorch/CUDA port of the constant-potential MD engine.

The JAX package ``lammps_user_conp2_tpu`` is the reference; this package
reproduces its mid-size main path (factored Ewald, INV charge solve, dense
pair sweep with the CONP Gaussian correction) in PyTorch, with the two
per-pair sweeps written as CUDA kernels for Hopper (``csrc/``).  On a CPU
tensor every kernel wrapper takes its plain PyTorch version instead.

Importing this package never imports jax.
"""

import torch

__version__ = "0.1.0"

# full-float32 products everywhere: the factored-Ewald contractions and the
# A^-1 b matvec lose ~1e-3 e in the charges under TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

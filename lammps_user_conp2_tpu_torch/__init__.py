"""PyTorch/CUDA port of the constant-potential MD engine.

The JAX package ``lammps_user_conp2_tpu`` is the reference; this package
reproduces its mid-size path (factored Ewald, INV charge solve, dense pair
sweep with the CONP Gaussian correction), its 100k-atom path (Verlet
block list, tiled PPPM) and the ionic-liquid decks (SHAKE/RATTLE; CONP,
CONQ and COND; FFIELD, NOSLAB, EHGO, zmirror) in PyTorch, with the TPU
kernels of those paths written as CUDA kernels for Hopper (``csrc/``),
and the JAX package's user surface: the command line (``cli``, ``python
-m lammps_user_conp2_tpu_torch``), the diagnostics and the pressure, the
log, dump, rerun, checkpoint, matrix-file and timing utilities.  The
entry points run on the card unless the caller passes ``device="cpu"``; every kernel wrapper launches its kernel on a CUDA
float32 tensor and takes its plain PyTorch version on a CPU or a CUDA
float64 tensor.

Importing this package never imports jax.
"""

import torch

__version__ = "0.1.0"

# full-float32 products everywhere: the factored-Ewald contractions and the
# A^-1 b matvec lose ~1e-3 e in the charges under TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

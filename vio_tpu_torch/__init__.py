"""vio_tpu_torch: the PyTorch/CUDA port of vio_tpu.

Same module layout and function names as ``vio_tpu``; plain functions on
tensors, with an explicit device and dtype.  The entry points
(``runner.run_sim``, ``Estimator``) run on the CUDA device unless the
caller passes ``device="cpu"`` (``device.resolve``).  The one TPU kernel on the
simulation main path (the Gauss-Jordan SPD solve) is a hand-written CUDA
kernel here (``csrc/gj_solve.cu``, wrapper ``ops.linsolve.gj_solve``),
built with nvcc at first use on a CUDA tensor.  Importing the package
builds nothing and never imports JAX.
"""
__version__ = "0.1.0"

import torch as _torch

# Reduced-precision (TF32) matmuls took the 200-frame APE from 0.00072 m to
# 0.399 m in the reference's precision A/B (RESULTS.md): keep every float32
# product in true float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

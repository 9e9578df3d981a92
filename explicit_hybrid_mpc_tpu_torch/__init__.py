"""Approximate explicit hybrid MPC on CUDA: the PyTorch port.

The same offline build (an eps-suboptimal simplicial partition of a
hybrid MPC problem's parameter space) and online evaluation (locate the
leaf simplex, interpolate its vertex inputs) as the JAX package
``explicit_hybrid_mpc_tpu``, with every device kernel written by hand
in CUDA C++ for Hopper (``csrc/``) beside a plain torch version of the
same function.  Entry points run on the first CUDA device unless the
caller asks for the CPU (``backend="cpu"``), where each kernel's plain
version runs instead; ``backend="serial"`` is the host baseline (one
QP per call, solved in numpy on the host), reached only by name.

Numerical policy: float64 everywhere the interior-point method needs
it, explicit ``dtype=torch.float64`` on every tensor (the global
default dtype is never changed).  float32 matrix products run in full
IEEE float32: TF32 keeps about three decimal digits, which the f32 IPM
leg and point location cannot afford, so it is switched off for the
process when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig  # noqa: E402,F401

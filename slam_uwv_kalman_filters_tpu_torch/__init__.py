"""slam_uwv_kalman_filters_tpu_torch — the PyTorch/CUDA port of the filter engine.

A second package beside the JAX reference (``slam_uwv_kalman_filters_tpu``),
with the same layout and module names so each counterpart is easy to find:

  ops/       manifold algebra, UKF core, vehicle dynamics, geodesy, kernels
  models/    PoseUKF (generic per-instance path, lanes-layout fused path),
             the mission driver and the fleet Monte-Carlo harness
  parallel/  filter-bank helpers, failover, checkpoints, sharding over
             torch.distributed
  utils/     config schema, validation, numpy <-> torch conversion,
             metrics, tracing
  examples/  runnable examples (python -m ...examples.<name>)
  csrc/      hand-written CUDA C++ kernels for Hopper (sm_90a)

Plain functions on tensors; state and parameters are NamedTuples of tensors
with the JAX field names. On a CUDA tensor the kernel wrappers launch the
hand-written kernels (built with ``nvcc`` at first use, see
``ops/cuda_lib.py``); on a CPU tensor they run the plain PyTorch version of
the same function.

The covariance algebra must never run in reduced precision (a TF32 product
flips posterior variances negative, the same failure bf16 caused on the
TPU), so importing the package pins full-precision float32 matmuls.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

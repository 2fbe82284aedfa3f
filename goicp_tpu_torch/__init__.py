"""goicp_tpu_torch — the Go-ICP registration engine in PyTorch with CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of `goicp_tpu` (JAX/XLA/Pallas), which stays beside it as the
reference each module is tested against.  Module paths mirror the JAX
package, so `goicp_tpu/X/y.py` has its counterpart at
`goicp_tpu_torch/X/y.py`.

  config.py the search configuration (GoICPConfig)
  geom/     Rodrigues rotations, cloud normalisation
  io/, chem/ the numpy host helpers preparation needs (6-digit
            quantisation, c-FPFH bins, property codes, neighbour weights)
  grid/     exact 3D EDT + nearest-occupied-cell fields, DT lookups
  pipeline/ per-pair preparation (PairData), shape buckets
  bounds/   translation-node bound evaluation: torch gather path (CPU) and
            the four hand-written CUDA kernels (bounds/cuda_eval.py, csrc/)
  icp/      batched trimmed ICP with a closed-form 3x3 Jacobi SVD
  search/   inner translation BnB, the device-side outer engine
            (device_engine.py) and the cross-pair streams built on it:
            fused_stream.py (every pair of a window advances each
            iteration) and packed_stream.py (a slot budget of lanes picked
            across the window)
  dist/     stacking prepared pairs along a pair axis (mesh.py)
  bench/    the bench's synthetic pair pools and bucketed preparation

The port stands alone: it imports neither jax nor `goicp_tpu`.
Everything runs in float32 with TF32 off, mirroring the
`Precision.HIGHEST` pins of the JAX package.
"""

import torch

from goicp_tpu_torch.config import GoICPConfig  # noqa: F401

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The first CUDA card when there is one, else the CPU."""
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")

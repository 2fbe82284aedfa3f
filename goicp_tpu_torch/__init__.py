"""goicp_tpu_torch — the Go-ICP registration engine in PyTorch with CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of `goicp_tpu` (JAX/XLA/Pallas), which stays beside it as the
reference each module is tested against.  Module paths mirror the JAX
package, so `goicp_tpu/X/y.py` has its counterpart at
`goicp_tpu_torch/X/y.py`.

  config.py the search configuration (GoICPConfig)
  geom/     Rodrigues rotations, cloud normalisation
  io/, chem/ file readers and writers (.mol2, .xyz, .cfpfh, BO1 pair
            lists, output files) and the numpy host helpers preparation
            needs (6-digit quantisation, property codes, neighbour weights)
  native/   the host C++ runtime: the outer search's batched heap and the
            .mol2 / float-table parsers, built at first use
  grid/     exact 3D EDT + nearest-occupied-cell fields, DT lookups
  pipeline/ per-pair preparation (PairData), shape buckets, the pair
            runner, the BO1 sweeps and the demo
  cli.py    the command line: run-pair, run-bo1, run-demo
  bounds/   translation-node bound evaluation: torch gather path (CPU) and
            the four hand-written CUDA kernels (bounds/cuda_eval.py, csrc/)
  icp/      batched trimmed ICP with a closed-form 3x3 Jacobi SVD
  search/   inner translation BnB, the host-streaming outer engine
            (outer.py), the device-side outer engine (device_engine.py)
            and the cross-pair streams built on it:
            fused_stream.py (every pair of a window advances each
            iteration) and packed_stream.py (a slot budget of lanes picked
            across the window); sharded_engine.py, per-rank rotation
            frontiers over several GPUs
  dist/     the multi-GPU layer on torch.distributed: the data x search
            mesh, its collectives and pair stacking (mesh.py), a launcher
            of n ranks (spawn.py), every multi-GPU engine once (dryrun.py)
  bench/    the bench (measure.py: pools, bucketed preparation, main)

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
    """The first CUDA card.  Without one this raises: an entry point runs on
    the CPU only when its caller passes device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to run on "
                           "the CPU")
    return torch.device("cuda:0")

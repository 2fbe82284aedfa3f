"""Rotations: batched angle-axis (Rodrigues) conversion.

Port of goicp_tpu/geom/rotation.py.  The BnB parameterizes SO(3) by the
angle-axis ball of radius pi; a rotation cube's center converts to a matrix
via Rodrigues.  Zero angle maps to identity.  The angle (norm3) and its
sin and cos (sincos32) take utils/fp32.py's fixed forms, the same on every
device.

On a CUDA float32 tensor rodrigues is one launch of
csrc/fp32_products.cu through utils/fp32.py's rodrigues_kernel (a thread
a vector: rot_body.cuh's norm3_of and rodrigues_of, which the
transition's pop runs too); on a CPU tensor it is rodrigues_plain, the
same function in elementwise torch ops and the same bits.  Its callers
are the host engine's outer step (the lanes' rotations) and the ICP
seeds of every device engine's first incumbent.
"""

from __future__ import annotations

import numpy as np
import torch

from goicp_tpu_torch.utils.fp32 import (_on_card, norm3_plain,
                                        rodrigues_kernel, sincos32_plain)


def rodrigues(v: torch.Tensor) -> torch.Tensor:
    """Angle-axis vectors (..., 3) -> rotation matrices (..., 3, 3): one
    launch of csrc/fp32_products.cu on a CUDA tensor (rodrigues_kernel),
    rodrigues_plain on a CPU one."""
    if _on_card(v):
        return rodrigues_kernel(v)
    return rodrigues_plain(v)


def rodrigues_plain(v: torch.Tensor) -> torch.Tensor:
    """rodrigues in elementwise torch ops, the angle and its sine and
    cosine by norm3_plain and sincos32_plain (no kernel of ours on the
    card either)."""
    t = norm3_plain(v)[..., None]
    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    u = v / safe_t
    u = torch.where(t > 0, u, torch.zeros_like(u))
    st, ct = sincos32_plain(t)
    st, ct = st[..., None], ct[..., None]             # (..., 1, 1)
    one_ct = 1.0 - ct

    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    zeros = torch.zeros_like(ux)
    K = torch.stack([
        torch.stack([zeros, -uz, uy], dim=-1),
        torch.stack([uz, zeros, -ux], dim=-1),
        torch.stack([-uy, ux, zeros], dim=-1),
    ], dim=-2)
    uuT = u[..., :, None] * u[..., None, :]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return ct * eye + st * K + one_ct * uuT


def rodrigues_np(v: np.ndarray) -> np.ndarray:
    """Host-side double-precision Rodrigues for output fidelity."""
    v = np.asarray(v, dtype=np.float64)
    t = np.linalg.norm(v)
    if t == 0:
        return np.eye(3)
    u = v / t
    K = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    return (np.eye(3) * np.cos(t) + np.sin(t) * K
            + (1 - np.cos(t)) * np.outer(u, u))

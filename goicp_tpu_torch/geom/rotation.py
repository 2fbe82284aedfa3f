"""Rotations: batched angle-axis (Rodrigues) conversion.

Port of goicp_tpu/geom/rotation.py.  The BnB parameterizes SO(3) by the
angle-axis ball of radius pi; a rotation cube's center converts to a matrix
via Rodrigues.  Zero angle maps to identity.  The angle (norm3) and its
sin and cos (sincos32, one launch for both on the card) take
utils/fp32.py's fixed forms, the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from goicp_tpu_torch.utils.fp32 import norm3, sincos32


def rodrigues(v: torch.Tensor) -> torch.Tensor:
    """Angle-axis vectors (..., 3) -> rotation matrices (..., 3, 3)."""
    t = norm3(v)[..., None]
    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    u = v / safe_t
    u = torch.where(t > 0, u, torch.zeros_like(u))
    st, ct = sincos32(t)
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

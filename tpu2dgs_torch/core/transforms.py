"""Quaternion / surfel geometry transforms (port of tpu2dgs/core/transforms.py).

Conventions match the reference so checkpoints interoperate: quaternions
are (w, x, y, z), un-normalized in the parameter store and normalized on
use; `splat_axes` returns the scaled tangent axes t_u, t_v and the unit
normal t_w (columns 0/1/2 of R(q) scaled by (s_u, s_v, 1)).
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` (F.normalize semantics: clamped norm)."""
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    return v / torch.clamp(n, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix (normalizes q)."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def splat_axes(scaling: torch.Tensor, rotation: torch.Tensor):
    """Per-splat world-space frame: (tu, tv, tw), each (..., 3).

    tu = s_u * R[:,0], tv = s_v * R[:,1], tw = R[:,2] (unit normal)."""
    R = quat_to_rotmat(rotation)
    tu = R[..., :, 0] * scaling[..., 0:1]
    tv = R[..., :, 1] * scaling[..., 1:2]
    tw = R[..., :, 2]
    return tu, tv, tw


def homogenize(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) with trailing 1."""
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))

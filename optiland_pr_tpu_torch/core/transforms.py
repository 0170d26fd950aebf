"""Rigid-body transforms between the global and per-surface local frames
(port of ``optiland_pr_tpu/core/transforms.py``).

- localize:  v_local = R^T (v - t) for positions, d_local = R^T d for directions
- globalize: v = R v_local + t
- R = Rz(rz) @ Ry(ry) @ Rx(rx)
"""
from __future__ import annotations

import torch

__all__ = ["rotation_matrix", "localize", "globalize"]


def rotation_matrix(rx, ry, rz):
    """R = Rz @ Ry @ Rx for Euler angles in radians, as a [3, 3] tensor."""
    rx, ry, rz = torch.broadcast_tensors(*(torch.as_tensor(a)
                                           for a in (rx, ry, rz)))
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    return torch.stack([torch.stack([r00, r01, r02]),
                        torch.stack([r10, r11, r12]),
                        torch.stack([r20, r21, r22])])


def localize(R, tx, ty, tz, x, y, z, L, M, N):
    """Transform positions and directions into the local frame."""
    dx, dy, dz = x - tx, y - ty, z - tz
    xl = R[0, 0] * dx + R[1, 0] * dy + R[2, 0] * dz
    yl = R[0, 1] * dx + R[1, 1] * dy + R[2, 1] * dz
    zl = R[0, 2] * dx + R[1, 2] * dy + R[2, 2] * dz
    Ll = R[0, 0] * L + R[1, 0] * M + R[2, 0] * N
    Ml = R[0, 1] * L + R[1, 1] * M + R[2, 1] * N
    Nl = R[0, 2] * L + R[1, 2] * M + R[2, 2] * N
    return xl, yl, zl, Ll, Ml, Nl


def globalize(R, tx, ty, tz, x, y, z, L, M, N):
    """Transform positions and directions back to the global frame."""
    xg = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + tx
    yg = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + ty
    zg = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + tz
    Lg = R[0, 0] * L + R[0, 1] * M + R[0, 2] * N
    Mg = R[1, 0] * L + R[1, 1] * M + R[1, 2] * N
    Ng = R[2, 0] * L + R[2, 1] * M + R[2, 2] * N
    return xg, yg, zg, Lg, Mg, Ng

"""Rigid-transform (SE(3)) utilities — counterpart of
``piecewise_icp_tpu/ops/transform.py``.

Host helpers are numpy float64 copies of the reference's (the JAX module
imports ``jax.numpy`` at the top, so it cannot be imported here); device
helpers work on torch tensors.  Angle extraction mirrors ``matrix2angle``
(CommonFunc.cpp:385-407): x-y-z Euler angles with the gimbal-lock branches.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import ARC_TO_GON


# ----------------------------------------------------------------------
# Host (numpy, float64)
# ----------------------------------------------------------------------

def matrix_to_angles(trans_mat: np.ndarray) -> np.ndarray:
    """Euler angles (ax, ay, az) in radians from a 4x4 (or 3x3) matrix."""
    m = np.asarray(trans_mat, dtype=np.float64)
    m20 = m[2, 0]
    if m20 == 1.0 or m20 == -1.0:
        az = 0.0
        delta = math.atan2(m[0, 1], m[0, 2])
        if m20 == -1.0:
            ay = math.pi / 2
            ax = az + delta
        else:
            ay = -math.pi / 2
            ax = -az + delta
    else:
        ay = -math.asin(m20)
        c = math.cos(ay)
        ax = math.atan2(m[2, 1] / c, m[2, 2] / c)
        az = math.atan2(m[1, 0] / c, m[0, 0] / c)
    return np.array([ax, ay, az], dtype=np.float64)


def matrix_to_params_gon(trans_mat: np.ndarray) -> np.ndarray:
    """(Rx, Ry, Rz [gon], tx, ty, tz [m])."""
    ang = matrix_to_angles(trans_mat) * ARC_TO_GON
    t = np.asarray(trans_mat, dtype=np.float64)[:3, 3]
    return np.concatenate([ang, t])


def translation_matrix(shift: np.ndarray) -> np.ndarray:
    """4x4 translation-only matrix."""
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = np.asarray(shift, dtype=np.float64)
    return m


def params_to_matrix(x: np.ndarray) -> np.ndarray:
    """Exact SE(3) matrix R = Rz Ry Rx from (rx, ry, rz [rad], tx, ty, tz)."""
    rx, ry, rz, tx, ty, tz = [float(v) for v in np.asarray(x).ravel()]
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = Rz @ Ry @ Rx
    m[:3, 3] = [tx, ty, tz]
    return m


def apply_transform_np(points: np.ndarray, trans_mat: np.ndarray) -> np.ndarray:
    pts = np.asarray(points)
    m = np.asarray(trans_mat, dtype=pts.dtype)
    return pts @ m[:3, :3].T + m[:3, 3]


def skew(v: np.ndarray) -> np.ndarray:
    """[v]x cross-product matrix, sign convention of the adjoint VCM
    propagation (Registration.cpp:1076-1078)."""
    x, y, z = [float(a) for a in np.asarray(v).ravel()]
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def adjoint_6x6(trans_mat: np.ndarray) -> np.ndarray:
    """SE(3) adjoint in the (rot, trans) parameter order of the rigorous
    VCM chaining: Ad = [[R, 0], [[t]x R, R]] (Registration.cpp:1074-1082)."""
    m = np.asarray(trans_mat, dtype=np.float64)
    R = m[:3, :3]
    ad = np.zeros((6, 6), dtype=np.float64)
    ad[:3, :3] = R
    ad[3:, 3:] = R
    ad[3:, :3] = skew(m[:3, 3]) @ R
    return ad


# ----------------------------------------------------------------------
# Device (torch)
# ----------------------------------------------------------------------

def apply_transform(points: torch.Tensor, trans_mat: torch.Tensor
                    ) -> torch.Tensor:
    """Transform ``[N, 3]`` points by a 4x4 matrix."""
    m = trans_mat.to(points.dtype)
    return points @ m[:3, :3].T + m[:3, 3]


def params_to_matrix_torch(x: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`params_to_matrix` (same dtype as ``x``)."""
    cx, sx = torch.cos(x[0]), torch.sin(x[0])
    cy, sy = torch.cos(x[1]), torch.sin(x[1])
    cz, sz = torch.cos(x[2]), torch.sin(x[2])
    one, zero = torch.ones_like(x[0]), torch.zeros_like(x[0])
    Rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cx, -sx]),
                      torch.stack([zero, sx, cx])])
    Ry = torch.stack([torch.stack([cy, zero, sy]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    Rz = torch.stack([torch.stack([cz, -sz, zero]),
                      torch.stack([sz, cz, zero]),
                      torch.stack([zero, zero, one])])
    R = (Rz @ Ry) @ Rx
    top = torch.cat([R, x[3:6, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=x.dtype,
                          device=x.device)
    return torch.cat([top, bottom], dim=0)


def bounding_box_corner_change(bb_min: torch.Tensor, bb_max: torch.Tensor,
                               trans_mat: torch.Tensor) -> torch.Tensor:
    """Max displacement of the two AABB corners under a transform — the
    Piecewise-ICP convergence metric (CommonFunc.cpp:410-419)."""
    R = trans_mat[:3, :3]
    c1 = R @ bb_min + trans_mat[:3, 3]
    c2 = R @ bb_max + trans_mat[:3, 3]
    d1 = torch.linalg.vector_norm(c1 - bb_min)
    d2 = torch.linalg.vector_norm(c2 - bb_max)
    return torch.maximum(d1, d2)


def masked_aabb(points: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB (min, max corners) over the valid points."""
    big = torch.finfo(points.dtype).max
    pmin = torch.where(mask[:, None], points, big).amin(dim=0)
    pmax = torch.where(mask[:, None], points, -big).amax(dim=0)
    return pmin, pmax

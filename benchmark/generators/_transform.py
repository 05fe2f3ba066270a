"""The two rigid-motion helpers the generators need (float64, numpy)."""

from __future__ import annotations

import math

import numpy as np


def params_to_matrix(x) -> np.ndarray:
    """Exact SE(3) matrix R = Rz Ry Rx from (rx, ry, rz [rad], tx, ty, tz)."""
    rx, ry, rz, tx, ty, tz = [float(v) for v in np.asarray(x).ravel()]
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = rot_z @ rot_y @ rot_x
    m[:3, 3] = [tx, ty, tz]
    return m


def apply_transform_np(points: np.ndarray, trans_mat: np.ndarray
                       ) -> np.ndarray:
    pts = np.asarray(points)
    m = np.asarray(trans_mat, dtype=pts.dtype)
    return pts @ m[:3, :3].T + m[:3, 3]

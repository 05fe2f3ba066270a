"""Batched closed-form symmetric 3x3 eigen-decomposition — counterpart of
``piecewise_icp_tpu/ops/eigh3.py``.

Trigonometric (Cardano) eigenvalues and the largest-row-cross-product
smallest eigenvector, with the reference's (0, 0, 1) fallback for
degenerate input.  ``torch.linalg.eigh`` is not used: its eigenvector sign
and degenerate handling differ from the reference's.
"""

from __future__ import annotations

from typing import Tuple

import math

import torch


def eigvals3(cov: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric ``[..., 3, 3]`` matrices, descending."""
    a00 = cov[..., 0, 0]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a11 = cov[..., 1, 1]
    a12 = cov[..., 1, 2]
    a22 = cov[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))

    det_b = (b00 * (b11 * b22 - a12 * a12)
             - a01 * (a01 * b22 - a12 * a02)
             + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det_b / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    vals = torch.stack([e1, e2, e3], dim=-1)
    iso = (p2 <= 0)[..., None]
    return torch.where(iso, q[..., None].expand_as(vals), vals)


def smallest_eigvec3(cov: torch.Tensor, eig_min: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for the smallest eigenvalue of ``[..., 3, 3]``."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    b = cov - eig_min[..., None, None] * eye
    r0, r1, r2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best12 = torch.where((n12 >= n02)[..., None], c12, c02)
    nbest12 = torch.maximum(n12, n02)
    best = torch.where((n01 >= nbest12)[..., None], c01, best12)
    nbest = torch.maximum(n01, nbest12)
    norm = torch.sqrt(torch.clamp(nbest, min=0.0))[..., None]
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    ok = norm > 1e-20
    return torch.where(ok, best / torch.where(ok, norm, torch.ones_like(norm)),
                       fallback)


def eigh3(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues descending ``[..., 3]``, smallest eigenvector)."""
    vals = eigvals3(cov)
    return vals, smallest_eigvec3(cov, vals[..., 2])

"""Point-to-plane ICP on patch centroids + VCM estimation — counterpart of
``piecewise_icp_tpu/models/icp.py``.

Each step re-establishes 1-NN correspondences over the (small) centroid
clouds, accumulates the 6x6 point-to-plane normal equations, solves them
in float32 on the device and composes the exact SE(3) update.  Parameter
order (Rx, Ry, Rz, tx, ty, tz):

    A_i = [Nz Qy - Ny Qz,  Nx Qz - Nz Qx,  Ny Qx - Nx Qy,  Nx, Ny, Nz]
    L_i = N . (P - Q)

The reference's ``lax.while_loop`` becomes a Python loop over device
tensors; its continue condition is evaluated on the device and read back
as ONE scalar per iteration.  Convergence mirrors PCL's
DefaultConvergenceCriteria (transform epsilon, absolute/relative MSE
change, max iterations).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.nn_cuda import sqdist
from ..ops.transform import params_to_matrix_torch
from ..utils.logging import log


def _masked_nn(q: torch.Tensor, q_mask: torch.Tensor,
               t: torch.Tensor, t_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked 1-NN for small clouds (patch centroids); ties to the
    lowest target index."""
    d2 = sqdist(q[:, None, :], t[None, :, :])
    d2 = torch.where(t_mask[None, :], d2, torch.inf)
    idx = torch.argmin(d2, dim=1)
    d = torch.sqrt(torch.clamp(d2.min(dim=1).values, min=0.0))
    d = torch.where(q_mask, d, torch.inf)
    return idx, d


def _p2pl_rows(src: torch.Tensor, tgt_pt: torch.Tensor, tgt_n: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearised point-to-plane rows (A [N, 6], L [N])."""
    qx, qy, qz = src[:, 0], src[:, 1], src[:, 2]
    nx, ny, nz = tgt_n[:, 0], tgt_n[:, 1], tgt_n[:, 2]
    a = torch.stack([nz * qy - ny * qz,
                     nx * qz - nz * qx,
                     ny * qx - nx * qy,
                     nx, ny, nz], dim=1)
    l = (tgt_n * (tgt_pt - src)).sum(dim=1)
    return a, l


def point_to_plane_icp(target: torch.Tensor, target_normals: torch.Tensor,
                       target_mask: torch.Tensor,
                       source: torch.Tensor, source_mask: torch.Tensor,
                       max_iterations: int = 100,
                       transformation_eps: float = 1e-8,
                       fitness_eps: float = 1e-6,
                       source_normals: torch.Tensor | None = None,
                       symmetric: bool = False,
                       target_var: torch.Tensor | None = None,
                       source_var: torch.Tensor | None = None
                       ) -> Tuple[torch.Tensor, int]:
    """Iterative point-to-plane alignment of ``source`` onto ``target``.

    With ``symmetric=True`` (and ``source_normals``, rotated with the
    source by every update) the residuals use the sign-aligned bisector
    ``0.5 * (n_t + s * n_s)`` of the matched normals, s = sign(n_t . n_s)
    with 0 taken as +1, left unnormalised: |n_t + n_s| < 2 where the
    normals disagree, which down-weights inconsistent correspondences.
    With ``target_var`` and ``source_var`` every row is weighted by
    sqrt(iv / mean iv), iv = 1 / max(var_t[idx] + var_s, 1e-14), the mean
    over the masked sources.  The defaults are the reference objective
    with uniform weights.  Returns (4x4 transform f32, iterations
    executed)."""
    f32 = dict(dtype=target.dtype, device=target.device)
    eye6 = 1e-12 * torch.eye(6, **f32)
    n_valid = torch.clamp(source_mask.sum(), min=1).to(target.dtype)
    weighted = target_var is not None and source_var is not None
    trans = torch.eye(4, **f32)
    src = source
    src_n = (source_normals if source_normals is not None
             else torch.zeros_like(source))
    prev_mse = torch.tensor(torch.inf, **f32)
    mse = torch.tensor(torch.inf, **f32)
    it = 0
    while True:
        idx, dist = _masked_nn(src, source_mask, target, target_mask)
        tgt_n = target_normals[idx]
        if symmetric:
            sign = torch.sign((tgt_n * src_n).sum(dim=1, keepdim=True))
            tgt_n = 0.5 * (tgt_n + torch.where(sign == 0, 1.0, sign) * src_n)
        a, l = _p2pl_rows(src, target[idx], tgt_n)
        w = source_mask.to(target.dtype)[:, None]
        if weighted:
            iv = 1.0 / torch.clamp(target_var[idx] + source_var, min=1e-14)
            iv_mean = torch.where(source_mask, iv, 0.0).sum() / n_valid
            w = w * torch.sqrt(iv / torch.clamp(iv_mean, min=1e-30))[:, None]
        a = a * w
        l = l * w[:, 0]
        ata = a.T @ a
        atl = a.T @ l
        x = torch.linalg.solve(ata + eye6, atl)
        t_delta = params_to_matrix_torch(x)
        src = src @ t_delta[:3, :3].T + t_delta[:3, 3]
        src_n = src_n @ t_delta[:3, :3].T
        trans = t_delta @ trans
        prev_mse, mse = mse, torch.where(source_mask, dist * dist,
                                         0.0).sum() / n_valid
        tr_sqr = (t_delta[:3, 3] ** 2).sum()
        cos_angle = (torch.trace(t_delta[:3, :3]) - 1.0) / 2.0
        delta_ok = (tr_sqr <= transformation_eps) & (cos_angle >= 0.99999)
        it += 1
        # the reference's while-loop condition, on the device, one read
        change = torch.abs(mse - prev_mse)
        go = (~delta_ok) & ((change > fitness_eps)
                            | (change > 1e-5 * torch.clamp(prev_mse,
                                                           min=1e-30)))
        if it >= max_iterations or not bool(go):
            return trans, it


def vcm_normal_equations(target: torch.Tensor, target_normals: torch.Tensor,
                         target_mask: torch.Tensor,
                         source: torch.Tensor, source_mask: torch.Tensor):
    """Device part of calTransParaVCM: correspondences + A, L rows."""
    idx, _ = _masked_nn(source, source_mask, target, target_mask)
    a, l = _p2pl_rows(source, target[idx], target_normals[idx])
    return a, l, source_mask


def compute_vcm(target: np.ndarray, target_normals: np.ndarray,
                target_mask: np.ndarray, source: np.ndarray,
                source_mask: np.ndarray):
    """Gauss-Markov VCM of the 6 transform parameters (calTransParaVCM).

    Correspondences and rows in float32 torch on the host arrays' CPU
    copies; the 6x6 algebra in numpy float64: Qxx = (A^T A)^-1,
    sigma0^2 = v^T v / (N - 6), VCM = sigma0^2 Qxx.  Returns
    (VCM, x, sigma0_sq)."""
    a, l, valid = (t.numpy() for t in vcm_normal_equations(
        torch.as_tensor(target), torch.as_tensor(target_normals),
        torch.as_tensor(target_mask), torch.as_tensor(source),
        torch.as_tensor(source_mask)))
    a = a[valid].astype(np.float64)
    l = l[valid].astype(np.float64)
    n = a.shape[0]
    ata = a.T @ a
    if abs(np.linalg.det(ata)) < 1e-9:
        log.warning("VCM normal matrix is near-singular")
    qxx = np.linalg.inv(ata)
    x = qxx @ (a.T @ l)
    v = a @ x - l
    sigma0_sq = float(v @ v) / max(n - 6, 1)
    return sigma0_sq * qxx, x, sigma0_sq

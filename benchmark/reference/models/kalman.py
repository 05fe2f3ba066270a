"""Kalman smoothing of the transformation time series — counterpart of
``piecewise_icp_tpu/models/kalman.py`` (a numpy float64 copy: the JAX
module imports ``jax.numpy`` through ``ops.transform``).

A forward Kalman filter and Rauch-Tung-Striebel smoother over the six
transform parameters (Rx, Ry, Rz [rad], tx, ty, tz [m]) chained to the
reference epoch, with the propagated per-epoch VCMs as measurement
covariances:

    state     x_k = x_{k-1} + w_k,   w ~ N(0, Q)       (random walk)
    measure   z_k = x_k + v_k,       v ~ N(0, VCM_k)

``process_noise="auto"`` sets Q from the data: the mean square of the
epoch-to-epoch increments less their noise, where the noise share is read
from the increments' lag-1 autocovariance (whiteness).  Only certified
white (independent per-epoch) error is averaged; chained error, which
accumulates, leaves the trajectory as it is.  The reported covariances
come from the formal-R recursion.  The JAX module explains each choice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ..ops.transform import matrix_to_angles, params_to_matrix


@dataclasses.dataclass
class SmoothedTrajectory:
    params: np.ndarray        # [N, 6] smoothed (rad, m)
    covariances: np.ndarray   # [N, 6, 6]
    filtered: np.ndarray      # [N, 6] forward-pass estimates
    trans_mats: List[np.ndarray]  # smoothed 4x4 matrices


def _params_from_matrix(m: np.ndarray) -> np.ndarray:
    ang = matrix_to_angles(m)
    return np.concatenate([ang, np.asarray(m, dtype=np.float64)[:3, 3]])


def kalman_smooth_transforms(trans_mats: Sequence[np.ndarray],
                             vcms: Sequence[np.ndarray],
                             process_noise: float | str | np.ndarray = "auto"
                             ) -> SmoothedTrajectory:
    """RTS-smooth a chained transform sequence.

    ``trans_mats``/``vcms`` are the per-epoch to-reference transforms and
    covariances (the outputs of :func:`chaining.chain_to_reference`).
    ``process_noise`` is the diagonal random-walk intensity (scalar or
    per-component [6]); the default ``"auto"`` matches it to the data by
    variance decomposition: Var(z_k - z_{k-1}) = Q + R_k + R_{k-1}, so
    Q = max(Var(diff z) - 2 mean(diag R), floor).  A fixed tiny Q on a
    sequence with real epoch-to-epoch motion would otherwise flatten the
    trajectory instead of denoising it.
    """
    n = len(trans_mats)
    if n == 0:
        return SmoothedTrajectory(np.zeros((0, 6)), np.zeros((0, 6, 6)),
                                  np.zeros((0, 6)), [])
    z = np.stack([_params_from_matrix(m) for m in trans_mats])
    r = np.stack([np.asarray(v, dtype=np.float64) for v in vcms])
    for k in range(n):
        d = np.diag(r[k])
        floor = max(np.max(d) * 1e-12, 1e-18)
        r[k] = r[k] + np.eye(6) * floor
    if isinstance(process_noise, str) and process_noise == "auto":
        mean_r = np.mean([np.diag(rk) for rk in r], axis=0)
        if n >= 4:
            d = np.diff(z, axis=0)
            msq = np.mean(d * d, axis=0)
            autocov = np.mean(d[1:] * d[:-1], axis=0)
            phi = -autocov / np.maximum(msq, 1e-300)
            se_pool = 1.0 / np.sqrt(6.0 * (n - 2))
            phi_raw = float(np.mean(phi))
            if phi_raw > 0.5 - se_pool:
                phi_pool = min(phi_raw, 0.5)
            else:
                phi_pool = max(phi_raw - se_pool, 0.0)
            se_c = 1.0 / np.sqrt(n - 2)
            w_frac = np.clip(2.0 * np.minimum(phi_pool, phi + se_c),
                             0.02, 1.0)
            r_hat = np.clip(-autocov, 0.0, mean_r)
            inc_var = msq
        else:
            inc_var = 4.0 * mean_r  # too short to estimate: track closely
            r_hat = mean_r
            w_frac = np.ones(6)
        q_diag = np.maximum(inc_var - 2.0 * r_hat, 0.02 * mean_r)
        q = np.diag(q_diag)
        s_w = np.sqrt(w_frac)
        r_gain = r * np.outer(s_w, s_w)[None, :, :]
    elif np.isscalar(process_noise):
        q = np.eye(6) * float(process_noise)
        r_gain = r
    else:
        q = np.diag(np.asarray(process_noise, dtype=np.float64))
        r_gain = r

    x_filt, x_smooth, p_smooth, _ = _rts_pass(z, r_gain, q)
    if r_gain is not r:
        p_smooth = _rts_pass(z, r, q)[2]

    mats = [params_to_matrix(x) for x in x_smooth]
    return SmoothedTrajectory(params=x_smooth, covariances=p_smooth,
                              filtered=x_filt, trans_mats=mats)


def _rts_pass(z: np.ndarray, r: np.ndarray, q: np.ndarray):
    """Forward Kalman filter + RTS smoother for the random-walk model.

    Returns (x_filt, x_smooth, p_smooth, p_filt)."""
    n = z.shape[0]
    eye = np.eye(6)
    x_pred = np.zeros((n, 6))
    p_pred = np.zeros((n, 6, 6))
    x_filt = np.zeros((n, 6))
    p_filt = np.zeros((n, 6, 6))

    x_prev, p_prev = z[0], r[0]
    for k in range(n):
        if k == 0:
            x_pred[k], p_pred[k] = z[0], r[0] + q
        else:
            x_pred[k] = x_prev
            p_pred[k] = p_prev + q
        s = p_pred[k] + r[k]
        gain = np.linalg.solve(s.T, p_pred[k].T).T
        x_filt[k] = x_pred[k] + gain @ (z[k] - x_pred[k])
        p_filt[k] = (eye - gain) @ p_pred[k]
        x_prev, p_prev = x_filt[k], p_filt[k]

    x_smooth = x_filt.copy()
    p_smooth = p_filt.copy()
    for k in range(n - 2, -1, -1):
        c = np.linalg.solve(p_pred[k + 1].T, p_filt[k].T).T
        x_smooth[k] = x_filt[k] + c @ (x_smooth[k + 1] - x_pred[k + 1])
        p_smooth[k] = (p_filt[k]
                       + c @ (p_smooth[k + 1] - p_pred[k + 1]) @ c.T)
    return x_filt, x_smooth, p_smooth, p_filt

"""Synthetic terrain series: a frozen copy of the program's
``utils/synth.py`` (``terrain_cloud``, ``make_series``).  The same
generator state gives the same float32 bytes."""

from __future__ import annotations

import numpy as np

from ._transform import apply_transform_np, params_to_matrix


def terrain_cloud(rng: np.random.Generator, n_side: int = 90,
                  extent: float = 2.0, noise: float = 3e-4) -> np.ndarray:
    """A gently undulating surface scan with four steep planar pyramids
    (well-constrained in all six DOF); ``n_side**2`` points, float32."""
    u = np.linspace(0.0, extent, n_side)
    xx, yy = np.meshgrid(u, u)
    # jitter the sample locations first so points lie exactly on the surface
    xx = xx + rng.normal(scale=extent / n_side / 6, size=xx.shape)
    yy = yy + rng.normal(scale=extent / n_side / 6, size=yy.shape)
    zz = (0.04 * np.sin(2.0 * xx) * np.cos(1.5 * yy)
          + 0.015 * np.sin(3.1 * yy) + 0.05 * xx - 0.03 * yy)
    for cx, cy, amp, w in ((0.5, 0.55, 0.35, 0.42), (1.5, 0.5, 0.3, 0.38),
                           (0.6, 1.5, 0.32, 0.40), (1.45, 1.5, 0.28, 0.36)):
        zz += amp * np.maximum(
            0.0, 1.0 - np.maximum(np.abs(xx - cx), np.abs(yy - cy)) / w)
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    pts += rng.normal(scale=noise, size=pts.shape)
    return pts.astype(np.float32)


def make_series(rng: np.random.Generator, n_epochs: int,
                trend=(0.0, 0.0, 0.0), **kw):
    """(epochs, ground truth): epoch k is an independent scan of the
    surface moved by the inverse of the cumulative random-walk transform
    G_k (G_0 = I; steps with rotations of std 8e-4 rad and translations of
    std 3 mm plus ``trend`` in metres).  ``kw`` goes to
    :func:`terrain_cloud`."""
    gt = [np.eye(4)]
    for _ in range(1, n_epochs):
        step = params_to_matrix(np.concatenate([
            rng.normal(scale=8e-4, size=3),
            rng.normal(scale=3e-3, size=3) + np.asarray(trend, np.float64)]))
        gt.append(gt[-1] @ step)
    epochs = []
    for k in range(n_epochs):
        scan = terrain_cloud(rng, **kw)
        epochs.append(apply_transform_np(
            scan.astype(np.float64), np.linalg.inv(gt[k])).astype(np.float32))
    return epochs, gt


def make(rng: np.random.Generator, n_epochs: int, **kw):
    """The configuration's entry: :func:`make_series`."""
    return make_series(rng, n_epochs, **kw)

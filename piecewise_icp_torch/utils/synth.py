"""Synthetic terrain epochs (numpy only).

A JAX-free copy of the repository's test generator (``tests/util.py``:
``terrain_cloud``, ``make_pair``), so that the port can make its own
full-size pair where JAX is not installed.  Same formulas, same random
stream for the same generator: the clouds are identical.
"""

from __future__ import annotations

import numpy as np

from ..ops.transform import apply_transform_np, params_to_matrix


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


def make_pair(rng: np.random.Generator, params, **kw):
    """(cloud1, cloud2, T_true): cloud2 = T_true applied to an independent
    scan of the same surface."""
    c1 = terrain_cloud(rng, **kw)
    c2 = terrain_cloud(rng, **kw)
    t_true = params_to_matrix(np.asarray(params, dtype=np.float64))
    c2 = apply_transform_np(c2.astype(np.float64), t_true).astype(np.float32)
    return c1, c2, t_true

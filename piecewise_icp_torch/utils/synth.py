"""Synthetic terrain epochs and 4D series (numpy only).

A JAX-free copy of the repository's test generators (``tests/util.py``:
``terrain_cloud``, ``make_pair``; the series of ``tests/test_4d.py``), so
that the port can make its own full-size pairs and series where JAX is not
installed.  Same formulas, same random stream for the same generator: the
clouds are identical.
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


def make_series(rng: np.random.Generator, n_epochs: int,
                trend=(0.0, 0.0, 0.0), **kw):
    """A synthetic 4D series: (epochs, ground truth).

    Epoch k is an independent scan of the surface moved by the inverse of
    the cumulative random-walk transform G_k (G_0 = I; each step draws
    rotations with std 8e-4 rad and translations with std 3 mm, plus the
    translation ``trend`` in metres), so G_k maps the moved epoch-k scan
    back onto the reference frame — the semantics of
    ``defined_transformations.txt``.  A trend that carries the surface
    beyond DTinit within a few epochs makes the adaptive plan advance its
    target.  ``kw`` goes to :func:`terrain_cloud`.
    """
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


def write_ground_truth(path, gt) -> None:
    """Write ``defined_transformations.txt``: per epoch its 1-based number,
    then the 4x4 matrix, one row per line."""
    lines = []
    for k, g in enumerate(gt):
        lines.append(str(k + 1))
        for row in g:
            lines.append(" ".join(f"{v:.12f}" for v in row))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

"""Voxel grouping — K7 (``csrc/voxel.cu``).

Two functions group a cloud by a floor lattice and keep one value a
voxel:

* :func:`voxel_centroids` — the voxel-grid downsample: the centroid of
  each occupied voxel, in ascending voxel key order; the bits of the host
  ``ops/preprocess.py:voxel_downsample``;
* :func:`voxel_seeds` — the supervoxel seed choice: in each occupied
  voxel the point nearest the voxel's centre (ties to the smallest index),
  ascending; the indices of the host
  ``models/segmentation_device.py:propagate_seeds``.

On CUDA tensors K7 runs three steps: a key a point (the lattice key in
int64 from float64 coordinates; in the seed mode also the float64 squared
distance to the cell's centre), a stable sort of the keys (``torch.sort``),
and an epilogue a voxel over its points in sorted order.  A CUDA tensor
launches the kernel or raises.  On CPU tensors the host numpy functions are
the plain version.

On the card each call counts one ``voxel_device`` or ``seeds_device`` in
the innermost open span (``utils/logging.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import GLOBAL_TIMER, note_sync
from . import _cuda

_CENTROID, _NEAREST = 0, 1
_NO_KEY = torch.iinfo(torch.int64).max     # a point outside the mask

_F64 = torch.float64
_I64 = torch.int64


def _check_operands(points: torch.Tensor, mask: Optional[torch.Tensor],
                    res: float) -> None:
    if points.dtype != torch.float32 or points.dim() != 2 \
            or points.shape[1] != 3:
        raise ValueError("points: expected a float32 [n, 3] tensor, got "
                         f"{points.dtype} {tuple(points.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (points.shape[0],)):
        raise ValueError("mask: expected a bool [n] tensor, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if not res > 0.0:
        raise ValueError(f"voxel size must be > 0, got {res}")


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def _keys_kernel(points: torch.Tensor, mode: int, res: float,
                 origin: Optional[Sequence[float]],
                 mask: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = points.device
    n = points.shape[0]
    _cuda.check(points, "points", torch.float32, (n, 3))
    if mask is not None:
        _cuda.check(mask, "mask", torch.bool, (n,), dev)
    keys = torch.empty(n, dtype=_I64, device=dev)
    d2c = torch.empty(n if mode == _NEAREST else 0, dtype=_F64, device=dev)
    bounds = torch.empty(6, dtype=torch.int32, device=dev)
    ox, oy, oz = ((0.0, 0.0, 0.0) if origin is None
                  else tuple(float(v) for v in origin))
    _cuda.launch("pwicp_voxel_keys", "voxel_keys", points.data_ptr(),
                 None if mask is None else mask.data_ptr(), n, mode,
                 float(res), int(origin is not None), ox, oy, oz,
                 bounds.data_ptr(), keys.data_ptr(),
                 d2c.data_ptr() if d2c.numel() else None, device=dev)
    return keys, d2c


def _segments_kernel(points: torch.Tensor, skeys: torch.Tensor,
                     perm: torch.Tensor, starts: torch.Tensor,
                     d2c: torch.Tensor, mode: int) -> torch.Tensor:
    dev = points.device
    m = starts.shape[0]
    out = (torch.empty((m, 3), dtype=torch.float32, device=dev)
           if mode == _CENTROID else torch.empty(m, dtype=_I64, device=dev))
    _cuda.launch("pwicp_voxel_segments", "voxel_segments",
                 skeys.data_ptr(), perm.data_ptr(), starts.data_ptr(), m,
                 skeys.shape[0], points.data_ptr(),
                 d2c.data_ptr() if d2c.numel() else None, mode,
                 out.data_ptr() if mode == _CENTROID else None,
                 out.data_ptr() if mode == _NEAREST else None, device=dev)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _group(points: torch.Tensor, mode: int, res: float,
           origin: Optional[Sequence[float]],
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K7's keys, their stable sort, the voxels' first sorted positions
    (one counted sync), and K7's epilogue."""
    keys, d2c = _keys_kernel(points, mode, res, origin, mask)
    skeys, perm = torch.sort(keys, stable=True)
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    starts = torch.nonzero(first & (skeys != _NO_KEY)).squeeze(1)
    note_sync(starts)
    return _segments_kernel(points, skeys, perm, starts, d2c, mode)


def voxel_centroids(points: torch.Tensor, leaf: float) -> torch.Tensor:
    """Voxel-grid downsample of ``points`` [n, 3] float32: the centroid of
    each occupied voxel of the ``leaf`` lattice anchored at the cloud's
    minimum voxel, [m, 3] float32 in ascending linearised voxel id (PCL
    ``VoxelGrid`` semantics; the bits of ``voxel_downsample``)."""
    _check_operands(points, None, leaf)
    if not points.is_cuda:
        from .preprocess import voxel_downsample

        return torch.from_numpy(voxel_downsample(points.numpy(), leaf))
    GLOBAL_TIMER.count(voxel_device=1)
    if points.shape[0] == 0:
        return points.new_empty((0, 3))
    return _group(points, _CENTROID, leaf, None, None)


def voxel_seeds(points: torch.Tensor, resolution: float,
                origin: Optional[Sequence[float]] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Seed indices [S] int64, ascending: in each occupied voxel of the
    ``resolution`` lattice anchored at ``origin`` (default: the minimum of
    the live points; it must be <= that minimum), the point nearest the
    voxel's centre, ties to the smallest index.  Only points where
    ``mask`` holds take part; indices are into ``points`` (the indices of
    ``propagate_seeds`` over ``points[mask]``, mapped back).  Raises
    ValueError where no point is live, as ``propagate_seeds`` does on an
    empty cloud."""
    _check_operands(points, mask, resolution)
    if not points.is_cuda:
        from ..models.segmentation_device import propagate_seeds

        pts = points.numpy()
        if mask is None:
            return torch.from_numpy(
                propagate_seeds(pts, resolution, origin=origin)
                .astype(np.int64))
        live = np.flatnonzero(mask.numpy())
        return torch.from_numpy(live[propagate_seeds(
            pts[live], resolution, origin=origin)])
    GLOBAL_TIMER.count(seeds_device=1)
    winners = _group(points, _NEAREST, resolution, origin, mask)
    if winners.shape[0] == 0:
        raise ValueError("no live point to seed")
    return torch.sort(winners).values

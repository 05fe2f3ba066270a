"""Uniform-grid index — counterpart of ``piecewise_icp_tpu/ops/grid_nn.py``.

``build_grid`` is a host numpy copy of the reference's: targets binned into
cells of size ``h`` and sorted by linearised cell id (x-major, z fastest),
with a dense CSR ``cell_starts`` array.  The cell order is kept bit for bit,
because it fixes the lowest-index tie-breaks and the summation order of
everything downstream.

The TPU build re-laid the sorted cloud into x-slab-padded tiles
(``slab_padded_self_join``) so that its Pallas kernels could DMA three
contiguous ranges per query tile.  The CUDA kernels of this port walk each
query's own 27 CSR cell runs instead, so that layout is not needed:
:class:`CellGrid` carries the sorted points and the CSR array to the device
as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.logging import to_device


def _bucket(n: int, base: int = 8) -> int:
    """Round up to the next power-of-two multiple of ``base``."""
    b = base
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class GridIndex:
    """Host-built uniform-grid index over a target cloud."""

    points: np.ndarray        # [Tb, 3] sorted by cell id, bucket-padded
    ids: np.ndarray           # [Tb] original target indices (int32)
    cell_starts: np.ndarray   # [n_cells + 1] CSR offsets (int32), padded
    origin: np.ndarray        # [3] f32
    dims: Tuple[int, int, int]
    h: float
    n_real: int = 0           # real (unpadded) target count


MAX_GRID_CELLS = 1 << 26   # dense CSR cap: 64M cells = 256 MB of starts


def build_grid(targets: np.ndarray, h: float) -> GridIndex:
    """Bin + sort targets into a uniform grid of cell size ``h`` (host).

    Raises ValueError when the dense CSR array would exceed
    ``MAX_GRID_CELLS`` (``h`` small relative to the extent).
    """
    pts = np.asarray(targets, dtype=np.float32)
    if pts.shape[0] == 0:
        raise ValueError("cannot build a grid over an empty target cloud")
    origin = pts.min(axis=0)
    cell = np.floor((pts - origin) / h).astype(np.int64)
    dims = cell.max(axis=0) + 1
    dx, dy, dz = (int(dims[0]), int(dims[1]), int(dims[2]))
    if dx * dy * dz > MAX_GRID_CELLS:
        raise ValueError(
            f"dense grid of {dx}x{dy}x{dz} cells exceeds MAX_GRID_CELLS "
            f"(cell size {h} too small for the cloud extent)")
    lin = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]
    order = np.argsort(lin, kind="stable").astype(np.int32)
    n_cells = dx * dy * dz
    counts_all = np.bincount(lin, minlength=n_cells)
    starts = np.zeros(n_cells + 1, dtype=np.int32)
    np.cumsum(counts_all, out=starts[1:])
    # padding repeats the total count, so out-of-range cells read empty runs
    starts_bucket = _bucket(n_cells + 1, base=4096)
    if starts_bucket > starts.shape[0]:
        starts = np.concatenate([
            starts, np.full(starts_bucket - starts.shape[0], pts.shape[0],
                            dtype=np.int32)])
    n_real = pts.shape[0]
    n_pad = _bucket(max(n_real, 1), base=4096) - n_real
    pts_sorted = pts[order]
    ids = order
    if n_pad > 0:
        pts_sorted = np.concatenate(
            [pts_sorted, np.full((n_pad, 3), 1e30, dtype=np.float32)])
        ids = np.concatenate([ids, np.zeros(n_pad, dtype=np.int32)])
    return GridIndex(points=pts_sorted, ids=ids,
                     cell_starts=starts, origin=origin.astype(np.float32),
                     dims=(dx, dy, dz), h=float(h), n_real=n_real)


@dataclasses.dataclass
class CellGrid:
    """A :class:`GridIndex` on a torch device, as the kernels read it.

    ``points`` holds the ``n`` real points in cell-sorted order (the
    bucket padding of the host index is dropped: the CSR runs never reach
    it).  ``points`` may differ from the binned coordinates — SOR-removed
    points are moved to the 1e30 sentinel in place, keeping the CSR array
    valid (a sentinel point is never within ``h`` of anything).
    """

    points: torch.Tensor       # [n, 3] f32, cell-sorted
    cell_starts: torch.Tensor  # [>= n_cells + 1] int32
    origin: Tuple[float, float, float]
    dims: Tuple[int, int, int]
    h: float
    # plain-version cache: the self-join neighbour lists (within h) of the
    # binned points, shared by copies made with with_points (a superset of
    # the true lists after points move to the sentinel)
    _self_nbr: list = dataclasses.field(default_factory=list, repr=False)

    @classmethod
    def from_index(cls, grid: GridIndex, device: torch.device) -> "CellGrid":
        n = grid.n_real
        return cls(
            points=to_device(np.ascontiguousarray(grid.points[:n]), device),
            cell_starts=to_device(grid.cell_starts, device),
            origin=tuple(float(v) for v in grid.origin),
            dims=tuple(int(v) for v in grid.dims), h=float(grid.h))

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        dx, dy, dz = self.dims
        return min(dx * dy * dz, self.cell_starts.shape[0] - 1)

    def with_points(self, points: torch.Tensor) -> "CellGrid":
        """Same cells and CSR, other coordinates (see class docstring)."""
        return dataclasses.replace(self, points=points,
                                   _self_nbr=self._self_nbr)

    def kernel_args(self) -> list:
        """The grid part of every C entry's argument list."""
        from ._cuda import check

        check(self.points, "grid.points", torch.float32, (self.n, 3))
        check(self.cell_starts, "grid.cell_starts", torch.int32,
              device=self.points.device)
        ox, oy, oz = self.origin
        dx, dy, dz = self.dims
        return [self.points.data_ptr(), self.cell_starts.data_ptr(),
                self.n_cells, ox, oy, oz, self.h, dx, dy, dz]

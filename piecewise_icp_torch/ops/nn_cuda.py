"""Nearest-neighbour kernels — counterpart of
``piecewise_icp_tpu/ops/nn_pallas.py`` (and the brute ``ops/nn.py``).

Three hand-written CUDA kernels (``csrc/range_nn1.cu``,
``csrc/knn_sorted.cu``, ``csrc/nn1_brute.cu``) with a plain PyTorch version
of each beside its wrapper:

* :func:`range_nn1` (K1) — exact 1-NN of moving queries among the
  cell-sorted targets of a :class:`~.grid_nn.CellGrid`;
* :func:`knn_sorted` (K2) — exact k-NN of the grid's own points (the SOR
  self-join), ascending, ties to the lowest sorted index;
* :func:`nn1_brute` (K5) — exact 1-NN of every query against the whole
  target cloud, with optional query and target masks.

A wrapper runs its kernel when handed CUDA tensors and its plain version
when handed CPU tensors; there is no fallback between the two.  The plain
versions are chunked brute force, independent of the grid walk by
construction; both sides agree on every query the contract calls resolved
(nearest, or k-th nearest, within ``h``).  The brute k-NN distances of
resolution estimation and the small-cloud SOR (:func:`knn_distances`) are
plain PyTorch on every device, as the JAX package computes them in XLA.

Distances are coordinate-difference first, ((dx^2 + dy^2) + dz^2) with
separately rounded products and sums, never the |q|^2 + |t|^2 - 2 q.t
identity (it loses ~1e-4 absolute in f32 at metre scale).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _cuda
from .grid_nn import CellGrid


def _chunk_rows(n_targets: int, device: torch.device) -> int:
    """Query rows per chunk so one [rows, n_targets] f32 block stays
    within 256 MB on the card and 16 MB on the host."""
    budget = (1 << 26) if device.type == "cuda" else (1 << 22)
    return max(1, budget // max(n_targets, 1))


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the kernels receive it."""
    return float(np.float32(v))


def sqdist(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """((dx^2 + dy^2) + dz^2) between broadcastable [..., 3] tensors."""
    d = q - t
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _nn1_sq(queries: torch.Tensor, targets: torch.Tensor,
            t_mask: torch.Tensor | None = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked brute 1-NN, the arithmetic of the plain versions of K1 and
    K5 (nothing else calls it, so :data:`_cuda.PLAIN_ON_CUDA` sees every
    use): (idx [Q] int64, d2 [Q] f32); ties to the lowest target index, -1
    where no finite distance exists."""
    rows = _chunk_rows(targets.shape[0], targets.device)
    idx, d2 = [], []
    for s in range(0, queries.shape[0], rows):
        blk = sqdist(queries[s:s + rows, None, :], targets[None, :, :])
        if t_mask is not None:
            blk = torch.where(t_mask[None, :], blk, torch.inf)
        i = torch.argmin(blk, dim=1)        # first occurrence
        v = torch.gather(blk, 1, i[:, None])[:, 0]
        idx.append(torch.where(torch.isfinite(v), i, -1))
        d2.append(v)
    if not idx:
        e = queries.new_empty((0,))
        return e.long(), e
    return torch.cat(idx), torch.cat(d2)


def knn_distances(queries: torch.Tensor, targets: torch.Tensor, k: int,
                  t_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Distances [Q, k] to the k nearest targets, ascending (inf where
    fewer than k valid targets exist): the distances of ``ops/nn.py:knn``,
    by chunked brute force with ``torch.topk``.  Callers use only the
    distances, so the order of tied indices does not matter."""
    nt = targets.shape[0]
    kk = min(k, nt)
    rows = _chunk_rows(nt, targets.device)
    out = []
    for s in range(0, queries.shape[0], rows):
        blk = sqdist(queries[s:s + rows, None, :], targets[None, :, :])
        if t_mask is not None:
            blk = torch.where(t_mask[None, :], blk, torch.inf)
        v = torch.topk(blk, kk, dim=1, largest=False, sorted=True).values
        out.append(torch.sqrt(torch.clamp(v, min=0.0)))
    d = torch.cat(out) if out else queries.new_empty((0, kk))
    if kk < k:
        d = torch.nn.functional.pad(d, (0, k - kk), value=torch.inf)
    return d


def self_neighbours(grid: CellGrid) -> torch.Tensor:
    """Plain-version helper: for every grid point, the indices (ascending,
    -1 padded) of the grid points within ``h`` of it, by chunked brute
    force.  A relative margin of 1e-4 on h^2 keeps every point the
    kernels' explicit thresholds can accept; each consumer re-applies its
    own threshold.  Cached on the grid (see ``CellGrid``)."""
    if grid._self_nbr:
        return grid._self_nbr[0]
    pts = grid.points
    n = pts.shape[0]
    h2m = _f32(grid.h) ** 2 * (1.0 + 1e-4)
    rows = _chunk_rows(n, pts.device)
    blocks, width = [], 1
    for s in range(0, n, rows):
        near = sqdist(pts[s:s + rows, None, :], pts[None, :, :]) <= h2m
        r, c = near.nonzero(as_tuple=True)          # row-major: c ascending
        cnt = near.sum(dim=1)
        first = torch.cumsum(cnt, 0) - cnt
        pos = torch.arange(r.shape[0], device=pts.device) - first[r]
        w = int(cnt.max()) if cnt.numel() else 0
        blk = torch.full((near.shape[0], max(w, 1)), -1, dtype=torch.int64,
                         device=pts.device)
        blk[r, pos] = c
        blocks.append(blk)
        width = max(width, w)
    nbr = torch.cat([torch.nn.functional.pad(b, (0, width - b.shape[1]),
                                             value=-1) for b in blocks])
    grid._self_nbr.append(nbr)
    return nbr


def neighbour_d2(grid: CellGrid, nbr: torch.Tensor) -> torch.Tensor:
    """Squared distances of each grid point to its listed neighbours
    (current coordinates; inf on padding)."""
    pts = grid.points
    d2 = sqdist(pts[:, None, :], pts[torch.clamp(nbr, min=0)])
    return torch.where(nbr >= 0, d2, torch.inf)


# ---------------------------------------------------------------------------
# K1: range_nn1
# ---------------------------------------------------------------------------


def range_nn1_plain(queries: torch.Tensor, q_mask: torch.Tensor,
                    grid: CellGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: chunked brute 1-NN over all grid points.
    Returns (idx into sorted targets or -1, d2); masked queries (inf, -1)."""
    _cuda.note_plain("range_nn1", queries)
    idx, d2 = _nn1_sq(queries, grid.points)
    d2 = torch.where(q_mask, d2, torch.inf)
    return torch.where(q_mask, idx, -1), d2


def _range_nn1_kernel(queries: torch.Tensor, q_mask: torch.Tensor,
                      grid: CellGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    n = queries.shape[0]
    dev = grid.points.device
    _cuda.check(queries, "queries", torch.float32, (n, 3), dev)
    _cuda.check(q_mask, "q_mask", torch.bool, (n,), dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    _cuda.launch("pwicp_range_nn1", "range_nn1", queries.data_ptr(),
                 q_mask.data_ptr(), n, *grid.kernel_args(),
                 idx.data_ptr(), d2.data_ptr(), device=dev)
    return idx.long(), d2


def range_nn1(queries: torch.Tensor, q_mask: torch.Tensor, grid: CellGrid
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, bool]:
    """1-NN of ``queries`` among the grid's sorted points (K1).

    Returns (idx into the SORTED targets, dist, resolved [Q], strict).
    ``resolved`` queries (masked, or nearest within ``h``) carry their
    exact nearest distance; the per-query window walk covers every query,
    so ``strict`` (every unresolved query's true distance exceeds ``h``)
    always holds.
    """
    if queries.is_cuda:
        idx, d2 = _range_nn1_kernel(queries, q_mask, grid)
    else:
        idx, d2 = range_nn1_plain(queries, q_mask, grid)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    found = torch.isfinite(d) & (d <= _f32(grid.h))
    resolved = ~q_mask | found
    d = torch.where(q_mask, d, torch.inf)
    return torch.clamp(idx, min=0), d, resolved, True


# ---------------------------------------------------------------------------
# K2: knn_sorted
# ---------------------------------------------------------------------------


def knn_sorted_plain(grid: CellGrid, q_mask: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2: the k nearest of each grid point among its brute-force
    neighbours within ``h`` (stable sort over ascending indices).
    Returns (idx [n, k] or -1, d2 [n, k] or inf)."""
    _cuda.note_plain("knn_sorted", grid.points)
    nbr = self_neighbours(grid)
    d2 = neighbour_d2(grid, nbr)
    d2s, order = torch.sort(d2, dim=1, stable=True)
    idx = torch.gather(nbr, 1, order)
    if d2s.shape[1] < k:
        pad = k - d2s.shape[1]
        d2s = torch.nn.functional.pad(d2s, (0, pad), value=torch.inf)
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    d2s, idx = d2s[:, :k], idx[:, :k]
    ok = torch.isfinite(d2s) & q_mask[:, None]
    return torch.where(ok, idx, -1), torch.where(ok, d2s, torch.inf)


def _knn_sorted_kernel(grid: CellGrid, q_mask: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not 1 <= k <= 32:
        raise ValueError(f"knn_sorted kernel supports 1 <= k <= 32, got {k}")
    n = grid.n
    dev = grid.points.device
    _cuda.check(q_mask, "q_mask", torch.bool, (n,), dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)   # per call
    _cuda.launch("pwicp_knn_sorted", "knn_sorted", q_mask.data_ptr(), k,
                 *grid.kernel_args(), counter.data_ptr(), idx.data_ptr(),
                 d2.data_ptr(), device=dev)
    return idx.long(), d2


def knn_sorted(grid: CellGrid, q_mask: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-NN of the grid's own points among themselves (K2, self-join).

    Returns (idx [n, k] into the SORTED order, -1 on empty slots;
    dist [n, k] ascending, inf on empty slots and masked queries;
    resolved [n]).  ``resolved`` queries (k-th neighbour within ``h``)
    carry their exact k nearest; the rest must be recomputed by the
    caller.
    """
    if grid.points.is_cuda:
        idx, d2 = _knn_sorted_kernel(grid, q_mask, k)
    else:
        idx, d2 = knn_sorted_plain(grid, q_mask, k)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    kth_ok = torch.isfinite(d[:, -1]) & (d[:, -1] <= _f32(grid.h))
    resolved = ~q_mask | kth_ok
    d = torch.where(q_mask[:, None], d, torch.inf)
    return idx, d, resolved


# ---------------------------------------------------------------------------
# K5: nn1_brute
# ---------------------------------------------------------------------------


def nn1_brute_plain(queries: torch.Tensor, targets: torch.Tensor,
                    q_mask: torch.Tensor | None = None,
                    t_mask: torch.Tensor | None = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K5: chunked brute 1-NN.  Returns (idx or -1, d2); masked
    queries and queries without a finite distance give (-1, inf)."""
    _cuda.note_plain("nn1_brute", queries)
    idx, d2 = _nn1_sq(queries, targets, t_mask)
    if q_mask is not None:
        idx = torch.where(q_mask, idx, -1)
        d2 = torch.where(q_mask, d2, torch.inf)
    return idx, d2


def _nn1_brute_kernel(queries: torch.Tensor, targets: torch.Tensor,
                      q_mask: torch.Tensor | None = None,
                      t_mask: torch.Tensor | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    nq, nt = queries.shape[0], targets.shape[0]
    dev = targets.device
    _cuda.check(queries, "queries", torch.float32, (nq, 3), dev)
    _cuda.check(targets, "targets", torch.float32, (nt, 3), dev)
    if q_mask is not None:
        _cuda.check(q_mask, "q_mask", torch.bool, (nq,), dev)
    if t_mask is not None:
        _cuda.check(t_mask, "t_mask", torch.bool, (nt,), dev)
    # only live queries work: the kernel reads them through this list
    live = None if q_mask is None \
        else torch.nonzero(q_mask).squeeze(1).to(torch.int32)
    nlive = nq if live is None else live.shape[0]
    tile = _cuda.lib().pwicp_nn1_tile()
    nt_pad = -(-nt // tile) * tile
    # scratch of this call (the prefetch thread may be in here too): the
    # targets as a padded structure of arrays, and the packed minima
    soa = torch.empty(3 * nt_pad, dtype=torch.float32, device=dev)
    packed = torch.empty(nq, dtype=torch.int64, device=dev)
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    d2 = torch.empty(nq, dtype=torch.float32, device=dev)
    _cuda.launch("pwicp_nn1_brute", "nn1_brute", queries.data_ptr(),
                 None if live is None else live.data_ptr(), nlive, nq,
                 targets.data_ptr(),
                 None if t_mask is None else t_mask.data_ptr(), nt, nt_pad,
                 soa.data_ptr(), packed.data_ptr(), idx.data_ptr(),
                 d2.data_ptr(), device=dev)
    return idx.long(), d2


def nn1_brute(queries: torch.Tensor, targets: torch.Tensor,
              q_mask: torch.Tensor | None = None,
              t_mask: torch.Tensor | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of every query against the whole target cloud (K5), with
    the contract of ``ops/nn.py:nn1``: (idx [Q] int64 clamped >= 0,
    Euclidean distance [Q] f32); ties go to the lowest target index,
    masked targets are never matched, masked queries get +inf."""
    if queries.is_cuda:
        idx, d2 = _nn1_brute_kernel(queries, targets, q_mask, t_mask)
    else:
        idx, d2 = nn1_brute_plain(queries, targets, q_mask, t_mask)
    return torch.clamp(idx, min=0), torch.sqrt(torch.clamp(d2, min=0.0))

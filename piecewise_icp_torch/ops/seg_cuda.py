"""Segmentation kernels — counterpart of ``piecewise_icp_tpu/ops/seg_pallas.py``.

Two hand-written CUDA kernels (``csrc/seg_stats.cu``, ``csrc/prop_round.cu``)
with a plain PyTorch version of each beside its wrapper:

* :func:`seg_stats` (K3) — per point of the cell-sorted self-join: the
  k-th-neighbour squared radius t2 by 3 rounds x 8 bins of histogram
  refinement over [0, h^2], the neighbour count within t2 and the
  query-centred first/second moments; then covariance -> closed-form
  eigensolve -> normals;
* :func:`prop_round` (K4) — one synchronous round of seeded label
  propagation under the VCCS metric, or of the orphan sweep (``adopt``);
  :func:`propagate_rounds` runs it to convergence (<= 256 rounds), then
  the sweep.

A wrapper runs its kernel when handed CUDA tensors and its plain version
when handed CPU tensors.  The plain versions work on brute-force neighbour
lists within ``h`` (``nn_cuda.self_neighbours``), independent of the grid
walk; every threshold either side tests is <= ``h``, so both see the same
candidates.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda
from .eigh3 import eigvals3, smallest_eigvec3
from .grid_nn import CellGrid
from .nn_cuda import neighbour_d2, self_neighbours, sqdist

_NBINS = 8
_NROUNDS = 3
_STATS = 16
_BIG = 1e30


# ---------------------------------------------------------------------------
# K3: seg_stats
# ---------------------------------------------------------------------------


def seg_stats_plain(grid: CellGrid, q_mask: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """Plain K3: the [n, 16] statistics rows (see ``csrc/seg_stats.cu``)."""
    _cuda.note_plain("seg_stats", grid.points)
    pts = grid.points
    n = pts.shape[0]
    nbr = self_neighbours(grid)
    t = pts[torch.clamp(nbr, min=0)]
    d = pts[:, None, :] - t                     # query - neighbour
    d2 = torch.where(nbr >= 0, sqdist(pts[:, None, :], t), torch.inf)
    f32 = dict(dtype=torch.float32, device=pts.device)
    h2 = torch.tensor(grid.h * grid.h, **f32)   # as the kernel receives it
    lo = torch.zeros(n, **f32)
    hi = h2.expand(n).clone()
    for _ in range(_NROUNDS):
        step = (hi - lo) / _NBINS
        edges = [lo + step * b for b in range(1, _NBINS + 1)]
        cums = [(d2 <= e[:, None]).sum(dim=1) for e in edges]
        new_lo, new_hi = lo, hi
        found = torch.zeros(n, dtype=torch.bool, device=pts.device)
        prev = lo
        for b in range(_NBINS):
            hit = ~found & (cums[b] >= k)
            new_lo = torch.where(hit, prev, new_lo)
            new_hi = torch.where(hit, edges[b], new_hi)
            found = found | hit
            prev = edges[b]
        lo = torch.where(found, new_lo, lo)
        hi = torch.where(found, new_hi, hi)
    t2 = hi
    m = d2 <= t2[:, None]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def s(v):
        return torch.where(m, v, 0.0).sum(dim=1)

    out = torch.zeros((n, _STATS), **f32)
    cols = [m.sum(dim=1).to(torch.float32), t2, s(-dx), s(-dy), s(-dz),
            s(dx * dx), s(dy * dy), s(dz * dz), s(dx * dy), s(dx * dz),
            s(dy * dz)]
    out[:, :11] = torch.stack(cols, dim=1)
    masked = torch.zeros_like(out)
    masked[:, 1] = h2
    return torch.where(q_mask[:, None], out, masked)


def _seg_stats_kernel(grid: CellGrid, q_mask: torch.Tensor, k: int
                      ) -> torch.Tensor:
    n = grid.n
    dev = grid.points.device
    _cuda.check(q_mask, "q_mask", torch.bool, (n,), dev)
    out = torch.empty((n, _STATS), dtype=torch.float32, device=dev)
    _cuda.launch("pwicp_seg_stats", "seg_stats", q_mask.data_ptr(), n, k,
                 grid.h * grid.h, *grid.kernel_args(), out.data_ptr())
    return out


def seg_stats_rows(grid: CellGrid, q_mask: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """The raw [n, 16] K3 rows: cnt, t2, sum d (3), sum d d^T (6), zeros."""
    if grid.points.is_cuda:
        return _seg_stats_kernel(grid, q_mask, k)
    return seg_stats_plain(grid, q_mask, k)


def seg_stats(grid: CellGrid, q_mask: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point neighbourhood statistics of the grid's self-join.

    Returns (t2 [n] — squared adjacency radius of the ~k nearest;
    count [n]; normals [n, 3] — smallest eigenvector of the neighbourhood
    covariance).  Every query is covered (window walk), so no coverage
    mask is returned.
    """
    stats = seg_stats_rows(grid, q_mask, k)
    return stats[:, 1], stats[:, 0], normals_from_stats(stats)


def normals_from_stats(stats: torch.Tensor) -> torch.Tensor:
    """The K3 epilogue: query-centred moments -> covariance -> smallest
    eigenvector (closed form)."""
    cnt = torch.clamp(stats[:, 0], min=1.0)
    mean = stats[:, 2:5] / cnt[:, None]
    xx = stats[:, 5] / cnt - mean[:, 0] * mean[:, 0]
    yy = stats[:, 6] / cnt - mean[:, 1] * mean[:, 1]
    zz = stats[:, 7] / cnt - mean[:, 2] * mean[:, 2]
    xy = stats[:, 8] / cnt - mean[:, 0] * mean[:, 1]
    xz = stats[:, 9] / cnt - mean[:, 0] * mean[:, 2]
    yz = stats[:, 10] / cnt - mean[:, 1] * mean[:, 2]
    cov = torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1)], dim=-2)
    vals = eigvals3(cov)
    return smallest_eigvec3(cov, vals[..., 2])


# ---------------------------------------------------------------------------
# K4: prop_round
# ---------------------------------------------------------------------------


def prop_round_plain(grid: CellGrid, qall: torch.Tensor,
                     q_mask: torch.Tensor, state: torch.Tensor,
                     inv_res_04: float, h2: float, adopt: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: (new state [n, 8], changed count) — see
    ``csrc/prop_round.cu`` for the rule."""
    _cuda.note_plain("prop_round", grid.points)
    pts = grid.points
    n = pts.shape[0]
    f32 = dict(dtype=torch.float32, device=pts.device)
    nbr = self_neighbours(grid)
    d2c = neighbour_d2(grid, nbr)
    st = state[torch.clamp(nbr, min=0)]               # [n, K, 8]
    lab_c = torch.where(nbr >= 0, st[..., 6], -1.0)
    labelled = lab_c >= 0.0
    big = torch.tensor(_BIG, **f32)
    if adopt:
        mask = labelled & (d2c <= torch.tensor(h2, **f32))
        m = torch.sqrt(d2c)
    else:
        ds = torch.sqrt(sqdist(qall[:, None, 0:3], st[..., 0:3]))
        dot = (qall[:, None, 3] * st[..., 3] + qall[:, None, 4] * st[..., 4]
               + qall[:, None, 5] * st[..., 5])
        m = 1.0 - torch.abs(dot) + ds * torch.tensor(inv_res_04, **f32)
        mask = labelled & (d2c <= qall[:, None, 6])
    mask = mask & q_mask[:, None]
    m = torch.where(mask, m, big)
    best = m.min(dim=1).values
    at_best = m == best[:, None]
    lab_best = torch.where(at_best, lab_c, big).min(dim=1).values
    sel = at_best & (lab_c == lab_best[:, None])
    j = torch.argmax(sel.to(torch.int32), dim=1)      # first = lowest index
    win = st[torch.arange(n, device=pts.device), j]
    lab_own = state[:, 6]
    upd = best < big
    if adopt:
        upd = upd & (lab_own < 0.0)
    out = torch.zeros((n, 8), **f32)
    out[:, :6] = torch.where(upd[:, None], win[:, :6], 0.0)
    new_lab = torch.where(upd, lab_best, lab_own)
    out[:, 6] = new_lab
    return out, (new_lab != lab_own).sum().to(torch.int32)


def _prop_round_kernel(grid: CellGrid, qall: torch.Tensor,
                       q_mask: torch.Tensor, state: torch.Tensor,
                       inv_res_04: float, h2: float, adopt: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = grid.n
    dev = grid.points.device
    _cuda.check(qall, "qall", torch.float32, (n, 8), dev)
    _cuda.check(q_mask, "q_mask", torch.bool, (n,), dev)
    _cuda.check(state, "state", torch.float32, (n, 8), dev)
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    changed = torch.zeros((), dtype=torch.int32, device=dev)
    _cuda.launch("pwicp_prop_round", "prop_round", qall.data_ptr(),
                 q_mask.data_ptr(), n, state.data_ptr(), inv_res_04, h2,
                 int(adopt), *grid.kernel_args(), out.data_ptr(),
                 changed.data_ptr())
    return out, changed


def prop_round(grid: CellGrid, qall: torch.Tensor, q_mask: torch.Tensor,
               state: torch.Tensor, inv_res_04: float, h2: float,
               adopt: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi propagation round (K4) over the grid's self-join.

    ``qall`` [n, 8]: query xyz, normal, t2, pad.  ``state`` [n, 8]: seed
    xyz, seed normal, label (float, -1 = none), pad.  Returns the new
    state (a fresh tensor; ``state`` is only read) and the number of
    labels that changed, as a 0-dim int32 tensor on the device.
    """
    if grid.points.is_cuda:
        return _prop_round_kernel(grid, qall, q_mask, state, inv_res_04, h2,
                                  adopt)
    return prop_round_plain(grid, qall, q_mask, state, inv_res_04, h2, adopt)


def init_state(points: torch.Tensor, normals: torch.Tensor,
               seed_idx: torch.Tensor) -> torch.Tensor:
    """Seed state rows: seeds carry their own position, normal and slot id
    as label; every other row is -1."""
    state = torch.full((points.shape[0], 8), -1.0, dtype=torch.float32,
                       device=points.device)
    state[seed_idx, 0:3] = points[seed_idx]
    state[seed_idx, 3:6] = normals[seed_idx].to(torch.float32)
    state[seed_idx, 6] = torch.arange(seed_idx.shape[0], dtype=torch.float32,
                                      device=points.device)
    return state


def propagate_rounds(grid: CellGrid, normals: torch.Tensor, r2: torch.Tensor,
                     q_mask: torch.Tensor, seed_idx: torch.Tensor,
                     sv_resolution: float, max_rounds: int = 256
                     ) -> Tuple[torch.Tensor, int]:
    """Seeded metric label propagation to convergence (<= ``max_rounds``),
    then the orphan sweep.  Returns (labels [n] int64 in SORTED order =
    seed slot ids, -1 unlabelled; propagation rounds).  One scalar
    device-to-host read per round decides the loop."""
    pts = grid.points
    qall = torch.cat([pts, normals.to(torch.float32),
                      r2.to(torch.float32)[:, None],
                      torch.zeros_like(r2, dtype=torch.float32)[:, None]],
                     dim=1).contiguous()
    state = init_state(pts, normals, seed_idx)
    inv = float(0.4 / sv_resolution)
    h2 = float(grid.h) * float(grid.h)
    rounds = 0
    for adopt in (False, True):
        it, changed = 0, 1
        while changed > 0 and it < max_rounds:
            state, chg = prop_round(grid, qall, q_mask, state, inv, h2, adopt)
            changed = int(chg)
            it += 1
        if not adopt:
            rounds = it
    lab = state[:, 6]
    lab = torch.where(torch.isfinite(lab) & (lab >= 0), lab, -1.0).long()
    return torch.where(q_mask, lab, -1), rounds

"""Measurement helpers shared by ``chip_smoke.py`` and ``bench_torch.py``:
the card's name and power limit, kernel timing, the least time the card
could take for a kernel's work on given inputs (its bound), and the
registration's residual against a known transform.

The bound of a kernel is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's memory
rate, and the lane instructions these inputs need over the card's float32
rate.  The grid kernels' instructions are counted from the candidates
their queries meet in their 27-cell windows (:func:`window_pairs`), what
this run's data needs and not the most it could.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np

# Peak rates of one NVIDIA H100 SXM (data sheet): 3.35 TB/s of device memory
# and 67 TFLOP/s in float32 outside the tensor cores.  The 67 counts a fused
# multiply-add as two; the distance contract forbids fusing (products and
# sums are rounded separately), so an operation here is one lane instruction
# (a subtraction, a product, a sum, a comparison) and the peak is half of it.
PEAK_BYTES_S = 3.35e12
PEAK_LANE_OPS_S = 67e12 / 2


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, device: str = "cuda",
            warmup: bool = True) -> float:
    """Median of ``reps`` calls after one warm-up (``warmup``): each
    between two CUDA events on the card, on the host clock where
    ``device`` is the CPU."""
    import torch

    if warmup:
        fn()
    if torch.device(device).type == "cpu":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: every input read once and every
    output written once at the memory rate, or the lane instructions this
    run's data needs at the float32 rate, whichever is longer."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    by_ops = 1e3 * n_ops / PEAK_LANE_OPS_S
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=None)


def grid_bytes(grid) -> int:
    """Bytes of a grid as a kernel reads it: the sorted points and the
    cell starts."""
    return 12 * grid.n + 4 * (grid.n_cells + 1)


def window_counts(grid):
    """Per cell of ``grid``, the number of points in its 27-cell window."""
    import torch

    dx, dy, dz = grid.dims
    starts = grid.cell_starts[:dx * dy * dz + 1].long()
    counts = (starts[1:] - starts[:-1]).reshape(1, 1, dx, dy, dz).double()
    # zero cells around the grid: a window sum also where an axis has
    # fewer than 3 cells
    counts = torch.nn.functional.pad(counts, (1, 1, 1, 1, 1, 1))
    return torch.nn.functional.avg_pool3d(
        counts, 3, stride=1, divisor_override=1).reshape(-1)


def window_pairs(grid, queries=None, q_mask=None) -> int:
    """Candidates in the 27-cell windows of all live queries: what a grid
    kernel has to meet on these inputs.  ``queries`` None: the self-join
    (every grid point asks from the cell it was binned into)."""
    import torch

    dx, dy, dz = grid.dims
    box = window_counts(grid)
    if queries is None:
        starts = grid.cell_starts[:dx * dy * dz + 1].long()
        cell = torch.searchsorted(
            starts[1:].contiguous(),
            torch.arange(grid.n, device=starts.device), right=True)
    else:
        o = torch.tensor(grid.origin, dtype=torch.float32,
                         device=queries.device)
        c = torch.floor((queries - o) / np.float32(grid.h)).long()
        hi = torch.tensor([dx - 1, dy - 1, dz - 1], device=queries.device)
        c = torch.minimum(torch.clamp(c, min=0), hi)
        cell = (c[:, 0] * dy + c[:, 1]) * dz + c[:, 2]
    per_query = box[cell]
    if q_mask is not None:
        per_query = per_query[q_mask]
    return int(per_query.sum())


def range_nn1_bound(grid, nq: int, q_mask: bool, pairs: int) -> dict:
    """K1's bound for ``nq`` queries meeting ``pairs`` candidates: a
    distance and its comparison for each candidate; the grid, the queries
    (and their mask) in, index, distance, flag and count out."""
    return bound(grid_bytes(grid) + (12 + q_mask) * nq + 13 * nq + 4,
                 9 * pairs)


def knn_sorted_bound(grid, k: int, pairs: int) -> dict:
    """K2's bound on the self-join of ``grid`` (``pairs`` candidates, every
    query live): a distance (8) and its comparison with the k-th so far (1)
    for each candidate, then the order of the k kept (k log2 k comparisons
    a query); the grid and the mask in, k ids and distances out."""
    n = grid.n
    return bound(grid_bytes(grid) + n + 8 * n * k,
                 9 * pairs + n * k * int(np.ceil(np.log2(k))))


def nn1_brute_bound(nq: int, nt: int, live_pairs: int, q_mask: bool,
                    t_mask: bool) -> dict:
    """K5's bound: every live query meets every live target (3 differences,
    3 products, 2 sums and the comparison); queries and targets (and their
    masks) in, index and distance out."""
    return bound((12 + q_mask) * nq + (12 + t_mask) * nt + 8 * nq,
                 9 * live_pairs)


def knn_brute_bound(nq: int, nt: int, live_pairs: int, t_mask: bool,
                    out_per_query: int) -> dict:
    """K6's bound: every query meets every live target (3 differences, 3
    products, 2 sums and the comparison with the K-th so far; the list's
    upkeep depends on the order of the data and is not counted); queries
    and targets (and their mask) in, ``out_per_query`` floats a query out
    (K distances, or one SOR mean)."""
    return bound(12 * nq + (12 + t_mask) * nt + 4 * out_per_query * nq,
                 9 * live_pairs)


def truth_mm(t_est: np.ndarray, t_true: np.ndarray, pts: np.ndarray):
    """Mean and max displacement (mm) that T_est @ T_true leaves on
    ``pts`` (ideally none): ``T_true`` moved the source, and the
    registration estimates its inverse."""
    from ..ops.transform import apply_transform_np

    p = pts.astype(np.float64)
    d = np.linalg.norm(apply_transform_np(p, t_est @ t_true) - p, axis=1)
    return 1e3 * float(d.mean()), 1e3 * float(d.max())

"""Masked segment reductions — counterpart of
``piecewise_icp_tpu/ops/segment_ops.py``.

One flat point array plus an int label array stands for the ragged
per-patch point lists; every per-patch statistic is a segment reduction
over it.  Ids < 0 are dropped.

Float sums run in an order fixed by the input alone: the rows are sorted
by segment (stably, so each segment keeps its rows in index order) and
each segment's contiguous run is reduced by ``segment_reduce``, which
takes no atomics.  On the CPU that adds one row after another, the order
of the CPU's ``index_add_`` (and of the JAX package's ``segment_sum`` on
the CPU), so the bits there are those of a scatter-add.  A float
``index_add_`` on CUDA adds by atomics in whatever order the threads
arrive: two runs of one input then differ in the last bits, and so does
every patch statistic built on them.  Integer sums and the max/min
reductions do not depend on the order.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Dropped ids (< 0) go to an extra sink segment ``num_segments``."""
    return torch.where(segment_ids >= 0, segment_ids,
                       num_segments).long()


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows per segment; ids < 0 are dropped.  Float sums
    take an order fixed by the input (the same bits in every run)."""
    ids = _ids(segment_ids, num_segments)
    tail = tuple(data.shape[1:])
    if not data.is_floating_point():
        out = torch.zeros((num_segments + 1,) + tail, dtype=data.dtype,
                          device=data.device)
        out.index_add_(0, ids, data)
        return out[:num_segments]
    lengths = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=data.device)
    lengths.index_add_(0, ids, torch.ones_like(ids))
    order = torch.argsort(ids, stable=True)
    out = torch.segment_reduce(data[order].reshape(-1, math.prod(tail)),
                               "sum", lengths=lengths, axis=0, unsafe=True)
    return out.reshape((num_segments + 1,) + tail)[:num_segments]


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    if mask is not None:
        segment_ids = torch.where(mask, segment_ids, -1)
    ones = torch.ones(segment_ids.shape, dtype=torch.int32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    if mask is not None:
        segment_ids = torch.where(mask, segment_ids, -1)
    cnt = segment_count(segment_ids, num_segments).to(data.dtype)
    total = segment_sum(data, segment_ids, num_segments)
    denom = torch.clamp(cnt, min=1.0)
    if data.ndim > 1:
        denom = denom.reshape(denom.shape + (1,) * (data.ndim - 1))
    return total / denom


def _segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, op: str) -> torch.Tensor:
    if values.is_floating_point():
        init = -torch.inf if op == "amax" else torch.inf
    else:
        info = torch.iinfo(values.dtype)
        init = info.min if op == "amax" else info.max
    out = torch.full((num_segments + 1,), init, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, _ids(segment_ids, num_segments), values, op,
                        include_self=True)
    return out[:num_segments]


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_reduce(values, segment_ids, num_segments, "amax")


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_reduce(values, segment_ids, num_segments, "amin")


def segment_argmax(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Index (into ``values``) of the max per segment.

    Ties resolve to the smallest index (first occurrence); empty segments
    return an index clipped into range.
    """
    if mask is not None:
        values = torch.where(mask, values, -torch.inf)
        segment_ids = torch.where(mask, segment_ids, -1)
    seg_max = segment_max(values, segment_ids, num_segments)
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=values.device)
    valid_seg = (segment_ids >= 0) & (segment_ids < num_segments)
    gathered = torch.where(valid_seg,
                           seg_max[torch.clamp(segment_ids, 0,
                                               num_segments - 1).long()],
                           -torch.inf)
    is_max = (values == gathered) & valid_seg
    cand = torch.where(is_max, idx, n)
    out = segment_min(cand, segment_ids, num_segments)
    return torch.clamp(out, 0, n - 1)


def segment_argmin(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    vals = -values
    if mask is not None:
        vals = torch.where(mask, vals, -torch.inf)
    return segment_argmax(vals, segment_ids, num_segments, mask=mask)


def segment_cov3(points: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: torch.Tensor | None = None,
                 ddof: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-segment 3x3 covariance (divided by N - ddof), centroid, count."""
    ids = segment_ids if mask is None else torch.where(mask, segment_ids, -1)
    cnt = segment_count(ids, num_segments).to(points.dtype)
    mean = segment_mean(points, ids, num_segments)
    safe_ids = torch.clamp(ids, 0, num_segments - 1).long()
    centered = points - mean[safe_ids]
    centered = torch.where((ids >= 0)[:, None], centered, 0.0)
    outer = (centered[:, :, None] * centered[:, None, :]).reshape(-1, 9)
    cov = segment_sum(outer, ids, num_segments).reshape(-1, 3, 3)
    denom = torch.clamp(cnt - ddof, min=1.0)
    return cov / denom[:, None, None], mean, cnt

"""pair_p90_s: the nearest-rank 90th percentile of every pair's latency in
the window; a pair that failed counts as infinitely late."""

import math

from benchmark import stats


def read(ctx):
    if not ctx.requests:
        return None
    lat = [r["end"] - r["start"] if r["ok"] else math.inf
           for r in ctx.requests]
    return stats.percentile(lat, 90)

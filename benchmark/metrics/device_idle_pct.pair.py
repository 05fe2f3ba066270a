"""device_idle_pct.pair: share of the traced window in which no operation
ran on the device (one minus the union of the profiler's device
intervals over the window), %."""

from benchmark import stats


def read(ctx):
    if not ctx.traced or not ctx.ops:
        return None
    lo, hi = ctx.window_ns
    return stats.idle_pct([(s, e) for _, s, e in ctx.ops], lo, hi)

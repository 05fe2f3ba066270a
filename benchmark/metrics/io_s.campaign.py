"""io_s.campaign: host time covered by the program's ``io.*`` spans (PCD
reads, the pair files and reports) on either thread, s a campaign.  None
where the program's span records carry no start."""

from benchmark import stats


def read(ctx):
    if not ctx.traced or not ctx.done:
        return None
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    lo, hi = ctx.window_ns
    recs = [r for r in GLOBAL_TIMER.records
            if "start_ns" in r and lo <= r["end_ns"] <= hi]
    if not recs:
        return None
    io = [(r["start_ns"], r["end_ns"]) for r in recs
          if r["phase"].startswith("io.")]
    return stats.covered(io) * 1e-9 / len(ctx.done)

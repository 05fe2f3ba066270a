"""host_syncs.campaign: the times the host waited for the card, as the
program counts them where it makes them (``counts.syncs`` of the span
records of both threads, the campaign's and the prefetch thread's), an
epoch registered.  None where the program's span records carry no
counts."""


def read(ctx):
    if not ctx.traced or not ctx.done:
        return None
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    lo, hi = ctx.window_ns
    counts = [r["counts"] for r in GLOBAL_TIMER.records
              if "counts" in r and lo <= r["end_ns"] <= hi]
    if not counts:
        return None
    epochs = sum(r["units"] for r in ctx.done)
    return sum(c.get("syncs", 0) for c in counts) / epochs

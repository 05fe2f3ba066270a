"""h2d_copies.pair: the program's copies from the host to the card
(``counts.h2d`` of its span records), a completed pair.  None where the
program's span records carry no counts."""


def read(ctx):
    if not ctx.traced or not ctx.done:
        return None
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    lo, hi = ctx.window_ns
    counts = [r["counts"] for r in GLOBAL_TIMER.records
              if "counts" in r and lo <= r["end_ns"] <= hi]
    if not counts:
        return None
    return sum(c.get("h2d", 0) for c in counts) / len(ctx.done)

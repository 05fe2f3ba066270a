"""host_syncs.pair: the times the host waited for the card, as the program
counts them where it makes them (``counts.syncs`` of its span records:
blocking reads to the host, uploads from pageable memory, the implicit
synchronises of ``torch.nonzero`` and the like), a completed pair.  None
where the program's span records carry no counts."""


def read(ctx):
    if not ctx.traced or not ctx.done:
        return None
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    lo, hi = ctx.window_ns
    counts = [r["counts"] for r in GLOBAL_TIMER.records
              if "counts" in r and lo <= r["end_ns"] <= hi]
    if not counts:
        return None
    return sum(c.get("syncs", 0) for c in counts) / len(ctx.done)

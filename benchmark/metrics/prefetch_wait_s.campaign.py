"""prefetch_wait_s.campaign: time the campaign's thread stood blocked on
an epoch the prefetch thread was still preparing (the program's
``campaign.prefetch_wait`` spans), s a campaign.  None where the program's
span records carry no start."""


def read(ctx):
    if not ctx.traced or not ctx.done:
        return None
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    lo, hi = ctx.window_ns
    recs = [r for r in GLOBAL_TIMER.records
            if "start_ns" in r and lo <= r["end_ns"] <= hi]
    if not recs:
        return None
    return sum(r["seconds"] for r in recs
               if r["phase"] == "campaign.prefetch_wait") / len(ctx.done)

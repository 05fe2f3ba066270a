"""pairs_per_s: pairs registered, over the time from the window's opening
to the end of the last pair started in it."""

from benchmark import stats


def read(ctx):
    if not ctx.done:
        return None
    return stats.window_rate(sum(r["units"] for r in ctx.done), ctx.t_open,
                             ctx.t_last_end)

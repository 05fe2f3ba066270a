"""kernel_ms.campaign: device time of the program's own kernels, from the
profiler, ms an epoch registered."""


def read(ctx):
    if not ctx.traced or not ctx.done:
        return None
    ops = ctx.kernel_ops()
    if not ops:
        return None
    epochs = sum(r["units"] for r in ctx.done)
    return sum(e - s for _, s, e in ops) * 1e-6 / epochs

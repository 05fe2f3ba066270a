"""kernel_ms.pair: device time of the program's own kernels (every
``__global__`` function of its CUDA sources), from the profiler, ms a
pair."""


def read(ctx):
    if not ctx.traced or not ctx.done:
        return None
    ops = ctx.kernel_ops()
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) * 1e-6 / len(ctx.done)

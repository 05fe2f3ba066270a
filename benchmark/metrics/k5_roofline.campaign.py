"""k5_roofline.campaign: the brute 1-NN (K5, ``csrc/nn1_brute.cu``)
against its bound in the campaigns' planning: Q x N x 9 lane instructions
at the float32 peak for every brute probe of the plan that the reference
scans when it checks every source of the plan (Q, N the raw epoch
sizes), over the profiler's device time of
the K5 kernels.  The stage-1 rescues' few K5 launches add to the time and
not to the bound, so the share reads a little low.  Nothing when the plan
makes no brute probe, or the judge checked only part of the plan."""

from benchmark import stats

K5 = ("nn1_stage_targets", "nn1_brute_kernel", "nn1_finalize")


def read(ctx):
    probes = ctx.extra.get("plan_probes")
    if not ctx.traced or not probes or not ctx.done:
        return None
    epochs = ctx.extra["epoch_sizes"]
    shapes = [(epochs[src], epochs[tgt]) for tgt, src, brute in probes
              if brute]
    ops = ctx.kernel_ops(K5)
    if not shapes or not ops:
        return None
    bound = stats.brute_bound_s(shapes) * len(ctx.done)
    return 100.0 * bound / (sum(e - s for _, s, e in ops) * 1e-9)

"""seg_ms.pair: host time under the program's ``seg.*`` spans (the fused
SOR + segmentation, ``seg.fused``), ms a pair."""


def read(ctx):
    return ctx.span_ms_per_request("seg") if ctx.traced else None

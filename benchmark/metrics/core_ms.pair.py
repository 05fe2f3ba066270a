"""core_ms.pair: host time under the program's ``core.*`` spans (the
staged ICP loop, the refine, the VCM), ms a pair."""


def read(ctx):
    return ctx.span_ms_per_request("core") if ctx.traced else None

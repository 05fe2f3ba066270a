"""prep_ms.pair: host time under the program's ``prep.*`` spans (voxel
grid, SOR), ms a pair."""


def read(ctx):
    return ctx.span_ms_per_request("prep") if ctx.traced else None

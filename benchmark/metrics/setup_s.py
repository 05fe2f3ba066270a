"""setup_s: process start to the window's opening (imports, CUDA context,
the kernel library's build or load, the inputs, the warm-up)."""


def read(ctx):
    return ctx.setup_s

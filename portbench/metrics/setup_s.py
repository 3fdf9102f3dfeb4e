"""setup_s: seconds from the process's start to the first timed request:
imports, CUDA, the kernel library, weights, the clip pool, the warm-up."""


def read(ctx):
    return ctx.setup_s

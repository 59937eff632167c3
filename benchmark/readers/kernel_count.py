"""Device kernels a frame or step: the program's kernel launches in the
traced stretch over its units."""


def read(spec: dict, ctx):
    n = ctx.trace.kernel_count()
    return n / ctx.units if n else None

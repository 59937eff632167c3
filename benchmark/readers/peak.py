"""Peak device memory of the traced stretch in GiB:
``torch.cuda.max_memory_allocated()`` after a reset at its start."""


def read(spec: dict, ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None

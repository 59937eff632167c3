"""A kernel's share of its roofline, in %: the summed bound of its launches
(the metric's ``bound``, from each call of its ``wrap`` target) over the
summed device time of the kernels named by ``kernels`` inside those calls.
Nothing when the stretch made no such launch."""

from benchmark.bounds import launch_ms


def read(spec: dict, ctx):
    target = spec["wrap"][0]
    shapes = [s for t, s in ctx.records if t == target]
    device_us = ctx.trace.device_us(frozenset([target]), spec["kernels"])
    if not shapes or device_us <= 0:
        return None
    return 100.0 * sum(launch_ms(s) for s in shapes) * 1e3 / device_us

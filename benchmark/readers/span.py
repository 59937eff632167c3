"""Device milliseconds a frame or step of the operations launched inside the
spans around the metric's ``wrap`` targets (and their children), restricted
to kernels whose name holds one of ``kernels`` where the metric gives
them. Nothing when no such span launched anything."""


def read(spec: dict, ctx):
    labels = frozenset(spec["wrap"])
    if not ctx.trace.spans_seen(labels):
        return None
    return ctx.trace.device_us(labels, spec.get("kernels")) / 1e3 / ctx.units

"""The device's idle share, in %: 1 − the device time of a stretch traced
on the card alone (the union of the program's operations) over the wall
time of an untraced stretch of as many units. The profiler's cost a launch
stretches a traced window of a host-bound loop by a quarter to a half, so
the traced window itself (``device.window_s``) overstates the idle time."""


def read(spec: dict, ctx):
    busy_us, _gaps = ctx.trace.busy()
    if busy_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us * 1e-6 / ctx.wall_s)

"""Share (%) of the traced window in which no operation ran on the device."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)

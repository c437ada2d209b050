"""Kernels on the device per env step over the traced stretch (copies and
fills left out)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps

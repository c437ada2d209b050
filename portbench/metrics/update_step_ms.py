"""Host ms of one gradient step: the mean length of the program's
``sac.update_step`` regions (the draw from the ring, the update's noise and
``SAC._update_step``) among the traced stretch's host events."""

REGION = "sac.update_step"


def read(ctx):
    spans = [b - a for name, a, b in ctx.trace.host_ops if name == REGION] if ctx.trace else []
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3

"""Host ms of one env step's part of an off-policy round: the mean length
of the program's ``sac.env_step`` regions (the behaviour action, the clip,
``step_autoreset``, the ring insert and the episode bookkeeping) among the
traced stretch's host events."""

REGION = "sac.env_step"


def read(ctx):
    spans = [b - a for name, a, b in ctx.trace.host_ops if name == REGION] if ctx.trace else []
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3

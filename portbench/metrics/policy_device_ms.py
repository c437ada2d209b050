"""Device ms per env step of the kernels launched inside the benchmark's
``portbench.act`` region, which wraps ``ActorCritic.act``."""


def read(ctx):
    us = ctx.trace.regions.get("portbench.act") if ctx.trace else None
    if not us:
        return None
    return us / 1e3 / ctx.trace.steps

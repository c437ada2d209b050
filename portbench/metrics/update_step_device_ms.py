"""Device ms of one gradient step: the device operations launched inside
the benchmark's ``portbench.update_step`` regions (around
``SAC._update_step`` in the traced stretch), on any thread (the backward's
kernels come from autograd's device thread), averaged over the regions
(the loop's span ``update_step_device``)."""


def read(ctx):
    spans = ctx.spans.get("update_step_device") if ctx.spans else None
    if not spans or not sum(spans):       # no regions, or no device operations in them
        return None
    return sum(spans) / len(spans)

"""Share (%) of the least time a control-step launch could take, by the
frozen counts (``counts/physics.py``), in the time it took: the least time
is max(operations / fp32 peak, bytes / HBM peak)."""

from . import megastep_ms


def read(ctx):
    ms = megastep_ms.read(ctx)
    if ms is None:
        return None
    c, p = ctx.counts, ctx.peaks
    least_s = max(c["megastep_flops_per_launch"] / p["fp32_flops_per_s"],
                  c["megastep_bytes_per_launch"] / p["hbm_bytes_per_s"])
    return 100.0 * least_s / (ms / 1e3)

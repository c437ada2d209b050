"""The whole step's share (%) of the card's fp32 peak over the measured
window: the frozen operations of every env step (physics and policy) and,
in training, of every update, over the window's seconds."""


def read(ctx):
    w = ctx.window
    if not w or w.get("seconds", 0) <= 0 or not w.get("flops"):
        return None
    return 100.0 * w["flops"] / (w["seconds"] * ctx.peaks["fp32_flops_per_s"])

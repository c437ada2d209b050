"""Host ms per env step of ``PPO.rollout``, from the benchmark's span
around the bound method, which ends in a synchronize."""


def read(ctx):
    spans = ctx.spans.get("rollout")
    if not spans:
        return None
    return sum(spans) / len(spans) / ctx.window["unroll"]

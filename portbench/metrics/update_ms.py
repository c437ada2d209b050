"""Host ms of one ``PPO.update`` (GAE, the loss, its backward, the clip and
Adam, the normalizer), from the benchmark's span around the bound method,
which ends in a synchronize."""


def read(ctx):
    spans = ctx.spans.get("update")
    if not spans:
        return None
    return sum(spans) / len(spans)

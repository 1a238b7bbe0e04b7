"""Mean device ms of a local-BA stage call (``ba``) in the window: a BA
runs every ``map_every`` frames, so its frames set the latency tail."""


def read(ctx):
    ms = ctx.get("stage_ms", {}).get("ba")
    return sum(ms) / len(ms) if ms else None

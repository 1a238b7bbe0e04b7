"""Mean device ms of a ``track`` stage call in the window (the system's
CUDA events around ``MIPSFusionTorch.track``)."""


def read(ctx):
    ms = ctx.get("stage_ms", {}).get("track")
    return sum(ms) / len(ms) if ms else None

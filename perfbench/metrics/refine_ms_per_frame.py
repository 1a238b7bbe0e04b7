"""Device ms of background refinement (``refine`` stage calls) in the
window, over the window's frames."""


def read(ctx):
    ms = ctx.get("stage_ms", {}).get("refine")
    if not ms or not ctx.get("frames"):
        return None
    return sum(ms) / ctx["frames"]

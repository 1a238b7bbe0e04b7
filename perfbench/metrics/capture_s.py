"""Seconds the stage programs spent capturing CUDA graphs inside the
window (growth of ``StagePrograms.stats()``'s ``capture_s``): 0 when the
warm lap captured every key the window meets."""


def read(ctx):
    win = ctx.get("window")
    if not win:
        return None

    def total(c):
        return sum(s["capture_s"] for s in c["programs"].values())
    return total(win["after"]) - total(win["before"])

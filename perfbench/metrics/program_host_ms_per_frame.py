"""Host ms a frame in the stage programs' draws, inputs, launch and
outputs (``StagePrograms.stats()``'s ``host_s``, summed over the
stages), over the untraced rest of the window: the growth of the
counters from the traced part's end (the window's start where nothing
was traced) to the window's end, over its frames. None where the program
keeps no such counters."""

PHASES = ("draws", "inputs", "launch", "outputs")


def _untraced(ctx):
    """(counters at the part's start, at its end, its frames)."""
    win = ctx.get("window")
    if not win:
        return None
    tr = win.get("traced")
    a, n = ((tr["after"], len(win["frames"]) - len(tr["frames"])) if tr
            else (win["before"], len(win["frames"])))
    a, b = a["programs"], win["after"]["programs"]
    if n <= 0 or "frame" not in b or any("host_s" not in s
                                         for s in b.values()):
        return None
    return a, b, n


def read(ctx):
    u = _untraced(ctx)
    if u is None:
        return None
    a, b, n = u

    def total(c):
        return sum(s["host_s"][p] for s in c.values() for p in PHASES)
    return (total(b) - total(a)) * 1e3 / n

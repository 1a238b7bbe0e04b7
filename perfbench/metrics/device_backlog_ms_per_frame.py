"""What the host waits a frame after ``process_frame`` returns until the
frame's pose is on the host: the mean frame latency (the harness's
``latency_s``) less the mean ``frame`` span (``StagePrograms.stats()``),
in ms, over the untraced rest of the window (from the traced part's end,
or the window's start where nothing was traced, to the window's end):
the device's queue at the frame's end, and the pose's read. None where
the program keeps no frame span."""


def read(ctx):
    win = ctx.get("window")
    if not win:
        return None
    tr = win.get("traced")
    skip = len(tr["frames"]) if tr else 0
    a = (tr["after"] if tr else win["before"])["programs"]
    b = win["after"]["programs"]
    lat = win["latency_s"][skip:]
    if not lat or "host_s" not in b.get("frame", {}):
        return None
    span = b["frame"]["host_s"]["span"] - (
        a["frame"]["host_s"]["span"] if "frame" in a else 0.0)
    return (sum(lat) - span) * 1e3 / len(lat)

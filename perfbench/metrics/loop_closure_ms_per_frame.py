"""Device ms of the submap manager and the loop-closure chain in the
window (stages ``manager`` with the ``verify`` calls inside it,
``switch_new``, ``switch_back``, ``switch_ba``, ``pgo``, ``init_chunk``),
over the window's frames."""

STAGES = ("manager", "switch_new", "switch_back", "switch_ba", "pgo",
          "init_chunk")


def read(ctx):
    sm = ctx.get("stage_ms")
    if not sm or not ctx.get("frames") or not sm.get("manager"):
        return None
    return sum(sum(sm.get(s, [])) for s in STAGES) / ctx["frames"]

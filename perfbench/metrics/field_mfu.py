"""The whole step's share of the card's arithmetic peak over the traced
part of the window, in %: the least time the traced frames' field
arithmetic needs at the published peaks (products at the TF32 rate, the
rest at the float32 rate; the benchmark's count, ``harness/work.py``)
over the traced part's wall time."""


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("work")
    if not t or not w or w["arith"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * w["arith"] / t["window_s"]

"""The card's idle share of the traced part of the window, in %: 1 -
(union of the intervals in which an operation ran on the device) / the
traced part's wall time."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

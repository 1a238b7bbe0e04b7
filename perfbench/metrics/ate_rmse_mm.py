"""Horn-aligned ATE RMSE (mm) of the window's frames: the port's world
trajectory (after any deferred PGO) against the stream's ground truth.
It reads a cell's ``ate_rmse_mm.<cell>``: per-layer in a cell where the
submaps a seed's session spawns and closes on move it by more than any
bound could hold (PERF.md, section 2)."""


def read(ctx):
    return ctx.get("ate_rmse_mm")

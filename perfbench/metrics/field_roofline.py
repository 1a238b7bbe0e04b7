"""The field kernels' share of their roofline over the traced part of
the window, in %: the least time the traced frames' field work needs
(the benchmark's count: stage calls x the points each call gives each
kernel kind, from the configuration's budgets, x the operations and bytes
a point, at the published peaks; ``harness/work.py``) over the device
time of the kernels that do it (K0-K4 and their helpers, by name in the
profiler's trace)."""

KERNELS = ("field_forward_kernel", "pack_weights_kernel",
           "decoder_bwd_kernel", "transpose_weights_kernel",
           "sum_partials_kernel", "plane_bwd_kernel", "k3_absmax_kernel",
           "k3_finish_kernel", "x_bwd_kernel", "encode_fwd_kernel")


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("work")
    if not t or not w or w["bound"] <= 0:
        return None
    busy = sum(s for n, s in t["kernel_s"].items()
               if any(k in n for k in KERNELS))
    if busy <= 0:
        return None
    return 100.0 * w["bound"] / busy

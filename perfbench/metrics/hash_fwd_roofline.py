"""The hash-grid encode's share of its roofline over the traced part of
the window, in %: the least time of the traced frames' encode work (stage
calls x the points each call gives the encode, from the configuration's
budgets, x the hash encoding's operations and bytes a point and a launch,
at the published peaks; ``harness/hash_count.py``) over the device time
of the ``hash_fwd`` kernels in the profiler's trace. None where no such
kernel ran (a Triplane field, or a port without the hash kernels)."""

from harness import hash_count


def read(ctx):
    t, calls = ctx.get("trace"), ctx.get("calls")
    if not t or not calls:
        return None
    busy = sum(s for n, s in t["kernel_s"].items() if "hash_fwd" in n)
    least = hash_count.least_s(ctx["cfg"], calls, hash_count.KINDS_FORWARD)
    if busy <= 0 or least is None:
        return None
    return 100.0 * least / busy

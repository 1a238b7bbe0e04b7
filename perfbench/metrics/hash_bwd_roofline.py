"""The hash grid's gradients' share of their roofline over the traced part
of the window, in %: the least time of the traced frames' table and point
gradient work (stage calls x the points each call gives them, from the
configuration's budgets, x the hash encoding's operations and bytes a
point and a launch, at the published peaks; ``harness/hash_count.py``)
over the device time of the ``hash_*bwd*`` kernels in the profiler's
trace (the table gradient, its conversion, the point gradient). None
where no such kernel ran (a Triplane field, or a port without the hash
kernels)."""

import re

from harness import hash_count

NAME = re.compile(r"hash_\w*bwd")


def read(ctx):
    t, calls = ctx.get("trace"), ctx.get("calls")
    if not t or not calls:
        return None
    busy = sum(s for n, s in t["kernel_s"].items() if NAME.search(n))
    least = hash_count.least_s(ctx["cfg"], calls, hash_count.KINDS_BACKWARD)
    if busy <= 0 or least is None:
        return None
    return 100.0 * least / busy

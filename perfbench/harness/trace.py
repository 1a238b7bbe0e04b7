"""Reduction of a ``torch.profiler`` trace of the window's traced part:
device busy time (the union of the intervals in which an operation ran
on the card), kernel time by name, and the device's idle gaps labelled
by the host span that was open when each began.

The busy-union arithmetic is a copy of the port's
``tools/torch_tree_compare._idle_window``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple


def profiler():
    """A profiler of the host and the card (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof, span_names) -> Tuple[List, List]:
    """(device ops, host spans) as (name, start_us, end_us). The device
    timeline's copies of the host spans (user annotations) are not
    operations and are left out."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in span_names:
                dev.append((e.name, a, b))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, a, b))
    return dev, host


def busy_union(spans: List[Tuple[float, float]]) -> Tuple[float, List]:
    """(busy length, merged intervals) of possibly overlapping spans."""
    busy, merged = 0.0, []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                busy += b - merged[-1][1]
                merged[-1][1] = b
        else:
            busy += b - a
            merged.append([a, b])
    return busy, merged


def reduce(prof, span_names, wall_s: float) -> Dict:
    """busy_s, window_s, device seconds by kernel name, the top ten
    device operations and the idle gaps summed by label (the innermost
    span of ``span_names`` open at a gap's start; "outside process_frame"
    where none is: the harness's pose read and loop)."""
    dev, host = _events(prof, span_names)
    busy_us, merged = busy_union([(a, b) for _, a, b in dev])
    by_name: Dict[str, float] = defaultdict(float)
    for n, a, b in dev:
        by_name[n] += (b - a) * 1e-6
    spans = sorted((a, b, n) for n, a, b in host if n in span_names)
    starts = [s[0] for s in spans]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        label = "outside process_frame"
        k = bisect.bisect_right(starts, end)
        best = None
        for j in range(k - 1, max(k - 64, -1), -1):
            a, b, n = spans[j]
            if a <= end < b and (best is None or a >= best[0]):
                best = (a, n)
        if best is not None:
            label = best[1]
        gaps[label] += (nxt - end) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": wall_s,
            "kernel_s": dict(by_name), "n_device_ops": len(dev),
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda x: -x[1])[:10]}

"""Where the port's frame holds the host, on a benchmark cell's stream
(an NVIDIA GPU only):

    python3 tools/torch_host_audit.py <cell> [--seed N] [--frames 200] \\
        [--profile-frames 60] [--rounds 1] [--out audit.json]

One session of the cell as ``perfbench/run.py`` builds it (the lap, the
system, the warm lap), each frame handed in as the benchmark hands it in
(``process_frame``, then the pose read), in three parts:

1. ``sync``: ``--frames`` frames with ``torch.cuda.set_sync_debug_mode
   ("warn")`` around ``process_frame``: every synchronising CUDA call by
   its line in the repository (and the line that called it), the stage
   span open at it and whether it came through the counted read
   (``manager.host_dict``), with its count a frame.
2. ``profile``: ``--profile-frames`` frames under ``torch.profiler`` with
   the span log on (``MIPSFusionTorch.trace_spans``): the host's ms a
   frame in the blocking CUDA runtime calls by the innermost ``mf/`` span
   open at each, and the card's idle seconds by span
   (``mipsfusion_tpu_torch.__main__.idle_by_span``).
3. ``cost``: tracked frames a second with the span log off, on, on, off
   (``--rounds`` times, a lap of the stream each), and the host ms a
   frame by stage and phase over the laps with it off
   (``StagePrograms.stats()``).

Prints one JSON object (also written to ``--out``).

    python3 tools/torch_host_audit.py --clock-cost SPANS,CALLS,READS

times, on any device, what the always-on counters cost a frame of SPANS
stage spans, CALLS program calls (six phases each at most) and READS
counted reads, and prints the microseconds.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
PHASES = ("draws", "inputs", "launch", "outputs", "capture", "read")


def session(cell: str, seed: int):
    """The cell's session after its warm lap."""
    import torch
    sys.path[:0] = [ROOT, os.path.join(ROOT, "perfbench")]
    from harness.session import Session
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        wl = next(w for w in json.load(f)["workloads"] if w["name"] == cell)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{wl['config']}.json")) as f:
        cfg = json.load(f)["config"]
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    from mipsfusion_tpu_torch.ops import _build
    _build.build()
    sess = Session(cfg, traffic, seed, torch.device("cuda", 0))
    sess.warm(int(traffic["warm_frames"]))
    return sess


def sync_sites(sess, n: int):
    """The synchronising calls of n frames' ``process_frame``."""
    import torch
    clock = sess.system.clock
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        mine = [f for f in stack if f.filename.startswith(ROOT)
                and f.filename != os.path.abspath(__file__)]
        site = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                f"{(f.line or '').strip()}" for f in mine[-2:]]
        sites[(" <- ".join(reversed(site)) or f"{filename}:{lineno}",
               clock._names[-1] if clock._names else "-",
               any(f.name == "host_dict" for f in stack),
               str(message)[:60])] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        for _ in range(n):
            i = sess.next_frame
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sess.system.process_frame(i)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sess.poses[i] = sess.world_pose(i).cpu().numpy()
            sess.next_frame = i + 1
    return [{"site": s, "stage": st, "counted_read": c, "message": m,
             "per_frame": k / n}
            for (s, st, c, m), k in sorted(sites.items(),
                                           key=lambda kv: -kv[1])]


def profiled(sess, n: int):
    """Blocking runtime calls by span and idle by span over n frames."""
    from torch.profiler import ProfilerActivity, profile

    from mipsfusion_tpu_torch.__main__ import idle_by_span, label_by_span
    sess.system.trace_spans(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sess.step()
    sess.system.trace_spans(False)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e["name"]) for e in ev if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("mf/")]
    calls = sorted((float(e["ts"]), float(e.get("dur", 0)), e["name"])
                   for e in ev if e.get("cat") == "cuda_runtime"
                   and e.get("name") in BLOCKING)
    wait = collections.defaultdict(float)
    count = collections.Counter()
    for (_, dur, name), label in zip(calls, label_by_span(
            [t for t, _, _ in calls], spans)):
        wait[f"{label} {name}"] += dur * 1e-3 / n
        count[f"{label} {name}"] += 1
    idle = idle_by_span(trace)
    return {"frames": n,
            "blocking_ms_per_frame": {k: [v, count[k] / n] for k, v in
                                      sorted(wait.items(),
                                             key=lambda kv: -kv[1])},
            "idle": idle}


def cost(sess, rounds: int):
    """Tracked frames a second with the span log off, on, on, off, a lap
    each, ``rounds`` times; host ms a frame by stage and phase over the
    laps with it off."""
    table = collections.defaultdict(lambda: collections.defaultdict(float))
    fps, frames, n = [], 0, sess.stream.lap
    for on in (False, True, True, False) * rounds:
        sess.system.trace_spans(on)
        before = sess.system.programs.stats()
        t0 = time.perf_counter()
        for _ in range(n):
            sess.step()
        fps.append(["on" if on else "off", n / (time.perf_counter() - t0)])
        if on:
            continue
        frames += n
        for stage, s in sess.system.programs.stats().items():
            b = before.get(stage, {}).get("host_s", {})
            for k, v in s["host_s"].items():
                table[stage][k] += v - b.get(k, 0.0)
    sess.system.trace_spans(False)
    rows = {}
    for stage, h in table.items():
        ms = {k: v * 1e3 / frames for k, v in h.items()}
        ms["self"] = ms["span"] - ms["nested"] - sum(ms[p] for p in PHASES)
        rows[stage] = ms
    return {"tracked_fps": fps, "frames_off": frames,
            "host_ms_per_frame": dict(sorted(
                rows.items(), key=lambda kv: -kv[1]["span"]))}


def clock_cost(spans: float, calls: float, reads: float,
               reps: int = 20000) -> float:
    """Microseconds a frame that the HostClock's span, phase and read
    counting takes with the span log off, for the given counts a frame
    (a program call: six phases)."""
    from mipsfusion_tpu_torch.slam.programs import HostClock
    clock = HostClock()
    ns, nc, nr = round(spans * reps), round(calls * reps), round(reads * reps)
    t0 = time.perf_counter()
    for _ in range(ns):
        clock.end(clock.begin("track"))
    for _ in range(nc):
        for phase in (clock.DRAWS, clock.INPUTS, clock.INPUTS,
                      clock.LAUNCH, clock.OUTPUTS, clock.OUTPUTS):
            clock.stop("track", phase, clock.start("track", phase))
    for _ in range(nr):
        clock.stop("read", clock.READ, clock.start("read", clock.READ), 8)
    return (time.perf_counter() - t0) * 1e6 / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--clock-cost"]:
        sys.path.insert(0, ROOT)
        counts = [float(x) for x in argv[1].split(",")]
        print(json.dumps({"clock_cost_us_per_frame": clock_cost(*counts)}))
        return 0
    p.add_argument("cell")
    p.add_argument("--seed", type=int, default=2_147_483_647)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--profile-frames", type=int, default=60)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_host_audit: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    sess = session(args.cell, args.seed)
    out = {"cell": args.cell, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "sync": sync_sites(sess, args.frames),
           "profile": profiled(sess, args.profile_frames),
           "cost": cost(sess, args.rounds)}
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command line: run the port's SLAM system on a config.

    python3 -m mipsfusion_tpu_torch --config configs/synthetic/orbit.yaml \
        [--n_frames N] [--resume <output>/<exp>/ckpt_<frame>] \
        [--profile trace.json] [--device cuda|cpu]

The counterpart of the JAX package's ``main.py``. It runs on the card
unless ``--device cpu`` is given. Output goes to
``<data.output>/<data.exp_name>/``: ``ate_*.txt``, ``traj_*.txt`` (TUM),
``traj_*.png`` and ``render_*.png`` at ``mesh.vis``, ``ckpt_<frame>`` at
``mesh.ckpt_freq``, ``mesh_<frame>.ply`` at ``mesh.mesh_freq``, and at
the end ``ckpt_final`` and ``mesh_final.ply``. ``--profile`` writes a
``torch.profiler`` Chrome trace of the run with the system's host spans
in it (``MIPSFusionTorch.trace_spans``: ``mf/frame``, ``mf/<stage>``,
``mf/<stage>/<phase>``, ``mf/read/<stage>``) and prints the device's idle
seconds over the frames by the innermost ``mf/`` span open at each idle
gap's start (``idle by span:``). The line before the last gives the wall
seconds of the start (imports, config, dataset, system), the frame loop
and the final checkpoint and mesh; the last line printed is
``ATE RMSE: <m> m | <fps> FPS``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from typing import Dict, List, Tuple

import numpy as np

# a Chrome trace's categories of device operations
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy(intervals: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[List[float]]:
    """The union of the intervals, clipped to [lo, hi], as sorted disjoint
    intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if a >= b:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def label_by_span(times: List[float], spans: List[Tuple[float, float, str]]
                  ) -> List[str]:
    """For each of the ascending ``times``, the name of the innermost of
    the properly nested ``spans`` (start, end, name) open at it, or
    "outside"."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "outside")
    return out


def idle_by_span(trace: Dict) -> Dict:
    """The device's idle time in a ``torch.profiler`` Chrome trace over
    its frames (the first ``mf/frame`` range's start to the last one's
    end; the whole trace without one): ``wall_s``, ``busy_s`` (the union
    of the device operations' intervals), ``idle_s`` = wall - busy, and
    ``by_span``: each idle gap's seconds summed by the innermost ``mf/``
    range open at its start ("outside" where none is); ``device_ops``
    their count."""
    ops, spans, ends = [], [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        ends += [a, b]
        if e.get("cat") in DEVICE_OPS:
            ops.append((a, b))
        elif e.get("cat") == "user_annotation" and \
                str(e.get("name", "")).startswith("mf/"):
            spans.append((a, b, e["name"]))
    frames = [(a, b) for a, b, n in spans if n == "mf/frame"]
    lo, hi = ((min(a for a, _ in frames), max(b for _, b in frames))
              if frames else (min(ends, default=0.0), max(ends, default=0.0)))
    busy = _busy(ops, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    by_span: Dict[str, float] = {}
    for (a, b), name in zip(gaps, label_by_span([a for a, _ in gaps],
                                                spans)):
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {"device_ops": len(ops), "wall_s": (hi - lo) * 1e-6,
            "busy_s": busy_s,
            "idle_s": (hi - lo) * 1e-6 - busy_s,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def idle_line(r: Dict) -> str:
    if not r["device_ops"]:
        return "idle by span: no device operations in the trace"
    spans = " | ".join(f"{n} {s:.4f}" for n, s in r["by_span"].items())
    return (f"idle by span: wall {r['wall_s']:.4f} s, busy "
            f"{r['busy_s']:.4f} s, idle {r['idle_s']:.4f} s | {spans}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python3 -m mipsfusion_tpu_torch",
        description="MIPSFusion port: neural RGB-D SLAM with PyTorch/CUDA")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to config yaml file")
    parser.add_argument("--n_frames", type=int, default=None,
                        help="Optionally cap the number of frames")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint dir to resume from")
    parser.add_argument("--profile", type=str, default=None,
                        help="Write a torch.profiler Chrome trace (json) "
                             "to this path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    t_start = time.time()

    from .config import load_config
    from .device import resolve_device
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    out = cfg.get("data", {}).get("output")
    if out:
        os.makedirs(os.path.join(out, cfg["data"].get("exp_name", "exp")),
                    exist_ok=True)

    import torch
    seed = cfg.get("seed", 0)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    from .slam.system import MIPSFusionTorch
    slam = MIPSFusionTorch(cfg, device=device)
    start = 0
    if args.resume:
        start = slam.resume_from(args.resume)
        print(f"resumed from {args.resume} at frame {start}")
    t_run = time.time()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if slam.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        slam.trace_spans(True)
        with profile(activities=acts) as prof:
            results = slam.run(n_frames=args.n_frames, start=start)
        prof.export_chrome_trace(args.profile)
        with open(args.profile) as f:
            print(idle_line(idle_by_span(json.load(f))))
    else:
        results = slam.run(n_frames=args.n_frames, start=start)
    n_run = (args.n_frames or slam.dataset.num_frames) - start
    print("wall: start %.1f s | loop %.1f s (%d frames) | final checkpoint "
          "%.1f s | final mesh %.1f s | run %.1f s" % (
              t_run - t_start, n_run / results["fps"], n_run,
              results.get("final_checkpoint_s", 0.0),
              results.get("final_mesh_s", 0.0), time.time() - t_run))
    print("ATE RMSE: %.4f m | %.2f FPS" % (
        results["absolute_translational_error.rmse"], results["fps"]))


if __name__ == "__main__":
    main()

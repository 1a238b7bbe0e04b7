#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``perfbench/configs/
<config>.json``) and a traffic mix (``perfbench/traffic/<traffic>.json``);
each per-layer metric is read by ``perfbench/metrics/<metric>.py``; the
field's encoding (``grid.enc``) has its reference in
``perfbench/reference/encodings/<enc>.py`` and may have a work count in
``perfbench/harness/counts/<enc>.py``. One run is one streamed SLAM
session of ``mipsfusion_tpu_torch``: set-up (imports, the kernel library
from the checkout's build directory, the lap rendered on the card, the
system built, one warm lap), then the
window: frame after frame through ``MIPSFusionTorch.process_frame``, each
frame's pose read to the host before the next is handed in, until
``--seconds`` have passed. With ``--trace 1`` the first ``trace_frames``
frames of the window run under ``torch.profiler`` and the run reports the
cell's per-layer metrics; with ``--trace 0`` its end-to-end metrics.
After the window the checked stage calls are run again by the plain
reference (``perfbench/reference``) and ``correct`` is decided.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit). Exit codes: 0 a result was printed; 2 a bad argument or a missing
file of the benchmark; 3 no card, or fewer than the cell asks for; 4 a
module of JAX or of the JAX package was loaded; 5 the port cannot be
imported.
"""

import time

T_ENTRY = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "out")
FORBIDDEN = ("jax", "jaxlib", "flax", "mipsfusion_tpu")


def process_start() -> float:
    """This process's start as a Unix time (from /proc; the entry time of
    this script where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return T_ENTRY


def fail(code: int, msg: str):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_json(path: str):
    if not os.path.exists(path):
        fail(2, f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, cell: str) -> dict:
    """The cell's workload entry, configuration, traffic, metrics and
    field encoding, each found by its name."""
    from reference import encodings
    wl = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if wl is None:
        fail(2, f"no workload {cell!r} in BENCHMARK.json")
    conf = load_json(os.path.join(HERE, "configs", f"{wl['config']}.json"))
    enc = encodings.name_of(conf["config"])
    if not os.path.exists(encodings.file_of(enc)):
        fail(2, f"missing file of the benchmark: "
             f"{os.path.relpath(encodings.file_of(enc), ROOT)} (the "
             f"reference of the encoding {enc!r})")
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{wl['traffic']}.json"))

    def mine(m):
        return cell in m.get("workloads", [cell])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    readers = {}
    for m in layer:
        path = reader_path(m["name"], cell)
        if path is None:
            fail(2, f"no reader metrics/{m['name']}.py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{len(readers)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[m["name"]] = mod.read
    return {"workload": wl, "config": conf, "traffic": traffic,
            "encoding": enc, "end_to_end": e2e, "per_layer": layer,
            "readers": readers}


def reader_path(metric: str, cell: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, or for a
    metric named ``<name>.<cell>`` (one cell's form of a metric),
    ``metrics/<name>.py``; None where neither exists."""
    names = [metric]
    if metric.endswith("." + cell):
        names.append(metric[:-len(cell) - 1])
    for n in names:
        path = os.path.join(HERE, "metrics", f"{n}.py")
        if os.path.exists(path):
            return path
    return None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class PowerSampler:
    """``nvidia-smi`` sampling the card's clock, power, limit and
    temperature every half second beside the window."""

    QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self):
        self.proc = None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return {}
        cols = list(zip(*rows))
        names = ("sm_clock_mhz", "power_w", "power_limit_w", "temp_c")
        return {n: [min(c), sum(c) / len(c), max(c)]
                for n, c in zip(names, cols)}


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def open_session(cell: dict, seed: int, dev):
    """The cell's session on ``dev`` (the lap rendered, the system built),
    with the correctness check's snapshots installed for the window."""
    from harness.session import CheckPlan, Session, Snapshots
    from reference import encodings
    conf, traffic = cell["config"], cell["traffic"]
    cfg = conf["config"]
    sess = Session(cfg, traffic, seed, dev)
    sess.snapshots = Snapshots(sess.system, CheckPlan(
        seed, int(traffic["warm_frames"]), int(traffic["check_span"]),
        int(cfg["mapping"]["map_every"]), conf["check"]),
        encodings.load(cell["encoding"]))
    return sess


def release(sess) -> None:
    """Free the program's state (the snapshots and the stream stay), so
    the reference runs in the memory the system held."""
    import torch
    sess.snapshots.system = None
    sess.system = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def execute(cell: dict, seed: int, seconds: float, trace: bool, dev,
            t_start: float, max_frames=None):
    """Set-up, window, metrics and the check of one run on ``dev``;
    returns the result line's object (None where a forbidden module was
    loaded). ``max_frames`` caps the window (the CPU tests' fixed work)."""
    import torch
    from harness import check, work
    from harness import trace as tr
    from harness.ate import ate_rmse
    from harness.session import SPAN_METHODS, install_spans
    cuda = dev.type == "cuda"
    conf = cell["config"]
    cfg, traffic = conf["config"], cell["traffic"]
    chips = int(cell["workload"]["chips"])
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sess = open_session(cell, seed, dev)
    snaps = sess.snapshots
    warm = int(traffic["warm_frames"])
    if trace:
        install_spans(sess.system)
    sess.warm(warm)

    power = PowerSampler() if cuda else None
    t_window = time.time()
    failed = 0
    try:
        win = sess.window(seconds, int(traffic["trace_frames"]),
                          tr.profiler if trace else None, max_frames)
    except (RuntimeError, FloatingPointError) as e:
        print(f"perfbench: a frame raised: {e!r}", file=sys.stderr)
        failed = 1
        win = None
    if cuda:
        torch.cuda.synchronize(dev)
    smi = power.stop() if power else {}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    setup_s = t_window - t_start
    if forbidden_modules():
        return None

    metrics = {}
    ctx = {"cfg": cfg, "traffic": traffic, "encoding": cell["encoding"],
           "cell": cell["workload"]["name"], "window": win}
    if win is not None:
        frames = win["frames"]
        poses = [sess.poses[i] for i in frames]
        failed += sum(1 for P in poses if not all(
            math.isfinite(x) for x in P.ravel()))
        if cuda:
            ev0, ev1 = win["before"]["events"], win["after"]["events"]
            ctx["stage_ms"] = {k: sess.stage_event_ms(k, ev0.get(k, 0), n)
                               for k, n in ev1.items()}
        ctx["frames"] = len(frames)
        system = sess.system
        system._flush_pending_switch()
        world = system.world_trajectory(frames[-1])
        gt = [sess.stream.gt_pose(i) for i in frames]
        ctx["ate_rmse_mm"] = ate_rmse(
            gt, world[frames[0]:frames[-1] + 1]) * 1e3
        lat = win["latency_s"]
        e2e = {"tracked_fps": len(frames) / win["wall_s"],
               "frame_ms_p95": percentile(lat, 95) * 1e3,
               "ate_rmse_mm": ctx["ate_rmse_mm"], "setup_s": setup_s}
        traced = win["traced"]
        if traced is not None:
            calls = {k: traced["after"]["calls"].get(k, 0)
                     - traced["before"]["calls"].get(k, 0)
                     for k in traced["after"]["calls"]}
            ctx["trace"] = tr.reduce(
                traced["profile"], {n.lstrip("_") for n in SPAN_METHODS},
                traced["t1"] - traced["t0"])
            ctx["calls"] = calls
            ctx["work"] = work.least_times(cfg, calls)
            traced["profile"] = None
        if trace:
            for m in cell["per_layer"]:
                v = cell["readers"][m["name"]](ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        print(f"perfbench: window frames {frames[0]}..{frames[-1]} "
              f"({len(frames)} samples of frame latency, p50 "
              f"{percentile(lat, 50) * 1e3:.3f} ms, p95 "
              f"{percentile(lat, 95) * 1e3:.3f} ms), wall "
              f"{win['wall_s']:.3f} s, setup {setup_s:.3f} s, "
              f"ATE {ctx['ate_rmse_mm']:.4f} mm", file=sys.stderr)
        moved = {k: v - win["before"]["calls"].get(k, 0)
                 for k, v in win["after"]["calls"].items()}
        print(f"perfbench: stage calls in the window {json.dumps(moved)}",
              file=sys.stderr)

    # the program's state goes before the reference runs
    system = None
    release(sess)
    numbers, calls = {}, {}
    if win is not None:
        ref = check.reference_outputs(snaps, cfg, sess.stream)
        res = check.compare(snaps, check.program_outputs(snaps), ref)
        numbers, calls = res["numbers"], res["calls"]
        for kind in check.KINDS:
            for r in res[kind]:
                print(f"perfbench: check {kind} {json.dumps(r)}",
                      file=sys.stderr)
    correct, rows = check.verdict(numbers, conf["limits"],
                                  conf["check"]["required"], calls)
    correct = correct and failed == 0 and win is not None

    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": chips, "memory_peak_bytes": peak}
    if smi:
        device["power_limit_w"] = smi["power_limit_w"][1]
        print(f"perfbench: nvidia-smi beside the window (min, mean, max): "
              f"{json.dumps(smi)}", file=sys.stderr)
    result = {"correct": bool(correct),
              "attempted": len(win["frames"]) if win else 0,
              "failed": failed, "metrics": metrics, "device": device}
    if "trace" in ctx:
        t = ctx["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
        print(f"perfbench: traced {len(win['traced']['frames'])} frames, "
              f"{t['n_device_ops']} device ops, work "
              f"{json.dumps(ctx['work'])}", file=sys.stderr)
    result["checks"] = rows
    print(f"perfbench: peak device memory {peak} bytes", file=sys.stderr)
    for name, r in rows.items():
        print(f"perfbench: check {name} = {r['value']} (limit {r['limit']})",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()
    sys.path[:0] = [ROOT, HERE]
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = resolve(bench, args.workload)
    chips = int(cell["workload"]["chips"])

    os.makedirs(OUT, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(OUT, "cache", sub)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        fail(3, f"the cell needs {chips} CUDA device(s); this machine has "
             f"{have}")
    try:
        from mipsfusion_tpu_torch.ops import _build
    except ImportError as e:
        fail(5, f"the port cannot be imported: {e}")
    built_here = not os.path.exists(_build.library_path())
    _build.build()
    print(f"perfbench: kernel library built in this run: {built_here}",
          file=sys.stderr)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), dev,
                     t_start)
    if result is None or forbidden_modules():
        fail(4, f"modules of JAX or the JAX package loaded: "
             f"{forbidden_modules()}")
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

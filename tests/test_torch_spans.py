"""The port's host spans and counters on the CPU (``programs.HostClock``,
``StagePrograms.stats()``, ``MIPSFusionTorch.trace_spans``), on 20
corridor frames with the manager (a second submap, its chunked first
fit, refinement of submap 0): every stats entry carries ``capture_s``
and ``host_s``; a stage's phases and the spans nested in it fit in its
span; the frame span holds the top-level stages; one counted read a
keyframe decision and one a verification; with the span log off a
profile holds no ``mf/`` range, with it on every range nests in a frame
and the ranges count what ``stats()`` counts. Also the benchmark's four
readers of these counters on a window built from them, and the
command line's reduction of a trace to idle seconds by span."""

import importlib.util
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mipsfusion_tpu_torch.__main__ import idle_by_span, label_by_span
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.slam import programs
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_torch_multi import corridor_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 20
# frames [OFF, ON) run under a profiler with the span log off, [ON, N)
# with it on
OFF, ON = 10, 14
PHASES = ("draws", "inputs", "launch", "outputs", "capture", "read")
READERS = ("program_host_ms_per_frame", "host_read_ms_per_frame",
           "stage_self_ms_per_frame", "device_backlog_ms_per_frame")


def _stats(slam):
    return {"programs": slam.programs.stats(),
            "calls": dict(slam.stage_calls)}


def _profiled(slam, frames):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in frames:
            slam.process_frame(i)
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events()]


@pytest.fixture(scope="module")
def corridor():
    """The system after 20 frames, the stats at frames 0, OFF, ON and N,
    and the profiles of [OFF, ON) (log off) and [ON, N) (log on)."""
    cfg = corridor_config(N_FRAMES)
    ds = SyntheticDataset(cfg, n_frames=N_FRAMES, trajectory="corridor",
                          span=0.55, device="cpu")
    ds.prerender(range(N_FRAMES))
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    snaps = [_stats(slam)]
    for i in range(OFF):
        slam.process_frame(i)
    snaps.append(_stats(slam))
    off = _profiled(slam, range(OFF, ON))
    snaps.append(_stats(slam))
    slam.trace_spans(True)
    on = _profiled(slam, range(ON, N_FRAMES))
    slam.trace_spans(False)
    snaps.append(_stats(slam))
    assert any(flag == 3 for _, flag in slam.switch_events)
    return slam, snaps, off, on


def test_every_entry_has_capture_and_host_phases(corridor):
    slam, snaps, _, _ = corridor
    stats = slam.programs.stats()
    assert stats["frame"]["spans"] == N_FRAMES
    for stage in ("keyframe", "switch_new", "init", "init_chunk"):
        assert stats[stage]["programs"] == 0, stage
    for stage in ("track", "ba", "refine", "fit", "manager"):
        assert stats[stage]["programs"] >= 1, stage
    for stage, s in stats.items():
        assert s["capture_s"] == 0.0, stage       # no graphs on the CPU
        assert set(s["host_s"]) == {"span", "nested", *PHASES}, stage
        assert all(v >= 0.0 for v in s["host_s"].values()), stage
    # each span counted once, under the stage names of stage_calls
    for stage, n in slam.stage_calls.items():
        if stage not in ("track_fired", "track_quiet"):
            assert stats[stage]["spans"] == n, stage
    assert stats["track"]["host_s"]["launch"] > 0.0
    assert stats["ba"]["host_s"]["draws"] > 0.0


def test_phases_and_nested_spans_fit_in_each_span(corridor):
    for stage, rec in corridor[0].clock.records.items():
        span, nested, phases = rec[0], rec[2], sum(rec[3:9])
        assert phases + nested <= span, stage
        assert rec[1] > 0, stage


def test_frame_span_holds_the_top_level_stages(corridor):
    rec = corridor[0].clock.records
    frame = rec["frame"]
    stages = [r for s, r in rec.items() if s != "frame"]
    top = sum(r[0] for r in stages) - sum(r[2] for r in stages)
    assert frame[2] == top > 0
    assert frame[0] >= top


def test_one_read_a_decision_and_a_verification(corridor):
    slam = corridor[0]
    stats = slam.programs.stats()
    calls = slam.stage_calls
    # the drift gate and the consistency BA are off in this session
    assert sum(s["reads"] for s in stats.values()) == \
        calls["manager"] + calls["verify"]
    assert stats["manager"]["reads"] == calls["manager"] > 0
    assert stats["manager"]["read_bytes"] > 0
    assert stats["manager"]["host_s"]["read"] > 0.0


def test_span_log_off_leaves_no_profiler_range(corridor):
    off = corridor[2]
    assert len(off) > 1000
    assert not [n for n, *_ in off if n.startswith("mf/")]


def test_span_log_ranges_nest_in_frames_and_count(corridor):
    _, snaps, _, on = corridor
    mf = [e for e in on if e[0].startswith("mf/")]
    frames = [e for e in mf if e[0] == "mf/frame"]
    assert len(frames) == N_FRAMES - ON
    for name, a, b, thread in mf:
        assert any(fa <= a and b <= fb and ft == thread
                   for _, fa, fb, ft in frames), name
    before, after = snaps[2]["programs"], snaps[3]["programs"]

    def grew(stage, key):
        return after[stage][key] - before.get(stage, {}).get(key, 0)
    counts = {}
    for name, *_ in mf:
        counts[name] = counts.get(name, 0) + 1
    for stage in after:
        assert counts.get(f"mf/{stage}", 0) == grew(stage, "spans"), stage
        assert counts.get(f"mf/read/{stage}", 0) == grew(stage, "reads"), \
            stage
    assert counts["mf/track/launch"] == grew("track", "calls") > 0
    assert counts["mf/read/manager"] > 0


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", os.path.join(ROOT, "perfbench", "metrics",
                                       f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _window(snaps, traced: bool, backlog_s: float = 0.002):
    """The harness's window over frames [OFF, N) from the fixture's
    stats, its traced part [OFF, ON) or none; each untraced frame's
    latency its mean frame span plus ``backlog_s``."""
    a = snaps[2] if traced else snaps[1]
    n = N_FRAMES - (ON if traced else OFF)
    span = 0.0
    if "frame" in a["programs"]:
        span = (snaps[3]["programs"]["frame"]["host_s"]["span"]
                - a["programs"]["frame"]["host_s"]["span"])
    lat = [0.5] * (ON - OFF if traced else 0) + [span / n + backlog_s] * n
    win = {"frames": list(range(OFF, N_FRAMES)), "latency_s": lat,
           "before": snaps[1], "after": snaps[3], "traced": None}
    if traced:
        win["traced"] = {"before": snaps[1], "after": snaps[2],
                         "frames": list(range(OFF, ON))}
    return {"window": win}


def _expected(name, a, b, n):
    def total(c, phases):
        return sum(s["host_s"][p] for s in c.values() for p in phases)
    if name == "program_host_ms_per_frame":
        d = total(b, PHASES[:4]) - total(a, PHASES[:4])
    elif name == "host_read_ms_per_frame":
        d = total(b, ("read",)) - total(a, ("read",))
    elif name == "stage_self_ms_per_frame":
        d = (b["frame"]["host_s"]["span"] - a["frame"]["host_s"]["span"]
             - total(b, PHASES) + total(a, PHASES))
    else:
        return 2.0
    return d * 1e3 / n


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("traced", [True, False])
def test_reader_on_the_untraced_window(corridor, name, traced):
    snaps = corridor[1]
    a = snaps[2] if traced else snaps[1]
    n = N_FRAMES - (ON if traced else OFF)
    got = _reader(name)(_window(snaps, traced))
    want = _expected(name, a["programs"], snaps[3]["programs"], n)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-9)
    if name != "device_backlog_ms_per_frame":
        assert got > 0.0


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_counters_is_none(corridor, name):
    """A program without the counters (the parent of this benchmark's
    readers) reads None, and so does a missing window."""
    snaps = corridor[1]
    old = []
    for s in snaps:
        prog = {k: {f: v for f, v in e.items()
                    if f in ("programs", "calls", "replays", "capture_s",
                             "graph_bytes")}
                for k, e in s["programs"].items() if k in ("ba", "track")}
        old.append({"programs": prog, "calls": s["calls"]})
    read = _reader(name)
    assert read(_window(old, True)) is None
    assert read(_window(old, False)) is None
    assert read({"window": None}) is None


def test_program_phases_outside_any_span():
    """A program called outside the system's spans counts its phases
    under its own stage."""
    clock = programs.HostClock()
    prog = programs.Program("probe", ("probe",),
                            lambda s: {"y": s["x"] * 2.0}, None, clock)
    for _ in range(3):
        prog({"x": torch.ones(4)})
    rec = clock.records["probe"]
    assert rec[1] == 0 and rec[0] == 0             # no span
    assert rec[clock.INPUTS] > 0 and rec[clock.LAUNCH] > 0
    assert rec[clock.OUTPUTS] == rec[clock.CAPTURE] == 0


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_by_span_sums_to_the_idle():
    """Idle gaps labelled by the innermost ``mf/`` range at their start,
    over the frames, and summing to wall - the union of device ops."""
    ev = [_event("user_annotation", "mf/frame", 100.0, 100.0),
          _event("user_annotation", "mf/track", 110.0, 40.0),
          _event("user_annotation", "mf/track/launch", 120.0, 10.0),
          _event("user_annotation", "mf/frame", 220.0, 80.0),
          _event("user_annotation", "mf/ba", 230.0, 30.0),
          _event("gpu_user_annotation", "mf/track", 110.0, 40.0),
          _event("cpu_op", "aten::add", 0.0, 400.0),
          _event("kernel", "k0", 90.0, 15.0),      # busy 100-105
          _event("kernel", "k1", 125.0, 10.0),     # busy 125-135
          _event("gpu_memcpy", "m", 130.0, 20.0),  # busy 135-150
          _event("kernel", "k2", 190.0, 40.0),     # busy 190-230
          _event("kernel", "k3", 240.0, 5.0)]      # busy 240-245
    r = idle_by_span({"traceEvents": ev})
    assert r["device_ops"] == 5
    assert r["wall_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(75e-6)
    assert r["idle_s"] == pytest.approx(125e-6)
    # 105-125 and 150-190 start in a frame outside its stages (mf/track
    # ends at 150); 230-240 and 245-300 start in mf/ba (230-260)
    want = {"mf/frame": 60e-6, "mf/ba": 65e-6}
    assert r["by_span"] == pytest.approx(want)
    assert sum(r["by_span"].values()) == pytest.approx(r["idle_s"],
                                                       rel=1e-12)


def test_label_by_span_innermost_and_outside():
    spans = [(0.0, 10.0, "a"), (2.0, 8.0, "b"), (2.0, 4.0, "c"),
             (12.0, 14.0, "d")]
    assert label_by_span([1.0, 2.0, 4.0, 5.0, 9.0, 11.0, 13.0, 20.0],
                         spans) == ["a", "c", "b", "b", "a", "outside", "d",
                                    "outside"]

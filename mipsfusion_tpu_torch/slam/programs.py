"""The SLAM loop's hot stages as programs: CUDA graphs captured once per
key and replayed.

Counterpart of how the JAX package runs its hot stages: ``_get_ba_step``
and ``_get_refine_step`` (``mipsfusion_tpu/slam/system.py``), the
system's caches of its BA and refine programs by shape, and the jit
caches of ``tracker.track_frame`` and ``mapper.init_submap_fit``. There
each stage is one compiled program, its iterations on the device with no
host round trip, compiled once per shape and replayed every frame.

A ``Program`` is one stage at one key: the stage, its configs, the shapes
and the static flags (``include_current``, ``optim_cur``, the iteration
counts), as a jit cache keys it. Its body is the eager stage function,
unchanged, run on static input buffers. Its first call runs the body
eagerly on a side stream, the warm-up, which also does every one-time
setup (the kernels' per-device attributes, the optimizers' state) and
gives that call's results; then it captures one ``torch.cuda.CUDAGraph``
of the body on the same stream. Later calls copy their inputs into the
static buffers, replay, and copy the outputs out. A failed capture raises,
naming the stage and the key. On the CPU, which has no graphs, the same
objects run the body eagerly on the same buffers.

What a replay cannot see, it is given:

- random draws: made eagerly from the call's generator before the replay
  (``mapper.fit_draws``, ``mapper.ba_draws``, ``tracker.track_draws``),
  what the stage function draws, in its order, so a replay gives the
  eager call's bits;
- parameters as arguments: a program trains a template field with its own
  map optimizer, and the submap's parameters and moments are copied in
  before the call and out after it, so one graph serves every submap of a
  shape (``_Template``);
- every tensor of the state the body reads (the keyframe store, the
  submap's first keyframe, the poses) is an input: a switch reassigns
  some (``active_first_kf``) and moves the host ints that index others
  (``active_submap_id``), which the body never sees;
- the kernels' launch counters: what the capture counted is added once a
  replay (``field_cuda.add_launch_counts``).

The host's share of a call is counted by phase (``HostClock``): the
draws, the inputs copied in, the launch (the replay; on the CPU the
eager body), the outputs copied out and the state written back, the
warm-up and capture, and the device-to-host reads, each under the
system's stage span open around the call. No span goes inside a body: a
capture records no host code.

The stages (``StagePrograms``): ``local_ba`` (local BA, and background
refinement: a fresh optimizer, ``include_current=False``),
``init_submap_fit`` (the first fits, one program a chunk of iterations),
``track_frame_update`` (tracking; with the drift gate on, three programs
around its one host read: the read, the rescue on a fired frame, the
commit with the anchor's refresh), and the loop-closure chain:
``global_pgo`` (PGO), ``switch_ba_update`` (switch BA),
``predicates_fused`` (the manager's keyframe predicates) and
``overlap_verify_icp`` (verification + ICP, run only when the manager
asks). Their ids, counts and frame indices are device inputs (host ints
copied into static buffers), so one program serves a run. What stays
eager: every path over a mesh of several devices, the consistency BA, the
mesher's volume and the switch-back bookkeeping.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from time import perf_counter_ns
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models import scene_rep as sr
from ..ops import field_cuda as fc
from . import manager, mapper, pose_graph, tracker
from .state import SlamState, row

Tensors = Dict[str, torch.Tensor]


class CudaGraphs:
    """Warm-up and capture on one side stream of ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def warm_up(self, fn: Callable[[], Tensors]) -> Tensors:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable[[], Tensors]):
        """(replay, the captured outputs, the graph's memory in bytes:
        the device memory its private pool reserved). A system lives in
        reference cycles, so its graphs die when the cyclic collector
        runs; a graph destroyed in the middle of another's capture ends
        that capture. So the collector runs before the capture and not
        during it."""
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    out = fn()
                return (graph.replay, out,
                        torch.cuda.memory_reserved() - before)
        finally:
            if enabled:
                gc.enable()


PHASES = ("draws", "inputs", "launch", "outputs", "capture", "read")


class HostClock:
    """Host nanoseconds inside the frame, by stage: each stage's span
    (``MIPSFusionTorch._timed``; ``frame`` around ``process_frame``), the
    part of it that spans nested in it took, and inside it the stage
    programs' host phases (``PHASES``) and the counted device-to-host
    reads (``manager.host_dict``). A phase or a read counts under the
    innermost open span, or outside any under the stage it names.

    Always on: a few ``perf_counter_ns`` calls and integer adds a span or
    phase, into one list a stage. With ``log`` (between frames:
    ``MIPSFusionTorch.trace_spans``) each span and phase is also a
    ``torch.profiler`` ``record_function`` range: ``mf/<stage>``,
    ``mf/<stage>/<phase>``, ``mf/read/<stage>``."""

    # a stage's record: [span ns, spans, nested ns, the phases' ns in
    # PHASES's order, reads, read bytes]
    DRAWS, INPUTS, LAUNCH, OUTPUTS, CAPTURE, READ = range(3, 9)

    def __init__(self):
        self.records: Dict[str, List[int]] = {}
        self.log = False
        self._open: List[List[int]] = []     # the open spans' records
        self._names: List[str] = []
        self._ranges: List = []              # their ranges (None: no log)

    def _record(self, stage: str) -> List[int]:
        rec = self.records.get(stage)
        if rec is None:
            rec = self.records[stage] = [0] * 11
        return rec

    @staticmethod
    def _range(name: str):
        from torch.profiler import record_function
        rng = record_function(name)
        rng.__enter__()
        return rng

    def begin(self, stage: str) -> int:
        """Open ``stage``'s span; gives the time ``end`` takes."""
        self._open.append(self._record(stage))
        self._names.append(stage)
        self._ranges.append(self._range(f"mf/{stage}") if self.log
                            else None)
        return perf_counter_ns()

    def end(self, t0: int) -> None:
        """Close the innermost span, opened at ``t0``."""
        dt = perf_counter_ns() - t0
        rec = self._open.pop()
        self._names.pop()
        rng = self._ranges.pop()
        rec[0] += dt
        rec[1] += 1
        if self._open:
            self._open[-1][2] += dt
        if rng is not None:
            rng.__exit__(None, None, None)

    def start(self, stage: str, phase: int) -> int:
        """Start a phase (``HostClock.DRAWS`` ... ``READ``) of ``stage``'s
        program; gives the time ``stop`` takes."""
        if self.log:
            name = self._names[-1] if self._names else stage
            self._ranges.append(self._range(
                f"mf/read/{name}" if phase == self.READ
                else f"mf/{name}/{PHASES[phase - self.DRAWS]}"))
        return perf_counter_ns()

    def stop(self, stage: str, phase: int, t0: int, nbytes: int = 0) -> None:
        """End the phase started at ``t0`` (a read: of ``nbytes``)."""
        dt = perf_counter_ns() - t0
        rec = self._open[-1] if self._open else self._record(stage)
        rec[phase] += dt
        if phase == self.READ:
            rec[9] += 1
            rec[10] += nbytes
        if self.log:
            self._ranges.pop().__exit__(None, None, None)

    def stats(self, stage: str) -> Dict:
        """``stage``'s spans, their host seconds and phases (``host_s``:
        ``span``, ``nested`` and each of ``PHASES``), reads and read
        bytes."""
        rec = self.records.get(stage) or [0] * 11
        host = {"span": rec[0] * 1e-9, "nested": rec[2] * 1e-9}
        host.update((p, rec[3 + j] * 1e-9) for j, p in enumerate(PHASES))
        return {"spans": rec[1], "host_s": host, "reads": rec[9],
                "read_bytes": rec[10]}


class Program:
    """One stage at one key: ``body(static inputs) -> outputs`` (dicts of
    tensors), run eagerly without ``graphs`` (the CPU), else warmed up,
    captured and replayed (see the module docstring). ``calls``,
    ``replays``, ``capture_s`` and ``graph_bytes`` describe it; ``clock``
    counts its host phases."""

    def __init__(self, stage: str, key: Tuple, body: Callable[[Tensors],
                                                               Tensors],
                 graphs: Optional[CudaGraphs] = None,
                 clock: Optional[HostClock] = None):
        self.stage, self.key, self.body = stage, key, body
        self.graphs = graphs
        self.clock = clock if clock is not None else HostClock()
        self.template: Optional[_Template] = None
        self._static: Optional[Tensors] = None
        self._out: Optional[Tensors] = None
        self._replay = None
        self._delta: Dict = {}
        self.calls = self.replays = 0
        self.capture_s = 0.0
        self.graph_bytes = 0

    def __call__(self, inputs: Tensors) -> Tensors:
        self.calls += 1
        clock, stage = self.clock, self.stage
        t = clock.start(stage, clock.INPUTS)
        if self._static is None:
            self._static = {k: v.detach().clone() for k, v in inputs.items()}
        else:
            self._load(inputs)
        clock.stop(stage, clock.INPUTS, t)
        if self.graphs is None:
            t = clock.start(stage, clock.LAUNCH)
            out = self.body(self._static)
            clock.stop(stage, clock.LAUNCH, t)
            return out
        if self._replay is None:
            t = clock.start(stage, clock.CAPTURE)
            out = self._warm_up_and_capture()
            clock.stop(stage, clock.CAPTURE, t)
            return out
        t = clock.start(stage, clock.LAUNCH)
        self._replay()
        fc.add_launch_counts(self._delta)
        self.replays += 1
        clock.stop(stage, clock.LAUNCH, t)
        t = clock.start(stage, clock.OUTPUTS)
        out = {k: v.clone() for k, v in self._out.items()}
        clock.stop(stage, clock.OUTPUTS, t)
        return out

    def _load(self, inputs: Tensors) -> None:
        static = self._static
        if inputs.keys() != static.keys() or any(
                v.shape != static[k].shape or v.dtype != static[k].dtype
                for k, v in inputs.items()):
            raise ValueError(f"stage {self.stage!r}: the inputs do not fit "
                             f"the program's key {self.key}")
        with torch.no_grad():
            torch._foreach_copy_([static[k] for k in inputs],
                                 list(inputs.values()))

    def _warm_up_and_capture(self) -> Tensors:
        out = self.graphs.warm_up(lambda: self.body(self._static))
        before = fc.launch_counters()
        t0 = time.perf_counter()
        try:
            self._replay, self._out, self.graph_bytes = self.graphs.capture(
                lambda: self.body(self._static))
        except Exception as err:
            raise RuntimeError(f"capturing stage {self.stage!r} at key "
                               f"{self.key} failed: {err}") from err
        self.capture_s = time.perf_counter() - t0
        # the capture counted launches that it only recorded
        self._delta = fc.launch_count_delta(before, fc.launch_counters())
        fc.add_launch_counts(self._delta, -1)
        return out


class _Template:
    """The field and map optimizer a program's body trains in place:
    each call copies a submap's parameters and moments in (matched by
    parameter name) and the results out."""

    def __init__(self, field: sr.Field, mcfg: mapper.MapConfig):
        self.field = sr.Field(field.params(detach=True))
        self.opt = mapper.make_map_optimizer(self.field, mcfg)
        self.opt.init_state()

    def _pairs(self, field: sr.Field, opt: mapper.MapAdam):
        """(the template's tensors, the submap's) in one order: the
        parameters, each group's count, the moments."""
        src = dict(field.named_parameters())
        names = [n for n, _ in self.field.named_parameters()]
        mine = [p for _, p in self.field.named_parameters()]
        theirs = [src[n] for n in names]
        opt.init_state()
        groups = [g["params"] for g in opt.param_groups]
        ta = mine + [self.opt.state[g["params"][0]]["step"]
                     for g in self.opt.param_groups]
        tb = theirs + [opt.state[g[0]]["step"] for g in groups]
        for key in ("exp_avg", "exp_avg_sq"):
            ta += [self.opt.state[p][key] for p in mine]
            tb += [opt.state[p][key] for p in theirs]
        return ta, tb

    @torch.no_grad()
    def load(self, field: sr.Field, opt: mapper.MapAdam) -> None:
        ta, tb = self._pairs(field, opt)
        torch._foreach_copy_(ta, tb)

    @torch.no_grad()
    def store(self, field: sr.Field, opt: mapper.MapAdam) -> None:
        ta, tb = self._pairs(field, opt)
        torch._foreach_copy_(tb, ta)


def _shapes(inputs: Tensors) -> Tuple:
    return tuple((k, tuple(v.shape), str(v.dtype))
                 for k, v in sorted(inputs.items()))


def _param_shapes(field: sr.Field) -> Tuple:
    return tuple((n, tuple(p.shape)) for n, p in field.named_parameters())


def _flatten(tree: Dict, prefix: str) -> Tensors:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(static: Tensors, prefix: str) -> Dict:
    tree: Dict = {}
    for name, v in static.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _consts_inputs(consts: sr.FieldConsts) -> Tensors:
    return {"bb_lo": consts.bb_lo, "bb_inv_extent": consts.bb_inv_extent}


def _consts(s: Tensors) -> sr.FieldConsts:
    return sr.FieldConsts(s["bb_lo"], s["bb_inv_extent"])


def _state_inputs(st: SlamState, names: Tuple[str, ...]) -> Tensors:
    return {f"st/{n}": getattr(st, n) for n in names}


def _state(s: Tensors, **registers) -> SlamState:
    """A SlamState over a program's static buffers: the tables it was
    given, the host registers it reads as device scalars (``registers``),
    None for the rest."""
    tables = {f.name: s.get(f"st/{f.name}")
              for f in dataclasses.fields(SlamState)
              if f.name not in ("n_kf", "active_submap_id",
                                "prev_active_submap_id",
                                "last_switch_frame")}
    return SlamState(**tables, **registers)


def _track_drawn(draws: tracker.TrackDraws, fcfg: sr.FieldConfig,
                 n_iter_go: int) -> Tensors:
    """A track program's inputs of its draws: RO's pixels, GO's offsets."""
    out = {}
    if draws.pixels is not None:
        out["pixels"] = draws.pixels
    if fcfg.perturb and n_iter_go > 0:
        out["go_u"] = torch.stack(draws.go)
    return out


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A host int as an int64 device scalar on like's device (a copy made
    before the replay, into the program's static buffer)."""
    return torch.as_tensor(x, dtype=torch.int64, device=like.device)


class StagePrograms:
    """One system's stage programs on ``device``, by key; each stage
    method takes the stage function's arguments and gives its result."""

    def __init__(self, device, graphs: Optional[CudaGraphs] = None):
        self.device = torch.device(device)
        if graphs is None and self.device.type == "cuda":
            graphs = CudaGraphs(self.device)
        self.graphs = graphs
        self.programs: Dict[Tuple, Program] = {}
        self.clock = HostClock()

    def _program(self, key: Tuple, make_body) -> Program:
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = Program(key[0], key, None,
                                                self.graphs, self.clock)
            prog.body = make_body(prog)
        return prog

    def stats(self) -> Dict:
        """Per stage: programs (graphs on the card), calls, replays,
        capture seconds and the graphs' memory in bytes, by the programs'
        stage; spans, host seconds by phase (``host_s``), reads and read
        bytes (``HostClock.stats``), by the span's stage (``frame``: the
        whole frame). Every entry has every field, 0 where it has none."""
        out: Dict[str, Dict] = {}
        for stage in [p.stage for p in self.programs.values()] + list(
                self.clock.records):
            if stage not in out:
                out[stage] = {"programs": 0, "calls": 0, "replays": 0,
                              "capture_s": 0.0, "graph_bytes": 0,
                              **self.clock.stats(stage)}
        for p in self.programs.values():
            s = out[p.stage]
            s["programs"] += 1
            s["calls"] += p.calls
            s["replays"] += p.replays
            s["capture_s"] += p.capture_s
            s["graph_bytes"] += p.graph_bytes
        return out

    # ------------------------------------------------------------ BA

    def local_ba(self, field: sr.Field, opt: mapper.MapAdam,
                 kf_rays: torch.Tensor, kf_mask: torch.Tensor, first_kf,
                 last_kf: torch.Tensor, kf_poses_local: torch.Tensor,
                 cur_rays: torch.Tensor, cur_pose_local: torch.Tensor,
                 fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                 mcfg: mapper.MapConfig, lw: sr.LossWeights, n_total: int,
                 generator: Optional[torch.Generator] = None,
                 include_current: bool = True,
                 optim_cur: Optional[bool] = None) -> mapper.BAResult:
        """``mapper.local_ba`` as a program (stage "ba", or "refine"
        without the current frame); ``field`` and ``opt`` are updated in
        place as the function updates them."""
        if optim_cur is None:
            optim_cur = mcfg.optim_cur
        stage = "ba" if include_current else "refine"
        clock = self.clock
        t = clock.start(stage, clock.DRAWS)
        K, R, _ = kf_rays.shape
        first_kf = torch.as_tensor(first_kf, device=kf_rays.device)
        w = mapper.kf_sampling_weights(
            kf_mask, first_kf, last_kf, mcfg.sample,
            mcfg.pixels_cur if include_current else 0)
        draws, us = mapper.ba_draws(w, mcfg.iters, n_total,
                                    (R, cur_rays.shape[0]), fcfg, generator)
        drawn = {name: torch.stack([d[j] for d in draws])
                 for j, name in enumerate(("src", "ray_idx", "cur_idx"))}
        if fcfg.perturb:
            drawn["u"] = torch.stack(us)
        clock.stop(stage, clock.DRAWS, t)
        t = clock.start(stage, clock.INPUTS)
        inputs = {"kf_rays": kf_rays, "kf_mask": kf_mask,
                  "first_kf": first_kf, "last_kf": last_kf,
                  "kf_poses": kf_poses_local, "cur_rays": cur_rays,
                  "cur_pose": cur_pose_local, **_consts_inputs(consts),
                  **drawn}
        key = (stage, fcfg, mcfg, lw, n_total, bool(include_current),
               bool(optim_cur), _shapes(inputs), _param_shapes(field))

        def make_body(prog):
            prog.template = _Template(field, mcfg)
            tmpl = prog.template

            def body(s: Tensors) -> Tensors:
                res = mapper.local_ba(
                    tmpl.field, tmpl.opt, s["kf_rays"], s["kf_mask"],
                    s["first_kf"], s["last_kf"], s["kf_poses"],
                    s["cur_rays"], s["cur_pose"], fcfg, _consts(s), mcfg,
                    lw, n_total, include_current=include_current,
                    optim_cur=optim_cur,
                    draws=list(zip(s["src"], s["ray_idx"], s["cur_idx"])),
                    us=list(s["u"]) if "u" in s else None)
                return res._asdict()
            return body

        prog = self._program(key, make_body)
        prog.template.load(field, opt)
        clock.stop(stage, clock.INPUTS, t)
        out = prog(inputs)
        t = clock.start(stage, clock.OUTPUTS)
        prog.template.store(field, opt)
        clock.stop(stage, clock.OUTPUTS, t)
        return mapper.BAResult(**out)

    # ----------------------------------------------------- first fits

    def init_submap_fit(self, field: sr.Field, opt: mapper.MapAdam,
                        frame_rays: torch.Tensor, fcfg: sr.FieldConfig,
                        consts: sr.FieldConsts, mcfg: mapper.MapConfig,
                        lw: sr.LossWeights, n_iters: int, n_rays: int,
                        generator: Optional[torch.Generator] = None,
                        chunk: int = 0) -> torch.Tensor:
        """``mapper.init_submap_fit`` as programs of ``chunk`` iterations
        each (all n_iters in one when chunk is 0 or not below n_iters),
        the last chunk what remains; the draws come from ``generator`` in
        the function's order across the chunks. Returns the last loss."""
        if not 0 < chunk < n_iters:
            chunk = n_iters
        dev = frame_rays.device
        clock = self.clock
        loss = None
        done = 0
        while done < n_iters:
            c = min(chunk, n_iters - done)
            t = clock.start("fit", clock.DRAWS)
            idx, us = mapper.fit_draws(generator, frame_rays.shape[0],
                                       n_rays, c, fcfg, dev)
            drawn = {"idx": torch.stack(idx)}
            if fcfg.perturb:
                drawn["u"] = torch.stack(us)
            clock.stop("fit", clock.DRAWS, t)
            t = clock.start("fit", clock.INPUTS)
            inputs = {"rays": frame_rays, **_consts_inputs(consts), **drawn}
            key = ("fit", fcfg, mcfg, lw, n_rays, c, _shapes(inputs),
                   _param_shapes(field))

            def make_body(prog, c=c):
                prog.template = _Template(field, mcfg)
                tmpl = prog.template

                def body(s: Tensors) -> Tensors:
                    return {"loss": mapper.init_submap_fit(
                        tmpl.field, tmpl.opt, s["rays"], fcfg, _consts(s),
                        mcfg, lw, c, n_rays, draws=list(s["idx"]),
                        us=list(s["u"]) if "u" in s else None)}
                return body

            prog = self._program(key, make_body)
            prog.template.load(field, opt)
            clock.stop("fit", clock.INPUTS, t)
            loss = prog(inputs)["loss"]
            t = clock.start("fit", clock.OUTPUTS)
            prog.template.store(field, opt)
            clock.stop("fit", clock.OUTPUTS, t)
            done += c
        return loss

    # --------------------------------------------------------- track

    def track_frame_update(self, params: Dict, fcfg: sr.FieldConfig,
                           consts: sr.FieldConsts, rcfg: tracker.ROConfig,
                           gcfg: tracker.GOConfig, pst: torch.Tensor,
                           generator: Optional[torch.Generator],
                           packed_frame: torch.Tensor, state, frame_idx: int,
                           use_const_speed: bool, lw: sr.LossWeights,
                           n_iter_ro: int, n_iter_go: int,
                           keyframe_every: int, loss_ewma: torch.Tensor,
                           prev_loss: Optional[torch.Tensor] = None,
                           dgcfg: Optional[tracker.DriftGateConfig] = None,
                           gate: Optional[tracker.GateAnchor] = None,
                           prev_rescued: Optional[torch.Tensor] = None,
                           polish_generator: Optional[torch.Generator] = None
                           ) -> tracker.TrackResult:
        """``tracker.track_frame_update``. With the drift gate off, a
        program of ``tracker.track_pose``, the pose committed to ``state``
        after the replay (``tracker.commit_pose``); with it on, three
        (``_track_gated``)."""
        if tracker._gate_on(dgcfg, gate):
            return self._track_gated(
                params, fcfg, consts, rcfg, gcfg, pst, generator,
                packed_frame, state, frame_idx, use_const_speed, lw,
                n_iter_ro, n_iter_go, keyframe_every, loss_ewma, prev_loss,
                dgcfg, gate, prev_rescued, polish_generator)
        clock = self.clock
        t = clock.start("track", clock.DRAWS)
        H, W = packed_frame.shape[:2]
        draws = tracker.track_draws(generator, H, W, rcfg, gcfg, fcfg,
                                    n_iter_go, packed_frame.device)
        drawn = _track_drawn(draws, fcfg, n_iter_go)
        clock.stop("track", clock.DRAWS, t)
        t = clock.start("track", clock.INPUTS)
        inputs = {"packed": packed_frame, "pst": pst,
                  "prev": state.est_c2w[frame_idx - 1],
                  "prev_prev": state.est_c2w[max(frame_idx - 2, 0)],
                  "loss_ewma": loss_ewma, **_consts_inputs(consts),
                  **_flatten(params, "p/")}
        if rcfg.escalate > 0.0 and prev_loss is not None:
            inputs["prev_loss"] = prev_loss
        inputs.update(drawn)
        key = ("track", fcfg, rcfg, gcfg, lw, n_iter_ro, n_iter_go,
               bool(use_const_speed), _shapes(inputs))

        def make_body(prog):
            def body(s: Tensors) -> Tensors:
                packed = s["packed"]
                res, _ = tracker.track_pose(
                    _unflatten(s, "p/"), fcfg, _consts(s), rcfg, gcfg,
                    s["pst"], None, packed[..., 3:6], packed[..., 6],
                    packed[..., :3], s["prev"], s["prev_prev"],
                    use_const_speed, lw, n_iter_ro, n_iter_go,
                    s["loss_ewma"], prev_loss=s.get("prev_loss"),
                    draws=tracker.TrackDraws(
                        s.get("pixels"),
                        list(s["go_u"]) if "go_u" in s
                        else [None] * n_iter_go))
                return {k: v for k, v in res._asdict().items()
                        if v is not None}
            return body

        prog = self._program(key, make_body)
        clock.stop("track", clock.INPUTS, t)
        out = prog(inputs)
        t = clock.start("track", clock.OUTPUTS)
        res = tracker.TrackResult(**out)
        tracker.commit_pose(state, frame_idx, res.pose, keyframe_every)
        clock.stop("track", clock.OUTPUTS, t)
        return res

    def _track_gated(self, params, fcfg, consts, rcfg, gcfg, pst, generator,
                     packed_frame, state, frame_idx, use_const_speed, lw,
                     n_iter_ro, n_iter_go, keyframe_every, loss_ewma,
                     prev_loss, dgcfg, gate, prev_rescued, polish_generator
                     ) -> tracker.TrackResult:
        """The drift-gated track as three programs around its one host
        read (JAX: ``lax.cond``): (A) ``track_pose`` and the gate's
        reading (stage "track_gate"), then the 2-element copy of its
        flags; (B) on a fired frame the rescue (stage "track_rescue"),
        its polish draws made first; (C) where the gate fired or the
        anchor is due, the commit and the anchor's refresh in that form
        (stage "track_commit"); else the commit eagerly, as with the gate
        off."""
        clock = self.clock
        t = clock.start("track_gate", clock.DRAWS)
        H, W = packed_frame.shape[:2]
        dev = packed_frame.device
        draws = tracker.track_draws(generator, H, W, rcfg, gcfg, fcfg,
                                    n_iter_go, dev)
        drawn = _track_drawn(draws, fcfg, n_iter_go)
        clock.stop("track_gate", clock.DRAWS, t)
        t = clock.start("track_gate", clock.INPUTS)
        frame = _scalar(frame_idx, packed_frame)
        gate_in = {"gate/pts": gate.pts, "gate/normals": gate.normals,
                   "gate/valid": gate.valid, "gate/kf_frame": gate.kf_frame}
        common = {"packed": packed_frame, "est_c2w": state.est_c2w,
                  **gate_in, **_consts_inputs(consts),
                  **_flatten(params, "p/")}
        inputs = {**common, "pst": pst, "frame": frame,
                  "loss_ewma": loss_ewma}
        if rcfg.escalate > 0.0 and prev_loss is not None:
            inputs["prev_loss"] = prev_loss
        if prev_rescued is not None:
            inputs["prev_rescued"] = prev_rescued
        inputs.update(drawn)
        key = ("track_gate", fcfg, rcfg, gcfg, dgcfg, lw, n_iter_ro,
               n_iter_go, bool(use_const_speed), _shapes(inputs))

        def gate_of(s):
            return tracker.GateAnchor(s["gate/pts"], s["gate/normals"],
                                      s["gate/valid"], s["gate/kf_frame"])

        def read_body(prog):
            def body(s: Tensors) -> Tensors:
                packed, est, f = s["packed"], s["est_c2w"], s["frame"]
                res, go_rays = tracker.track_pose(
                    _unflatten(s, "p/"), fcfg, _consts(s), rcfg, gcfg,
                    s["pst"], None, packed[..., 3:6], packed[..., 6],
                    packed[..., :3], row(est, f - 1),
                    row(est, torch.clamp(f - 2, min=0)), use_const_speed,
                    lw, n_iter_ro, n_iter_go, s["loss_ewma"],
                    prev_loss=s.get("prev_loss"),
                    prev_rescued=s.get("prev_rescued"),
                    draws=tracker.TrackDraws(
                        s.get("pixels"),
                        list(s["go_u"]) if "go_u" in s
                        else [None] * n_iter_go))
                reading = tracker.gate_read(res.pose, packed[..., 6],
                                            packed[..., :3], est, f,
                                            gate_of(s), dgcfg)
                return {**{k: v for k, v in res._asdict().items()
                           if v is not None},
                        "go/dirs": go_rays[0], "go/rgb": go_rays[1],
                        "go/depth": go_rays[2], **reading._asdict()}
            return body

        prog = self._program(key, read_body)
        clock.stop("track_gate", clock.INPUTS, t)
        a = prog(inputs)
        res = tracker.TrackResult(**{k: a[k] for k in (
            "pose", "loss", "loss_ewma", "accepted", "drift_res", "armed",
            "fired", "rescued", "ss_scale")})
        reading = tracker.GateReading(a["slip"], a["pose_icp"], a["armed"],
                                      a["flags"])
        # the host's one read a frame
        fire_h, refresh = manager.host_dict(
            {"flags": reading.flags}, clock, "track_gate")["flags"].tolist()
        rescue = ()
        if fire_h:
            t = clock.start("track_rescue", clock.DRAWS)
            us = tracker.polish_draws(polish_generator, gcfg, fcfg, dgcfg,
                                      n_iter_go, dev)
            polish = ({"polish_u": torch.stack(us)} if us and us[0] is not None
                      else {})
            clock.stop("track_rescue", clock.DRAWS, t)
            t = clock.start("track_rescue", clock.INPUTS)
            b_in = {**common, "pose": a["pose"], "slip": a["slip"],
                    "pose_icp": a["pose_icp"], "go/dirs": a["go/dirs"],
                    "go/rgb": a["go/rgb"], "go/depth": a["go/depth"],
                    **polish}
            b_key = ("track_rescue", fcfg, gcfg, dgcfg, lw, n_iter_go,
                     _shapes(b_in))

            def rescue_body(prog):
                def body(s: Tensors) -> Tensors:
                    packed = s["packed"]
                    pose, drift, rescued = tracker.gate_rescue(
                        _unflatten(s, "p/"), fcfg, _consts(s), gcfg, dgcfg,
                        s["pose"], tracker.GateReading(
                            s["slip"], s["pose_icp"], None, None),
                        packed[..., 6], packed[..., :3], s["est_c2w"],
                        gate_of(s),
                        (s["go/dirs"], s["go/rgb"], s["go/depth"]),
                        n_iter_go, lw,
                        us=(list(s["polish_u"]) if "polish_u" in s
                            else [None] * n_iter_go))
                    return {"pose": pose, "drift_res": drift,
                            "rescued": rescued}
                return body

            prog = self._program(b_key, rescue_body)
            clock.stop("track_rescue", clock.INPUTS, t)
            b = prog(b_in)
            rescue = (b["pose"], b["drift_res"], b["rescued"])
        res = tracker.gate_result(res, reading, gate, refresh, *rescue)
        if not (fire_h or refresh):
            t = clock.start("track_gate", clock.OUTPUTS)
            tracker.commit_pose(state, frame_idx, res.pose, keyframe_every)
            clock.stop("track_gate", clock.OUTPUTS, t)
            return res
        # (C): the commit and the anchor's refresh, in the form the read
        # chose
        t = clock.start("track_commit", clock.INPUTS)
        c_in = {"pose": res.pose, "frame": frame, "packed": packed_frame,
                "st/est_c2w": state.est_c2w,
                "st/est_c2w_rel": state.est_c2w_rel,
                "st/keyframe_ref": state.keyframe_ref,
                "st/active_first_kf": state.active_first_kf, **gate_in}
        if fire_h:
            c_in["drift_res"] = res.drift_res
        c_key = ("track_commit", dgcfg, keyframe_every, bool(fire_h),
                 _shapes(c_in))

        def commit_body(prog):
            def body(s: Tensors) -> Tensors:
                est, rel, ref = tracker.commit_pose_at(
                    s["st/est_c2w"], s["st/est_c2w_rel"],
                    s["st/keyframe_ref"], s["st/active_first_kf"],
                    s["frame"], s["pose"], keyframe_every)
                new = tracker.gate_refresh(gate_of(s), s["packed"],
                                           s["frame"], dgcfg,
                                           s.get("drift_res"))
                return {"est_c2w": est, "est_c2w_rel": rel,
                        "keyframe_ref": ref,
                        **{f"gate/{k}": v for k, v in new._asdict().items()}}
            return body

        prog = self._program(c_key, commit_body)
        clock.stop("track_commit", clock.INPUTS, t)
        c = prog(c_in)
        t = clock.start("track_commit", clock.OUTPUTS)
        with torch.no_grad():
            torch._foreach_copy_(
                [state.est_c2w, state.est_c2w_rel, state.keyframe_ref],
                [c["est_c2w"], c["est_c2w_rel"], c["keyframe_ref"]])
        clock.stop("track_commit", clock.OUTPUTS, t)
        return res._replace(gate=tracker.GateAnchor(
            c["gate/pts"], c["gate/normals"], c["gate/valid"],
            c["gate/kf_frame"]))

    # ----------------------------------------------------- loop closure

    def global_pgo(self, st: SlamState, local_prev: torch.Tensor,
                   local_aft: torch.Tensor, aft_id: int, prev_id: int,
                   used: int, key_w: float) -> None:
        """``system.global_pgo`` as one program for every PGO of a run
        (stage "pgo"; JAX: ``_global_pgo``): the ids, the used count and
        the key edge's weight are device inputs, the pair list a constant
        made once a key; the anchors are written to ``st`` after the
        replay."""
        from . import system
        clock = self.clock
        t = clock.start("pgo", clock.INPUTS)
        dev = st.kf_c2w.device
        inputs = {"kf_c2w": st.kf_c2w, "first_kf": st.localMLP_first_kf,
                  "adjacency": st.localMLP_adjacent,
                  "local_prev": local_prev, "local_aft": local_aft,
                  "key_edge": _scalar([aft_id, prev_id], st.kf_c2w),
                  "used": _scalar(used, st.kf_c2w),
                  "key_w": torch.as_tensor(key_w, dtype=torch.float32,
                                           device=dev)}
        key = ("pgo", _shapes(inputs))

        def make_body(prog):
            pairs = pose_graph.edge_pairs(st.localMLP_first_kf.shape[0], dev)

            def body(s: Tensors) -> Tensors:
                return {"kf_c2w": system.pgo_anchors(
                    s["kf_c2w"], s["first_kf"], s["adjacency"],
                    s["local_prev"], s["local_aft"], s["key_edge"],
                    s["used"], s["key_w"], pairs=pairs)}
            return body

        prog = self._program(key, make_body)
        clock.stop("pgo", clock.INPUTS, t)
        out = prog(inputs)
        t = clock.start("pgo", clock.OUTPUTS)
        with torch.no_grad():
            st.kf_c2w.copy_(out["kf_c2w"])
        clock.stop("pgo", clock.OUTPUTS, t)

    def switch_ba_update(self, st: SlamState, params: Dict,
                         kf_mask: torch.Tensor, frame_rays: torch.Tensor,
                         i: int, kf_frames: torch.Tensor,
                         fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                         lw: sr.LossWeights, lr_rot: float, lr_trans: float,
                         n_iters: int, n_total: int, pose_accum_step: int,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """``system.switch_ba_update`` as a program (stage "switch_ba";
        JAX: ``_switch_ba_fused``): the keyframe-pose extraction, the
        pose-only BA on the frozen field (its parameters are inputs) and
        the write of frame i's pose; the frame index and the active submap
        are device inputs, the draws made before the replay. Returns the
        last loss."""
        from . import system
        clock = self.clock
        t = clock.start("switch_ba", clock.DRAWS)
        K, R, _ = st.kf_rays.shape
        w = mapper.switch_ba_weights(kf_mask, n_total)
        draws, us = mapper.ba_draws(w, n_iters, n_total,
                                    (R, frame_rays.shape[0]), fcfg,
                                    generator)
        drawn = {name: torch.stack([d[j] for d in draws])
                 for j, name in enumerate(("src", "ray_idx", "ovlp_idx"))}
        if fcfg.perturb:
            drawn["u"] = torch.stack(us)
        clock.stop("switch_ba", clock.DRAWS, t)
        t = clock.start("switch_ba", clock.INPUTS)
        inputs = {**_state_inputs(st, _POSE_TABLES), "kf_mask": kf_mask,
                  "rays": frame_rays, "frame": _scalar(i, kf_mask),
                  "active": _scalar(st.active_submap_id, kf_mask),
                  "kf_frames": kf_frames, **_consts_inputs(consts),
                  **_flatten(params, "p/"), **drawn}
        key = ("switch_ba", fcfg, lw, lr_rot, lr_trans, n_iters, n_total,
               pose_accum_step, _shapes(inputs))

        def make_body(prog):
            def body(s: Tensors) -> Tensors:
                est, loss = system.switch_ba_at(
                    _state(s, active_submap_id=s["active"]),
                    _unflatten(s, "p/"), s["kf_mask"], s["rays"],
                    s["frame"], s["kf_frames"], fcfg, _consts(s), lw,
                    lr_rot, lr_trans, n_iters, n_total, pose_accum_step,
                    draws=list(zip(s["src"], s["ray_idx"], s["ovlp_idx"])),
                    us=list(s["u"]) if "u" in s else [None] * n_iters)
                return {"est_c2w": est, "loss": loss}
            return body

        prog = self._program(key, make_body)
        clock.stop("switch_ba", clock.INPUTS, t)
        out = prog(inputs)
        t = clock.start("switch_ba", clock.OUTPUTS)
        with torch.no_grad():
            st.est_c2w.copy_(out["est_c2w"])
        clock.stop("switch_ba", clock.OUTPUTS, t)
        return out["loss"]

    def predicates_fused(self, st: SlamState, pose_local: torch.Tensor,
                         depth: torch.Tensor, rays_d: torch.Tensor,
                         wait_id: int, min_cr_len: torch.Tensor, near: float,
                         far: float, rows: torch.Tensor, cols: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
        """``manager.predicates_fused`` as one program (stage "manager";
        JAX: ``manager._predicates_fused``), the active and the wait-loop
        submap device inputs; the caller's one batched host copy
        (``manager.host_dict``) follows the replay."""
        clock = self.clock
        t = clock.start("manager", clock.INPUTS)
        inputs = {**_state_inputs(st, ("kf_c2w", "localMLP_first_kf",
                                       "localMLP_info", "localMLP_max_len")),
                  "active": _scalar(st.active_submap_id, depth),
                  "wait": _scalar(wait_id, depth), "pose_local": pose_local,
                  "depth": depth, "rays_d": rays_d,
                  "min_cr_len": min_cr_len, "rows": rows, "cols": cols}
        key = ("manager", near, far, _shapes(inputs))

        def make_body(prog):
            def body(s: Tensors) -> Tensors:
                return manager.predicates_fused(
                    _state(s, active_submap_id=s["active"]),
                    s["pose_local"], s["depth"], s["rays_d"], s["wait"],
                    s["min_cr_len"], near, far, s["rows"], s["cols"])
            return body

        prog = self._program(key, make_body)
        clock.stop("manager", clock.INPUTS, t)
        return prog(inputs)

    def overlap_verify_icp(self, st: SlamState, depth, rays_d, pose_world,
                           mo_id: int, active_id: int, rows, cols, K_mat,
                           kf_frames, cur_frame: int, rr_src, cc_src,
                           sub_incl, threshold: float, min_trans: float,
                           min_count: int, k: int, edge: int, H: int, W: int,
                           n_per: int, n_incl: int, keyframe_every: int,
                           R: int, n_iters: int = 15,
                           rel_damping: float = 0.0
                           ) -> Dict[str, torch.Tensor]:
        """``system.overlap_verify_icp`` as one program for every
        verification of a run (stage "verify"; JAX:
        ``_overlap_verify_icp``): the submap ids, the last tracked frame
        and the keyframe count are device inputs. It runs only when the
        manager asks for a verification (unfused from the predicates)."""
        from . import system
        clock = self.clock
        t = clock.start("verify", clock.INPUTS)
        inputs = {**_state_inputs(st, _VERIFY_TABLES),
                  "n_kf": _scalar(st.n_kf, depth),
                  "mo": _scalar(mo_id, depth),
                  "active": _scalar(active_id, depth),
                  "cur": _scalar(cur_frame, depth), "depth": depth,
                  "rays_d": rays_d, "pose_world": pose_world, "rows": rows,
                  "cols": cols, "K_mat": K_mat, "kf_frames": kf_frames,
                  "rr_src": rr_src, "cc_src": cc_src, "sub_incl": sub_incl}
        statics = (threshold, min_trans, min_count, k, edge, H, W, n_per,
                   n_incl, keyframe_every, R, n_iters, rel_damping)
        key = ("verify", statics, _shapes(inputs))

        def make_body(prog):
            def body(s: Tensors) -> Tensors:
                return system.overlap_verify_icp(
                    _state(s, n_kf=s["n_kf"]), s["depth"], s["rays_d"],
                    s["pose_world"], s["mo"], s["active"], s["rows"],
                    s["cols"], s["K_mat"], s["kf_frames"], s["cur"],
                    s["rr_src"], s["cc_src"], s["sub_incl"], threshold,
                    min_trans, min_count, k, edge, H, W, n_per, n_incl,
                    keyframe_every, R, n_iters, rel_damping)
            return body

        prog = self._program(key, make_body)
        clock.stop("verify", clock.INPUTS, t)
        return prog(inputs)


# the state tables the keyframe-pose extraction reads, and verification
_POSE_TABLES = ("kf_rays", "kf_c2w", "est_c2w", "keyframe_ref",
                "keyframe_localMLP", "localMLP_first_kf")
_VERIFY_TABLES = _POSE_TABLES + ("localMLP_info", "kf_frame_ids")

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

The stages (``StagePrograms``): ``local_ba`` (local BA, and background
refinement: a fresh optimizer, ``include_current=False``),
``init_submap_fit`` (the first fits, one program a chunk of iterations)
and ``track_frame_update`` (tracking with the drift gate off). The drift-
gated track (one host read a frame), every path over a mesh of several
devices, the manager, ICP, PGO, switch BA, the consistency BA and the
mesher stay eager.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models import scene_rep as sr
from ..ops import field_cuda as fc
from . import mapper, tracker

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


class Program:
    """One stage at one key: ``body(static inputs) -> outputs`` (dicts of
    tensors), run eagerly without ``graphs`` (the CPU), else warmed up,
    captured and replayed (see the module docstring). ``calls``,
    ``replays``, ``capture_s`` and ``graph_bytes`` describe it."""

    def __init__(self, stage: str, key: Tuple, body: Callable[[Tensors],
                                                               Tensors],
                 graphs: Optional[CudaGraphs] = None):
        self.stage, self.key, self.body = stage, key, body
        self.graphs = graphs
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
        if self._static is None:
            self._static = {k: v.detach().clone() for k, v in inputs.items()}
        else:
            self._load(inputs)
        if self.graphs is None:
            return self.body(self._static)
        if self._replay is None:
            return self._warm_up_and_capture()
        self._replay()
        fc.add_launch_counts(self._delta)
        self.replays += 1
        return {k: v.clone() for k, v in self._out.items()}

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


class StagePrograms:
    """One system's stage programs on ``device``, by key; each stage
    method takes the stage function's arguments and gives its result."""

    def __init__(self, device, graphs: Optional[CudaGraphs] = None):
        self.device = torch.device(device)
        if graphs is None and self.device.type == "cuda":
            graphs = CudaGraphs(self.device)
        self.graphs = graphs
        self.programs: Dict[Tuple, Program] = {}

    def _program(self, key: Tuple, make_body) -> Program:
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = Program(key[0], key, None,
                                                self.graphs)
            prog.body = make_body(prog)
        return prog

    def stats(self) -> Dict:
        """Per stage: programs (graphs on the card), calls, replays,
        capture seconds and the graphs' memory in bytes."""
        out: Dict[str, Dict] = {}
        for p in self.programs.values():
            s = out.setdefault(p.stage, {"programs": 0, "calls": 0,
                                         "replays": 0, "capture_s": 0.0,
                                         "graph_bytes": 0})
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
        K, R, _ = kf_rays.shape
        first_kf = torch.as_tensor(first_kf, device=kf_rays.device)
        w = mapper.kf_sampling_weights(
            kf_mask, first_kf, last_kf, mcfg.sample,
            mcfg.pixels_cur if include_current else 0)
        draws, us = mapper.ba_draws(w, mcfg.iters, n_total,
                                    (R, cur_rays.shape[0]), fcfg, generator)
        inputs = {"kf_rays": kf_rays, "kf_mask": kf_mask,
                  "first_kf": first_kf, "last_kf": last_kf,
                  "kf_poses": kf_poses_local, "cur_rays": cur_rays,
                  "cur_pose": cur_pose_local, **_consts_inputs(consts)}
        for j, name in enumerate(("src", "ray_idx", "cur_idx")):
            inputs[name] = torch.stack([d[j] for d in draws])
        if fcfg.perturb:
            inputs["u"] = torch.stack(us)
        stage = "ba" if include_current else "refine"
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
        out = prog(inputs)
        prog.template.store(field, opt)
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
        loss = None
        done = 0
        while done < n_iters:
            c = min(chunk, n_iters - done)
            idx, us = mapper.fit_draws(generator, frame_rays.shape[0],
                                       n_rays, c, fcfg, dev)
            inputs = {"rays": frame_rays, "idx": torch.stack(idx),
                      **_consts_inputs(consts)}
            if fcfg.perturb:
                inputs["u"] = torch.stack(us)
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
            loss = prog(inputs)["loss"]
            prog.template.store(field, opt)
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
                           prev_loss: Optional[torch.Tensor] = None
                           ) -> tracker.TrackResult:
        """``tracker.track_frame_update`` with the drift gate off, as a
        program of ``tracker.track_pose``; the pose is committed to
        ``state`` after the replay (``tracker.commit_pose``)."""
        H, W = packed_frame.shape[:2]
        draws = tracker.track_draws(generator, H, W, rcfg, gcfg, fcfg,
                                    n_iter_go, packed_frame.device)
        inputs = {"packed": packed_frame, "pst": pst,
                  "prev": state.est_c2w[frame_idx - 1],
                  "prev_prev": state.est_c2w[max(frame_idx - 2, 0)],
                  "loss_ewma": loss_ewma, **_consts_inputs(consts),
                  **_flatten(params, "p/")}
        if rcfg.escalate > 0.0 and prev_loss is not None:
            inputs["prev_loss"] = prev_loss
        if draws.pixels is not None:
            inputs["pixels"] = draws.pixels
        if fcfg.perturb and n_iter_go > 0:
            inputs["go_u"] = torch.stack(draws.go)
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

        out = self._program(key, make_body)(inputs)
        res = tracker.TrackResult(**out)
        tracker.commit_pose(state, frame_idx, res.pose, keyframe_every)
        return res

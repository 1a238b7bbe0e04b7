"""One streamed SLAM session of the port: the system on the benchmark's
lap stream, a warm lap, then the measured window, frame by frame as a
closed loop (frame i is handed in only once frame i - 1's pose is on the
host).

The system under test is ``mipsfusion_tpu_torch.slam.system
.MIPSFusionTorch``, driven through ``process_frame``. From it the
session reads the pose of each frame, the per-stage CUDA events and call
counts (``stage_ms``'s events, ``stage_calls``) and the stage programs'
counters (``programs.stats()``). Around the
system's stage methods it puts its own wrappers: ``record_function``
spans in a traced run, and on the calls the correctness check samples,
copies of each checked stage's inputs and outputs (``Snapshots``).
"""

from __future__ import annotations

import copy
import inspect
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .lapdata import LapStream

# the system's stage methods that the traced run wraps in spans
SPAN_METHODS = ("process_frame", "track", "do_local_ba",
                "inactive_refine_step",
                "_manager_step", "active_submap_switch",
                "active_submap_switch_new", "local_ba_switch",
                "add_keyframe", "_drain_switch_chain", "_drain_init_chunk")


# The system seeds each stage's generator with seed x 1_000_003 x 100_003
# plus small terms in 64 bits, so its config seed must stay below about
# 9e7: the run's --seed is folded into [0, SEED_MOD) (a prime).
SEED_MOD = 67_108_859


def config_seed(seed: int) -> int:
    return int(seed) % SEED_MOD


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    return t.detach().clone()


class CheckPlan:
    """The stage calls the correctness check copies, drawn from the seed:
    ``track_calls`` tracked frames and ``ba_frames`` mapping frames (local
    BA and the refine round of that frame) among the window's first
    ``span`` frames, and the window's first ``verify_calls``
    verifications with their ICP, ``switch_ba_calls`` switch BAs and
    ``pgo_calls`` PGOs (``check`` of a configuration file)."""

    def __init__(self, seed: int, start: int, span: int, map_every: int,
                 check: Dict):
        rng = random.Random(seed * 7919 + 17)
        frames = list(range(start, start + span))
        self.track = set(rng.sample(frames, min(check["track_calls"],
                                                len(frames))))
        ba = [i for i in frames if i % map_every == 0]
        self.ba = set(rng.sample(ba, min(check["ba_frames"], len(ba))))
        self.n_pgo = check["pgo_calls"]
        self.n_verify = check["verify_calls"]
        self.n_switch_ba = check["switch_ba_calls"]


class Snapshots:
    """Copies of the checked stage calls' inputs and outputs (device
    tensors, cloned on the device: no host read inside the window);
    ``encoding`` is the reference's module of the field's encoding, which
    names the embed leaves."""

    def __init__(self, system, plan: CheckPlan, encoding):
        self.system = system
        self.plan = plan
        self.encoding = encoding
        self.frame = -1
        self.active = False
        self.track: List[Dict] = []
        self.ba: List[Dict] = []
        self.pgo: List[Dict] = []
        self.verify: List[Dict] = []
        self.switch_ba: List[Dict] = []
        prog = system.programs
        self._track = prog.track_frame_update
        self._pgo = prog.global_pgo
        self._verify = prog.overlap_verify_icp
        self._switch_ba = prog.switch_ba_update
        self._ba = system._local_ba
        prog.track_frame_update = self.track_hook
        prog.global_pgo = self.pgo_hook
        prog.overlap_verify_icp = self.verify_hook
        prog.switch_ba_update = self.switch_ba_hook
        system._local_ba = self.ba_hook

    def track_hook(self, *args, **kw):
        i = args[9]
        take = self.active and i in self.plan.track and not kw
        if take:
            snap = {"frame": i, "params": _clone_tree(args[0]),
                    "pst": args[5].clone(),
                    "generator": args[6].get_state(),
                    "prev": args[8].est_c2w[i - 1].clone(),
                    "prev_prev": args[8].est_c2w[max(i - 2, 0)].clone(),
                    "use_cs": bool(args[10]),
                    "loss_ewma": args[15].clone()}
        res = self._track(*args, **kw)
        if take:
            snap.update(pose=res.pose.clone(), loss=res.loss.clone())
            self.track.append(snap)
        return res

    def ba_hook(self, field, opt, args, generator, **kw):
        take = self.active and self.frame in self.plan.ba
        if take:
            kf_rays, kf_mask, first_kf, last_kf, kf_poses, cur_rays, \
                cur_pose = args[:7]
            include = kw.get("include_current", True)
            moments = {}
            for name, g in zip(("decoder", "embed"), opt.param_groups):
                if all(p in opt.state for p in g["params"]):
                    names = _leaf_names(field, self.encoding, g["params"])
                    st = [opt.state[p] for p in g["params"]]
                    moments[name] = {
                        "count": st[0]["step"].clone(),
                        "m": {n: s["exp_avg"].clone()
                              for n, s in zip(names, st)},
                        "v": {n: s["exp_avg_sq"].clone()
                              for n, s in zip(names, st)}}
            snap = {"frame": self.frame,
                    "params": _clone_tree(field.params(detach=True)),
                    "moments": moments, "kf_mask": kf_mask.clone(),
                    "first_kf": torch.as_tensor(first_kf).clone(),
                    "last_kf": last_kf.clone(), "kf_poses": kf_poses.clone(),
                    "R": int(kf_rays.shape[1]),
                    "cur_rays": None if include else cur_rays.clone(),
                    "cur_pose": cur_pose.clone(), "n_total": int(args[11]),
                    "include_current": bool(include),
                    "optim_cur": bool(kw.get("optim_cur", False)),
                    "generator": generator.get_state()}
        res = self._ba(field, opt, args, generator, **kw)
        if take:
            snap.update(after=_clone_tree(field.params(detach=True)),
                        kf_quat=res.kf_quat.clone(),
                        kf_trans=res.kf_trans.clone(),
                        loss=res.loss.clone())
            self.ba.append(snap)
        return res

    def pgo_hook(self, st, local_prev, local_aft, aft_id, prev_id, used,
                 key_w):
        take = self.active and len(self.pgo) < self.plan.n_pgo
        if take:
            snap = {"frame": self.frame, "kf_c2w": st.kf_c2w.clone(),
                    "first_kf": st.localMLP_first_kf.clone(),
                    "adjacency": st.localMLP_adjacent.clone(),
                    "local_prev": local_prev.clone(),
                    "local_aft": local_aft.clone(), "aft_id": int(aft_id),
                    "prev_id": int(prev_id), "used": int(used),
                    "key_w": float(key_w)}
        out = self._pgo(st, local_prev, local_aft, aft_id, prev_id, used,
                        key_w)
        if take:
            snap["after"] = st.kf_c2w.clone()
            self.pgo.append(snap)
        return out

    def verify_hook(self, *args, **kw):
        take = self.active and len(self.verify) < self.plan.n_verify
        if take:
            a = inspect.signature(self._verify).bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            st = a["st"]
            snap = {"frame": self.frame, "tables": _tables(st, _VERIFY),
                    "n_kf": int(st.n_kf), "pose_world": a["pose_world"].clone(),
                    "mo": int(a["mo_id"]), "active": int(a["active_id"]),
                    "cur": int(a["cur_frame"]),
                    "n_src": int(a["rr_src"].shape[0]),
                    "consts": {n: a[n] for n in _VERIFY_CONSTS}}
        out = self._verify(*args, **kw)
        if take:
            snap["out"] = {k: v.clone() for k, v in out.items()}
            self.verify.append(snap)
        return out

    def switch_ba_hook(self, *args, **kw):
        take = self.active and len(self.switch_ba) < self.plan.n_switch_ba
        if take:
            a = inspect.signature(self._switch_ba).bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            st, i = a["st"], int(a["i"])
            snap = {"frame": i, "tables": _tables(st, _POSES),
                    "active": int(st.active_submap_id),
                    "params": _clone_tree(a["params"]),
                    "kf_mask": a["kf_mask"].clone(),
                    "generator": a["generator"].get_state(),
                    "consts": {n: a[n] for n in _SWITCH_BA_CONSTS}}
        loss = self._switch_ba(*args, **kw)
        if take:
            snap.update(pose=st.est_c2w[i].clone(), loss=loss.clone())
            self.switch_ba.append(snap)
        return loss


# the state tables the loop-closure stages read
_POSES = ("est_c2w", "kf_c2w", "keyframe_ref", "keyframe_localMLP",
          "localMLP_first_kf")
_VERIFY = _POSES + ("localMLP_info",)
# the stages' constant arguments, as the call gives them
_VERIFY_CONSTS = ("threshold", "min_trans", "min_count", "k", "edge", "H",
                  "W", "n_per", "n_incl", "keyframe_every", "R", "n_iters",
                  "rel_damping")
_SWITCH_BA_CONSTS = ("lr_rot", "lr_trans", "n_iters", "n_total",
                     "pose_accum_step")


def _tables(st, names) -> Dict[str, torch.Tensor]:
    return {n: getattr(st, n).clone() for n in names}


def _leaf_names(field, encoding, params) -> List[str]:
    """The names of an optimizer group's ``params`` in the moments: a
    decoder leaf's ``<layer>.<w|b>``, an embed leaf's as the encoding
    names it in ``field.params(detach=True)`` (matched by storage)."""
    tree = field.params(detach=True)
    named = [(f"{n}.{k}", t) for n, d in tree["decoder"].items()
             for k, t in d.items()] + encoding.embed_leaves(tree)
    by_ptr = {t.data_ptr(): n for n, t in named}
    return [by_ptr[p.data_ptr()] for p in params]


def install_spans(system) -> None:
    """Wrap the system's stage methods in ``record_function`` spans named
    after them (the traced run's labels for the device's idle gaps)."""
    from torch.profiler import record_function
    for name in SPAN_METHODS:
        fn = getattr(system, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name.lstrip("_")):
                return _fn(*a, **k)
        setattr(system, name, wrapped)


class Session:
    """A system on the stream of ``traffic`` under configuration ``cfg``
    with ``seed`` as its config seed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
        cfg = copy.deepcopy(cfg)
        cfg["seed"] = config_seed(seed)
        self.device = torch.device(device)
        self.stream = LapStream(cfg["cam"], traffic, self.device)
        self.stream.render_lap()
        self.system = MIPSFusionTorch(cfg, dataset=self.stream,
                                      device=self.device)
        self.next_frame = 0
        self.poses: Dict[int, np.ndarray] = {}
        self.snapshots: Optional[Snapshots] = None

    def world_pose(self, i: int) -> torch.Tensor:
        """Frame i's pose in the world as the system holds it after
        ``process_frame(i)``: the active submap's anchor times the local
        pose (on the device)."""
        st = self.system.state
        anchor = st.kf_c2w[st.localMLP_first_kf[st.active_submap_id]]
        return anchor @ st.est_c2w[i]

    def step(self) -> np.ndarray:
        """Hand in the next frame and read its pose to the host."""
        i = self.next_frame
        if i >= self.stream.num_frames:
            raise RuntimeError(f"the session reached its {i} frames: "
                               "session_frames is too small for this rate")
        if self.snapshots is not None:
            self.snapshots.frame = i
        self.system.process_frame(i)
        pose = self.world_pose(i).cpu().numpy()
        self.next_frame = i + 1
        self.poses[i] = pose
        return pose

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> Dict:
        """Stage calls, event counts and the programs' counters now."""
        s = self.system
        return {"calls": dict(s.stage_calls),
                "events": {k: len(v) for k, v in s._events.items()},
                "programs": copy.deepcopy(s.programs.stats())}

    def window(self, seconds: float, trace_frames: int = 0,
               profiler_factory=None, max_frames: Optional[int] = None
               ) -> Dict:
        """Frames until ``seconds`` have passed since the first was handed
        in (the last one finishes). Returns each frame's latency, the
        window's wall seconds, the counters before and after, and with a
        profiler the traced part (its first ``trace_frames`` frames)."""
        if self.snapshots is not None:
            self.snapshots.active = True
        before = self.counters()
        lat: List[float] = []
        frames: List[int] = []
        traced = None
        prof = None
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            if profiler_factory is not None and not frames:
                prof = profiler_factory()
                prof.__enter__()
                traced = {"t0": t0, "before": self.counters()}
            frames.append(self.next_frame)
            self.step()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if prof is not None and len(frames) == trace_frames:
                torch.cuda.synchronize(self.device)
                traced["t1"] = time.perf_counter()
                traced["after"] = self.counters()
                traced["frames"] = list(frames)
                prof.__exit__(None, None, None)
                traced["profile"] = prof
                prof = None
            if t1 - t_start >= seconds or len(frames) == max_frames:
                break
        wall = time.perf_counter() - t_start
        if prof is not None:
            raise RuntimeError("the traced part outlasted the window: "
                               "lower the traffic's trace_frames")
        if self.snapshots is not None:
            self.snapshots.active = False
        return {"latency_s": lat, "frames": frames, "wall_s": wall,
                "before": before, "after": self.counters(),
                "traced": traced}

    def stage_event_ms(self, stage: str, first: int, last: int) -> List[float]:
        """Device ms of the stage's calls first..last-1 (CUDA events)."""
        ev = self.system._events.get(stage, [])[first:last]
        return [a.elapsed_time(b) for a, b in ev]

"""The per-frame SLAM loop, single-submap subset.

Port of ``mipsfusion_tpu/slam/system.py`` with ``use_manager: False``:
first-frame mapping, tracking (RO then GO), local BA every ``map_every``
frames, keyframes every ``keyframe_every`` frames, trajectory assembly and
ATE. The submap manager, loop closure, background refinement,
checkpoints and meshing are later slices.

Randomness: one ``torch.Generator`` per stage (tracking, BA, first-frame
fit), reseeded from (config seed, frame index) at each use, so a run is
reproducible on one device.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from mipsfusion_tpu.eval.ate import pose_evaluation

from ..models import scene_rep as sr
from ..ops.geometry import get_frame_surface_bbox, qt_to_matrix
from . import mapper, tracker
from . import state as slam_state

_STAGE_SEED = {"track": 1, "ba": 2, "init": 3}


class MIPSFusionTorch:
    """Online single-submap neural RGB-D SLAM in PyTorch."""

    def __init__(self, config: Dict, dataset, device=None):
        if config.get("use_manager", True):
            raise NotImplementedError(
                "the port runs the single-submap loop: set use_manager: False")
        self.config = config
        self.dataset = dataset
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.H, self.W = dataset.H, dataset.W

        self.fcfg = sr.FieldConfig.from_dict(config)
        self.rcfg = tracker.ROConfig.from_dict(config)
        self.gcfg = tracker.GOConfig.from_dict(config)
        self.mcfg = mapper.MapConfig.from_dict(config)
        self.lw = sr.LossWeights.from_dict(config)
        m = config["mapping"]
        self.keyframe_every = m["keyframe_every"]
        self.map_every = m["map_every"]

        n_frames = dataset.num_frames
        n_kf = (n_frames - 1) // self.keyframe_every + 1
        samp = config["sampling"]
        self.state = slam_state.init_state(
            n_frames, n_kf, m["localMLP_num"],
            samp["kf_n_rays_h"] * samp["kf_n_rays_w"], self.device)
        self.kf_rows, self.kf_cols = slam_state.kf_downsample_indices(
            self.H, self.W, samp["kf_n_rays_h"], samp["kf_n_rays_w"],
            self.device)
        self.kf_frames = torch.arange(n_kf, device=self.device) \
            * self.keyframe_every
        bound = torch.tensor(m["bound"], dtype=torch.float32,
                             device=self.device)
        if self.fcfg.use_bound_normalize:
            self.consts = sr.FieldConsts.from_bound(bound)
        else:
            self.consts = sr.FieldConsts.from_norm_factor(torch.tensor(
                m["localMLP_max_len"], dtype=torch.float32,
                device=self.device))

        self.seed = int(config.get("seed", 0))
        g = self._generator("init", -1)
        self.field = sr.Field(sr.init_field(self.fcfg, g, self.device))
        self.map_opt = mapper.make_map_optimizer(self.field, self.mcfg)
        self.pst = tracker.make_pst(g, self.rcfg, self.device)
        self.active_id = 0
        self.track_losses = []
        self._loss_ewma = torch.full((), -1.0, device=self.device)
        # CUDA event pairs per stage (no host sync while the loop runs)
        self._events = defaultdict(list)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _generator(self, stage: str, i: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + _STAGE_SEED[stage]) * 100_003
                      + i + 1)
        return g

    def _timed(self, stage: str, fn, *args):
        if self.device.type != "cuda":
            return fn(*args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        self._events[stage].append((a, b))
        return out

    def stage_ms(self) -> Dict[str, float]:
        """Mean device-stream time per call of each stage (CUDA only)."""
        if self._events:
            torch.cuda.synchronize()
        return {k: float(np.mean([a.elapsed_time(b) for a, b in v]))
                for k, v in self._events.items()}

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def first_frame_mapping(self, packed: torch.Tensor, c2w_world,
                            n_iters: int):
        """Initialize submap 0 on frame 0 at the local identity pose."""
        st = self.state
        c2w = torch.as_tensor(c2w_world, dtype=torch.float32,
                              device=self.device)
        center, length = get_frame_surface_bbox(
            c2w, packed[..., 6], packed[..., :3],
            self.config["cam"]["near"], self.config["cam"]["far"])
        st.kf_c2w[0] = c2w
        st.est_c2w[0] = torch.eye(4, device=self.device)
        st.keyframe_ref[0] = -1
        st.localMLP_first_kf[0] = 0
        st.localMLP_info[0] = torch.cat(
            [torch.ones(1, device=self.device), center, length])
        st.keyframe_localMLP[0, 0] = 0
        mapper.init_submap_fit(
            self.field, self.map_opt, packed.reshape(-1, 7), self.fcfg,
            self.consts, self.mcfg, self.lw, n_iters, self.mcfg.sample,
            self._generator("init", 0))
        slam_state.add_keyframe(st, packed, 0, self.kf_rows, self.kf_cols)

    def track(self, packed: torch.Tensor, i: int):
        # constant-velocity prediction from the third frame on (no submap
        # switch resets it in the single-submap loop)
        use_cs = bool(self.config["tracking"]["const_speed"] and i >= 2)
        res = tracker.track_frame_update(
            self.field.params(detach=True), self.fcfg, self.consts,
            self.rcfg, self.gcfg, self.pst, self._generator("track", i),
            packed, self.state, i, use_cs, self.lw, self.rcfg.n_iters,
            self.gcfg.n_iters, self.keyframe_every, self._loss_ewma)
        self._loss_ewma = res.loss_ewma
        self.track_losses.append(res.loss)

    def do_local_ba(self, packed: torch.Tensor, i: int):
        """Local BA on the active submap and the pose write-back."""
        st = self.state
        kf_mask = slam_state.submap_kf_mask(st, self.active_id)
        first_kf = st.active_first_kf
        K = kf_mask.shape[0]
        last_kf = torch.where(kf_mask, torch.arange(K, device=self.device),
                              torch.full_like(kf_mask, -1, dtype=torch.int64)
                              ).max()
        poses_local = st.est_c2w[self.kf_frames].clone()
        poses_local[first_kf] = torch.eye(4, device=self.device)
        res = mapper.local_ba(
            self.field, self.map_opt, st.kf_rays, kf_mask, first_kf, last_kf,
            poses_local, packed.reshape(-1, 7), st.est_c2w[i], self.fcfg,
            self.consts, self.mcfg, self.lw,
            self.mcfg.sample + self.mcfg.pixels_cur, self._generator("ba", i))
        # write back ordinary keyframes of this submap (the first stays)
        idx = torch.arange(K, device=self.device)
        upd = kf_mask & (idx != first_kf) & (st.keyframe_ref >= 0)
        opt_poses = qt_to_matrix(res.kf_quat, res.kf_trans)
        st.est_c2w[self.kf_frames] = torch.where(
            upd[:, None, None], opt_poses, st.est_c2w[self.kf_frames])
        if self.mcfg.optim_cur:
            st.est_c2w[i] = qt_to_matrix(res.cur_quat, res.cur_trans)

    def add_keyframe(self, packed: torch.Tensor, i: int):
        slam_state.add_keyframe(self.state, packed, i, self.kf_rows,
                                self.kf_cols)
        self.state.keyframe_localMLP[i // self.keyframe_every, 0] = \
            self.active_id

    def process_frame(self, i: int):
        """Track, map and add keyframes for frame i."""
        packed = self.dataset.packed(i)
        if i == 0:
            self._timed("init", self.first_frame_mapping, packed,
                        self.dataset.gt_pose(0), self.mcfg.first_iters)
            return
        self._timed("track", self.track, packed, i)
        if i % self.map_every == 0:
            self._timed("ba", self.do_local_ba, packed, i)
        if i % self.keyframe_every == 0:
            self._timed("keyframe", self.add_keyframe, packed, i)

    def run(self, verbose: bool = True) -> Dict:
        """Process every frame; returns ATE stats, ``fps`` (frames over the
        loop's wall time, synchronised at the end) and ``n_submaps``.
        Frames are rendered before the clock starts."""
        n = self.dataset.num_frames
        for j in range(n):
            self.dataset.packed(j)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        for i in range(n):
            self.process_frame(i)
            if verbose and i % 25 == 0 and i > 0:
                print(f"frame {i}/{n}  track_loss="
                      f"{float(self.track_losses[-1]):.4f}  "
                      f"{i / (time.time() - t0):.2f} fps")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.time() - t0
        results = self.evaluate(n - 1)
        results["fps"] = n / elapsed
        results["n_submaps"] = int(
            self.state.localMLP_info[:, 0].sum().item())
        return results

    # ------------------------------------------------------------------
    # trajectory + evaluation
    # ------------------------------------------------------------------

    def assemble_trajectory(self, up_to: int) -> np.ndarray:
        """Local poses: keyframes as stored, other frames as their
        keyframe's pose times the stored relative pose."""
        st = self.state
        est = st.est_c2w[:up_to + 1].cpu().numpy()
        rel = st.est_c2w_rel[:up_to + 1].cpu().numpy()
        kf_ref = st.keyframe_ref.cpu().numpy()
        poses = np.empty_like(est)
        for i in range(up_to + 1):
            kf_id = i // self.keyframe_every
            if i % self.keyframe_every == 0:
                poses[i] = np.eye(4) if kf_ref[kf_id] == -1 else est[i]
            else:
                poses[i] = est[kf_id * self.keyframe_every] @ rel[i]
        return poses

    def world_trajectory(self, up_to: int) -> np.ndarray:
        st = self.state
        poses_local = self.assemble_trajectory(up_to)
        kf_ids = np.arange(up_to + 1) // self.keyframe_every
        kf_submap = st.keyframe_localMLP[:, 0].cpu().numpy()
        first_kf = st.localMLP_first_kf.cpu().numpy()
        kf_c2w = st.kf_c2w.cpu().numpy()
        anchors = kf_c2w[first_kf[np.clip(kf_submap[kf_ids], 0, None)]]
        return anchors @ poses_local

    def evaluate(self, up_to: int) -> Dict:
        """ATE of frames 0..up_to against the dataset's ground truth."""
        world = self.world_trajectory(up_to)
        gt = np.stack([self.dataset.gt_pose(i) for i in range(up_to + 1)])
        return pose_evaluation(gt, world)

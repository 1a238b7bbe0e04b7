"""The per-frame SLAM loop with multiple implicit submaps.

Port of ``mipsfusion_tpu/slam/system.py``: first-frame mapping, tracking
(RO then GO), local BA every ``map_every`` frames, keyframes every
``keyframe_every`` frames, and with ``use_manager`` (the default) the
submap manager's decisions: a new submap (its first fit drained in chunks
over the following frames), or a switch back to a previous submap after
overlap verification and ICP rectification, with switch BA on the switch
frame and the pose-graph optimization of the submap anchors on the next.
Between them, one background-refinement round on an inactive submap per
mapping step. Trajectory assembly and ATE lift each frame through its
keyframe's submap anchor.

Loop-closure verification runs unfused: the manager's predicates first,
then verification and ICP only when the host asks for it (the JAX
package's speculative fused program exists to save round trips through a
remote TPU link; both give the same decisions).

The output half: ``run`` writes, at the JAX package's cadences, the
evaluation, TUM trajectory, render panel and trajectory plot
(``mesh.vis``), checkpoints (``mesh.ckpt_freq``; ``save_checkpoint``,
``resume_from``), meshes (``mesh.mesh_freq`` or ``request_mesh``;
``extract_mesh``, the joint mesh fusing every submap's SDF), and at the
end the trajectory, ``ckpt_final`` and ``mesh_final.ply`` with its
accuracy and completion on a synthetic scene. A meshing failure raises
(the JAX package prints it and carries on).

The robustness levers, all off by default: the RO screen and escalation
and the GO motion prior (``slam/tracker.py``), the drift gate with its
anchor armed on the first frame, refreshed by the tracker and disarmed on
a switch, a PGO or a resume, and ``mapping.kf_strain_mask`` (a keyframe
tracked under strain stores zero depth).

Left out (later slices): the SDF-consistency global BA, sharded
refinement.

Randomness: one ``torch.Generator`` per stage, reseeded from (config seed,
stage, frame index or call count) at each use, so a run is reproducible
on one device.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..eval.ate import pose_evaluation, save_traj_tum
from ..models import scene_rep as sr
from ..ops.geometry import (get_frame_surface_bbox, pose_inverse,
                            project_to_pixel, pts_in_bbox, qt_to_matrix,
                            rays_to_world)
from . import icp as icp_mod
from . import manager as manager_mod
from . import mapper, pose_graph, tracker
from . import state as slam_state
from .state import SlamState

_STAGE_SEED = {"track": 1, "ba": 2, "init": 3, "refine": 4, "switch": 5,
               "render": 6, "polish": 7}

# Relative damping of the loop-closure ICP (icp_point_to_plane). The JAX
# package solves undamped; on the flagship outback's forced switch back
# the clouds are nearly degenerate (walls and floor seen from 1-2 m
# apart) and the undamped solve slides the pose along them by 5-35 cm
# (tests/test_torch_icp_damping.py).
SWITCH_ICP_DAMPING = 0.01


# ---------------------------------------------------------------------------
# submap bookkeeping (pure functions of the state, or in-place updates)
# ---------------------------------------------------------------------------

def _anchor_of(st: SlamState, submap_id) -> torch.Tensor:
    return st.kf_c2w[st.localMLP_first_kf[submap_id]]


def extract_submap_kf_poses(st: SlamState, submap_id,
                            kf_frames: torch.Tensor) -> torch.Tensor:
    """Local poses [K, 4, 4] of every keyframe slot in submap_id's frame:
    ordinary keyframes as stored; first keyframes of OTHER submaps from
    their world anchors; overlapping keyframes first-bound elsewhere
    through both anchors; the submap's own first keyframe the identity."""
    poses = st.est_c2w[kf_frames]
    K = poses.shape[0]
    M = st.localMLP_first_kf.shape[0]
    anchor_inv = pose_inverse(_anchor_of(st, submap_id))
    kf_ref = st.keyframe_ref
    first_kf = st.localMLP_first_kf[submap_id]
    idx = torch.arange(K, device=poses.device)
    from_world = anchor_inv @ st.kf_c2w[:K]
    is_other_first = (kf_ref == -1) & (idx != first_kf)
    poses = torch.where(is_other_first[:, None, None], from_world, poses)
    first_bind = st.keyframe_localMLP[:, 0]
    other_anchor = st.kf_c2w[st.localMLP_first_kf[
        torch.clamp(first_bind, 0, M - 1)]]
    local_ovlp = anchor_inv @ (other_anchor @ st.est_c2w[kf_frames])
    is_ovlp_other = (kf_ref == -2) & (first_bind != submap_id)
    poses = torch.where(is_ovlp_other[:, None, None], local_ovlp, poses)
    eye = torch.eye(4, device=poses.device)
    return torch.where((idx == first_kf)[:, None, None], eye, poses)


def writeback_ba_poses(st: SlamState, submap_id, kf_mask: torch.Tensor,
                       opt_poses: torch.Tensor,
                       kf_frames: torch.Tensor) -> None:
    """Write BA-optimized local poses back by keyframe type (in place):
    ordinary and overlapping keyframes first-bound here as they are,
    overlapping keyframes first-bound elsewhere into that submap's frame,
    first keyframes of other submaps into their world anchors."""
    K = opt_poses.shape[0]
    M = st.localMLP_first_kf.shape[0]
    kf_ref = st.keyframe_ref
    idx = torch.arange(K, device=opt_poses.device)
    upd = kf_mask & (idx != st.localMLP_first_kf[submap_id])
    first_bind = st.keyframe_localMLP[:, 0]
    ordinary = upd & (kf_ref >= 0)
    ovlp_here = upd & (kf_ref == -2) & (first_bind == submap_id)
    ovlp_other = upd & (kf_ref == -2) & (first_bind != submap_id)
    world = _anchor_of(st, submap_id) @ opt_poses
    other_anchor_inv = pose_inverse(st.kf_c2w[st.localMLP_first_kf[
        torch.clamp(first_bind, 0, M - 1)]])
    local_other = other_anchor_inv @ world
    new_frame_pose = torch.where(
        (ordinary | ovlp_here)[:, None, None], opt_poses,
        torch.where(ovlp_other[:, None, None], local_other,
                    st.est_c2w[kf_frames]))
    other_first = upd & (kf_ref == -1)
    new_anchor = torch.where(other_first[:, None, None], world,
                             st.kf_c2w[:K])
    st.est_c2w[kf_frames] = new_frame_pose
    st.kf_c2w[:K] = new_anchor


def switch_state_update(st: SlamState, i: int, rectified: torch.Tensor,
                        back_id: int) -> torch.Tensor:
    """Switch-back bookkeeping (in place): the rectified local pose
    replaces frame i's; returns the pre-rectification pose (the PGO's
    temp_local_pose)."""
    temp = st.est_c2w[i].clone()
    st.active_first_kf = st.localMLP_first_kf[back_id].clone()
    st.last_switch_frame = int(i)
    st.est_c2w[i] = rectified
    return temp


def global_pgo(st: SlamState, local_prev: torch.Tensor,
               local_aft: torch.Tensor, aft_id: int, prev_id: int,
               used: int, key_w: float) -> None:
    """Pose-graph optimization of the submap anchors after a loop closure
    (in place): edges between adjacent used submaps plus the key edge
    (aft_id, prev_id) observed as local_prev @ local_aft^-1; submap 0 is
    fixed; the optimized anchors go back only to rows < used."""
    M = st.localMLP_info.shape[0]
    Nk = st.kf_c2w.shape[0]
    dev = st.kf_c2w.device
    first_kf = torch.clamp(st.localMLP_first_kf, 0, Nk - 1)
    anchors = st.kf_c2w[first_kf]
    edges, rels, weights = pose_graph.build_pose_graph_problem(
        anchors, st.localMLP_adjacent, (aft_id, prev_id),
        local_prev @ pose_inverse(local_aft), key_w, used)
    ar = torch.arange(M, device=dev)
    node_mask = (ar >= 1) & (ar < used)
    nodes, _ = pose_graph.optimize_pose_graph(anchors, edges, rels, weights,
                                              node_mask, n_iters=10)
    st.kf_c2w.index_copy_(0, first_kf[:used], nodes[:used])


# ---------------------------------------------------------------------------
# loop-closure verification and ICP rectification
# ---------------------------------------------------------------------------

def overlap_verify(st: SlamState, depth, rays_d, pose_world, mo_id: int,
                   active_id: int, rows, cols, K_mat, kf_frames, k: int,
                   edge: int, H: int, W: int) -> Dict[str, torch.Tensor]:
    """Does the current keyframe re-observe submap mo_id? Related
    keyframes (bound to mo_id, not first-bound to the active submap), the
    k nearest of them to the keyframe's surface centre, the surface
    points each sees, and those inside mo_id's box. Missing keyframes pad
    the k slots with top_valid False and take no part in the votes."""
    K = kf_frames.shape[0]
    M = st.localMLP_first_kf.shape[0]
    rel_mask = (slam_state.submap_kf_mask(st, mo_id)
                & (st.keyframe_localMLP[:, 0] != active_id))
    first_bind = st.keyframe_localMLP[:, 0]
    anchors = st.kf_c2w[st.localMLP_first_kf[torch.clamp(first_bind, 0,
                                                          M - 1)]]
    world = anchors @ st.est_c2w[kf_frames]
    world = torch.where((st.keyframe_ref == -1)[:, None, None],
                        st.kf_c2w[:K], world)
    d = depth[rows, cols][:, None]
    rays_o, rays_dw = rays_to_world(rays_d[rows, cols], pose_world)
    pts = rays_o + rays_dw * d
    center = pts.mean(0)
    dists = torch.linalg.norm(world[:, :3, 3] - center, dim=-1)
    dists = torch.where(rel_mask, dists, torch.full_like(dists, 1e9))
    # k nearest; a stable sort breaks ties by index, as lax.top_k does
    top_ids = torch.sort(dists, stable=True).indices[:k]
    top_valid = dists[top_ids] < 1e9
    w2c = pose_inverse(world[top_ids])                       # [k, 4, 4]
    pts_cam = (torch.einsum("kij,nj->kni", w2c[:, :3, :3], pts)
               + w2c[:, None, :3, 3])
    uv = project_to_pixel(K_mat, pts_cam)
    vis = ((uv[..., 0] > edge) & (uv[..., 0] < W - edge)
           & (uv[..., 1] > edge) & (uv[..., 1] < H - edge)
           & (pts_cam[..., 2] < 0) & top_valid[:, None])     # [k, N]
    mask_pts = vis.any(0)
    info = st.localMLP_info[mo_id]
    lo = info[1:4] - 0.5 * info[4:7]
    hi = info[1:4] + 0.5 * info[4:7]
    mask_in = pts_in_bbox(pts, lo[None], hi[None])[:, 0]
    mask_final = mask_pts & mask_in & (d[:, 0] > 0)
    return {"top_kf_ids": top_ids, "top_valid": top_valid,
            "counts": vis.sum(-1), "vis": vis, "mask_final": mask_final,
            "n_related": rel_mask.sum(), "n_visible": mask_pts.sum(),
            "n_in_bbox": mask_in.sum(), "n_valid": mask_final.sum()}


def switch_icp(st: SlamState, use_ids, depth, rays_d, mo_id: int,
               active_id: int, cur_frame: int, kf_frames, rr_src, cc_src,
               sub_dst, sub_incl, threshold: float, min_trans: float,
               n_per: int, n_incl: int, keyframe_every: int,
               n_iters: int = 15, rel_damping: float = 0.0):
    """ICP rectification of the switch pose. Target: the rays sub_dst
    [k, n_per] of the selected keyframes use_ids [k] in mo_id's frame.
    Source: the current keyframe's grid rays at its pose carried into
    mo_id's frame, plus the last n_incl keyframes' stored rays through
    both anchors. Returns (n_inliers, pose_final, pose_local_ini);
    pose_final keeps the initial pose when the correction moves by
    min_trans or more (large corrections are distrusted). ``rel_damping``
    goes to ``icp_point_to_plane`` (0: the JAX package's undamped solve)."""
    anchor_prev = _anchor_of(st, active_id)
    anchor_aft = _anchor_of(st, mo_id)
    pose_local_ini = pose_inverse(anchor_aft) @ (anchor_prev
                                                 @ st.est_c2w[cur_frame])
    poses_local_all = extract_submap_kf_poses(st, mo_id, kf_frames)
    dst_rays = st.kf_rays[use_ids[:, None], sub_dst].reshape(-1, 7)
    dst_pts, dst_valid = icp_mod.backproject_rays(
        dst_rays, poses_local_all, use_ids.repeat_interleave(n_per))
    d = depth[rr_src, cc_src][:, None]
    dirs_w = rays_d[rr_src, cc_src] @ pose_local_ini[:3, :3].T
    src_pts = [pose_local_ini[:3, 3] + dirs_w * d]
    src_valid = [d[:, 0] > 0]
    if n_incl > 0:
        cur_kf = cur_frame // keyframe_every
        prev_locals = extract_submap_kf_poses(st, active_id, kf_frames)
        rel_anchor = pose_inverse(anchor_aft) @ anchor_prev
        for j in range(1, n_incl + 1):
            kj = max(cur_kf - j, 0)
            pose_aft = rel_anchor @ prev_locals[kj]
            rays_k = st.kf_rays[kj][sub_incl]
            dk = rays_k[:, 6:7]
            src_pts.append(pose_aft[:3, 3]
                           + (rays_k[:, :3] @ pose_aft[:3, :3].T) * dk)
            src_valid.append((dk[:, 0] > 0) & (cur_kf - j >= 0))
    normals = icp_mod.estimate_normals(dst_pts, k=10)
    res = icp_mod.icp_point_to_plane(
        torch.cat(src_pts), torch.cat(src_valid), dst_pts, dst_valid,
        normals, threshold, n_iters=n_iters, rel_damping=rel_damping)
    eye = torch.eye(4, dtype=res.transform.dtype, device=res.transform.device)
    rel = torch.where(torch.linalg.norm(res.transform[:3, 3]) >= min_trans,
                      eye, res.transform)
    return res.n_inliers, rel @ pose_local_ini, pose_local_ini


def overlap_verify_icp(st: SlamState, depth, rays_d, pose_world,
                       mo_id: int, active_id: int, rows, cols, K_mat,
                       kf_frames, cur_frame: int, rr_src, cc_src, sub_incl,
                       threshold: float, min_trans: float, min_count: int,
                       k: int, edge: int, H: int, W: int, n_per: int,
                       n_incl: int, keyframe_every: int, R: int,
                       n_iters: int = 15, rel_damping: float = 0.0
                       ) -> Dict[str, torch.Tensor]:
    """``overlap_verify``, the selection of the keyframes that see more
    than min_count overlap points (all valid ones if none does), and
    ``switch_icp`` on them, on the device. The selected ids are stably
    compacted to the front and cycle-padded over the k slots, each slot
    sampling its own segment of an even spread over the ray store, so
    the whole k * n_per budget lands on the selected keyframes."""
    ver = overlap_verify(st, depth, rays_d, pose_world, mo_id, active_id,
                         rows, cols, K_mat, kf_frames, k, edge, H, W)
    dev = kf_frames.device
    k = ver["top_kf_ids"].shape[0]
    sel = (ver["counts"] > min_count) & ver["top_valid"]
    sel = torch.where(sel.any(), sel, ver["top_valid"])
    order = torch.sort((~sel).to(torch.int32), stable=True).indices
    n_used = torch.clamp(sel.sum(), min=1)
    slots = torch.arange(k, device=dev)
    use_ids = ver["top_kf_ids"][order[slots % n_used]]
    reps = (k + n_used - 1) // n_used
    total = n_per * reps
    seg = slots[:, None] // n_used
    pos = seg * n_per + torch.arange(n_per, device=dev)[None, :]
    sub_dst = torch.clamp((pos * max(R - 1, 1))
                          // torch.clamp(total - 1, min=1), 0, R - 1)
    n_in, pose_final, pose_ini = switch_icp(
        st, use_ids, depth, rays_d, mo_id, active_id, cur_frame, kf_frames,
        rr_src, cc_src, sub_dst, sub_incl, threshold, min_trans, n_per,
        n_incl, keyframe_every, n_iters, rel_damping)
    ver.update({"n_inliers": n_in, "pose_final": pose_final,
                "pose_ini": pose_ini})
    return ver


# ---------------------------------------------------------------------------
# the system
# ---------------------------------------------------------------------------

class MIPSFusionTorch:
    """Online multi-implicit-submap neural RGB-D SLAM in PyTorch, on
    ``device`` (None: the card; ``"cpu"`` for a CPU run). Without a
    ``dataset`` the config's is built (``datasets.dataset.get_dataset``)."""

    def __init__(self, config: Dict, dataset=None, device=None):
        m = config["mapping"]
        if m.get("global_BA", {}).get("sdf_consistency", False):
            raise NotImplementedError(
                "mapping.global_BA.sdf_consistency is not ported")
        self.config = config
        self.device = resolve_device(device)
        if dataset is None:
            from ..datasets.dataset import get_dataset
            dataset = get_dataset(config, self.device)
        self.dataset = dataset
        self.H, self.W = dataset.H, dataset.W

        self.fcfg = sr.FieldConfig.from_dict(config)
        # tracking may run a leaner z-ladder than mapping:
        # tracking.n_samples_d / n_range_d override training.* for the
        # tracker alone (mapping, BA, refine and the mesher keep fcfg)
        tz = {k: config["tracking"][k] for k in ("n_samples_d", "n_range_d")
              if k in config["tracking"]}
        self.fcfg_track = dataclasses.replace(self.fcfg, **tz)
        self.rcfg = tracker.ROConfig.from_dict(config)
        self.gcfg = tracker.GOConfig.from_dict(config)
        self.dgcfg: Optional[tracker.DriftGateConfig] = \
            tracker.DriftGateConfig.from_dict(config)
        if self.dgcfg.thresh <= 0.0:
            self.dgcfg = None                 # the gate off
        self.mcfg = mapper.MapConfig.from_dict(config)
        self.lw = sr.LossWeights.from_dict(config)
        self.keyframe_every = m["keyframe_every"]
        self.kf_strain_mask = float(m.get("kf_strain_mask", 0.0))
        self.map_every = m["map_every"]

        n_frames = dataset.num_frames
        n_kf = (n_frames - 1) // self.keyframe_every + 1
        samp = config["sampling"]
        self.rays_per_kf = samp["kf_n_rays_h"] * samp["kf_n_rays_w"]
        self.state = slam_state.init_state(
            n_frames, n_kf, m["localMLP_num"], self.rays_per_kf,
            m["localMLP_max_len"], self.device)
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

        # every submap starts from the SAME initial params (the reference
        # stores the init values and restores them for each new submap)
        self.seed = int(config.get("seed", 0))
        g = self._generator("init", -1)
        self.initial_params = sr.init_field(self.fcfg, g, self.device)
        self.fields: List[Optional[sr.Field]] = [None] * m["localMLP_num"]
        self.fields[0] = sr.Field(self.initial_params)
        self.active_id = 0
        self.map_opt = mapper.make_map_optimizer(self.fields[0], self.mcfg)
        self.pst = tracker.make_pst(g, self.rcfg, self.device)

        self.use_manager = bool(config.get("use_manager", True))
        self.manager = manager_mod.Manager(
            manager_mod.ManagerConfig.from_dict(config), self.H, self.W,
            self.keyframe_every, self.device)
        self.manager.find_overlap_fn = self._find_overlapping_region
        t = config["tracking"]
        self.switch_interval = t.get("switch_interval", 30)
        sw = t.get("switch", {})
        self.sw_align_threshold = sw.get("align_threshold", 0.05)
        self.sw_min_corr = sw.get("min_correspondence", 2000)
        self.sw_min_trans = sw.get("min_trans_dist", 0.5)
        self.sw_including_last = int(sw.get("including_last", 0))
        self.sw_map_num = sw.get("map_num", 15)
        self.sw_lr_rot = sw.get("lr_rot", 0.001)
        self.sw_lr_trans = sw.get("lr_trans", 0.001)
        self.key_edge_weight = m.get("global_BA", {}).get(
            "key_edge_weight", 0.1)
        self.near_kf_num = 10
        # chunked new-submap init: the first fit drains init_chunk
        # iterations per tracked frame (0 = whole fit on the switch frame)
        self.init_chunk = int(m.get("first_iters_chunk", 0))
        self._pending_init_iters = 0
        self._pending_init_rays = None
        self._n_init_chunks = 0
        # switch-back PGO deferred to the frame after the switch keyframe
        self._pending_switch: Optional[Dict] = None
        # ICP clouds are subsampled; the min-correspondence threshold
        # scales by icp_src_n / rays_per_kf
        self.icp_src_n = min(2048, self.rays_per_kf)
        self.icp_dst_n = 4096
        self._ovlp_grid = None
        self._icp_subs = None
        self._K_mat = None
        self.optim_cur = self.mcfg.optim_cur
        self._inactive_rr = 0
        self.rectified_local_pose: Optional[torch.Tensor] = None
        self.temp_local_pose: Optional[torch.Tensor] = None
        # host mirrors of slow-changing state (updated at keyframe
        # cadence), so the loop never waits on the device for them
        self._host_used = 0
        self._host_kf_bind = np.full((n_kf, 2), -1, np.int64)
        self._last_tracked_frame = 0

        self.switch_events: List[Tuple[int, int]] = []   # (frame, flag)
        self._loss_ewma = torch.full((), -1.0, device=self.device)
        # the previous frame's loss: RO's escalation signal and the strain
        # mask's (-1: none since the last switch)
        self._prev_loss = torch.full((), -1.0, device=self.device)
        # per tracked frame the tracker's result without its anchor (device
        # tensors, no host sync: the pose gate's verdict, the drift gate's
        # reading and whether it was armed, fired and rescued, RO's
        # search-size factor); with the strain mask each keyframe's verdict
        self.track_log: List[tracker.TrackResult] = []
        self.kf_strained: List[torch.Tensor] = []
        # the drift gate's anchor (disarmed until the first frame arms it)
        # and the motion-model suppressor after a rescue
        self._gate = (tracker.disarmed_anchor(self.dgcfg, self.device)
                      if self.dgcfg is not None else None)
        self._prev_rescued = torch.zeros((), dtype=torch.bool,
                                         device=self.device)
        # CUDA event pairs per stage (no host sync while the loop runs)
        self._events = defaultdict(list)
        self.stage_calls = defaultdict(int)

        self._mesh_request: Optional[int] = None
        self.mesh_times: Dict[str, float] = {}
        out = config.get("data", {}).get("output")
        self.output_dir = None
        if out:
            self.output_dir = os.path.join(
                out, config["data"].get("exp_name", "exp"))
            os.makedirs(self.output_dir, exist_ok=True)

    @property
    def field(self) -> sr.Field:
        """The active submap's field."""
        return self.fields[self.active_id]

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _generator(self, stage: str, i: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + _STAGE_SEED[stage]) * 100_003
                      + i + 1)
        return g

    def _timed(self, stage: str, fn, *args):
        self.stage_calls[stage] += 1
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

    @property
    def track_losses(self) -> List[torch.Tensor]:
        """Each tracked frame's loss (device scalars)."""
        return [r.loss for r in self.track_log]

    def _reset_loss_regime(self):
        """A switch changes the loss distribution: unseed the pose gate and
        forget the previous loss."""
        self._loss_ewma = torch.full((), -1.0, device=self.device)
        self._prev_loss = torch.full((), -1.0, device=self.device)

    def track_counts(self) -> Dict[str, int]:
        """Tracked frames, and those the pose gate rejected, the drift
        gate was armed on, fired on and rescued, and RO escalated its
        search on (reads the device once)."""
        log = self.track_log
        if not log:
            return {}
        flags = torch.stack([torch.stack([
            ~r.accepted, r.armed, r.fired, r.rescued, r.ss_scale > 1.0])
            for r in log]).sum(0).tolist()
        return dict(zip(("frames", "rejected", "armed", "fired", "rescued",
                         "escalated"), [len(log)] + flags))

    def _gate_anchor_update(self, packed: torch.Tensor, i: int):
        """Arm the drift gate's anchor from frame i (the first frame; the
        tracker refreshes it after that)."""
        if self.dgcfg is None:
            return
        pts, normals, valid = tracker.gate_anchor(
            packed, self.dgcfg.anchor_rows, self.dgcfg.anchor_cols)
        self._gate = tracker.GateAnchor(
            pts, normals, valid,
            torch.full((), i, dtype=torch.int64, device=self.device))

    def _gate_disarm(self):
        """Disarm the anchor after a switch, a PGO or a resume: est_c2w is
        re-expressed and the anchor's frame pose no longer fits its cloud
        (the next tracked frame re-arms it)."""
        if self.dgcfg is not None:
            self._gate = self._gate._replace(kf_frame=torch.full(
                (), -1, dtype=torch.int64, device=self.device))

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
        self._host_used = 1
        self._host_kf_bind[0] = (0, -1)
        st.kf_c2w[0] = c2w
        st.est_c2w[0] = torch.eye(4, device=self.device)
        st.keyframe_ref[0] = -1
        st.localMLP_first_kf[0] = 0
        st.localMLP_info[0] = torch.cat(
            [torch.ones(1, device=self.device), center, length])
        st.keyframe_localMLP[0, 0] = 0
        mapper.init_submap_fit(
            self.fields[0], self.map_opt, packed.reshape(-1, 7), self.fcfg,
            self.consts, self.mcfg, self.lw, n_iters, self.mcfg.sample,
            self._generator("init", 0))
        slam_state.add_keyframe(st, packed, 0, self.kf_rows, self.kf_cols)
        self._gate_anchor_update(packed, 0)

    def track(self, packed: torch.Tensor, i: int):
        # constant-velocity prediction from the second frame after a
        # switch on (a switch re-expresses poses in another local frame)
        use_cs = bool(self.config["tracking"]["const_speed"]
                      and (i - self.state.last_switch_frame) >= 2)
        # the levers' inputs, only where a lever is on
        gate_on = self.dgcfg is not None
        levers = {}
        if self.rcfg.escalate > 0.0:
            levers["prev_loss"] = self._prev_loss
        if gate_on:
            levers.update(dgcfg=self.dgcfg, gate=self._gate,
                          prev_rescued=self._prev_rescued,
                          polish_generator=self._generator("polish", i))
        res = tracker.track_frame_update(
            self.field.params(detach=True), self.fcfg_track, self.consts,
            self.rcfg, self.gcfg, self.pst, self._generator("track", i),
            packed, self.state, i, use_cs, self.lw, self.rcfg.n_iters,
            self.gcfg.n_iters, self.keyframe_every, self._loss_ewma,
            **levers)
        self._loss_ewma = res.loss_ewma
        self._prev_loss = res.loss
        # overwritten on every frame, as the JAX system does (ADVICE.md)
        self._prev_rescued = res.rescued
        if gate_on:
            self._gate = res.gate
        self.track_log.append(res._replace(gate=None))

    def do_local_ba(self, packed: torch.Tensor, i: int):
        """Local BA on the active submap and the pose write-back."""
        st = self.state
        active = st.active_submap_id
        kf_mask = slam_state.submap_kf_mask(st, active)
        K = kf_mask.shape[0]
        last_kf = torch.where(kf_mask, torch.arange(K, device=self.device),
                              -1).max()
        res = mapper.local_ba(
            self.field, self.map_opt, st.kf_rays, kf_mask,
            st.active_first_kf, last_kf,
            extract_submap_kf_poses(st, active, self.kf_frames),
            packed.reshape(-1, 7), st.est_c2w[i], self.fcfg, self.consts,
            self.mcfg, self.lw, self.mcfg.sample + self.mcfg.pixels_cur,
            self._generator("ba", i), optim_cur=self.optim_cur)
        writeback_ba_poses(st, active, kf_mask,
                           qt_to_matrix(res.kf_quat, res.kf_trans),
                           self.kf_frames)
        if self.optim_cur:
            st.est_c2w[i] = qt_to_matrix(res.cur_quat, res.cur_trans)

    def add_keyframe(self, packed: torch.Tensor, i: int):
        if self.kf_strain_mask > 0.0:
            # a keyframe tracked under strain (loss over kf_strain_mask x
            # the accepted-loss EWMA, the pose gate's signal) stores zero
            # depth, inert in every loss, so a slipped pose cannot train
            # itself into BA and refine; it still exists for the manager
            strained = (self._loss_ewma > 0.0) & (
                self._prev_loss > self.kf_strain_mask * self._loss_ewma)
            self.kf_strained.append(strained)
            keep = torch.where(strained, 0.0, 1.0)
            packed = torch.cat([packed[..., :6], packed[..., 6:7] * keep],
                               dim=-1)
        slam_state.add_keyframe(self.state, packed, i, self.kf_rows,
                                self.kf_cols)
        kf_id = i // self.keyframe_every
        if not self.use_manager:
            self.state.keyframe_localMLP[kf_id, 0] = self.active_id
            self._host_kf_bind[kf_id] = (self.active_id, -1)

    def _manager_step(self, packed: torch.Tensor, i: int, kf_id: int,
                      force: bool) -> int:
        _, flag = self.manager.process_keyframe(
            self.state, packed[..., 6], packed[..., :3],
            self.state.est_c2w[i], i, kf_id, force=force)
        return flag

    # ------------------------------------------------------------------
    # submap switching
    # ------------------------------------------------------------------

    def active_submap_switch_new(self, packed: torch.Tensor, i: int,
                                 kf_id: int):
        """Create the submap the manager just allocated, from the shared
        initial params, and start its first fit (the state's msg3 update
        already made it active, with kf_id its first keyframe)."""
        self._flush_pending_init()
        self._flush_pending_switch()
        new_id = self.manager.last_binding[1][0]
        self.fields[new_id] = sr.Field(self.initial_params)
        self.active_id = new_id
        self.map_opt = mapper.make_map_optimizer(self.fields[new_id],
                                                 self.mcfg)
        self._host_used = max(self._host_used, new_id + 1)
        self.state.last_switch_frame = i
        self._reset_loss_regime()
        self._gate_disarm()
        rays = packed.reshape(-1, 7)
        total = self.mcfg.first_iters
        if 0 < self.init_chunk < total:
            # one chunk now, the rest one chunk per tracked frame: the
            # tracker runs against the still-training submap
            self._pending_init_rays = rays
            self._pending_init_iters = total
            self._drain_init_chunk()
        else:
            self._n_init_chunks += 1
            mapper.init_submap_fit(
                self.fields[new_id], self.map_opt, rays, self.fcfg,
                self.consts, self.mcfg, self.lw, total, self.mcfg.sample,
                self._generator("init", self._n_init_chunks))

    def _drain_init_chunk(self):
        """One chunk of init_chunk iterations of the deferred first fit
        (the last one overshoots first_iters by less than a chunk)."""
        self._n_init_chunks += 1
        mapper.init_submap_fit(
            self.field, self.map_opt, self._pending_init_rays, self.fcfg,
            self.consts, self.mcfg, self.lw, self.init_chunk,
            self.mcfg.sample, self._generator("init", self._n_init_chunks))
        self._pending_init_iters -= self.init_chunk
        if self._pending_init_iters <= 0:
            self._pending_init_iters = 0
            self._pending_init_rays = None

    def _flush_pending_init(self):
        while self._pending_init_iters > 0:
            self._drain_init_chunk()

    def active_submap_switch(self, packed: torch.Tensor, i: int,
                             kf_id: int):
        """Switch back to a previous submap: its field becomes active with
        a fresh map optimizer, and the ICP-rectified local pose replaces
        the tracked one."""
        self._flush_pending_init()
        self._flush_pending_switch()
        back_id = self.manager.last_binding[1][0]
        self.active_id = back_id
        self.map_opt = mapper.make_map_optimizer(self.field, self.mcfg)
        self.temp_local_pose = switch_state_update(
            self.state, i, self.rectified_local_pose, back_id)
        self.optim_cur = True
        self._reset_loss_regime()
        self._gate_disarm()

    def local_ba_switch(self, packed: torch.Tensor, kf_id: int, i: int):
        """Pose-only BA of the loop keyframe against the switched-to
        submap, on the switch frame."""
        top = (self.manager.ovlp_data or {}).get("top_kf_ids")
        if top is None or len(top) == 0:
            return
        self._timed("switch_ba", self._switch_ba, packed, top, i)

    def _switch_ba(self, packed: torch.Tensor, top_kf_ids, i: int):
        st = self.state
        kf_mask = torch.zeros(st.kf_rays.shape[0], dtype=torch.bool,
                              device=self.device)
        kf_mask[torch.as_tensor(np.asarray(top_kf_ids),
                                device=self.device)] = True
        pose, _ = mapper.switch_ba(
            self.field.params(detach=True), st.kf_rays, kf_mask,
            extract_submap_kf_poses(st, st.active_submap_id,
                                    self.kf_frames),
            packed.reshape(-1, 7), st.est_c2w[i], self.fcfg, self.consts,
            self.lw, self.sw_lr_rot, self.sw_lr_trans, self.sw_map_num,
            self.mcfg.sample, self.mcfg.pose_accum_step,
            generator=self._generator("switch", i))
        st.est_c2w[i] = pose

    def _drain_switch_chain(self):
        """The deferred PGO of a switch-back (run on the frame after the
        switch keyframe)."""
        ps = self._pending_switch
        if ps is None:
            return
        self.global_ba(ps["ids"])
        self._pending_switch = None

    def _flush_pending_switch(self):
        while self._pending_switch is not None:
            self._drain_switch_chain()

    # ------------------------------------------------------------------
    # loop-closure verification
    # ------------------------------------------------------------------

    def _verify_statics(self):
        """Overlap grid, ICP source subsampling, intrinsics, the image
        margin and the keyframe-selection count, built once."""
        mc = self.manager.cfg
        if self._ovlp_grid is None:
            self._ovlp_grid = manager_mod.uniform_grid(
                self.H, self.W, mc.ovlp_rays_h, mc.ovlp_rays_w, self.device)
            R = self.rays_per_kf
            src_sub = torch.as_tensor(np.linspace(
                0, len(self.kf_rows) - 1, self.icp_src_n).astype(np.int64),
                device=self.device)
            self._icp_subs = (self.kf_rows[src_sub], self.kf_cols[src_sub],
                              torch.as_tensor(np.linspace(
                                  0, R - 1, self.icp_src_n).astype(np.int64),
                                  device=self.device))
            ds = self.dataset
            self._K_mat = torch.tensor([[ds.fx, 0.0, ds.cx],
                                        [0.0, ds.fy, ds.cy],
                                        [0.0, 0.0, 1.0]],
                                       device=self.device)
        # the reference's fixed 20 px margin on 1200x680 images, kept
        # proportional (~3%)
        edge = max(2, int(round(0.03 * min(self.H, self.W))))
        # the reference demands > 200 visible points of its 40x40 grid,
        # scaled to the configured grid
        min_count = max(1, int(round(200 * mc.ovlp_rays_h * mc.ovlp_rays_w
                                     / 1600)))
        return edge, min_count

    def _find_overlapping_region(self, mo_id: int, active_id: int,
                                 st: SlamState, depth, rays_d, pose_world):
        """Verify that the current keyframe re-observes submap mo_id, then
        ICP-rectify the switch pose: one device program and one host copy.
        Returns (ok, data)."""
        edge, min_count = self._verify_statics()
        rows, cols = self._ovlp_grid
        rr_src, cc_src, sub_incl = self._icp_subs
        k = self.near_kf_num
        R = self.rays_per_kf
        ver = manager_mod.host_dict(overlap_verify_icp(
            st, depth, rays_d, slam_state.to_like(pose_world, st.kf_c2w),
            mo_id, active_id, rows, cols, self._K_mat, self.kf_frames,
            self._last_tracked_frame, rr_src, cc_src, sub_incl,
            self.sw_align_threshold, self.sw_min_trans, min_count, k=k,
            edge=edge, H=self.H, W=self.W, n_per=max(1, self.icp_dst_n // k),
            n_incl=self.sw_including_last,
            keyframe_every=self.keyframe_every, R=R,
            rel_damping=SWITCH_ICP_DAMPING))
        if int(ver["n_related"]) == 0 or \
                int(ver["n_valid"]) < self.manager.cfg.min_ovlp_pts:
            return False, None
        # the reference's min_correspondence counts matches of its full
        # cloud; scale to the subsampled source
        need_icp = int(self.sw_min_corr * self.icp_src_n / R)
        if int(ver["n_inliers"]) < max(need_icp, 32):
            return False, None
        self.rectified_local_pose = torch.as_tensor(ver["pose_final"],
                                                    device=self.device)
        top_valid = ver["top_valid"]
        return True, {"top_kf_ids": ver["top_kf_ids"][top_valid],
                      "top_kf_mask": ver["vis"][top_valid],
                      "pts_mask": ver["mask_final"]}

    # ------------------------------------------------------------------
    # background refinement and global BA
    # ------------------------------------------------------------------

    def inactive_refine_step(self, i: int):
        """One BA round on the next inactive submap (round robin).
        Membership and the ownership rule (skip keyframes first-bound to
        the active submap) come from the host mirrors."""
        inactive = [m for m in range(self._host_used)
                    if m != self.active_id and self.fields[m] is not None]
        if not inactive:
            return
        m = inactive[self._inactive_rr % len(inactive)]
        self._inactive_rr += 1
        bind = self._host_kf_bind
        valid = np.arange(bind.shape[0]) < self.state.n_kf
        mask_np = (valid & ((bind[:, 0] == m) | (bind[:, 1] == m))
                   & (bind[:, 0] != self.active_id))
        if mask_np.any():
            self._timed("refine", self._refine_round, m, mask_np, i)

    def _refine_round(self, m: int, mask_np: np.ndarray, i: int):
        st = self.state
        kf_mask = torch.as_tensor(mask_np, device=self.device)
        K = kf_mask.shape[0]
        last_kf = torch.where(kf_mask, torch.arange(K, device=self.device),
                              -1).max()
        field = self.fields[m]
        res = mapper.local_ba(
            field, mapper.make_map_optimizer(field, self.mcfg), st.kf_rays,
            kf_mask, st.localMLP_first_kf[m], last_kf,
            extract_submap_kf_poses(st, m, self.kf_frames),
            torch.zeros((8, 7), device=self.device),
            torch.eye(4, device=self.device), self.fcfg, self.consts,
            self.mcfg, self.lw, self.mcfg.sample, self._generator("refine", i),
            include_current=False)
        writeback_ba_poses(st, m, kf_mask,
                           qt_to_matrix(res.kf_quat, res.kf_trans),
                           self.kf_frames)

    def global_ba(self, ids: Tuple[int, int]):
        """Pose-graph optimization of the submap anchors after a loop
        closure. ``ids`` = (switched-to, previous) submap."""
        if self._host_used < 2 or self.temp_local_pose is None:
            return
        self._timed("pgo", global_pgo, self.state, self.temp_local_pose,
                    self.rectified_local_pose, int(ids[0]), int(ids[1]),
                    self._host_used, self.key_edge_weight)
        # the PGO rewrote the frame poses: the anchor's pose is stale
        self._gate_disarm()

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def process_frame(self, i: int):
        """Track, map, refine, and decide on keyframes for frame i."""
        packed = self.dataset.packed(i)
        self._last_tracked_frame = i
        if i == 0:
            self._timed("init", self.first_frame_mapping, packed,
                        self.dataset.gt_pose(0), self.mcfg.first_iters)
            return
        self._timed("track", self.track, packed, i)
        if self._pending_init_iters > 0:
            self._timed("init_chunk", self._drain_init_chunk)
        if self._pending_switch is not None and i > self._pending_switch["i"]:
            self._drain_switch_chain()
        if i % self.map_every == 0:
            self._timed("ba", self.do_local_ba, packed, i)
            self.inactive_refine_step(i)
        if i % self.keyframe_every != 0:
            return
        kf_id = i // self.keyframe_every
        self._timed("keyframe", self.add_keyframe, packed, i)
        if not self.use_manager:
            return
        force = (i - self.state.last_switch_frame) <= self.switch_interval
        flag = self._timed("manager", self._manager_step, packed, i, kf_id,
                           force)
        if flag == 3:
            self.switch_events.append((i, 3))
            self._timed("switch_new", self.active_submap_switch_new, packed,
                        i, kf_id)
        elif flag == 1:
            self.switch_events.append((i, 1))
            self._timed("switch_back", self.active_submap_switch, packed, i,
                        kf_id)
            self.local_ba_switch(packed, kf_id, i)
            self._pending_switch = {"i": i,
                                    "ids": self.manager.last_binding[1]}
        # the binding mirror follows the manager's own record
        if self.manager.last_binding is not None:
            bkf, bpair = self.manager.last_binding
            self._host_kf_bind[bkf] = bpair
            self.manager.last_binding = None

    def run(self, n_frames: Optional[int] = None, verbose: bool = True,
            start: int = 0) -> Dict:
        """Process frames start..n-1 (n: ``n_frames`` or the dataset's);
        returns ATE stats, ``fps`` ((n - start) frames over the loop's wall
        time, synchronised at the end) and ``n_submaps``. Frames are
        rendered before the clock starts. With an output directory it
        writes what the JAX package's run writes, at its cadences
        (``mesh.vis``, ``mesh.ckpt_freq``, ``mesh.mesh_freq``), and at the
        end the trajectory, ``ckpt_final`` and ``mesh_final.ply`` (with
        mesh accuracy and completion on a synthetic scene, and the wall
        seconds of the two as ``final_checkpoint_s`` and
        ``final_mesh_s``)."""
        n = n_frames or self.dataset.num_frames
        mesh_cfg = self.config.get("mesh", {})
        vis_every = mesh_cfg.get("vis", 0)
        ckpt_every = mesh_cfg.get("ckpt_freq", 0)
        mesh_every = mesh_cfg.get("mesh_freq", 0)
        out = self.output_dir
        self.dataset.prerender(range(start, n))      # a batch at a time
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        for i in range(start, n):
            self.process_frame(i)
            if i == 0 and out and vis_every:
                self.render_debug_images(i)
            if verbose and i % 25 == 0 and i > 0:
                print(f"frame {i}/{n}  track_loss="
                      f"{float(self.track_log[-1].loss):.4f}  submap="
                      f"{self.active_id}  "
                      f"{(i - start) / (time.time() - t0):.2f} fps")
            if out and vis_every and i > 0 and i % vis_every == 0:
                res = self.evaluate(i, tag=str(i))
                world = self.world_trajectory(i)
                save_traj_tum(world, os.path.join(out, f"traj_{i}.txt"))
                psnr, d_l1 = self.render_debug_images(i)
                from .logger import plot_traj
                gt = np.stack([self.dataset.gt_pose(j)
                               for j in range(i + 1)])
                plot_traj(gt, world, os.path.join(out, f"traj_{i}.png"))
                if verbose:
                    print(f"  [eval@{i}] ATE RMSE "
                          f"{res['absolute_translational_error.rmse']:.4f}"
                          f"  render psnr {psnr:.2f} depth L1 {d_l1:.4f} m"
                          f"  (render_{i:05d}.png, traj_{i}.png)")
            if out and ckpt_every and i > 0 and i % ckpt_every == 0:
                self.save_checkpoint(str(i))
            if mesh_every and i > 0 and i % mesh_every == 0:
                self._mesh_request = i
            if self._mesh_request is not None and out:
                mid = self._mesh_request
                self._mesh_request = None
                self.extract_mesh(os.path.join(out, f"mesh_{mid}.ply"))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.time() - t0
        results = self.evaluate(n - 1)
        results["fps"] = (n - start) / elapsed
        results["n_submaps"] = int(
            self.state.localMLP_info[:, 0].sum().item())
        if out:
            t1 = time.perf_counter()
            save_traj_tum(self.world_trajectory(n - 1),
                          os.path.join(out, f"traj_{n - 1}.txt"))
            self.save_checkpoint("final")
            results["final_checkpoint_s"] = time.perf_counter() - t1
            if mesh_cfg.get("extract_final", True):
                t1 = time.perf_counter()
                verts, _faces, _ = self.extract_mesh(
                    os.path.join(out, "mesh_final.ply"))
                results["final_mesh_s"] = time.perf_counter() - t1
                if hasattr(self.dataset, "room_half") and len(verts):
                    from ..eval.recon import evaluate_synthetic_mesh
                    m = evaluate_synthetic_mesh(self, verts=verts)
                    results["mesh_accuracy_m"] = m["mesh_accuracy_m"]
                    results["mesh_completion@5cm"] = \
                        m["mesh_completion@5cm"]
        return results

    # ------------------------------------------------------------------
    # trajectory + evaluation
    # ------------------------------------------------------------------

    def assemble_trajectory(self, up_to: int) -> np.ndarray:
        """Local poses: keyframes as stored (first keyframes the
        identity), other frames as their keyframe's pose times the stored
        relative pose."""
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
        """World poses: each frame lifted through the anchor of its
        keyframe's first binding."""
        st = self.state
        poses_local = self.assemble_trajectory(up_to)
        kf_ids = np.arange(up_to + 1) // self.keyframe_every
        kf_submap = st.keyframe_localMLP[:, 0].cpu().numpy()
        first_kf = st.localMLP_first_kf.cpu().numpy()
        kf_c2w = st.kf_c2w.cpu().numpy()
        anchors = kf_c2w[first_kf[np.clip(kf_submap[kf_ids], 0, None)]]
        return anchors @ poses_local

    def evaluate(self, up_to: int, tag: str = "final") -> Dict:
        """ATE of frames 0..up_to against the dataset's ground truth (any
        deferred PGO first); with an output directory also ate_<tag>.txt."""
        self._flush_pending_switch()
        world = self.world_trajectory(up_to)
        gt = np.stack([self.dataset.gt_pose(i) for i in range(up_to + 1)])
        return pose_evaluation(gt, world, self.output_dir, tag)

    def _kf_world_poses(self, kf_ids: np.ndarray) -> torch.Tensor:
        """World poses [k, 4, 4] of the given keyframes: each lifted
        through the anchor of its first binding, first keyframes their
        anchors."""
        st = self.state
        ids = torch.as_tensor(np.asarray(kf_ids), dtype=torch.int64,
                              device=self.device)
        first_bind = torch.clamp(st.keyframe_localMLP[ids, 0], min=0)
        anchors = st.kf_c2w[st.localMLP_first_kf[first_bind]]
        world = anchors @ st.est_c2w[self.kf_frames[ids]]
        return torch.where((st.keyframe_ref[ids] == -1)[:, None, None],
                           st.kf_c2w[ids], world)

    # ------------------------------------------------------------------
    # checkpoints, meshes, render panels
    # ------------------------------------------------------------------

    def save_checkpoint(self, tag: str = "final") -> Optional[str]:
        """Write ``<output_dir>/ckpt_<tag>`` (slam/checkpoint.py) after
        draining any deferred fit or PGO; None without an output
        directory."""
        if not self.output_dir:
            return None
        self._flush_pending_init()
        self._flush_pending_switch()
        from .checkpoint import save_ckpt
        ckpt_dir = os.path.join(self.output_dir, f"ckpt_{tag}")
        save_ckpt(ckpt_dir, self.state, self.fields,
                  extra={"active_id": self.active_id}, opt=self.map_opt,
                  opt_field=self.field)
        return ckpt_dir

    def resume_from(self, ckpt_dir: str) -> int:
        """Restore the state, the submap fields and the active submap's
        Adam moments from a checkpoint of either package (a fresh
        optimizer if they do not fit); rebuild the host mirrors (submaps
        in use, keyframe bindings), so background refinement resumes, and
        unseed the pose gate. Returns the next frame to process: the one
        after the last keyframe."""
        from .checkpoint import load_ckpt, load_opt_state
        state, fields, extra = load_ckpt(ckpt_dir, like=self.state)
        self.state = state
        for i, f in enumerate(fields):
            if f is not None and i < len(self.fields):
                self.fields[i] = f
        self.active_id = int(extra.get("active_id", state.active_submap_id))
        self.map_opt = mapper.make_map_optimizer(self.field, self.mcfg)
        load_opt_state(ckpt_dir, self.map_opt, self.field)
        n_kf = state.n_kf
        last_frame = int(state.kf_frame_ids[n_kf - 1]) if n_kf else 0
        self._host_used = int(state.localMLP_info[:, 0].sum().item())
        self._host_kf_bind = state.keyframe_localMLP.cpu().numpy().copy()
        self._pending_init_iters = 0
        self._pending_init_rays = None
        self._pending_switch = None
        self._reset_loss_regime()
        self._gate_disarm()
        return last_frame + 1

    def request_mesh(self, frame_id: int) -> None:
        """Ask ``run`` for a mesh at the next frame boundary."""
        self._mesh_request = int(frame_id)

    def extract_mesh(self, path: Optional[str] = None, joint: bool = True,
                     voxel_size: Optional[float] = None):
        """The joint mesh of all submaps in use (one submap: its own mesh),
        validity from the keyframes' observed-surface occupancy, then the
        small-component and unseen-face filters; written to ``path`` as
        PLY if given. Returns (verts, faces, colors); ``self.mesh_times``
        holds the steps' wall seconds."""
        from ..mesher.mesher import (MeshConfig, Mesher,
                                     apply_visibility_filters,
                                     keyframe_occupancies, save_mesh_ply)
        self._flush_pending_init()
        self._flush_pending_switch()
        st = self.state
        used = int(st.localMLP_info[:, 0].sum().item())
        mesh_cfg = self.config.get("mesh", {})
        voxel = voxel_size or mesh_cfg.get("voxel_final", 0.05)
        mesher = Mesher(self.fcfg, self.consts, MeshConfig(voxel_size=voxel))
        bound = np.asarray(self.config["mapping"].get(
            "marching_cubes_bound", self.config["mapping"]["bound"]))
        info = st.localMLP_info.cpu().numpy()
        anchors = st.kf_c2w[st.localMLP_first_kf[:used]].cpu().numpy()
        params = [self.fields[m].params(detach=True) for m in range(used)]
        # the field's SDF is in units of trunc: |sdf| < 1 is in the band
        sdf_trunc_units = 0.99
        t0 = time.perf_counter()

        # coarse observed-surface occupancy from the keyframes' back-
        # projected depth: grid points far from any observed surface are
        # invalid (the SDF is unsupervised there)
        observed_fn = submap_fns = grid_bounds = None
        n_kf = st.n_kf
        kf_world = self._kf_world_poses(np.arange(n_kf)).cpu().numpy()
        if n_kf and mesh_cfg.get("use_occupancy", True):
            observed_fn, submap_fns, grid_bounds = keyframe_occupancies(
                kf_world, st.kf_rays[:n_kf].cpu().numpy(),
                self._host_kf_bind[:n_kf], used, bound,
                cvox=mesh_cfg.get("occupancy_voxel", 0.2),
                dilate=mesh_cfg.get("occupancy_dilate", 1))
        times = {"occupancy": time.perf_counter() - t0}

        if joint and used > 1:
            verts, faces, colors = mesher.extract_mesh_jointly(
                params, anchors, info[:used, 1:4], info[:used, 4:7],
                trunc=sdf_trunc_units, bound_world=bound,
                observed_fn=observed_fn, submap_observed_fns=submap_fns,
                grid_bounds=grid_bounds)
        else:
            verts, faces, colors = mesher.extract_single_mesh(
                params[0], anchors[0], info[0, 1:4], info[0, 4:7],
                trunc=sdf_trunc_units, bound_world=bound,
                observed_fn=observed_fn, grid_bounds=grid_bounds)
        times.update(mesher.times)

        # post-extraction cleanup: small components, faces no keyframe sees
        t0 = time.perf_counter()
        if len(verts) and n_kf:
            kf_max_d = st.kf_rays[:n_kf, :, 6].amax(dim=1).cpu().numpy()
            ds = self.dataset
            K_mat = np.asarray([[ds.fx, 0.0, ds.cx], [0.0, ds.fy, ds.cy],
                                [0.0, 0.0, 1.0]])
            min_area = mesh_cfg.get("remove_small_geometry_threshold", 0.5)
            verts, faces, colors = apply_visibility_filters(
                verts, faces, colors, kf_world, K_mat, self.H, self.W,
                kf_max_d, min_component_area=min_area)
        times["filters"] = time.perf_counter() - t0
        if path:
            t0 = time.perf_counter()
            save_mesh_ply(path, verts, faces, colors)
            times["ply"] = time.perf_counter() - t0
        self.mesh_times = times
        return verts, faces, colors

    def render_debug_images(self, i: int):
        """The ground-truth-vs-render panel of frame i through the active
        field into the output directory; returns (psnr, depth_l1), or
        None without an output directory."""
        if not self.output_dir:
            return None
        from .logger import img_render_save
        packed = self.dataset.packed(i)
        return img_render_save(
            self.field.params(detach=True), self.fcfg, self.consts,
            self.state.est_c2w[i], packed[..., 3:6].cpu().numpy(),
            packed[..., 6].cpu().numpy(), packed[..., :3], self.output_dir,
            i, generator=self._generator("render", i))

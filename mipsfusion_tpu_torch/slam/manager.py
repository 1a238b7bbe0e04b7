"""Submap manager: allocation, expansion, binding and switch decisions.

Port of ``mipsfusion_tpu/slam/manager.py``. The decision engine runs on
the host at keyframe cadence; its geometric predicates (frustum box,
containing ratios, the most-overlapping submap) run on the device and come
to the host as ONE batched copy per keyframe (``host_dict``). The state
updates of each decision are ``state.msg1_apply`` / ``msg2_apply`` /
``msg3_apply``.

The case analysis of ``process_keyframe`` (reference Manager.py:373-490):
  case 1: the active submap contains the keyframe's surface
          (cr_active >= min_containing_ratio) -> bind (msg1 if it also
          overlaps another submap, else msg2);
  case 2: the same after the axis-wise box expansion;
  case 3: the most-overlapping submap is the active one and does not
          contain the surface -> new submap (msg3);
  case 4: another most-overlapping submap, but cr_mo below
          min_containing_ratio_back -> new submap (msg3);
  case 5: the camera re-entered a previous submap -> verify the overlap;
          switch back (msg1 with switch) or create a new submap and wait
          for the loop to mature.
Plus the double-binding counter (>= thres_db_time consecutive same-pair
bindings force a switch attempt) and the wait-loop re-check.

Flags: 1 = keyframe bound to two submaps and the active submap switched
to a previous one; 2 = keyframe bound, active unchanged; 3 = new submap
created and switched to.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.geometry import get_frame_surface_bbox, pts_in_bbox, rays_to_world
from .state import SlamState, msg1_apply, msg2_apply, msg3_apply


@dataclasses.dataclass
class ManagerConfig:
    min_containing_ratio: float = 0.7
    min_containing_ratio_mo: float = 0.6
    min_containing_ratio_back: float = 0.5
    min_cr_localMLP_len: Tuple[float, ...] = (5.0, 5.0, 5.0)
    localMLP_max_len: Tuple[float, ...] = (7.0, 7.0, 7.0)
    localMLP_max_len_back: Tuple[float, ...] = (7.0, 7.0, 7.0)
    near: float = 0.0
    far: float = 5.0
    thres_db_time: int = 4
    ovlp_rays_h: int = 40
    ovlp_rays_w: int = 40
    min_ovlp_pts: int = 200

    @staticmethod
    def from_dict(cfg: dict) -> "ManagerConfig":
        m = cfg["mapping"]
        ov = m.get("overlapping", {})
        return ManagerConfig(
            min_containing_ratio=m.get("min_containing_ratio", 0.7),
            min_containing_ratio_mo=m.get("min_containing_ratio_mo", 0.6),
            min_containing_ratio_back=m.get("min_containing_ratio_back", 0.5),
            min_cr_localMLP_len=tuple(m.get("min_cr_localMLP_len",
                                            (5.0, 5.0, 5.0))),
            localMLP_max_len=tuple(m["localMLP_max_len"]),
            localMLP_max_len_back=tuple(m.get("localMLP_max_len_back",
                                              m["localMLP_max_len"])),
            near=cfg["cam"]["near"], far=cfg["cam"]["far"],
            ovlp_rays_h=ov.get("n_rays_h", 40),
            ovlp_rays_w=ov.get("n_rays_w", 40),
            min_ovlp_pts=ov.get("min_pts", 200),
        )


def host_dict(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Bring a dict of small tensors to the host in ONE copy (float64
    holds every float32 and every index exactly); each entry comes back
    as numpy with its shape and kind (float32, int64 or bool)."""
    keys = list(d)
    flat = torch.cat([d[k].reshape(-1).to(torch.float64) for k in keys])
    h = flat.cpu().numpy()
    out, off = {}, 0
    for k in keys:
        t = d[k]
        a = h[off:off + t.numel()].reshape(tuple(t.shape))
        off += t.numel()
        if t.dtype == torch.bool:
            out[k] = a != 0
        elif t.is_floating_point():
            out[k] = a.astype(np.float32)
        else:
            out[k] = a.astype(np.int64)
    return out


# ---------------------------------------------------------------------------
# geometric predicates (device)
# ---------------------------------------------------------------------------

def containing_ratio(depth_img: torch.Tensor, rays_d_img: torch.Tensor,
                     pose_world: torch.Tensor, center: torch.Tensor,
                     length: torch.Tensor, min_len: torch.Tensor,
                     rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Fraction of the sampled valid-depth surface points strictly inside
    the box (its length floored at min_len)."""
    d = depth_img[rows, cols][:, None]
    rays_o, rays_d = rays_to_world(rays_d_img[rows, cols], pose_world)
    pts = rays_o + rays_d * d
    length = torch.maximum(length, min_len)
    lo, hi = center - 0.5 * length, center + 0.5 * length
    inside = pts_in_bbox(pts, lo[None], hi[None])[:, 0]
    valid = d[:, 0] > 0.0
    n_valid = torch.clamp(valid.sum(), min=1)
    return (inside & valid).sum() / n_valid


def expand_rule(center: np.ndarray, length: np.ndarray,
                kf_center: np.ndarray, kf_len: np.ndarray,
                max_len: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-wise box expansion with a per-axis max clamp: grow the box to
    cover the keyframe's surface box; where the union exceeds max_len on
    an axis, spend the allowed growth in proportion to the growth needed
    on each side; axes already at max_len stay (reference
    Manager.localMLP_expand_rule)."""
    center = np.asarray(center, np.float64)
    length = np.asarray(length, np.float64)
    kf_min = np.asarray(kf_center) - 0.5 * np.asarray(kf_len)
    kf_max = np.asarray(kf_center) + 0.5 * np.asarray(kf_len)
    lo, hi = center - 0.5 * length, center + 0.5 * length
    max_len = np.asarray(max_len, np.float64)

    if (kf_min >= lo).all() and (kf_max <= hi).all():
        return center.astype(np.float32), length.astype(np.float32)

    u_lo, u_hi = np.minimum(kf_min, lo), np.maximum(kf_max, hi)
    new_lo, new_hi = lo.copy(), hi.copy()
    for a in range(3):
        if length[a] >= max_len[a]:
            continue
        if u_hi[a] - u_lo[a] <= max_len[a]:
            new_lo[a], new_hi[a] = u_lo[a], u_hi[a]
            continue
        pos_need = abs(u_hi[a] - hi[a])
        neg_need = abs(lo[a] - u_lo[a])
        budget = max_len[a] - length[a]
        if pos_need == 0.0 or neg_need == 0.0:
            if pos_need > 0:
                new_hi[a] = hi[a] + budget
            else:
                new_lo[a] = lo[a] - budget
        else:
            new_hi[a] = hi[a] + budget * pos_need / (pos_need + neg_need)
            new_lo[a] = lo[a] - budget * neg_need / (pos_need + neg_need)
    new_len = new_hi - new_lo
    new_center = new_lo + 0.5 * new_len
    return new_center.astype(np.float32), new_len.astype(np.float32)


def expand_rule_t(center, length, kf_center, kf_len, max_len):
    """``expand_rule`` on device tensors (the same cases as masks)."""
    kf_min, kf_max = kf_center - 0.5 * kf_len, kf_center + 0.5 * kf_len
    lo, hi = center - 0.5 * length, center + 0.5 * length
    contained = (kf_min >= lo).all() & (kf_max <= hi).all()
    u_lo, u_hi = torch.minimum(kf_min, lo), torch.maximum(kf_max, hi)
    can = length < max_len
    fits = (u_hi - u_lo) <= max_len
    pos_need = (u_hi - hi).abs()
    neg_need = (lo - u_lo).abs()
    budget = max_len - length
    single = (pos_need == 0.0) | (neg_need == 0.0)
    denom = torch.clamp(pos_need + neg_need, min=1e-12)
    hi_c2 = torch.where(pos_need > 0, hi + budget, hi)
    lo_c2 = torch.where(pos_need > 0, lo, lo - budget)
    hi_c3 = hi + budget * pos_need / denom
    lo_c3 = lo - budget * neg_need / denom
    new_hi = torch.where(~can, hi, torch.where(
        fits, u_hi, torch.where(single, hi_c2, hi_c3)))
    new_lo = torch.where(~can, lo, torch.where(
        fits, u_lo, torch.where(single, lo_c2, lo_c3)))
    new_hi = torch.where(contained, hi, new_hi)
    new_lo = torch.where(contained, lo, new_lo)
    new_len = new_hi - new_lo
    return new_lo + 0.5 * new_len, new_len


def uniform_grid(H: int, W: int, n_rows: int, n_cols: int, device=None):
    rows = torch.linspace(0, H - 1, n_rows, device=device).long()
    cols = torch.linspace(0, W - 1, n_cols, device=device).long()
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def manager_predicates(localMLP_info, localMLP_max_len, anchor, pose_local,
                       depth_img, rays_d_img, active_id: int, wait_id: int,
                       min_cr_len, near: float, far: float, rows, cols
                       ) -> Dict[str, torch.Tensor]:
    """Every per-keyframe decision quantity, on the device: the frustum
    box, cr_active, cr of the expanded active box (and that box), the
    most-overlapping submap among the 3 nearest used ones other than the
    active one, its cr, and the cr of the wait-loop submap."""
    pose_world = anchor @ pose_local
    fr_center, fr_len = get_frame_surface_bbox(
        pose_world, depth_img, rays_d_img, near, far)
    d = depth_img[rows, cols][:, None]
    rays_o, rays_d = rays_to_world(rays_d_img[rows, cols], pose_world)
    pts = rays_o + rays_d * d
    valid = d[:, 0] > 0.0
    n_valid = torch.clamp(valid.sum(), min=1)

    def cr_of(center, length, apply_floor):
        ln = torch.maximum(length, min_cr_len) if apply_floor else length
        lo, hi = center - 0.5 * ln, center + 0.5 * ln
        inside = ((pts > lo) & (pts < hi)).all(-1)
        return (inside & valid).sum() / n_valid

    M = localMLP_info.shape[0]
    dev = localMLP_info.device
    used = localMLP_info[:, 0] > 0
    centers, lengths = localMLP_info[:, 1:4], localMLP_info[:, 4:7]
    cr_active = cr_of(centers[active_id], lengths[active_id], True)
    new_c, new_l = expand_rule_t(centers[active_id], lengths[active_id],
                                 fr_center, fr_len,
                                 localMLP_max_len[active_id])
    cr_active_new = cr_of(new_c, new_l, False)

    dists = torch.linalg.norm(centers - fr_center, dim=-1)
    excl = (~used) | (torch.arange(M, device=dev) == active_id)
    dists = torch.where(excl, torch.full_like(dists, 1e9), dists)
    # the 3 nearest; a stable sort breaks ties by index, as lax.top_k does
    top3 = torch.sort(dists, stable=True).indices[:3]
    lo3 = centers[top3] - 0.5 * lengths[top3]
    hi3 = centers[top3] + 0.5 * lengths[top3]
    inside3 = ((pts[:, None] > lo3[None]) & (pts[:, None] < hi3[None])
               ).all(-1)                                        # [N, 3]
    scores = (inside3 & valid[:, None]).sum(0)
    scores = torch.where(dists[top3] >= 1e9, torch.full_like(scores, -1),
                         scores)
    mo_id = top3[torch.argmax(scores)]
    cr_mo = cr_of(centers[mo_id], lengths[mo_id], True)
    mo_id = torch.where((~excl).sum() > 0, mo_id,
                        torch.full_like(mo_id, active_id))
    cr_wait = cr_of(centers[wait_id], lengths[wait_id], True)
    return {"fr_center": fr_center, "fr_len": fr_len,
            "cr_active": cr_active, "cr_active_new": cr_active_new,
            "new_center": new_c, "new_len": new_l,
            "mo_id": mo_id, "cr_mo": cr_mo, "cr_wait": cr_wait,
            "pose_world": pose_world}


def predicates_fused(st: SlamState, pose_local, depth, rays_d, wait_id: int,
                     min_cr_len, near: float, far: float, rows, cols
                     ) -> Dict[str, torch.Tensor]:
    """``manager_predicates`` with the active anchor gathered on the
    device; the submap tables ride along in the same host copy, so the
    decision and its state update need no further readback."""
    anchor = st.kf_c2w[st.localMLP_first_kf[st.active_submap_id]]
    pred = manager_predicates(
        st.localMLP_info, st.localMLP_max_len, anchor, pose_local, depth,
        rays_d, st.active_submap_id, wait_id, min_cr_len, near, far, rows,
        cols)
    pred["localMLP_info"] = st.localMLP_info
    pred["localMLP_max_len"] = st.localMLP_max_len
    return pred


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------

class Manager:
    """Host-side per-keyframe decision engine over the device state."""

    def __init__(self, cfg: ManagerConfig, H: int, W: int,
                 keyframe_every: int, device=None):
        self.cfg = cfg
        self.keyframe_every = keyframe_every
        self.cr_rows, self.cr_cols = uniform_grid(H, W, min(H, 150),
                                                  min(W, 200), device)
        self.min_cr_len = torch.tensor(cfg.min_cr_localMLP_len,
                                       dtype=torch.float32, device=device)
        self.double_binding_counter = 0
        self.db_active_id = -1
        self.db_mo_id = -1
        self.wait_loop = False
        self.localMLP_Id_wait = -1
        self.localMLP_Id_actual = -1
        # overlap data of the last successful switch trigger
        self.ovlp_data: Optional[Dict] = None
        # (kf_id, (first, second)) of the binding each msg wrote, so the
        # system keeps its binding mirror without a readback
        self.last_binding: Optional[Tuple[int, Tuple[int, int]]] = None
        # overlap verification, installed by the system: returns (ok, data)
        self.find_overlap_fn = None

    # -- helpers ----------------------------------------------------------

    def _double_binding(self, active_id: int, mo_id: int, cr_mo: float,
                        overlap_args) -> bool:
        """Double-binding counter (reference process_double_binding)."""
        if self.double_binding_counter == 0:
            self.double_binding_counter = 1
            self.db_active_id, self.db_mo_id = active_id, mo_id
            return False
        if active_id == self.db_active_id and mo_id == self.db_mo_id:
            if self.double_binding_counter >= self.cfg.thres_db_time:
                ok = self._loop_flag(mo_id, active_id, cr_mo, overlap_args,
                                     force=True)
                self.double_binding_counter = 0
                return ok
            self.double_binding_counter += 1
            return False
        self.double_binding_counter = 0
        self.db_active_id, self.db_mo_id = active_id, mo_id
        return False

    def _loop_flag(self, mo_id: int, active_id: int, cr_mo: float,
                   overlap_args, force: bool = False) -> bool:
        """Verify a pending loop trigger (reference get_loop_flag)."""
        if not (force or (self.wait_loop and self.localMLP_Id_wait == mo_id
                          and self.localMLP_Id_actual == active_id)):
            return False
        if cr_mo < self.cfg.min_containing_ratio_back:
            return False
        if self.find_overlap_fn is None:
            return False
        ok, data = self.find_overlap_fn(mo_id, active_id, *overlap_args)
        if ok:
            self.ovlp_data = data
            self.wait_loop = False
        return bool(ok)

    # -- state mutators ---------------------------------------------------

    def _apply_msg1(self, st: SlamState, kf_id: int, kf_center, kf_len,
                    id1: int, id2: int, switch: bool, info, max_len):
        max_len = np.array(max_len)
        if switch:
            max_len[id2] = self.cfg.localMLP_max_len_back
        c1, l1 = expand_rule(info[id1, 1:4], info[id1, 4:7], kf_center,
                             kf_len, max_len[id1])
        if switch:
            c2, l2 = expand_rule(info[id2, 1:4], info[id2, 4:7], kf_center,
                                 kf_len, max_len[id2])
        else:
            c2, l2 = info[id2, 1:4], info[id2, 4:7]
        bind = (id2, id1) if switch else (id1, id2)
        self.last_binding = (kf_id, (int(bind[0]), int(bind[1])))
        msg1_apply(st, kf_id, id1, id2, c1, l1, c2, l2,
                   max_len.astype(np.float32), np.asarray(bind), switch)
        return st, (1 if switch else 2)

    def _apply_msg2(self, st: SlamState, kf_id: int, kf_center, kf_len,
                    submap_id: int, info, max_len):
        c, ln = expand_rule(info[submap_id, 1:4], info[submap_id, 4:7],
                            kf_center, kf_len, max_len[submap_id])
        msg2_apply(st, kf_id, submap_id, c, ln)
        self.last_binding = (kf_id, (int(submap_id), -1))
        return st, 2

    def _apply_msg3(self, st: SlamState, kf_id: int, frame_id: int,
                    kf_center, kf_len, active_id: int, pose_world, info):
        new_id = int(info[:, 0].sum())          # first unused slot
        self.last_binding = (kf_id, (new_id, int(active_id)))
        msg3_apply(st, kf_id, frame_id, new_id, int(active_id), kf_center,
                   kf_len, pose_world)
        return st, 3, new_id

    # -- main entry -------------------------------------------------------

    def process_keyframe(self, st: SlamState, depth: torch.Tensor,
                         rays_d: torch.Tensor, pose_local: torch.Tensor,
                         frame_id: int, kf_id: int, force: bool = False):
        """Decide for keyframe kf_id; updates ``st`` in place and returns
        (st, flag)."""
        if self.wait_loop:
            return self._process_wait_loop(st, depth, rays_d, pose_local,
                                           frame_id, kf_id, force)
        return self._process_normal(st, depth, rays_d, pose_local,
                                    frame_id, kf_id, force)

    def _predicates(self, st: SlamState, depth, rays_d, pose_local,
                    wait_id: int) -> Dict[str, np.ndarray]:
        """One device program and ONE host copy per keyframe."""
        return host_dict(predicates_fused(
            st, pose_local, depth, rays_d, max(wait_id, 0), self.min_cr_len,
            self.cfg.near, self.cfg.far, self.cr_rows, self.cr_cols))

    def _process_normal(self, st: SlamState, depth, rays_d, pose_local,
                        frame_id: int, kf_id: int, force: bool, pred=None):
        if pred is None:
            pred = self._predicates(st, depth, rays_d, pose_local, -1)
        active_id = st.active_submap_id
        pose_world = pred["pose_world"]
        fr_center, fr_len = pred["fr_center"], pred["fr_len"]
        info, max_len = pred["localMLP_info"], pred["localMLP_max_len"]
        used = int(info[:, 0].sum())
        mo_id = int(pred["mo_id"]) if used > 1 else active_id
        cr_mo = float(pred["cr_mo"])
        same = mo_id == active_id
        overlap_args = (st, depth, rays_d, pose_world)

        # cases 1 and 2: containment without, then with, expansion
        for cr in (float(pred["cr_active"]), float(pred["cr_active_new"])):
            if force or cr >= self.cfg.min_containing_ratio:
                if not same and cr_mo >= self.cfg.min_containing_ratio_mo:
                    switch = self._double_binding(active_id, mo_id, cr_mo,
                                                  overlap_args)
                    return self._apply_msg1(st, kf_id, fr_center, fr_len,
                                            active_id, mo_id, switch, info,
                                            max_len)
                self.double_binding_counter = 0
                return self._apply_msg2(st, kf_id, fr_center, fr_len,
                                        active_id, info, max_len)

        self.double_binding_counter = 0
        # cases 3 and 4: new submap
        if same or cr_mo < self.cfg.min_containing_ratio_back:
            st, flag, _ = self._apply_msg3(st, kf_id, frame_id, fr_center,
                                           fr_len, active_id, pose_world,
                                           info)
            self.wait_loop = False
            return st, flag
        # case 5: the camera re-entered a previous submap
        ok, data = False, None
        if self.find_overlap_fn is not None:
            ok, data = self.find_overlap_fn(mo_id, active_id, *overlap_args)
        if ok:      # 5.1: switch back
            self.ovlp_data = data
            self.wait_loop = False
            return self._apply_msg1(st, kf_id, fr_center, fr_len, active_id,
                                    mo_id, True, info, max_len)
        # 5.2: new submap, and wait for the loop to mature
        st, flag, new_id = self._apply_msg3(st, kf_id, frame_id, fr_center,
                                            fr_len, active_id, pose_world,
                                            info)
        self.wait_loop = True
        self.localMLP_Id_wait = mo_id
        self.localMLP_Id_actual = new_id
        return st, flag

    def _process_wait_loop(self, st: SlamState, depth, rays_d, pose_local,
                           frame_id: int, kf_id: int, force: bool):
        """Wait-loop re-check (reference process_keyframe_wait_loop)."""
        pred = self._predicates(st, depth, rays_d, pose_local,
                                self.localMLP_Id_wait)
        active_id = st.active_submap_id
        cr_wt = float(pred["cr_wait"])
        if force or cr_wt < self.cfg.min_containing_ratio_back:
            return self._process_normal(st, depth, rays_d, pose_local,
                                        frame_id, kf_id, force, pred=pred)
        overlap_args = (st, depth, rays_d, pred["pose_world"])
        if not self._loop_flag(self.localMLP_Id_wait, active_id, cr_wt,
                               overlap_args):
            return self._process_normal(st, depth, rays_d, pose_local,
                                        frame_id, kf_id, force, pred=pred)
        return self._apply_msg1(st, kf_id, pred["fr_center"],
                                pred["fr_len"], active_id,
                                self.localMLP_Id_wait, True,
                                pred["localMLP_info"],
                                pred["localMLP_max_len"])

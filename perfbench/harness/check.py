"""The comparison that decides ``correct``: each checked stage call of
the window, run again by the plain reference (``perfbench/reference``)
from the inputs the program's call had, and its outputs held against the
program's.

The reference follows the program step by step: a stage's inputs are
the program's state at that call (the submap's field and map-optimizer
moments, the keyframe poses and memberships, the previous poses, the
particle template, the generator's state). The frames and the keyframe
rays it takes from the benchmark's own stream, not from the program.

Numbers compared, where the configuration file gives a limit:

- ``track_pose_mm``: the widest gap, over the checked frames, between
  the program's tracked pose and the reference's (the larger of the
  translation gap and the rotation angle times 1 m), in mm. GO keeps
  the iterate of its best loss; where two iterates' losses tie within
  ``TIE_REL``, round-off picks one, a step (about 1 mm) from the other,
  so the gap is taken to the nearest of the reference's tied iterates
  (``best_mm``, the gap to its best alone, is printed);
- ``ba_pose_median_mm``: after each checked BA and refine call, the
  median over the keyframes the reference moved of their pose gap (mm;
  ``_kf_pose_gaps_mm``), and the median of that over the calls. The
  widest keyframe gap (``pose_mm``, printed) does not separate sound runs
  from the control: a pose coordinate whose gradient is a few thousandths
  of the others' still takes a full Adam step, whose size its round-off
  decides (0.77 and 2.02 mm in sound snake runs). Nor does the widest
  call: a few calls are ill-conditioned, and there the reference run on
  the card and the same reference run on the host's CPU part by as much
  as the program does (0.091 mm), as far as the control's least calls
  (0.048 mm); a call's own median is printed;
- ``ba_change_gap``: over those calls, the worst leaf's gap between the
  norms of the program's and the reference's parameter change, over the
  larger of the reference leaf's change norm and the median leaf's;
  leaves whose first reference gradient is under a thousandth of the
  median leaf's are left out. A map left unchanged reads 1;
- ``pgo_anchor_mm``: the widest anchor gap after the window's PGOs, mm;
- ``icp_pose_mm``: over the window's first verifications, the widest gap
  between the program's ICP-rectified switch pose and the reference's
  (the reference verifies and runs the ICP again from the state the call
  had), mm;
- ``switch_ba_pose_mm``: over the window's first switch BAs, the widest
  gap of the loop keyframe's refined pose, mm.

Printed beside them and not compared: the widest keyframe gap, each
call's relative gap of its last loss (``loss_rel``), which sound runs move
by up to a few tenths of a percent, as far as the control moves it, and
each verification's chosen keyframes, point and inlier counts.

A number with a limit that no call gave fails: a run where a kind of
call the configuration requires was never checked is not correct.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

import numpy as np

from reference import loop, stages

KINDS = ("track", "ba", "pgo", "verify", "switch_ba")
# GO keeps the pose of its best loss: iterates whose losses lie within
# this share of each other are a tie that round-off decides (sound runs
# move a best loss by up to 2.3e-4 of itself; two iterates' gaps, twice)
TIE_REL = 1e-3
NUMBERS = ("track_pose_mm", "ba_pose_median_mm", "ba_change_gap",
           "pgo_anchor_mm", "icp_pose_mm", "switch_ba_pose_mm")


def _pose_gap_mm(a: torch.Tensor, b: torch.Tensor) -> float:
    """max(|t_a - t_b|, angle(R_a, R_b) x 1 m) in mm, over a batch; the
    angle from the chord |R_a - R_b|_F = 2 sqrt(2) sin(angle / 2), which
    keeps its precision at small angles."""
    a, b = a.reshape(-1, 4, 4).double(), b.reshape(-1, 4, 4).double()
    dt = torch.linalg.norm(a[:, :3, 3] - b[:, :3, 3], dim=-1)
    chord = torch.linalg.norm((a[:, :3, :3] - b[:, :3, :3]).reshape(-1, 9),
                              dim=-1)
    ang = 2.0 * torch.asin(torch.clamp(chord / (2.0 * math.sqrt(2.0)),
                                       max=1.0))
    return float(torch.maximum(dt, ang).max()) * 1e3


def _leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _map_tree(fn, tree: Dict) -> Dict:
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _generator(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


class KeyframeRays:
    """The keyframe store rebuilt from the stream: slot k holds frame
    k x keyframe_every at the even rows x cols grid."""

    def __init__(self, stream, cfg: Dict):
        s = cfg["sampling"]
        dev = stream.device
        rows = torch.linspace(0, stream.H - 1, int(s["kf_n_rays_h"]),
                              device=dev).long()
        cols = torch.linspace(0, stream.W - 1, int(s["kf_n_rays_w"]),
                              device=dev).long()
        rr, cc = torch.meshgrid(rows, cols, indexing="ij")
        self.rows, self.cols = rr.reshape(-1), cc.reshape(-1)
        self.ke = int(cfg["mapping"]["keyframe_every"])
        self.lap = stream.lap
        self.frames = torch.stack(stream.frames)
        self.R = self.rows.shape[0]

    def __call__(self, slot: torch.Tensor, ray: torch.Tensor) -> torch.Tensor:
        lap = torch.remainder(slot * self.ke, self.lap)
        return self.frames[lap, self.rows[ray], self.cols[ray]]


class LoopInputs:
    """What the loop-closure stages read besides the program's state,
    worked out again from the configuration and the stream: the overlap
    grid, the ICP's source subsample of the keyframe grid, the
    intrinsics and the keyframe slots' frames."""

    def __init__(self, stream, cfg: Dict, kf: KeyframeRays):
        dev = stream.device
        ov = cfg["mapping"]["overlapping"]
        rows = torch.linspace(0, stream.H - 1, int(ov["n_rays_h"]),
                              device=dev).long()
        cols = torch.linspace(0, stream.W - 1, int(ov["n_rays_w"]),
                              device=dev).long()
        rr, cc = torch.meshgrid(rows, cols, indexing="ij")
        self.rows, self.cols = rr.reshape(-1), cc.reshape(-1)
        self.kf = kf
        c = cfg["cam"]
        self.K_mat = torch.tensor([[c["fx"], 0.0, c["cx"]],
                                   [0.0, c["fy"], c["cy"]],
                                   [0.0, 0.0, 1.0]], device=dev)
        n_kf = (stream.num_frames - 1) // kf.ke + 1
        self.kf_frames = torch.arange(n_kf, device=dev) * kf.ke

    def icp_source(self, n_src: int):
        """(rows, cols) of n_src grid rays spread evenly over the keyframe
        grid, and n_src ray indices spread over the ray store."""
        dev = self.kf.rows.device
        sub = torch.as_tensor(np.linspace(0, self.kf.R - 1, n_src).astype(
            np.int64), device=dev)
        return self.kf.rows[sub], self.kf.cols[sub], sub


def _ref_track(snap: Dict, cfg: Dict, stream) -> Dict:
    pose, loss, ties = stages.track_pose(
        snap["params"], cfg, snap["pst"], stream.packed(snap["frame"]),
        snap["prev"], snap["prev_prev"], snap["use_cs"],
        _generator(snap["generator"], stream.device), snap["loss_ewma"],
        TIE_REL)
    return {"pose": pose, "loss": loss, "ties": ties}


def _ref_ba(snap: Dict, cfg: Dict, stream, kf_rays: KeyframeRays) -> Dict:
    params = _map_tree(lambda t: t.clone().requires_grad_(True),
                       snap["params"])
    opt = stages.map_optimizer(params, cfg, snap["moments"])
    if snap["R"] != kf_rays.R:
        raise RuntimeError("keyframe store width differs from the "
                           "configuration's sampling grid")
    cur = (snap["cur_rays"] if snap["cur_rays"] is not None
           else stream.packed(snap["frame"]).reshape(-1, 7))
    g0: Dict[str, float] = {}
    step = opt.step

    def step_recording_first_grads():
        for name, p in _leaves(params).items():
            if name not in g0 and p.grad is not None:
                g0[name] = float(torch.linalg.norm(p.grad))
        step()
    opt.step = step_recording_first_grads
    kq, kt, _, _, loss, pose_g = stages.local_ba(
        params, opt, kf_rays, kf_rays.R, snap["kf_mask"], snap["first_kf"],
        snap["last_kf"], snap["kf_poses"], cur, snap["cur_pose"], cfg,
        snap["n_total"], _generator(snap["generator"], stream.device),
        snap["include_current"], snap["optim_cur"])
    return {"after": {k: v.detach() for k, v in _leaves(params).items()},
            "kf_quat": kq, "kf_trans": kt, "loss": loss, "g0": g0,
            "pose_g": pose_g}


def _ref_pgo(snap: Dict) -> Dict:
    return {"after": stages.pgo_anchors(
        snap["kf_c2w"], snap["first_kf"], snap["adjacency"],
        snap["local_prev"], snap["local_aft"], snap["aft_id"],
        snap["prev_id"], snap["used"], snap["key_w"])}


def _ref_verify(snap: Dict, stream, li: LoopInputs) -> Dict:
    packed = stream.packed(snap["frame"])
    rr, cc, sub = li.icp_source(snap["n_src"])
    if snap["consts"]["R"] != li.kf.R:
        raise RuntimeError("keyframe store width differs from the "
                           "configuration's sampling grid")
    return loop.verify_icp(
        snap["tables"], snap["n_kf"], li.kf, packed[..., 6],
        packed[..., :3], snap["pose_world"], snap["mo"], snap["active"],
        li.rows, li.cols, li.K_mat, li.kf_frames, snap["cur"], rr, cc, sub,
        snap["consts"])


def _ref_switch_ba(snap: Dict, cfg: Dict, stream, li: LoopInputs) -> Dict:
    c = snap["consts"]
    t = snap["tables"]
    pose, loss = loop.switch_ba(
        snap["params"], cfg, li.kf, li.kf.R, snap["kf_mask"],
        loop.submap_kf_poses(t, snap["active"], li.kf_frames),
        stream.packed(snap["frame"]).reshape(-1, 7),
        t["est_c2w"][snap["frame"]], c["lr_rot"], c["lr_trans"],
        c["n_iters"], c["n_total"], c["pose_accum_step"],
        _generator(snap["generator"], stream.device))
    return {"pose": pose, "loss": loss}


def reference_outputs(snaps, cfg: Dict, stream, tf32: bool = False) -> Dict:
    """Every snapshot's stage run by the reference: float32 with TF32 off
    or, with ``tf32``, its products in TF32 (the control's precision)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        kf = KeyframeRays(stream, cfg)
        li = LoopInputs(stream, cfg, kf)
        return {"track": [_ref_track(s, cfg, stream) for s in snaps.track],
                "ba": [_ref_ba(s, cfg, stream, kf) for s in snaps.ba],
                "pgo": [_ref_pgo(s) for s in snaps.pgo],
                "verify": [_ref_verify(s, stream, li)
                           for s in snaps.verify],
                "switch_ba": [_ref_switch_ba(s, cfg, stream, li)
                              for s in snaps.switch_ba]}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def program_outputs(snaps) -> Dict:
    """The program's outputs of the same calls, as the snapshots hold
    them."""
    return {"track": [{"pose": s["pose"], "loss": s["loss"]}
                      for s in snaps.track],
            "ba": [{"after": _leaves(s["after"]), "kf_quat": s["kf_quat"],
                    "kf_trans": s["kf_trans"], "loss": s["loss"]}
                   for s in snaps.ba],
            "pgo": [{"after": s["after"]} for s in snaps.pgo],
            "verify": [s["out"] for s in snaps.verify],
            "switch_ba": [{"pose": s["pose"], "loss": s["loss"]}
                          for s in snaps.switch_ba]}


def _kf_pose_gaps_mm(snap: Dict, out: Dict, ref: Dict):
    """The keyframe pose gaps (mm) after a BA or refine call, over the
    pose coordinates the reference's gradient moves: a coordinate whose
    accumulated gradient is under a thousandth of the median coordinate's
    at every pose step (quaternion and translation apart) moves under
    Adam by round-off alone and is left out. A keyframe's gap is the
    larger of the translation gap and twice the quaternion gap (the
    angle, for small gaps) times 1 m, over its kept coordinates. Returns
    (the widest gap, the median over the keyframes the reference moved,
    coordinates left out)."""
    mask = snap["kf_mask"]
    if not bool(mask.any()) or ref["pose_g"] is None:
        return 0.0, 0.0, 0
    parts, moved_kf, n_out = [], None, 0
    for name, scale in (("kf_trans", 1.0), ("kf_quat", 2.0)):
        g = ref["pose_g"][0 if name == "kf_quat" else 1][mask]
        moved = g[g > 0]
        if moved.numel() == 0:
            continue
        keep = g >= 1e-3 * moved.median()
        n_out += int((~keep).sum()) - int((g == 0).sum())
        d = (out[name][mask] - ref[name][mask]).double() * keep
        parts.append(scale * torch.linalg.norm(d, dim=-1))
        row = (g > 0).any(-1)
        moved_kf = row if moved_kf is None else moved_kf | row
    if not parts:
        return 0.0, 0.0, n_out
    gap = torch.stack(parts).amax(0) * 1e3
    return (float(gap.max()), float(gap[moved_kf].median()), n_out)


def _ba_gaps(snap: Dict, out: Dict, ref: Dict) -> Dict:
    before = _leaves(snap["params"])
    g0 = ref["g0"]
    ch_ref = {k: float(torch.linalg.norm(ref["after"][k] - before[k]))
              for k in before}
    ch_out = {k: float(torch.linalg.norm(out["after"][k] - before[k]))
              for k in before}
    med_g = sorted(g0.values())[len(g0) // 2]
    keep = [k for k in before if g0.get(k, 0.0) >= 1e-3 * med_g]
    med_ch = sorted(ch_ref[k] for k in keep)[len(keep) // 2]
    gaps = {k: abs(ch_out[k] - ch_ref[k]) / max(ch_ref[k], med_ch, 1e-30)
            for k in keep}
    worst = max(gaps, key=gaps.get)
    pose, pose_med, n_out = _kf_pose_gaps_mm(snap, out, ref)
    return {"change_gap": gaps[worst], "worst_leaf": worst,
            "left_out": sorted(set(before) - set(keep)), "pose_mm": pose,
            "pose_median_mm": pose_med, "pose_coords_left_out": n_out,
            "loss_rel": abs(float(out["loss"]) - float(ref["loss"]))
            / max(abs(float(ref["loss"])), 1e-12)}


def compare(snaps, out: Dict, ref: Dict) -> Dict:
    """The numbers of ``out`` (the program's outputs, or the control's)
    held against the reference's ``ref``, and the per-call readings."""
    tr = [{"frame": s["frame"],
           "pose_mm": min(_pose_gap_mm(o["pose"], t) for t in r["ties"]),
           "best_mm": _pose_gap_mm(o["pose"], r["pose"]),
           "ties": len(r["ties"]),
           "loss_rel": abs(float(o["loss"]) - float(r["loss"]))
           / max(abs(float(r["loss"])), 1e-12)}
          for s, o, r in zip(snaps.track, out["track"], ref["track"])]
    ba = [dict(_ba_gaps(s, o, r), frame=s["frame"],
               refine=not s["include_current"])
          for s, o, r in zip(snaps.ba, out["ba"], ref["ba"])]
    pg = [{"frame": s["frame"],
           "anchor_mm": _pose_gap_mm(o["after"], r["after"])}
          for s, o, r in zip(snaps.pgo, out["pgo"], ref["pgo"])]
    ve = [_verify_gaps(s, o, r)
          for s, o, r in zip(snaps.verify, out["verify"], ref["verify"])]
    sw = [{"frame": s["frame"], "pose_mm": _pose_gap_mm(o["pose"], r["pose"]),
           "loss_rel": abs(float(o["loss"]) - float(r["loss"]))
           / max(abs(float(r["loss"])), 1e-12)}
          for s, o, r in zip(snaps.switch_ba, out["switch_ba"],
                             ref["switch_ba"])]
    numbers = {
        "track_pose_mm": _widest(tr, "pose_mm"),
        "ba_pose_median_mm": _median(ba, "pose_median_mm"),
        "ba_change_gap": _widest(ba, "change_gap"),
        "pgo_anchor_mm": _widest(pg, "anchor_mm"),
        "icp_pose_mm": _widest(ve, "pose_mm"),
        "switch_ba_pose_mm": _widest(sw, "pose_mm")}
    rows = {"track": tr, "ba": ba, "pgo": pg, "verify": ve, "switch_ba": sw}
    return {"numbers": numbers, **rows,
            "calls": {k: len(v) for k, v in rows.items()}}


def _widest(rows, key: str) -> Optional[float]:
    return max((r[key] for r in rows), default=None)


def _median(rows, key: str) -> Optional[float]:
    """The median over the calls (the mean of the middle two for an even
    count), None where there is no call."""
    return statistics.median(r[key] for r in rows) if rows else None


def _verify_gaps(snap: Dict, out: Dict, ref: Dict) -> Dict:
    """One verification: the rectified pose's gap (compared), and beside
    it the chosen keyframes and the counts the decision reads."""
    def n(d, k):
        return int(d[k])
    return {"frame": snap["frame"], "mo": snap["mo"],
            "pose_mm": _pose_gap_mm(out["pose_final"], ref["pose_final"]),
            "ini_mm": _pose_gap_mm(out["pose_ini"], ref["pose_ini"]),
            "same_keyframes": bool(torch.equal(out["top_kf_ids"].cpu(),
                                               ref["top_kf_ids"].cpu())),
            "n_valid": [n(out, "n_valid"), n(ref, "n_valid")],
            "n_inliers": [n(out, "n_inliers"), n(ref, "n_inliers")]}


def verdict(numbers: Dict[str, Optional[float]], limits: Dict[str, float],
            required: Dict[str, int], calls: Dict[str, int]):
    """(correct, lines): every number that has a limit present and within
    it, and at least the required checked calls of each kind made."""
    ok = True
    rows = {}
    for name in NUMBERS:
        v = numbers.get(name)
        lim = limits.get(name)
        if lim is None:
            continue
        ok = ok and v is not None and math.isfinite(v) and v <= lim
        rows[name] = {"value": v, "limit": lim}
    for kind, n in required.items():
        rows[f"{kind}_calls_checked"] = {"value": calls.get(kind, 0),
                                         "limit": n}
        ok = ok and calls.get(kind, 0) >= n
    return ok, rows

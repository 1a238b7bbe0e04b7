"""Camera tracking: particle-swarm RO, then gradient GO.

Port of ``mipsfusion_tpu/slam/tracker.py``: the antithetic particle
template (``make_pst``), ``ro_optimize`` with its two-stage fitness screen
and the search-size escalation, ``go_optimize`` with its early stop,
best-pose carry and motion prior, ``sample_pixels_mix``, the pose
acceptance gate, the drift gate with its ICP rescue (``DriftGateConfig``,
``gate_anchor``) and ``track_frame_update``. Every lever is off by default
and then draws and computes exactly what the default path does.

The iteration loops are Python loops over tensor ops with no host
readback inside: GO's early stop and best-pose selection are tensor
masks, RO's success branch a ``torch.where``. With the drift gate on, the
host reads two bools a frame in one sync, whether the gate fired and
whether the anchor is due for a refresh, and runs the rescue or builds the
anchor only then (JAX: ``lax.cond``); after a rescue the refresh is a
``torch.where``. Over a mesh of several devices, RO's queries and GO's
rays split where their sizes divide by the mesh's (``mesh=``).

``track_pose`` is the frame's tracking without the drift gate, a function
of the previous two poses that reads no host value: the body of the track
program (``slam/programs.py``), which makes its draws beforehand
(``track_draws``) and commits the pose after (``commit_pose``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from ..models import scene_rep as sr
from ..ops.geometry import (matrix_to_quaternion, pose_inverse, qt_to_matrix,
                            quaternion_to_matrix)
from ..parallel.sharding import (Mesh, column_sharded, divides,
                                 replicate_params, split)
from . import icp as icp_mod


@dataclasses.dataclass(frozen=True)
class ROConfig:
    particle_size: int = 2000
    initial_scaling_factor: float = 0.02
    rescaling_factor: float = 0.5
    n_rows: int = 16
    n_cols: int = 24
    n_iters: int = 5
    sdf_weight: float = 1000.0
    # two-stage fitness screen (0: off): stage A scores every particle on
    # screen_px evenly strided pixels of the grid, stage B re-scores the
    # screen_keep best (the identity always among them) on the full grid;
    # the others get no weight
    screen_px: int = 0
    screen_keep: int = 0
    # search escalation (0: off): the initial search size grows by
    # clip(previous loss / loss EWMA, 1, escalate)
    escalate: float = 0.0

    @staticmethod
    def from_dict(cfg: dict) -> "ROConfig":
        ro = cfg["tracking"]["RO"]
        return ROConfig(
            particle_size=ro["particle_size"],
            initial_scaling_factor=ro["initial_scaling_factor"],
            rescaling_factor=ro["rescaling_factor"],
            n_rows=ro["n_rows"], n_cols=ro["n_cols"],
            n_iters=cfg["tracking"]["iter_RO"],
            screen_px=int(ro.get("screen_px", 0)),
            screen_keep=int(ro.get("screen_keep", 0)),
            escalate=float(ro.get("escalate", 0.0)))


@dataclasses.dataclass(frozen=True)
class GOConfig:
    n_iters: int = 10
    n_rays: int = 1000
    lr_rot: float = 0.001
    lr_trans: float = 0.001
    ignore_edge_w: int = 20
    ignore_edge_h: int = 20
    best: bool = True
    wait_iters: int = 100
    # quadratic anchor of the GO pose to the motion-model prediction
    # (0: off)
    motion_prior_w: float = 0.0
    gate_rel: float = 0.0
    gate_abs: float = 0.0

    @staticmethod
    def from_dict(cfg: dict) -> "GOConfig":
        t = cfg["tracking"]
        gate = t.get("pose_gate", {}) or {}
        return GOConfig(n_iters=t["iter"], n_rays=t["sample"],
                        lr_rot=t["lr_rot"], lr_trans=t["lr_trans"],
                        ignore_edge_w=t["ignore_edge_W"],
                        ignore_edge_h=t["ignore_edge_H"],
                        best=bool(t["best"]),
                        wait_iters=int(t.get("wait_iters", 100)),
                        motion_prior_w=float(t.get("motion_prior_w", 0.0)),
                        gate_rel=float(gate.get("rel", 0.0)),
                        gate_abs=float(gate.get("abs", 0.0)))


@dataclasses.dataclass(frozen=True)
class DriftGateConfig:
    """Frame-to-keyframe drift gate with ICP rescue (``thresh`` 0: off).

    Each frame, point-to-plane ICP of the frame's strided back-projection
    onto an anchor cloud (a recent frame's own depth, immutable sensor
    data) from the tracked pose; the size of the correction it proposes
    (translation + ``rot_lever`` x angle, metres) is the drift reading.
    Over ``thresh`` with enough inliers the gate fires: the ICP pose is
    verified by a second ICP from it (which must propose under half the
    first correction), optionally polished by GO anchored to it, and
    adopted. The anchor is refreshed every ``anchor_every`` frames from a
    frame whose own reading is healthy."""
    thresh: float = 0.0
    src_rows: int = 16
    src_cols: int = 24
    anchor_rows: int = 24
    anchor_cols: int = 43
    icp_iters: int = 10
    icp_thresh: float = 0.2
    rot_lever: float = 2.0
    anchor_every: int = 5
    anchor_health: float = 0.5
    polish_prior_w: float = 3.0
    min_inlier_frac: float = 0.3
    icp_damping: float = 0.05
    icp_robust_delta: float = 0.02
    polish: bool = True

    @staticmethod
    def from_dict(cfg: dict) -> "DriftGateConfig":
        g = cfg["tracking"].get("drift_gate", {}) or {}
        return DriftGateConfig(
            thresh=float(g.get("thresh", 0.0)),
            src_rows=int(g.get("src_rows", 16)),
            src_cols=int(g.get("src_cols", 24)),
            anchor_rows=int(g.get("anchor_rows", 24)),
            anchor_cols=int(g.get("anchor_cols", 43)),
            icp_iters=int(g.get("icp_iters", 10)),
            icp_thresh=float(g.get("icp_thresh", 0.2)),
            icp_damping=float(g.get("icp_damping", 0.05)),
            icp_robust_delta=float(g.get("icp_robust_delta", 0.02)),
            rot_lever=float(g.get("rot_lever", 2.0)),
            anchor_every=int(g.get("anchor_every", 5)),
            anchor_health=float(g.get("anchor_health", 0.5)),
            polish_prior_w=float(g.get("polish_prior_w", 3.0)),
            min_inlier_frac=float(g.get("min_inlier_frac", 0.3)),
            polish=bool(g.get("polish", True)))


class GateAnchor(NamedTuple):
    """The drift gate's anchor: camera-frame points [M, 3] (invalid ones at
    1e6, so they never win a nearest neighbour), their normals, validity,
    and the frame it came from (an int64 tensor; -1: disarmed)."""
    pts: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor
    kf_frame: torch.Tensor


def gate_anchor(packed_frame: torch.Tensor, rows: int, cols: int):
    """(points, normals, valid) of a strided rows x cols back-projection of
    a packed [H, W, 7] frame, normals by 8-nearest-neighbour PCA."""
    H, W = packed_frame.shape[:2]
    dev = packed_frame.device
    r, c = torch.meshgrid(_linspace_idx(0, H - 1, rows, dev),
                          _linspace_idx(0, W - 1, cols, dev), indexing="ij")
    r, c = r.reshape(-1), c.reshape(-1)
    d = packed_frame[r, c, 6:7]
    valid = d[:, 0] > 0.0
    pts = torch.where(valid[:, None], packed_frame[r, c, :3] * d,
                      torch.full_like(d, 1e6))
    return pts, icp_mod.estimate_normals(pts, k=8), valid


def disarmed_anchor(dgcfg: DriftGateConfig, device) -> GateAnchor:
    """An anchor that never fires (the JAX system pre-allocates the same)."""
    M = dgcfg.anchor_rows * dgcfg.anchor_cols
    return GateAnchor(torch.full((M, 3), 1e6, device=device),
                      torch.zeros((M, 3), device=device),
                      torch.zeros((M,), dtype=torch.bool, device=device),
                      torch.full((), -1, dtype=torch.int64, device=device))


class MaskedAdam:
    """optax.adam over a list of tensors whose step can be masked by a
    device bool (the reference applies or discards each update with
    jnp.where, so the decision never leaves the device). Nothing here
    copies from the host, so a step never waits for the device."""

    def __init__(self, params: Sequence[torch.Tensor], lrs: Sequence[float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lrs, self.b1, self.b2, self.eps = list(lrs), b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), device=params[0].device)

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             do) -> List[torch.Tensor]:
        """Return the stepped params; where ``do`` (a bool tensor, or True)
        is false, params and state stay as they were."""
        if do is True:
            do = torch.ones((), dtype=torch.bool, device=self.count.device)
        count = self.count + 1.0
        c1 = 1.0 - torch.pow(self.b1, count)
        c2 = 1.0 - torch.pow(self.b2, count)
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            m = self.b1 * self.m[i] + (1.0 - self.b1) * g
            v = self.b2 * self.v[i] + (1.0 - self.b2) * g * g
            upd = -self.lrs[i] * (m / c1) / (torch.sqrt(v / c2) + self.eps)
            out.append(torch.where(do, p + upd, p))
            self.m[i] = torch.where(do, m, self.m[i])
            self.v[i] = torch.where(do, v, self.v[i])
        self.count = torch.where(do, count, self.count)
        return out


def make_pst(generator: torch.Generator, cfg: ROConfig,
             device=None) -> torch.Tensor:
    """Particle swarm template [P, 6] ~ N(0, I) clamped to +-2, drawn as
    antithetic pairs (+z, -z) after 1-2 identity rows (reference
    ``make_pst``): the template's sample mean is zero by construction."""
    P = cfg.particle_size
    pairs = (P - 1) // 2
    z = torch.clamp(torch.randn((pairs, 6), generator=generator,
                                device=device), -2.0, 2.0)
    zeros = torch.zeros((P - 2 * pairs, 6), device=z.device)
    return torch.cat([zeros, z, -z], dim=0)


def _linspace_idx(lo: int, hi: int, n: int, device) -> torch.Tensor:
    return torch.linspace(lo, hi, n, device=device).long()


def ro_pixel_grid(H: int, W: int, cfg: ROConfig, device=None):
    """Uniform pixel grid of RO, clipped so the per-iteration offset
    (iter % 5) stays in range."""
    rows = _linspace_idx(0, H - 1, cfg.n_rows, device)
    cols = _linspace_idx(0, W - 1, cfg.n_cols, device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return (torch.clamp(rr.reshape(-1), 0, H - 5),
            torch.clamp(cc.reshape(-1), 0, W - 5))


def _pose_6d_to_7d(p6: torch.Tensor) -> torch.Tensor:
    """[P, 6] (qx, qy, qz, t) -> [P, 7] (qw, qx, qy, qz, t)."""
    imag_sq = (p6[:, :3] ** 2).sum(-1)
    qw = torch.where(imag_sq <= 1.0,
                     torch.sqrt(torch.clamp(1.0 - imag_sq, min=0.0)),
                     torch.zeros_like(imag_sq))
    return torch.cat([qw[:, None], p6], dim=-1)


def ro_optimize(params: Dict, fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                rcfg: ROConfig, pst: torch.Tensor, depth_img: torch.Tensor,
                rays_dir_img: torch.Tensor, initial_pose: torch.Tensor,
                row_idx: torch.Tensor, col_idx: torch.Tensor,
                n_iters: int, ss_scale: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Particle-swarm pose search; returns the refined pose [4, 4]. Each
    iteration scores all P particles on the shifted pixel grid with one
    SDF-only field query of [3, P * n] points (the K1 kernel); with the
    screen on, one query of [3, P * screen_px] points and one of
    [3, screen_keep * n]. ``ss_scale`` multiplies the initial search
    size (the escalation). With a ``mesh`` of several devices, a query
    whose point count divides by its size splits by columns over it
    (screen stages included; JAX: ``ray_sharding``)."""
    dev = pst.device
    devices = (column_sharded(mesh).devices()
               if mesh is not None and mesh.size > 1 else None)
    if devices is not None:
        reps = replicate_params(params, devices)
        consts_reps = replicate_params(consts, devices)
    rot, trans = initial_pose[:3, :3], initial_pose[:3, 3]
    search_size = torch.full((1, 6), rcfg.initial_scaling_factor, device=dev)
    if ss_scale is not None:
        search_size = search_size * ss_scale
    identity7 = torch.eye(1, 7, device=dev)[0]
    P = pst.shape[0]
    screen = 0 < rcfg.screen_keep < P and rcfg.screen_px > 0

    def fitness(abs_rot, abs_trans, ptsT, valid):
        n = abs_rot.shape[0]
        worldT = (abs_rot @ ptsT + abs_trans[:, :, None])       # [n, 3, m]
        worldT = worldT.permute(1, 0, 2).reshape(3, -1)
        if devices is not None and divides(mesh, worldT.shape[1]):
            sdf = sr.run_network_sdf_T_sharded(reps, worldT, fcfg,
                                               consts_reps, devices)
        else:
            sdf = sr.run_network_sdf_T(params, worldT, fcfg, consts)
        sdf = sdf.reshape(n, -1) * fcfg.trunc
        mean_sdf = (valid[None] * sdf.abs()).mean(-1)             # [n]
        return mean_sdf * rcfg.sdf_weight, mean_sdf

    for i in range(n_iters):
        off = i % 5
        d = depth_img[row_idx + off, col_idx + off][:, None]      # [n, 1]
        dirs = rays_dir_img[row_idx + off, col_idx + off]         # [n, 3]
        ptsT = (dirs * d).T                                       # [3, n]
        valid = (d[:, 0] > 0.0).to(d.dtype)

        pst7 = _pose_6d_to_7d(pst * search_size)                  # [P, 7]
        abs_rot = rot[None] @ quaternion_to_matrix(pst7[:, :4])  # [P, 3, 3]
        abs_trans = trans[None] + pst7[:, 4:]                     # [P, 3]
        if screen:
            sub = _linspace_idx(0, ptsT.shape[1] - 1, rcfg.screen_px, dev)
            fit_a, _ = fitness(abs_rot, abs_trans, ptsT[:, sub], valid[sub])
            # the identity always survives
            fit_a = torch.cat([torch.full((1,), -float("inf"), device=dev),
                               fit_a[1:]])
            # the screen_keep lowest; a stable sort breaks ties by index,
            # as lax.top_k does
            keep = torch.sort(fit_a, stable=True).indices[:rcfg.screen_keep]
            fit_b, ms_b = fitness(abs_rot[keep], abs_trans[keep], ptsT,
                                  valid)
            # the others score a large finite sentinel (an inf would make
            # their zero weight a NaN)
            fit = torch.full((P,), 1e10, device=dev).index_copy(0, keep,
                                                                fit_b)
            mean_sdf = torch.zeros((P,), device=dev).index_copy(0, keep,
                                                                ms_b)
        else:
            fit, mean_sdf = fitness(abs_rot, abs_trans, ptsT, valid)

        f0 = fit[0]
        better = (fit < f0).to(fit.dtype)
        weights = (f0 - fit) * better
        wsum = weights.sum() + 1e-5
        success = better.sum() > 0
        mean_sdf_aps = torch.where(success, (weights * mean_sdf).sum() / wsum,
                                   mean_sdf[0])
        mean_tf = (pst7 * weights[:, None]).sum(0) / wsum         # [7]
        quat = mean_tf[:4] / (torch.linalg.norm(mean_tf[:4]) + 1e-5)
        mean_tf = torch.where(success, torch.cat([quat, mean_tf[4:]]),
                              identity7)
        dR = quaternion_to_matrix(mean_tf[:4])
        rot = torch.where(success, rot @ dR, rot)
        trans = torch.where(success, trans + mean_tf[4:], trans)
        s = mean_tf[1:].abs() + 1e-4
        ss = (rcfg.rescaling_factor * mean_sdf_aps * s / torch.linalg.norm(s)
              + 1e-4)
        search_size = torch.where(success, ss, ss * 2.0)[None]
    T = torch.eye(4, device=dev)
    T[:3, :3] = rot
    T[:3, 3] = trans
    return T


def go_optimize(params: Dict, fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                gcfg: GOConfig, rays_d_cam: torch.Tensor,
                target_rgb: torch.Tensor, target_d: torch.Tensor,
                initial_pose: torch.Tensor, n_iters: int, lw: sr.LossWeights,
                generator: Optional[torch.Generator] = None,
                prior_pose: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None,
                us: Optional[Sequence[torch.Tensor]] = None):
    """Adam on (quaternion, translation) against the rendering losses of
    fixed rays; returns (pose [4, 4], best loss). The loss before each
    update competes for the best pose; after ``wait_iters`` non-improving
    iterations the loop stops without that iteration's update (reference
    semantics), kept on device as the ``alive`` mask. ``params`` should be
    detached: GO differentiates only the pose. With ``motion_prior_w`` > 0
    the loss adds w (|t - t_prior|^2 + 1 - (q . q_prior)^2), anchored to
    ``prior_pose`` (default: the initial pose). With a ``mesh`` of several
    devices and a ray count that divides by its size, the rays and targets
    split over it and the field and pose are replicated. ``us``: each
    iteration's z perturbation (else drawn from ``generator`` where
    ``fcfg.perturb``)."""
    dev = rays_d_cam.device
    p = [matrix_to_quaternion(initial_pose[:3, :3]), initial_pose[:3, 3]]
    opt = MaskedAdam(p, [gcfg.lr_rot, gcfg.lr_trans])
    rays_d_camT = rays_d_cam.T
    target_rgbT = target_rgb.T
    devices = None
    if divides(mesh, rays_d_cam.shape[0]):
        devices = column_sharded(mesh).devices()
        reps = replicate_params(params, devices)
        consts_reps = replicate_params(consts, devices)
        dirs_s = split(rays_d_camT, devices, 1)
        rgb_s = split(target_rgbT, devices, 1)
        depth_s = split(target_d, devices)
    best_loss = torch.full((), float("inf"), device=dev)
    best_p = list(p)
    thresh = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    if gcfg.motion_prior_w > 0.0:
        prior = initial_pose if prior_pose is None else prior_pose
        q_prior = matrix_to_quaternion(prior[:3, :3])
        t_prior = prior[:3, 3]
    for i in range(n_iters):
        u = (us[i] if us is not None
             else sr.draw_u(rays_d_cam.shape[0], fcfg, generator, dev))
        rot = p[0].detach().requires_grad_(True)
        trans = p[1].detach().requires_grad_(True)
        T = qt_to_matrix(rot, trans)
        if devices is not None:
            Ts = replicate_params(T, devices)
            dT = [Tk[:3, :3] @ d for Tk, d in zip(Ts, dirs_s)]
            ret = sr.forward_losses_T_sharded(
                reps, [Tk[:3, 3][:, None].expand_as(d)
                       for Tk, d in zip(Ts, dT)], dT, rgb_s, depth_s, fcfg,
                consts_reps, emd_w=0.0, u=u)
        else:
            rays_dT = T[:3, :3] @ rays_d_camT
            rays_oT = T[:3, 3][:, None].expand_as(rays_dT)
            ret = sr.forward_losses_T(params, rays_oT, rays_dT, target_rgbT,
                                      target_d, fcfg, consts, emd_w=0.0,
                                      u=u)
        loss = sr.total_loss(ret, lw)
        if gcfg.motion_prior_w > 0.0:
            # metres^2 in translation; the sign-free quaternion term is
            # about theta^2 / 4 for small angles
            q = rot / (torch.linalg.norm(rot) + 1e-9)
            dq = (q * q_prior).sum() ** 2
            loss = loss + gcfg.motion_prior_w * (
                ((trans - t_prior) ** 2).sum() + (1.0 - dq))
        g = torch.autograd.grad(loss, [rot, trans])
        loss = loss.detach()
        improved = alive & (loss < best_loss)
        best_loss = torch.where(improved, loss, best_loss)
        best_p = [torch.where(improved, c, b) for c, b in zip(p, best_p)]
        # iteration 0 seeds the best loss and counts as non-improving
        thresh = torch.where(alive, torch.where(improved & (i > 0),
                                                torch.zeros_like(thresh),
                                                thresh + 1), thresh)
        do = alive & (thresh <= gcfg.wait_iters)
        p = opt.step(p, list(g), do)
        alive = do
    final = best_p if gcfg.best else p
    return qt_to_matrix(final[0], final[1]), best_loss


def _mix_frame(H: int, W: int, edge_h: int, edge_w: int):
    """The border ``sample_pixels_mix`` leaves out, clamped so at least
    8 rows and columns stay: (edge_h, edge_w, inner rows, inner cols)."""
    edge_h = min(edge_h, max((H - 8) // 2, 0))
    edge_w = min(edge_w, max((W - 8) // 2, 0))
    return edge_h, edge_w, H - 2 * edge_h, W - 2 * edge_w


def sample_pixels_mix(generator: Optional[torch.Generator], H: int, W: int,
                      n_rows: int, n_cols: int, depth_img: torch.Tensor,
                      n_total: int, edge_h: int = 0, edge_w: int = 0,
                      noise: Optional[torch.Tensor] = None):
    """Uniform grid of n_rows x n_cols pixels plus valid-biased random
    pixels up to n_total, excluding an image border. ``noise``: the
    uniform score of each inner pixel (else drawn from ``generator``)."""
    dev = depth_img.device
    edge_h, edge_w, Hi, Wi = _mix_frame(H, W, edge_h, edge_w)
    rows = edge_h + _linspace_idx(0, Hi - 1, n_rows, dev)
    cols = edge_w + _linspace_idx(0, Wi - 1, n_cols, dev)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    n_rand = n_total - rr.shape[0]
    if n_rand <= 0:
        return rr[:n_total], cc[:n_total]
    interior = depth_img[edge_h:H - edge_h, edge_w:W - edge_w]
    valid = (interior > 0.0).to(torch.float32).reshape(-1)
    if noise is None:
        noise = torch.rand(valid.shape, generator=generator, device=dev)
    score = valid + noise
    idx = torch.topk(score, n_rand).indices
    return (torch.cat([rr, edge_h + idx // Wi]),
            torch.cat([cc, edge_w + idx % Wi]))


class TrackDraws(NamedTuple):
    """What tracking draws from its generator, in its order: the score
    noise of ``sample_pixels_mix`` (None when the grid fills the budget),
    then GO's z perturbation per iteration (None entries with perturbation
    off)."""
    pixels: Optional[torch.Tensor]
    go: List[Optional[torch.Tensor]]


def track_draws(generator: Optional[torch.Generator], H: int, W: int,
                rcfg: ROConfig, gcfg: GOConfig, fcfg: sr.FieldConfig,
                n_iter_go: int, device) -> TrackDraws:
    """The draws ``track_frame`` makes on a frame of H x W (RO draws
    nothing)."""
    _, _, Hi, Wi = _mix_frame(H, W, gcfg.ignore_edge_h, gcfg.ignore_edge_w)
    pixels = None
    if gcfg.n_rays > rcfg.n_rows * rcfg.n_cols:
        pixels = torch.rand((Hi * Wi,), generator=generator, device=device)
    return TrackDraws(pixels, [sr.draw_u(gcfg.n_rays, fcfg, generator,
                                         device)
                               for _ in range(n_iter_go)])


class TrackResult(NamedTuple):
    pose: torch.Tensor
    loss: torch.Tensor
    loss_ewma: torch.Tensor   # running accepted-loss EWMA (gate state)
    # False: the pose gate kept the motion-model prediction
    accepted: Optional[torch.Tensor] = None
    # the drift gate's reading (m; 0 when off), whether it was armed,
    # fired, and whether the rescued pose was adopted
    drift_res: Optional[torch.Tensor] = None
    armed: Optional[torch.Tensor] = None
    fired: Optional[torch.Tensor] = None
    rescued: Optional[torch.Tensor] = None
    # RO's initial search-size factor (1 when escalation is off)
    ss_scale: Optional[torch.Tensor] = None
    # the drift gate's anchor after this frame (None when off)
    gate: Optional[GateAnchor] = None
    # whether track_frame_update refreshes the anchor from this frame: a
    # host bool, read with ``fired``; None where the gate fired (then
    # decided on the device from the rescue's reading)
    refresh: Optional[bool] = None


def _gate_on(dgcfg: Optional[DriftGateConfig], gate) -> bool:
    return dgcfg is not None and dgcfg.thresh > 0.0 and gate is not None


def _anchor_due(dgcfg: DriftGateConfig, gate: GateAnchor, frame_idx: int,
                drift_res: torch.Tensor) -> torch.Tensor:
    """Refresh the anchor from frame ``frame_idx`` (a device bool): it has
    aged ``anchor_every`` frames and the frame's own reading is healthy
    (under anchor_health x thresh; under thresh once three refreshes were
    missed; any reading while disarmed)."""
    armed = gate.kf_frame >= 0
    age = frame_idx - gate.kf_frame
    due = (~armed) | (age >= dgcfg.anchor_every)
    health = torch.where(age >= 3 * dgcfg.anchor_every,
                         torch.full_like(drift_res, dgcfg.thresh),
                         torch.full_like(drift_res,
                                         dgcfg.anchor_health * dgcfg.thresh))
    return due & ((~armed) | (drift_res <= health))


def track_pose(params: Dict, fcfg: sr.FieldConfig, consts: sr.FieldConsts,
               rcfg: ROConfig, gcfg: GOConfig, pst: torch.Tensor,
               generator: Optional[torch.Generator], rgb_img: torch.Tensor,
               depth_img: torch.Tensor, rays_dir_img: torch.Tensor,
               prev_pose: torch.Tensor, prev_prev: torch.Tensor,
               use_const_speed: bool, lw: sr.LossWeights, n_iter_ro: int,
               n_iter_go: int, loss_ewma: torch.Tensor,
               prev_loss: Optional[torch.Tensor] = None,
               prev_rescued: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None,
               draws: Optional[TrackDraws] = None):
    """Motion model (from the previous two poses) -> RO -> GO -> pose
    gate: ``track_frame`` without the drift gate, reading no host value.
    Returns (the result, with the drift gate's fields false, and GO's
    rays: directions, colours, depths). ``draws``: what it would draw
    from ``generator`` (``track_draws``)."""
    H, W = depth_img.shape
    dev = depth_img.device
    if use_const_speed:
        pred = (prev_pose @ pose_inverse(prev_prev)) @ prev_pose
        if prev_rescued is not None:
            pred = torch.where(prev_rescued, prev_pose, pred)
    else:
        pred = prev_pose

    pose = pred
    ss_scale = torch.ones((), device=dev)
    if n_iter_ro > 0:
        scale = None
        if rcfg.escalate > 0.0 and prev_loss is not None:
            # tracking strain: grow the initial reach by the previous
            # loss over the accepted-loss EWMA, once the EWMA is seeded
            ratio = prev_loss / torch.clamp(loss_ewma, min=1e-8)
            scale = torch.where((loss_ewma > 0.0) & (prev_loss > 0.0),
                                torch.clamp(ratio, 1.0, rcfg.escalate),
                                torch.ones_like(ratio))
            ss_scale = scale
        row_idx, col_idx = ro_pixel_grid(H, W, rcfg, dev)
        pose = ro_optimize(params, fcfg, consts, rcfg, pst, depth_img,
                           rays_dir_img, pose, row_idx, col_idx, n_iter_ro,
                           ss_scale=scale, mesh=mesh)

    rr, cc = sample_pixels_mix(generator, H, W, rcfg.n_rows, rcfg.n_cols,
                               depth_img, gcfg.n_rays,
                               edge_h=gcfg.ignore_edge_h,
                               edge_w=gcfg.ignore_edge_w,
                               noise=None if draws is None else draws.pixels)
    rays_d_cam = rays_dir_img[rr, cc]
    target_rgb = rgb_img[rr, cc]
    target_d = depth_img[rr, cc][:, None]
    pose, loss = go_optimize(params, fcfg, consts, gcfg, rays_d_cam,
                             target_rgb, target_d, pose, n_iter_go, lw,
                             generator, prior_pose=pred, mesh=mesh,
                             us=None if draws is None else draws.go)

    seeded = loss_ewma > 0.0
    if gcfg.gate_rel > 0.0:
        # a loss far above the running EWMA of accepted losses marks a
        # basin escape: keep the motion-model prediction for this frame
        ok = (~seeded) | (loss <= gcfg.gate_abs) \
            | (loss <= gcfg.gate_rel * loss_ewma)
        pose = torch.where(ok, pose, pred)
        ewma_upd = torch.where(seeded, 0.9 * loss_ewma + 0.1 * loss, loss)
        loss_ewma = torch.where(ok, ewma_upd, loss_ewma * 1.25)
    else:
        ok = torch.ones((), dtype=torch.bool, device=dev)
        loss_ewma = torch.where(seeded, 0.9 * loss_ewma + 0.1 * loss, loss)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    return (TrackResult(pose, loss, loss_ewma, ok,
                        torch.zeros((), device=dev), false, false, false,
                        ss_scale),
            (rays_d_cam, target_rgb, target_d))


def track_frame(params: Dict, fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                rcfg: ROConfig, gcfg: GOConfig, pst: torch.Tensor,
                generator: Optional[torch.Generator], rgb_img: torch.Tensor,
                depth_img: torch.Tensor, rays_dir_img: torch.Tensor,
                est_c2w: torch.Tensor, frame_idx: int, use_const_speed: bool,
                lw: sr.LossWeights, n_iter_ro: int, n_iter_go: int,
                loss_ewma: torch.Tensor,
                prev_loss: Optional[torch.Tensor] = None,
                dgcfg: Optional[DriftGateConfig] = None,
                gate: Optional[GateAnchor] = None,
                prev_rescued: Optional[torch.Tensor] = None,
                polish_generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> TrackResult:
    """Motion model -> RO -> GO -> pose gate (``track_pose``) -> drift
    gate for frame ``frame_idx``. ``prev_loss``: the previous frame's loss
    (RO's escalation signal); ``prev_rescued``: the drift gate rescued the
    previous frame, whose correction jump the constant-velocity model must
    not extrapolate; ``polish_generator``: the rescue's GO polish draws
    (the tracking generator's stream stays as it is with the gate off);
    ``mesh``: RO's queries, GO and the polish GO split over it where their
    sizes divide (JAX: ``ray_sharding``)."""
    H, W = depth_img.shape
    dev = depth_img.device
    res, (rays_d_cam, target_rgb, target_d) = track_pose(
        params, fcfg, consts, rcfg, gcfg, pst, generator, rgb_img,
        depth_img, rays_dir_img, est_c2w[frame_idx - 1],
        est_c2w[max(frame_idx - 2, 0)], use_const_speed, lw, n_iter_ro,
        n_iter_go, loss_ewma, prev_loss, prev_rescued, mesh)
    if not _gate_on(dgcfg, gate):
        return res
    pose, loss, loss_ewma, ok = res[:4]
    ss_scale, false = res.ss_scale, res.rescued

    sr_, sc_ = torch.meshgrid(_linspace_idx(0, H - 1, dgcfg.src_rows, dev),
                              _linspace_idx(0, W - 1, dgcfg.src_cols, dev),
                              indexing="ij")
    sr_, sc_ = sr_.reshape(-1), sc_.reshape(-1)
    sd = depth_img[sr_, sc_][:, None]
    src_cam = rays_dir_img[sr_, sc_] * sd
    src_valid = sd[:, 0] > 0.0
    n_valid = src_valid.sum()
    kf_pose = est_c2w[torch.clamp(gate.kf_frame, min=0)]
    kf_inv = pose_inverse(kf_pose)

    def slip_of(p4):
        """ICP of the frame's cloud onto the anchor from pose p4: the size
        of the correction it proposes is the drift reading (a median
        plane distance under-measures slips along the dominant planes)."""
        rel0 = kf_inv @ p4
        src0 = src_cam @ rel0[:3, :3].T + rel0[:3, 3]
        res = icp_mod.icp_point_to_plane(
            src0, src_valid, gate.pts, gate.valid, gate.normals,
            dgcfg.icp_thresh, n_iters=dgcfg.icp_iters,
            rel_damping=dgcfg.icp_damping,
            robust_delta=dgcfg.icp_robust_delta)
        T = res.transform
        theta = torch.arccos(torch.clamp(
            (torch.diagonal(T[:3, :3]).sum() - 1.0) * 0.5, -1.0, 1.0))
        slip = torch.linalg.norm(T[:3, 3]) + dgcfg.rot_lever * theta
        enough = res.n_inliers >= dgcfg.min_inlier_frac * n_valid
        return slip, enough, kf_pose @ (T @ rel0)

    slip, enough, pose_icp = slip_of(pose)
    drift_res, rescued = slip, false
    armed = gate.kf_frame >= 0
    fire = armed & enough & (slip > dgcfg.thresh)
    # the host's one read a frame: did the gate fire, and, were it not to,
    # is the anchor due to be refreshed from this frame (JAX: lax.cond)
    fire_h, refresh = torch.stack(
        [fire, _anchor_due(dgcfg, gate, frame_idx, slip)]).tolist()
    if fire_h:
        # verify first, with the same instrument: from a right pose a
        # second ICP proposes almost no further correction (the polish
        # optimizes against a map that may have been dragged, so it gets
        # no veto)
        slip_v, enough_v, _ = slip_of(pose_icp)
        rescued = enough_v & (slip_v < 0.5 * slip)
        pose_r = pose_icp
        if dgcfg.polish and n_iter_go > 0:
            pgcfg = dataclasses.replace(gcfg,
                                        motion_prior_w=dgcfg.polish_prior_w)
            pose_r, _ = go_optimize(params, fcfg, consts, pgcfg, rays_d_cam,
                                    target_rgb, target_d, pose_icp,
                                    n_iter_go, lw, polish_generator,
                                    prior_pose=pose_icp, mesh=mesh)
        pose = torch.where(rescued, pose_r, pose)
        drift_res = torch.where(rescued, slip_v, slip)
        refresh = None
    return TrackResult(pose, loss, loss_ewma, ok, drift_res, armed, fire,
                       rescued, ss_scale, gate, refresh)


def commit_pose(state, frame_idx: int, pose: torch.Tensor,
                keyframe_every: int) -> None:
    """The pose-store bookkeeping of a tracked frame, in place: est_c2w,
    then keyframe_ref on a keyframe, else the pose relative to the
    frame's keyframe."""
    kf_id = frame_idx // keyframe_every
    kf_frame = kf_id * keyframe_every
    state.est_c2w[frame_idx] = pose
    if frame_idx % keyframe_every == 0:
        state.keyframe_ref[kf_id] = state.active_first_kf
    else:
        state.est_c2w_rel[frame_idx] = (pose_inverse(state.est_c2w[kf_frame])
                                        @ pose)


def track_frame_update(params: Dict, fcfg: sr.FieldConfig,
                       consts: sr.FieldConsts, rcfg: ROConfig,
                       gcfg: GOConfig, pst: torch.Tensor,
                       generator: Optional[torch.Generator],
                       packed_frame: torch.Tensor, state, frame_idx: int,
                       use_const_speed: bool, lw: sr.LossWeights,
                       n_iter_ro: int, n_iter_go: int, keyframe_every: int,
                       loss_ewma: torch.Tensor,
                       prev_loss: Optional[torch.Tensor] = None,
                       dgcfg: Optional[DriftGateConfig] = None,
                       gate: Optional[GateAnchor] = None,
                       prev_rescued: Optional[torch.Tensor] = None,
                       polish_generator: Optional[torch.Generator] = None,
                       mesh: Optional[Mesh] = None) -> TrackResult:
    """Track frame ``frame_idx`` and commit the pose-store bookkeeping
    (est_c2w, the pose relative to its keyframe, keyframe_ref) in place.
    With the drift gate on, the returned anchor is refreshed from this
    frame when ``_anchor_due``."""
    res = track_frame(params, fcfg, consts, rcfg, gcfg, pst, generator,
                      packed_frame[..., 3:6], packed_frame[..., 6],
                      packed_frame[..., :3], state.est_c2w, frame_idx,
                      use_const_speed, lw, n_iter_ro, n_iter_go, loss_ewma,
                      prev_loss=prev_loss, dgcfg=dgcfg, gate=gate,
                      prev_rescued=prev_rescued,
                      polish_generator=polish_generator, mesh=mesh)
    commit_pose(state, frame_idx, res.pose, keyframe_every)
    if not _gate_on(dgcfg, gate) or res.refresh is False:
        return res
    pts, normals, valid = gate_anchor(packed_frame, dgcfg.anchor_rows,
                                      dgcfg.anchor_cols)
    frame = torch.full_like(gate.kf_frame, frame_idx)
    if res.refresh:
        return res._replace(gate=GateAnchor(pts, normals, valid, frame))
    do = _anchor_due(dgcfg, gate, frame_idx, res.drift_res)
    new = GateAnchor(
        torch.where(do, pts, gate.pts), torch.where(do, normals, gate.normals),
        torch.where(do, valid, gate.valid),
        torch.where(do, frame, gate.kf_frame))
    return res._replace(gate=new)

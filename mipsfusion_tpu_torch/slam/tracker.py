"""Camera tracking: particle-swarm RO, then gradient GO.

Port of the default path of ``mipsfusion_tpu/slam/tracker.py``: the
antithetic particle template (``make_pst``), ``ro_optimize``,
``go_optimize`` with its early stop and best-pose carry,
``sample_pixels_mix``, the pose acceptance gate and
``track_frame_update``. The knob-gated levers (RO screen and escalation,
motion prior, drift gate) are not ported; their config keys must keep the
defaults.

The iteration loops are Python loops over tensor ops with no host
readback inside: GO's early stop and best-pose selection are tensor
masks, RO's success branch a ``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from ..models import scene_rep as sr
from ..ops.geometry import (matrix_to_quaternion, pose_inverse, qt_to_matrix,
                            quaternion_to_matrix)


@dataclasses.dataclass(frozen=True)
class ROConfig:
    particle_size: int = 2000
    initial_scaling_factor: float = 0.02
    rescaling_factor: float = 0.5
    n_rows: int = 16
    n_cols: int = 24
    n_iters: int = 5
    sdf_weight: float = 1000.0

    @staticmethod
    def from_dict(cfg: dict) -> "ROConfig":
        ro = cfg["tracking"]["RO"]
        for k in ("screen_px", "screen_keep", "escalate"):
            if ro.get(k, 0):
                raise NotImplementedError(f"tracking.RO.{k} is not ported")
        return ROConfig(
            particle_size=ro["particle_size"],
            initial_scaling_factor=ro["initial_scaling_factor"],
            rescaling_factor=ro["rescaling_factor"],
            n_rows=ro["n_rows"], n_cols=ro["n_cols"],
            n_iters=cfg["tracking"]["iter_RO"])


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
    gate_rel: float = 0.0
    gate_abs: float = 0.0

    @staticmethod
    def from_dict(cfg: dict) -> "GOConfig":
        t = cfg["tracking"]
        if float(t.get("motion_prior_w", 0.0)):
            raise NotImplementedError("tracking.motion_prior_w is not ported")
        if float((t.get("drift_gate") or {}).get("thresh", 0.0)):
            raise NotImplementedError("tracking.drift_gate is not ported")
        gate = t.get("pose_gate", {}) or {}
        return GOConfig(n_iters=t["iter"], n_rays=t["sample"],
                        lr_rot=t["lr_rot"], lr_trans=t["lr_trans"],
                        ignore_edge_w=t["ignore_edge_W"],
                        ignore_edge_h=t["ignore_edge_H"],
                        best=bool(t["best"]),
                        wait_iters=int(t.get("wait_iters", 100)),
                        gate_rel=float(gate.get("rel", 0.0)),
                        gate_abs=float(gate.get("abs", 0.0)))


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
                n_iters: int) -> torch.Tensor:
    """Particle-swarm pose search; returns the refined pose [4, 4]. Each
    iteration scores all P particles on the shifted pixel grid with one
    SDF-only field query of [3, P * n] points (the K1 kernel)."""
    dev = pst.device
    rot, trans = initial_pose[:3, :3], initial_pose[:3, 3]
    search_size = torch.full((1, 6), rcfg.initial_scaling_factor, device=dev)
    identity7 = torch.zeros(7, device=dev)
    identity7[0] = 1.0
    P = pst.shape[0]
    for i in range(n_iters):
        off = i % 5
        d = depth_img[row_idx + off, col_idx + off][:, None]      # [n, 1]
        dirs = rays_dir_img[row_idx + off, col_idx + off]         # [n, 3]
        ptsT = (dirs * d).T                                       # [3, n]
        valid = (d[:, 0] > 0.0).to(d.dtype)

        pst7 = _pose_6d_to_7d(pst * search_size)                  # [P, 7]
        abs_rot = rot[None] @ quaternion_to_matrix(pst7[:, :4])  # [P, 3, 3]
        abs_trans = trans[None] + pst7[:, 4:]                     # [P, 3]
        worldT = (abs_rot @ ptsT + abs_trans[:, :, None])         # [P, 3, n]
        worldT = worldT.permute(1, 0, 2).reshape(3, -1)
        sdf = sr.run_network_sdf_T(params, worldT, fcfg, consts)
        sdf = sdf.reshape(P, -1) * fcfg.trunc
        mean_sdf = (valid[None] * sdf.abs()).mean(-1)             # [P]
        fit = mean_sdf * rcfg.sdf_weight

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
                generator: Optional[torch.Generator] = None):
    """Adam on (quaternion, translation) against the rendering losses of
    fixed rays; returns (pose [4, 4], best loss). The loss before each
    update competes for the best pose; after ``wait_iters`` non-improving
    iterations the loop stops without that iteration's update (reference
    semantics), kept on device as the ``alive`` mask. ``params`` should be
    detached: GO differentiates only the pose."""
    dev = rays_d_cam.device
    p = [matrix_to_quaternion(initial_pose[:3, :3]), initial_pose[:3, 3]]
    opt = MaskedAdam(p, [gcfg.lr_rot, gcfg.lr_trans])
    rays_d_camT = rays_d_cam.T
    target_rgbT = target_rgb.T
    best_loss = torch.full((), float("inf"), device=dev)
    best_p = list(p)
    thresh = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(n_iters):
        rot = p[0].detach().requires_grad_(True)
        trans = p[1].detach().requires_grad_(True)
        T = qt_to_matrix(rot, trans)
        rays_dT = T[:3, :3] @ rays_d_camT
        rays_oT = T[:3, 3][:, None].expand_as(rays_dT)
        ret = sr.forward_losses_T(params, rays_oT, rays_dT, target_rgbT,
                                  target_d, fcfg, consts, emd_w=0.0,
                                  generator=generator)
        loss = sr.total_loss(ret, lw)
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


def sample_pixels_mix(generator: Optional[torch.Generator], H: int, W: int,
                      n_rows: int, n_cols: int, depth_img: torch.Tensor,
                      n_total: int, edge_h: int = 0, edge_w: int = 0):
    """Uniform grid of n_rows x n_cols pixels plus valid-biased random
    pixels up to n_total, excluding an image border."""
    dev = depth_img.device
    edge_h = min(edge_h, max((H - 8) // 2, 0))
    edge_w = min(edge_w, max((W - 8) // 2, 0))
    Hi, Wi = H - 2 * edge_h, W - 2 * edge_w
    rows = edge_h + _linspace_idx(0, Hi - 1, n_rows, dev)
    cols = edge_w + _linspace_idx(0, Wi - 1, n_cols, dev)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    n_rand = n_total - rr.shape[0]
    if n_rand <= 0:
        return rr[:n_total], cc[:n_total]
    interior = depth_img[edge_h:H - edge_h, edge_w:W - edge_w]
    valid = (interior > 0.0).to(torch.float32).reshape(-1)
    score = valid + torch.rand(valid.shape, generator=generator, device=dev)
    idx = torch.topk(score, n_rand).indices
    return (torch.cat([rr, edge_h + idx // Wi]),
            torch.cat([cc, edge_w + idx % Wi]))


class TrackResult(NamedTuple):
    pose: torch.Tensor
    loss: torch.Tensor
    loss_ewma: torch.Tensor   # running accepted-loss EWMA (gate state)


def track_frame(params: Dict, fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                rcfg: ROConfig, gcfg: GOConfig, pst: torch.Tensor,
                generator: Optional[torch.Generator], rgb_img: torch.Tensor,
                depth_img: torch.Tensor, rays_dir_img: torch.Tensor,
                est_c2w: torch.Tensor, frame_idx: int, use_const_speed: bool,
                lw: sr.LossWeights, n_iter_ro: int, n_iter_go: int,
                loss_ewma: torch.Tensor) -> TrackResult:
    """Motion model -> RO -> GO -> pose gate for frame ``frame_idx``."""
    H, W = depth_img.shape
    prev_pose = est_c2w[frame_idx - 1]
    if use_const_speed:
        prev_prev = est_c2w[max(frame_idx - 2, 0)]
        pred = (prev_pose @ pose_inverse(prev_prev)) @ prev_pose
    else:
        pred = prev_pose

    pose = pred
    if n_iter_ro > 0:
        row_idx, col_idx = ro_pixel_grid(H, W, rcfg, depth_img.device)
        pose = ro_optimize(params, fcfg, consts, rcfg, pst, depth_img,
                           rays_dir_img, pose, row_idx, col_idx, n_iter_ro)

    rr, cc = sample_pixels_mix(generator, H, W, rcfg.n_rows, rcfg.n_cols,
                               depth_img, gcfg.n_rays,
                               edge_h=gcfg.ignore_edge_h,
                               edge_w=gcfg.ignore_edge_w)
    pose, loss = go_optimize(params, fcfg, consts, gcfg, rays_dir_img[rr, cc],
                             rgb_img[rr, cc], depth_img[rr, cc][:, None],
                             pose, n_iter_go, lw, generator)

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
        loss_ewma = torch.where(seeded, 0.9 * loss_ewma + 0.1 * loss, loss)
    return TrackResult(pose, loss, loss_ewma)


def track_frame_update(params: Dict, fcfg: sr.FieldConfig,
                       consts: sr.FieldConsts, rcfg: ROConfig,
                       gcfg: GOConfig, pst: torch.Tensor,
                       generator: Optional[torch.Generator],
                       packed_frame: torch.Tensor, state, frame_idx: int,
                       use_const_speed: bool, lw: sr.LossWeights,
                       n_iter_ro: int, n_iter_go: int, keyframe_every: int,
                       loss_ewma: torch.Tensor) -> TrackResult:
    """Track frame ``frame_idx`` and commit the pose-store bookkeeping
    (est_c2w, the pose relative to its keyframe, keyframe_ref) in place."""
    res = track_frame(params, fcfg, consts, rcfg, gcfg, pst, generator,
                      packed_frame[..., 3:6], packed_frame[..., 6],
                      packed_frame[..., :3], state.est_c2w, frame_idx,
                      use_const_speed, lw, n_iter_ro, n_iter_go, loss_ewma)
    kf_id = frame_idx // keyframe_every
    kf_frame = kf_id * keyframe_every
    state.est_c2w[frame_idx] = res.pose
    if frame_idx % keyframe_every == 0:
        state.keyframe_ref[kf_id] = state.active_first_kf
    else:
        state.est_c2w_rel[frame_idx] = (pose_inverse(state.est_c2w[kf_frame])
                                        @ res.pose)
    return res

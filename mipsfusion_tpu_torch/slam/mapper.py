"""Mapping: first-frame fit and local bundle adjustment.

Port of ``mipsfusion_tpu/slam/mapper.py`` (``make_map_optimizer``,
``init_submap_fit``, ``_kf_sampling_weights``, ``local_ba``). The map
optimizer is one ``torch.optim.Adam`` with the reference's two groups
(decoder: weight decay 1e-6 added to the gradient, eps 1e-8; planes and
CP lines: eps 1e-15; betas (0.9, 0.99) for both); its state persists
across the first-frame fit and every BA. Pose optimizers are fresh per BA
(``tracker.MaskedAdam``, optax.adam's defaults).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models import scene_rep as sr
from ..ops.geometry import matrix_to_quaternion, qt_to_matrix
from .tracker import MaskedAdam


@dataclasses.dataclass(frozen=True)
class MapConfig:
    sample: int = 1800
    pixels_cur: int = 800
    iters: int = 15
    first_iters: int = 500
    lr_embed: float = 0.01
    lr_decoder: float = 0.01
    lr_rot: float = 0.001
    lr_trans: float = 0.001
    map_accum_step: int = 1
    pose_accum_step: int = 5
    map_wait_step: int = 0
    optim_cur: bool = False

    @staticmethod
    def from_dict(cfg: dict) -> "MapConfig":
        m = cfg["mapping"]
        if float(m.get("kf_strain_mask", 0.0)):
            raise NotImplementedError("mapping.kf_strain_mask is not ported")
        return MapConfig(
            sample=m["sample"], pixels_cur=m["pixels_cur"],
            iters=m["iters"], first_iters=m["first_iters"],
            lr_embed=m["lr_embed"], lr_decoder=m["lr_decoder"],
            lr_rot=m["lr_rot"], lr_trans=m["lr_trans"],
            map_accum_step=m["map_accum_step"],
            pose_accum_step=m["pose_accum_step"],
            map_wait_step=m["map_wait_step"],
            optim_cur=bool(m["optim_cur"]))


def make_map_optimizer(field: sr.Field, mcfg: MapConfig) -> torch.optim.Adam:
    return torch.optim.Adam([
        {"params": list(field.decoder.parameters()), "lr": mcfg.lr_decoder,
         "weight_decay": 1e-6, "eps": 1e-8},
        {"params": list(field.planes.parameters()), "lr": mcfg.lr_embed,
         "eps": 1e-15},
    ], betas=(0.9, 0.99))


def init_submap_fit(field: sr.Field, opt: torch.optim.Adam,
                    frame_rays: torch.Tensor, fcfg: sr.FieldConfig,
                    consts: sr.FieldConsts, mcfg: MapConfig,
                    lw: sr.LossWeights, n_iters: int, n_rays: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Fit the field to one frame at the local identity pose (the frame is
    the submap origin). frame_rays: [H*W, 7]. Returns the last loss."""
    loss = None
    n_total = frame_rays.shape[0]
    for _ in range(n_iters):
        idx = torch.randint(0, n_total, (n_rays,), generator=generator,
                            device=frame_rays.device)
        rays = frame_rays[idx]
        dirsT = rays[:, :3].T
        ret = sr.forward_losses_T(field.params(), torch.zeros_like(dirsT),
                                  dirsT, rays[:, 3:6].T, rays[:, 6:7], fcfg,
                                  consts, generator=generator)
        loss = sr.total_loss(ret, lw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return loss.detach()


def kf_sampling_weights(kf_mask: torch.Tensor, first_kf: int,
                        last_kf: torch.Tensor, sample: int,
                        pixels_cur: float) -> torch.Tensor:
    """Expected ray counts [K + 1] per keyframe slot (the reference's
    quotas: first kf max(1/n, 1/10) of the budget, last kf max(1/n, 1/5)
    when n > 2, the rest uniform); slot K is the current frame."""
    K = kf_mask.shape[0]
    n = torch.clamp(kf_mask.sum(), min=1)
    nf = n.to(torch.float32)
    big = n > 2
    q_first = torch.clamp(sample / nf, min=sample / 10.0)
    q_last = torch.where(big, torch.clamp(sample / nf, min=sample / 5.0),
                         torch.zeros_like(nf))
    n_other = torch.clamp(nf - 1.0 - big.to(nf.dtype), min=1.0)
    q_other = torch.clamp(sample - q_first - q_last, min=0.0) / n_other
    idx = torch.arange(K, device=kf_mask.device)
    w = torch.where(idx == first_kf, q_first,
                    torch.where((idx == last_kf) & big, q_last, q_other))
    w = w * kf_mask.to(w.dtype)
    w_cur = (torch.clamp(sample / nf, min=float(pixels_cur))
             if pixels_cur > 0 else torch.zeros_like(nf))
    return torch.cat([w, w_cur[None]])


class BAResult(NamedTuple):
    kf_quat: torch.Tensor     # [K, 4] optimized keyframe rotations (local)
    kf_trans: torch.Tensor    # [K, 3]
    cur_quat: torch.Tensor    # [4] current-frame pose (moves iff optim_cur)
    cur_trans: torch.Tensor   # [3]
    loss: torch.Tensor


def local_ba(field: sr.Field, opt: torch.optim.Adam, kf_rays: torch.Tensor,
             kf_mask: torch.Tensor, first_kf: int, last_kf: torch.Tensor,
             kf_poses_local: torch.Tensor, cur_rays: torch.Tensor,
             cur_pose_local: torch.Tensor, fcfg: sr.FieldConfig,
             consts: sr.FieldConsts, mcfg: MapConfig, lw: sr.LossWeights,
             n_total: int, generator: Optional[torch.Generator] = None
             ) -> BAResult:
    """Joint map + keyframe-pose BA over the active submap's keyframes.

    kf_rays [K, R, 7] keyframe store; kf_mask [K] membership;
    kf_poses_local [K, 4, 4]; cur_rays [P, 7] the current frame. Each
    iteration draws n_total rays by the quota weights, steps the map every
    map_accum_step iterations, and steps the poses with the gradients
    accumulated over pose_accum_step iterations; the first keyframe and
    slots outside the mask stay frozen."""
    K, R, _ = kf_rays.shape
    dev = kf_rays.device
    w = kf_sampling_weights(kf_mask, first_kf, last_kf, mcfg.sample,
                            mcfg.pixels_cur)
    pose_p = [torch.cat([matrix_to_quaternion(kf_poses_local[:, :3, :3]),
                         matrix_to_quaternion(cur_pose_local[:3, :3])[None]]),
              torch.cat([kf_poses_local[:, :3, 3], cur_pose_local[None, :3, 3]])]
    pose_opt = MaskedAdam(pose_p, [mcfg.lr_rot, mcfg.lr_trans])
    idx = torch.arange(K, device=dev)
    free = torch.cat([kf_mask & (idx != first_kf),
                      torch.full((1,), mcfg.optim_cur, device=dev)]
                     ).to(torch.float32)[:, None]
    accum = [torch.zeros_like(p) for p in pose_p]
    loss = None
    for i in range(mcfg.iters):
        src = torch.multinomial(w, n_total, replacement=True,
                                generator=generator)
        ray_idx = torch.randint(0, R, (n_total,), generator=generator,
                                device=dev)
        cur_idx = torch.randint(0, cur_rays.shape[0], (n_total,),
                                generator=generator, device=dev)
        from_cur = src == K
        rays = torch.where(from_cur[:, None], cur_rays[cur_idx],
                           kf_rays[torch.clamp(src, max=K - 1), ray_idx])
        rot = pose_p[0].detach().requires_grad_(True)
        trans = pose_p[1].detach().requires_grad_(True)
        T = qt_to_matrix(rot, trans)[src]                         # [N, 4, 4]
        rays_dT = torch.einsum("nj,nij->in", rays[:, :3], T[:, :3, :3])
        rays_oT = T[:, :3, 3].T
        ret = sr.forward_losses_T(field.params(), rays_oT, rays_dT,
                                  rays[:, 3:6].T, rays[:, 6:7], fcfg, consts,
                                  generator=generator)
        loss = sr.total_loss(ret, lw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if (i + 1) % mcfg.map_accum_step == 0 and (i + 1) > mcfg.map_wait_step:
            opt.step()
        accum = [a + g * free for a, g in zip(accum, (rot.grad, trans.grad))]
        if (i + 1) % mcfg.pose_accum_step == 0:
            pose_p = pose_opt.step(pose_p, accum, True)
            accum = [torch.zeros_like(a) for a in accum]
    return BAResult(kf_quat=pose_p[0][:K], kf_trans=pose_p[1][:K],
                    cur_quat=pose_p[0][K], cur_trans=pose_p[1][K],
                    loss=loss.detach())

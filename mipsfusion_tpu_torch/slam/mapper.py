"""Mapping: first-frame fit and local bundle adjustment.

Port of ``mipsfusion_tpu/slam/mapper.py`` (``make_map_optimizer``,
``init_submap_fit``, ``_kf_sampling_weights``, ``local_ba``,
``switch_ba``). The map optimizer is one ``torch.optim.Adam`` with the
reference's two groups (decoder: weight decay 1e-6 added to the gradient,
eps 1e-8; planes and CP lines: eps 1e-15; betas (0.9, 0.99) for both);
the active submap's persists across its first fit and every BA until the
next switch, and background refinement makes a fresh one per round. Pose
optimizers are fresh per BA (``tracker.MaskedAdam``, optax.adam's
defaults).

Random draws (ray sources, ray and pixel indices) come from a
``torch.Generator``; ``local_ba`` and ``switch_ba`` also take them passed
in (``draws``), so tests can feed both packages the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

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


def pose_rows(T: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """T[src] for poses T [K, 4, 4] and a slot per ray src [N], as a
    one-hot product: exact, and its gradient is a matrix product summed in
    a fixed order. The indexing form's gradient scatters with float
    atomics on the card, which makes every run's poses differ."""
    onehot = torch.nn.functional.one_hot(src, T.shape[0]).to(T.dtype)
    return (onehot @ T.reshape(T.shape[0], 16)).reshape(-1, 4, 4)


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


Draws = Sequence[Tuple[torch.Tensor, ...]]


def _draw(w: torch.Tensor, n: int, sizes: Sequence[int],
          generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """n sources by the weights w, then n uniform indices below each of
    ``sizes``."""
    dev = w.device
    return ([torch.multinomial(w, n, replacement=True, generator=generator)]
            + [torch.randint(0, s, (n,), generator=generator, device=dev)
               for s in sizes])


def local_ba(field: sr.Field, opt: torch.optim.Adam, kf_rays: torch.Tensor,
             kf_mask: torch.Tensor, first_kf, last_kf: torch.Tensor,
             kf_poses_local: torch.Tensor, cur_rays: torch.Tensor,
             cur_pose_local: torch.Tensor, fcfg: sr.FieldConfig,
             consts: sr.FieldConsts, mcfg: MapConfig, lw: sr.LossWeights,
             n_total: int, generator: Optional[torch.Generator] = None,
             include_current: bool = True,
             optim_cur: Optional[bool] = None,
             draws: Optional[Draws] = None) -> BAResult:
    """Joint map + keyframe-pose BA over one submap's keyframes.

    kf_rays [K, R, 7] keyframe store; kf_mask [K] membership; first_kf
    (int or device scalar) the submap's first keyframe; kf_poses_local
    [K, 4, 4]; cur_rays [P, 7] the current frame, which gets no rays
    without ``include_current`` (background refinement). Each iteration
    draws n_total rays by the quota weights, steps the map every
    map_accum_step iterations, and steps the poses with the gradients
    accumulated over pose_accum_step iterations; the first keyframe and
    slots outside the mask stay frozen, the current frame too unless
    ``optim_cur`` (default ``mcfg.optim_cur``). ``draws``: per iteration
    (source slot, keyframe ray index, current-frame ray index)."""
    K, R, _ = kf_rays.shape
    dev = kf_rays.device
    if optim_cur is None:
        optim_cur = mcfg.optim_cur
    w = kf_sampling_weights(kf_mask, first_kf, last_kf, mcfg.sample,
                            mcfg.pixels_cur if include_current else 0)
    pose_p = [torch.cat([matrix_to_quaternion(kf_poses_local[:, :3, :3]),
                         matrix_to_quaternion(cur_pose_local[:3, :3])[None]]),
              torch.cat([kf_poses_local[:, :3, 3], cur_pose_local[None, :3, 3]])]
    pose_opt = MaskedAdam(pose_p, [mcfg.lr_rot, mcfg.lr_trans])
    idx = torch.arange(K, device=dev)
    free = torch.cat([kf_mask & (idx != first_kf),
                      torch.full((1,), bool(optim_cur), device=dev)]
                     ).to(torch.float32)[:, None]
    accum = [torch.zeros_like(p) for p in pose_p]
    loss = None
    for i in range(mcfg.iters):
        src, ray_idx, cur_idx = (draws[i] if draws is not None else _draw(
            w, n_total, (R, cur_rays.shape[0]), generator))
        from_cur = src == K
        rays = torch.where(from_cur[:, None], cur_rays[cur_idx],
                           kf_rays[torch.clamp(src, max=K - 1), ray_idx])
        rot = pose_p[0].detach().requires_grad_(True)
        trans = pose_p[1].detach().requires_grad_(True)
        T = pose_rows(qt_to_matrix(rot, trans), src)              # [N, 4, 4]
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


def switch_ba(params, kf_rays: torch.Tensor, kf_mask: torch.Tensor,
              kf_poses_local: torch.Tensor, ovlp_rays: torch.Tensor,
              ovlp_pose_local: torch.Tensor, fcfg: sr.FieldConfig,
              consts: sr.FieldConsts, lw: sr.LossWeights, lr_rot: float,
              lr_trans: float, n_iters: int, n_total: int,
              pose_accum_step: int = 5,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Draws] = None):
    """Refine ONLY the loop keyframe's pose against the switched-to
    submap, on a frozen field (``params`` detached; the map optimizer is
    never stepped), with a fresh pose Adam stepped every pose_accum_step
    iterations on the accumulated gradient. Rays come uniformly from the
    keyframes in kf_mask (poses kf_poses_local, fixed) plus a quota of
    max(1/n, 1/5) of n_total from the loop keyframe's own rays ovlp_rays
    [P, 7]. ``draws``: per iteration (source slot, keyframe ray index,
    loop-keyframe ray index). Returns (pose [4, 4], last loss)."""
    K, R, _ = kf_rays.shape
    n = torch.clamp(kf_mask.sum(), min=1).to(torch.float32)
    w_kf = kf_mask.to(torch.float32)
    w_kf = w_kf / torch.clamp(w_kf.sum(), min=1.0)
    w_ovlp = torch.clamp(n_total / n, min=n_total / 5.0) / n_total
    w = torch.cat([w_kf, w_ovlp[None]])
    p = [matrix_to_quaternion(ovlp_pose_local[:3, :3]),
         ovlp_pose_local[:3, 3]]
    pose_opt = MaskedAdam(p, [lr_rot, lr_trans])
    kf_quats = matrix_to_quaternion(kf_poses_local[:, :3, :3])
    kf_trans = kf_poses_local[:, :3, 3]
    accum = [torch.zeros_like(t) for t in p]
    loss = None
    for i in range(n_iters):
        src, ray_idx, ovlp_idx = (draws[i] if draws is not None else _draw(
            w, n_total, (R, ovlp_rays.shape[0]), generator))
        rays = torch.where((src == K)[:, None], ovlp_rays[ovlp_idx],
                           kf_rays[torch.clamp(src, max=K - 1), ray_idx])
        rot = p[0].detach().requires_grad_(True)
        trans = p[1].detach().requires_grad_(True)
        T = pose_rows(qt_to_matrix(torch.cat([kf_quats, rot[None]]),
                                   torch.cat([kf_trans, trans[None]])), src)
        rays_dT = torch.einsum("nj,nij->in", rays[:, :3], T[:, :3, :3])
        ret = sr.forward_losses_T(params, T[:, :3, 3].T, rays_dT,
                                  rays[:, 3:6].T, rays[:, 6:7], fcfg, consts,
                                  generator=generator)
        loss = sr.total_loss(ret, lw)
        g = torch.autograd.grad(loss, [rot, trans])
        accum = [a + gg for a, gg in zip(accum, g)]
        if (i + 1) % pose_accum_step == 0:
            p = pose_opt.step(p, accum, True)
            accum = [torch.zeros_like(a) for a in accum]
    return qt_to_matrix(p[0], p[1]), loss.detach()

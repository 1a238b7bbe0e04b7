"""Training losses: free-space / truncation SDF losses + EMD classification.

Port of ``mipsfusion_tpu/ops/losses.py`` (``compute_loss``, ``mse2psnr``,
``get_masks``, ``get_sdf_loss_T``, and the cross-submap consistency losses
of the SDF-consistency global BA), with the reference's scalings (EMD
terms divided by 250 and 5000) and the mean-over-all-elements convention
of the masked regression terms.
"""

from __future__ import annotations

import math

import torch


def mse2psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(x) / math.log(10.0)


def compute_loss(prediction: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (the reference's default "l2")."""
    return torch.mean((prediction - target) ** 2)


def get_masks(z_vals: torch.Tensor, target_d: torch.Tensor,
              truncation: float):
    """z_vals [B, S], target_d [B, 1] -> (front_mask, sdf_mask, fs_weight,
    sdf_weight)."""
    front_mask = (z_vals < (target_d - truncation)).to(z_vals.dtype)
    back_mask = (z_vals > (target_d + truncation)).to(z_vals.dtype)
    depth_mask = (target_d > 0.0).to(z_vals.dtype)
    sdf_mask = (1.0 - front_mask) * (1.0 - back_mask) * depth_mask
    num_fs = torch.count_nonzero(front_mask).to(z_vals.dtype)
    num_sdf = torch.count_nonzero(sdf_mask).to(z_vals.dtype)
    num = num_fs + num_sdf
    return front_mask, sdf_mask, 1.0 - num_fs / num, 1.0 - num_sdf / num


def get_sdf_loss_T(z_vals: torch.Tensor, target_d: torch.Tensor,
                   predicted_sdf: torch.Tensor, sdf_probT: torch.Tensor,
                   truncation: float, cate_num: int = 5,
                   emd_w: float = 0.01):
    """z_vals / predicted_sdf [B, S], target_d [B, 1], class-major
    probabilities sdf_probT [C, B, S] -> (fs_loss, sdf_loss)."""
    front_mask, sdf_mask, fs_weight, sdf_weight = get_masks(
        z_vals, target_d, truncation)
    fs_loss = compute_loss(predicted_sdf * front_mask, front_mask) * fs_weight
    sdf_loss = compute_loss((z_vals + predicted_sdf * truncation) * sdf_mask,
                            target_d * sdf_mask) * sdf_weight
    if emd_w > 0:
        fs_all, sdf_all = emd_terms(z_vals, target_d, front_mask, sdf_mask,
                                    sdf_probT, truncation, cate_num)
        fs_loss = fs_loss + torch.mean(fs_all) / 250.0 * emd_w
        sdf_loss = sdf_loss + torch.mean(sdf_all) / 5000.0 * emd_w
    return fs_loss, sdf_loss


def emd_terms(z_vals, target_d, front_mask, sdf_mask, sdf_probT,
              truncation: float, cate_num: int):
    """The EMD classification terms per sample [B, S] (free space, then
    the truncation band), before their means and scalings."""
    max_class_id = cate_num - 1
    idx = torch.arange(cate_num, dtype=z_vals.dtype,
                       device=z_vals.device)[:, None, None]
    fs_all = sdf_probT * (max_class_id - idx) * front_mask[None]
    gt_class = (((target_d - z_vals) + truncation)
                / (2.0 * truncation)) * max_class_id
    sdf_all = torch.abs(gt_class[None] - idx) * sdf_mask[None] * sdf_probT
    return fs_all.sum(0), sdf_all.sum(0)


# ---------------------------------------------------------------------------
# Cross-submap consistency (the SDF-consistency global BA, ref
# geometry_helper.py:225-236 and InactiveMap.get_SDF_dif :149-192)
# ---------------------------------------------------------------------------

def sdf_consistency_loss(pred_sdf1: torch.Tensor, pred_sdf2: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean squared SDF difference over the valid rays (mask > 0)."""
    loss = torch.sum((pred_sdf1 * mask - pred_sdf2 * mask) ** 2)
    n = torch.count_nonzero(mask).to(pred_sdf1.dtype) + 0.001
    return loss / n


def rgb_consistency_loss(pred_rgb1: torch.Tensor, pred_rgb2: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid rays of the squared per-ray photometric L1;
    rgb [N, 3], mask [N, 1]."""
    per_ray = torch.where(mask[..., 0] > 0,
                          torch.abs(pred_rgb1 - pred_rgb2).sum(-1),
                          torch.zeros((), dtype=pred_rgb1.dtype,
                                      device=pred_rgb1.device))
    n = torch.count_nonzero(mask).to(pred_rgb1.dtype) + 0.001
    return torch.sum(per_ray ** 2) / n


def surface_points_T(rays_d_camT: torch.Tensor, target_d: torch.Tensor,
                     pose: torch.Tensor) -> torch.Tensor:
    """The rays' surface points [3, N] in the frame of ``pose`` (camera to
    that frame): camera directions [3, N] rotated, times the depth [N],
    plus the camera centre."""
    return pose[:3, 3:4] + (pose[:3, :3] @ rays_d_camT) * target_d


def cross_submap_consistency(params1, params2, fcfg, consts1, consts2,
                             rays_d_camT: torch.Tensor,
                             target_d: torch.Tensor, pose_local1,
                             pose_local2, rgb_weight: float = 0.0):
    """SDF (+ optional RGB) consistency of two submaps on shared surface
    points: back-project the rays [3, N] at depths [N] in each submap's
    local frame, query both fields there and penalize the disagreement."""
    from ..models import scene_rep as sr

    def query(params, consts, pose):
        ptsT = surface_points_T(rays_d_camT, target_d, pose)
        return sr.query_color_sdf_T(params, sr.normalize_T(ptsT, consts),
                                    fcfg)

    out1 = query(params1, consts1, pose_local1)
    out2 = query(params2, consts2, pose_local2)
    mask = (target_d > 0).to(out1.dtype)[:, None]
    loss = sdf_consistency_loss(out1[3][:, None], out2[3][:, None], mask)
    if rgb_weight > 0:
        loss = loss + rgb_weight * rgb_consistency_loss(
            out1[:3].T, out2[:3].T, mask)
    return loss

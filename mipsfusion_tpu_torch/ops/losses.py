"""Training losses: free-space / truncation SDF losses + EMD classification.

Port of ``mipsfusion_tpu/ops/losses.py`` (``compute_loss``, ``mse2psnr``,
``get_masks``, ``get_sdf_loss_T``), with the reference's scalings (EMD
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
    max_class_id = cate_num - 1
    front_mask, sdf_mask, fs_weight, sdf_weight = get_masks(
        z_vals, target_d, truncation)
    fs_loss = compute_loss(predicted_sdf * front_mask, front_mask) * fs_weight
    sdf_loss = compute_loss((z_vals + predicted_sdf * truncation) * sdf_mask,
                            target_d * sdf_mask) * sdf_weight
    if emd_w > 0:
        idx = torch.arange(cate_num, dtype=z_vals.dtype,
                           device=z_vals.device)[:, None, None]
        fs_all = sdf_probT * (max_class_id - idx) * front_mask[None]
        fs_loss1 = torch.mean(fs_all.sum(0)) / 250.0
        gt_class = (((target_d - z_vals) + truncation)
                    / (2.0 * truncation)) * max_class_id
        sdf_all = torch.abs(gt_class[None] - idx) * sdf_mask[None] * sdf_probT
        sdf_loss1 = torch.mean(sdf_all.sum(0)) / 5000.0
        fs_loss = fs_loss + fs_loss1 * emd_w
        sdf_loss = sdf_loss + sdf_loss1 * emd_w
    return fs_loss, sdf_loss

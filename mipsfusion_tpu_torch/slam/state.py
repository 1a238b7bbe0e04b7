"""SLAM state: fixed-capacity tables as a dataclass of tensors.

Port of ``mipsfusion_tpu/slam/state.py``. The tables keep the reference's
conventions (keyframe slot k is valid iff k < n_kf; keyframe_ref -1 = the
first keyframe of a submap, >= 0 = ordinary; est_c2w[f] is frame f's pose
in its submap's local frame; kf_c2w[k] is a world anchor). PyTorch
updates them in place; the counters the host decides on (n_kf, the
active submap's first keyframe) are Python ints, so reading them never
waits on the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SlamState:
    kf_rays: torch.Tensor            # [K, R, 7] (direction 3, rgb 3, depth)
    kf_frame_ids: torch.Tensor       # [K] int64, -1 = empty
    kf_c2w: torch.Tensor             # [K, 4, 4] world anchors
    est_c2w: torch.Tensor            # [F, 4, 4] local poses per frame
    est_c2w_rel: torch.Tensor        # [F, 4, 4] pose relative to its keyframe
    keyframe_ref: torch.Tensor       # [K] int64 type codes
    localMLP_info: torch.Tensor      # [M, 7] used, center(3), len(3)
    keyframe_localMLP: torch.Tensor  # [K, 2] int64 submap bindings
    localMLP_first_kf: torch.Tensor  # [M] int64, -1 = unset
    n_kf: int = 0
    active_first_kf: int = 0


def init_state(n_frames: int, n_keyframes: int, n_submaps: int,
               rays_per_kf: int, device=None) -> SlamState:
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    eye = torch.eye(4, **f32)
    return SlamState(
        kf_rays=torch.zeros((n_keyframes, rays_per_kf, 7), **f32),
        kf_frame_ids=torch.full((n_keyframes,), -1, **i64),
        kf_c2w=eye.repeat(n_keyframes, 1, 1),
        est_c2w=eye.repeat(n_frames, 1, 1),
        est_c2w_rel=eye.repeat(n_frames, 1, 1),
        keyframe_ref=torch.zeros((n_keyframes,), **i64),
        localMLP_info=torch.zeros((n_submaps, 7), **f32),
        keyframe_localMLP=torch.full((n_keyframes, 2), -1, **i64),
        localMLP_first_kf=torch.full((n_submaps,), -1, **i64),
    )


def kf_downsample_indices(H: int, W: int, n_rows: int, n_cols: int,
                          device=None):
    """Evenly spaced rows x cols grid of pixel indices (flattened)."""
    rows = torch.linspace(0, H - 1, n_rows, device=device).long()
    cols = torch.linspace(0, W - 1, n_cols, device=device).long()
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def add_keyframe(state: SlamState, frame_rays: torch.Tensor, frame_id: int,
                 row_idx: torch.Tensor, col_idx: torch.Tensor) -> None:
    """Store a downsampled keyframe in slot n_kf (in place)."""
    k = state.n_kf
    state.kf_rays[k] = frame_rays[row_idx, col_idx]
    state.kf_frame_ids[k] = frame_id
    state.n_kf = k + 1


def submap_kf_mask(state: SlamState, submap_id: int) -> torch.Tensor:
    """Bool [K]: valid keyframes bound to the submap (either binding)."""
    K = state.kf_frame_ids.shape[0]
    valid = torch.arange(K, device=state.kf_frame_ids.device) < state.n_kf
    return valid & (state.keyframe_localMLP == submap_id).any(dim=-1)

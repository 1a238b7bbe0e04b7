"""SLAM state: fixed-capacity tables as a dataclass of tensors.

Port of ``mipsfusion_tpu/slam/state.py`` and of the manager's state
mutators (``_msg1_apply``, ``_msg2_apply``, ``_msg3_apply`` of
``mipsfusion_tpu/slam/manager.py``). The tables keep the reference's
conventions (keyframe slot k is valid iff k < n_kf; keyframe_ref -1 = the
first keyframe of a submap, -2 = an overlapping keyframe bound to two
submaps, >= 0 = ordinary; keyframe_localMLP[k] = (first, second) submap
binding, -1 = none; localMLP_info[m] = [used, center(3), len(3)];
est_c2w[f] is frame f's pose in its submap's local frame; kf_c2w[k] is a
world anchor, authoritative for first keyframes). PyTorch updates them in
place. The registers the host decides on (n_kf, the active and previous
submap, the last switch frame) are Python ints, so reading them never
waits on the device; the active submap's first keyframe is a device
scalar, since it is read from the device table localMLP_first_kf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
    localMLP_max_len: torch.Tensor   # [M, 3]
    localMLP_adjacent: torch.Tensor  # [M, M] float 0/1
    keyframe_localMLP: torch.Tensor  # [K, 2] int64 submap bindings
    localMLP_first_kf: torch.Tensor  # [M] int64, -1 = unset
    active_first_kf: torch.Tensor    # [] int64 (kf id)
    n_kf: int = 0
    active_submap_id: int = 0
    prev_active_submap_id: int = -1
    last_switch_frame: int = 0


def init_state(n_frames: int, n_keyframes: int, n_submaps: int,
               rays_per_kf: int, localMLP_max_len, device=None) -> SlamState:
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
        localMLP_max_len=torch.tensor(localMLP_max_len, **f32).expand(
            n_submaps, 3).clone(),
        localMLP_adjacent=torch.zeros((n_submaps, n_submaps), **f32),
        keyframe_localMLP=torch.full((n_keyframes, 2), -1, **i64),
        localMLP_first_kf=torch.full((n_submaps,), -1, **i64),
        active_first_kf=torch.zeros((), **i64),
    )


def kf_downsample_indices(H: int, W: int, n_rows: int, n_cols: int,
                          device=None):
    """Evenly spaced rows x cols grid of pixel indices (flattened)."""
    rows = torch.linspace(0, H - 1, n_rows, device=device).long()
    cols = torch.linspace(0, W - 1, n_cols, device=device).long()
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def make_frame_rays(direction: torch.Tensor, rgb: torch.Tensor,
                    depth: torch.Tensor) -> torch.Tensor:
    """Pack a frame into the ray layout [H, W, 7] = (dir, rgb, depth)."""
    return torch.cat([direction, rgb, depth[..., None]], dim=-1)


def add_keyframe(state: SlamState, frame_rays: torch.Tensor, frame_id: int,
                 row_idx: torch.Tensor, col_idx: torch.Tensor) -> None:
    """Store a downsampled keyframe in slot n_kf (in place)."""
    k = state.n_kf
    state.kf_rays[k] = frame_rays[row_idx, col_idx]
    state.kf_frame_ids[k] = frame_id
    state.n_kf = k + 1


def row(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for a host int i, or for an integer device scalar i as a
    gather: indexing by a 0-d tensor reads it on the host (``x[t]`` is
    ``x[t.item()]``), which waits for the device and cannot be captured
    in a CUDA graph. Both give the same values."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1))[0]
    return x[i]


def submap_kf_mask(state: SlamState, submap_id) -> torch.Tensor:
    """Bool [K]: valid keyframes bound to the submap (either binding).
    ``state.n_kf`` and ``submap_id`` may be device scalars."""
    K = state.kf_frame_ids.shape[0]
    valid = torch.arange(K, device=state.kf_frame_ids.device) < state.n_kf
    return valid & (state.keyframe_localMLP == submap_id).any(dim=-1)


# ---------------------------------------------------------------------------
# The manager's decisions, applied in place. Box centers, lengths and the
# max-length table come from the host (numpy), where the manager computed
# them; the rest stays on the device.
# ---------------------------------------------------------------------------

def to_like(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` (numpy, a list or a tensor) on like's device with its dtype."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def msg1_apply(st: SlamState, kf_id: int, id1: int, id2: int, c1, l1, c2,
               l2, max_len, bind, switch: bool) -> None:
    """Bind keyframe kf_id to two submaps (an overlapping keyframe) and
    grow both boxes; with ``switch``, make id2 the active submap."""
    st.localMLP_info[id1, 1:4] = to_like(c1, st.localMLP_info)
    st.localMLP_info[id1, 4:7] = to_like(l1, st.localMLP_info)
    st.localMLP_info[id2, 1:4] = to_like(c2, st.localMLP_info)
    st.localMLP_info[id2, 4:7] = to_like(l2, st.localMLP_info)
    st.localMLP_max_len.copy_(to_like(max_len, st.localMLP_max_len))
    st.keyframe_localMLP[kf_id] = to_like(bind, st.keyframe_localMLP)
    st.localMLP_adjacent[id1, id2] = 1.0
    st.localMLP_adjacent[id2, id1] = 1.0
    st.keyframe_ref[kf_id] = -2
    if switch:
        st.prev_active_submap_id = st.active_submap_id
        st.active_submap_id = int(id2)
        st.active_first_kf = st.localMLP_first_kf[id2].clone()


def msg2_apply(st: SlamState, kf_id: int, submap_id: int, c, ln) -> None:
    """Bind keyframe kf_id to one submap and grow its box."""
    st.localMLP_info[submap_id, 1:4] = to_like(c, st.localMLP_info)
    st.localMLP_info[submap_id, 4:7] = to_like(ln, st.localMLP_info)
    st.keyframe_localMLP[kf_id, 0] = submap_id


def msg3_apply(st: SlamState, kf_id: int, frame_id: int, new_id: int,
               active_id: int, kf_center, kf_len, pose_world) -> None:
    """Create submap new_id with keyframe kf_id as its first keyframe (its
    world pose the anchor, its local pose the identity) and make it the
    active submap."""
    M = st.localMLP_info.shape[0]
    if not 0 <= new_id < M:
        raise RuntimeError(f"submap capacity mapping.localMLP_num = {M} "
                           "is exhausted")
    st.localMLP_info[new_id] = to_like(
        np.concatenate([[1.0], np.asarray(kf_center), np.asarray(kf_len)]),
        st.localMLP_info)
    st.localMLP_first_kf[new_id] = kf_id
    st.keyframe_localMLP[kf_id, 0] = new_id
    st.keyframe_localMLP[kf_id, 1] = active_id
    st.localMLP_adjacent[active_id, new_id] = 1.0
    st.localMLP_adjacent[new_id, active_id] = 1.0
    st.prev_active_submap_id = st.active_submap_id
    st.active_submap_id = int(new_id)
    st.active_first_kf = torch.full_like(st.active_first_kf, kf_id)
    st.keyframe_ref[kf_id] = -1
    st.kf_c2w[kf_id] = to_like(pose_world, st.kf_c2w)
    st.est_c2w[frame_id] = torch.eye(4, device=st.est_c2w.device)

"""Reconstruction quality metrics: the port of ``mipsfusion_tpu/eval/recon.py``.

  * ``mesh_accuracy_vs_sdf``: mean |SDF| of mesh vertices under an
    analytic ground-truth SDF (exact for the synthetic scenes);
  * ``mesh_completion``: fraction of ground-truth surface samples within
    ``tau`` of a mesh vertex;
  * ``mesh_error_split``: where a synthetic mesh's error sits (behind the
    room's walls or inside it);
  * ``depth_l1``: re-rendered depth error against ground-truth frames.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def mesh_accuracy_vs_sdf(verts: np.ndarray,
                         sdf_fn: Callable[[np.ndarray], np.ndarray]
                         ) -> float:
    """Mean |sdf| over mesh vertices (meters)."""
    if len(verts) == 0:
        return float("inf")
    d = np.abs(np.asarray(sdf_fn(verts)))
    return float(d.mean())


def mesh_completion(gt_points: np.ndarray, verts: np.ndarray,
                    tau: float = 0.05) -> float:
    """Fraction of GT surface points with a mesh vertex within tau
    (k-d tree nearest neighbour)."""
    if len(verts) == 0 or len(gt_points) == 0:
        return 0.0
    from scipy.spatial import cKDTree
    d, _ = cKDTree(verts).query(gt_points, k=1,
                                distance_upper_bound=tau * 1.001)
    return float((d < tau).mean())


def mesh_error_split(verts: np.ndarray, room_half,
                     tau: float = 0.05) -> Dict[str, float]:
    """Where a synthetic mesh's accuracy error sits: the share of
    vertices outside the room's box (behind its walls), the accuracy
    (mean |SDF|) of those inside, and the share farther than ``tau`` from
    the surface with their mean |SDF| (meters)."""
    import torch
    from ..datasets.synthetic import props_on, scene_sdf
    half = torch.as_tensor(room_half, dtype=torch.float32).cpu()
    d = np.abs(scene_sdf(torch.as_tensor(np.asarray(verts),
                                         dtype=torch.float32),
                         half, props_on("cpu")).numpy())
    inside = (np.abs(verts) < half.numpy()).all(axis=1)
    far = d > tau
    return {"outside_share": float(1.0 - inside.mean()),
            "inside_accuracy_m": float(d[inside].mean()) if inside.any()
            else float("inf"),
            "far_share": float(far.mean()),
            "far_mean_m": float(d[far].mean()) if far.any() else 0.0}


def depth_l1(pred_depth: np.ndarray, gt_depth: np.ndarray) -> float:
    """Mean |depth error| over valid GT pixels (meters)."""
    valid = gt_depth > 0
    if not valid.any():
        return 0.0
    return float(np.abs(pred_depth - gt_depth)[valid].mean())


def evaluate_synthetic_mesh(slam, n_gt_samples: int = 20000,
                            seed: int = 0, verts=None,
                            room_half=None) -> Dict[str, float]:
    """Mesh accuracy and completion against the synthetic dataset's
    analytic SDF (``datasets/synthetic.scene_sdf``, evaluated in float32 on
    the CPU). Pass ``verts`` to score an already-extracted mesh instead of
    extracting one, and ``room_half`` for a run whose dataset is not the
    synthetic one (the scene read back from files). Completion counts only
    the ground-truth samples a keyframe saw, with the mesher's own
    visibility test."""
    import torch
    from ..datasets.synthetic import props_on, scene_sdf
    from ..mesher.mesher import point_seen_mask

    ds = slam.dataset
    room_half = torch.as_tensor(
        ds.room_half if room_half is None else room_half).detach().cpu()
    props = props_on("cpu")
    if verts is None:
        verts, _faces, _ = slam.extract_mesh(joint=True)

    def sdf_fn(pts):
        return scene_sdf(torch.as_tensor(np.asarray(pts),
                                         dtype=torch.float32),
                         room_half, props).numpy()

    acc = mesh_accuracy_vs_sdf(verts, sdf_fn)

    # GT surface samples: random points projected to the surface along
    # the SDF gradient
    rng = np.random.default_rng(seed)
    half = room_half.numpy()
    pts = rng.uniform(-half * 0.98, half * 0.98,
                      (n_gt_samples, 3)).astype(np.float32)
    eps = 1e-3
    for _ in range(3):
        d = np.asarray(sdf_fn(pts))[:, None]
        grad = np.stack([
            np.asarray(sdf_fn(pts + np.array(o, np.float32) * eps))
            - np.asarray(sdf_fn(pts - np.array(o, np.float32) * eps))
            for o in ((1, 0, 0), (0, 1, 0), (0, 0, 1))], axis=-1) / (2 * eps)
        norm = np.linalg.norm(grad, axis=-1, keepdims=True) + 1e-9
        pts = pts - d * grad / norm
    on_surface = np.abs(np.asarray(sdf_fn(pts))) < 5e-3
    gt_pts = pts[on_surface]

    st = slam.state
    n_kf = int(st.n_kf)
    if n_kf and len(gt_pts):
        kf_world = slam._kf_world_poses(np.arange(n_kf)).cpu().numpy()
        kf_max_d = st.kf_rays[:n_kf, :, 6].amax(dim=1).cpu().numpy()
        K_mat = np.asarray([[ds.fx, 0.0, ds.cx], [0.0, ds.fy, ds.cy],
                            [0.0, 0.0, 1.0]])
        seen = point_seen_mask(gt_pts, kf_world, K_mat, slam.H, slam.W,
                               kf_max_d)
        observed_frac = float(seen.mean())
        gt_pts = gt_pts[seen]
    else:
        observed_frac = 1.0

    comp = mesh_completion(gt_pts, verts, tau=0.05)
    return {"mesh_accuracy_m": acc, "mesh_completion@5cm": comp,
            "gt_observed_frac": observed_frac,
            "n_vertices": int(len(verts))}

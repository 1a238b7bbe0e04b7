"""TUM-style absolute trajectory error (ATE) with Horn alignment.

The port's copy of ``mipsfusion_tpu/eval/ate.py`` (``align_horn``,
``evaluate_ate``, ``pose_evaluation``, ``save_traj_tum``): closed-form SE(3) alignment of the
estimated trajectory onto GT (Horn 1987, unit scale), then translational
RMSE/mean/median over matched frames. Frames whose GT pose contains
NaN/Inf are masked out.

Numpy on the host, off the hot path (the TUM writer's quaternions come
from the port's float32 ``matrix_to_quaternion`` on the CPU, as the JAX
writer's come from its float32 one).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """Align two trajectories by closed-form rigid registration.

    model, data: [3, N] point sets (est, gt). Returns (rot [3,3],
    trans [3,1], trans_error [N]) such that rot @ model + trans ~= data.
    """
    model_zc = model - model.mean(axis=1, keepdims=True)
    data_zc = data - data.mean(axis=1, keepdims=True)

    W = np.zeros((3, 3))
    for column in range(model.shape[1]):
        W += np.outer(model_zc[:, column], data_zc[:, column])
    U, _, Vh = np.linalg.svd(W.transpose())
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(axis=1, keepdims=True) - rot @ model.mean(
        axis=1, keepdims=True)

    model_aligned = rot @ model + trans
    alignment_error = model_aligned - data
    trans_error = np.sqrt(np.sum(alignment_error ** 2, axis=0))
    return rot, trans, trans_error


def evaluate_ate(gt_traj: np.ndarray, est_traj: np.ndarray) -> Dict:
    """ATE stats between matched trajectories [N, 3] translations."""
    rot, trans, trans_error = align_horn(est_traj.T, gt_traj.T)
    return {
        "compared_pose_pairs": len(trans_error),
        "absolute_translational_error.rmse":
            float(np.sqrt(np.mean(trans_error ** 2))),
        "absolute_translational_error.mean": float(np.mean(trans_error)),
        "absolute_translational_error.median": float(np.median(trans_error)),
        "absolute_translational_error.std": float(np.std(trans_error)),
        "absolute_translational_error.min": float(np.min(trans_error)),
        "absolute_translational_error.max": float(np.max(trans_error)),
    }


def pose_evaluation(poses_gt: np.ndarray, poses_est: np.ndarray,
                    output_dir: str = None, tag: str = "final") -> Dict:
    """Evaluate 4x4 pose arrays [N,4,4]; masks non-finite GT entries."""
    poses_gt = np.asarray(poses_gt)
    poses_est = np.asarray(poses_est)
    n = min(len(poses_gt), len(poses_est))
    poses_gt, poses_est = poses_gt[:n], poses_est[:n]
    mask = np.isfinite(poses_gt.reshape(n, -1)).all(axis=1)
    gt_t = poses_gt[mask][:, :3, 3]
    est_t = poses_est[mask][:, :3, 3]
    results = evaluate_ate(gt_t, est_t)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, f"ate_{tag}.txt"), "w") as f:
            for k, v in results.items():
                f.write(f"{k}: {v}\n")
    return results


def save_traj_tum(poses: np.ndarray, path: str) -> None:
    """Write [N,4,4] poses as TUM lines: t tx ty tz qx qy qz qw."""
    import torch
    from ..ops.geometry import matrix_to_quaternion

    quats = matrix_to_quaternion(torch.as_tensor(
        np.asarray(poses[:, :3, :3]), dtype=torch.float32)).numpy()
    with open(path, "w") as f:
        for i, (pose, q) in enumerate(zip(poses, quats)):
            t = pose[:3, 3]
            # TUM order: qx qy qz qw (real-last)
            f.write(f"{i} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")

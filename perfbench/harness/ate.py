"""Horn-aligned absolute trajectory error: a frozen copy of the port's
``eval/ate.py`` (``align_horn``, ``evaluate_ate``), numpy on the host."""

from __future__ import annotations

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """Closed-form rigid alignment of [3, N] ``model`` onto ``data``:
    (rot [3, 3], trans [3, 1], per-point error [N])."""
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
    err = rot @ model + trans - data
    return rot, trans, np.sqrt(np.sum(err ** 2, axis=0))


def ate_rmse(gt_poses: np.ndarray, est_poses: np.ndarray) -> float:
    """RMSE (m) of the estimated [N, 4, 4] positions after Horn alignment
    onto the ground truth's; frames with a non-finite pose on either side
    are left out."""
    gt = np.asarray(gt_poses, np.float64)
    est = np.asarray(est_poses, np.float64)
    n = len(gt)
    ok = (np.isfinite(gt.reshape(n, -1)).all(1)
          & np.isfinite(est.reshape(n, -1)).all(1))
    _, _, e = align_horn(est[ok][:, :3, 3].T, gt[ok][:, :3, 3].T)
    return float(np.sqrt(np.mean(e ** 2)))

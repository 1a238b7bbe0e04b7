"""Point-to-plane and point-to-point ICP (loop-closure pose rectification).

Port of ``mipsfusion_tpu/slam/icp.py``: normals by k-nearest-neighbour PCA
(one batched 3x3 ``eigh``), brute-force nearest neighbours over the full
[N, M] distance matrix (the clouds are a few thousand subsampled keyframe
points), and a fixed number of Gauss-Newton steps with masked
correspondences, undamped unless asked. The outputs mirror the open3d
contract the reference consumes: the rigid transform and the count of
inliers within the threshold.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.geometry import se3_exp


def _sq_dists(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[N, M] squared distances as differences (no |p|^2 + |q|^2 - 2 p.q
    cancellation, so nearest neighbours match the reference's choice)."""
    return ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)


def estimate_normals(pts: torch.Tensor, k: int = 10) -> torch.Tensor:
    """Per-point normals [N, 3] (up to sign) via k-NN PCA of pts [N, 3]."""
    idx = torch.topk(_sq_dists(pts, pts), k, dim=-1, largest=False).indices
    nbrs = pts[idx]                                         # [N, k, 3]
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered)
    # the eigenvector of the smallest eigenvalue is the plane normal
    return torch.linalg.eigh(cov).eigenvectors[:, :, 0]


class ICPResult(NamedTuple):
    transform: torch.Tensor      # [4, 4] src -> dst
    n_inliers: torch.Tensor      # [] int64
    rmse: torch.Tensor           # []


def _nearest(p, dst, dst_valid):
    d2 = _sq_dists(p, dst)
    d2 = torch.where(dst_valid[None, :], d2, torch.full_like(d2, 1e10))
    dmin2, j = d2.min(dim=-1)
    return j, torch.sqrt(dmin2)


def _inlier_stats(T, src, src_valid, dst, dst_valid, threshold) -> ICPResult:
    p = src @ T[:3, :3].T + T[:3, 3]
    _, dmin = _nearest(p, dst, dst_valid)
    inlier = src_valid & (dmin < threshold)
    n_in = inlier.sum()
    rmse = torch.sqrt(torch.where(inlier, dmin ** 2, torch.zeros_like(dmin))
                      .sum() / torch.clamp(n_in, min=1))
    return ICPResult(transform=T, n_inliers=n_in, rmse=rmse)


def icp_point_to_plane(src: torch.Tensor, src_valid: torch.Tensor,
                       dst: torch.Tensor, dst_valid: torch.Tensor,
                       dst_normals: torch.Tensor, threshold: float,
                       n_iters: int = 20,
                       rel_damping: float = 0.0) -> ICPResult:
    """Register src [N, 3] onto dst [M, 3] minimizing the point-to-plane
    error over nearest-neighbour correspondences within ``threshold``.
    The residual does not depend on a normal's sign.

    ``rel_damping`` > 0 adds Tikhonov damping relative to the normal
    equations' own scale (lambda = rel_damping * tr(H) / 6), as the JAX
    function's argument of that name: a direction the correspondences
    barely constrain (sliding along the scene's dominant planes) then
    takes almost no step instead of wandering on noise."""
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    for _ in range(n_iters):
        p = src @ T[:3, :3].T + T[:3, 3]
        j, dmin = _nearest(p, dst, dst_valid)
        w = (src_valid & (dmin < threshold)).to(src.dtype)
        n = dst_normals[j]
        r = ((p - dst[j]) * n).sum(-1)
        J = torch.cat([n, torch.linalg.cross(p, n)], dim=-1)     # [N, 6]
        Jw = J * w[:, None]
        H = Jw.T @ J
        H = H + (1e-6 + rel_damping * torch.trace(H) / 6.0) * eye6
        xi = -torch.linalg.solve(H, Jw.T @ r)
        T = se3_exp(xi) @ T
    return _inlier_stats(T, src, src_valid, dst, dst_valid, threshold)


def backproject_rays(rays: torch.Tensor, poses: torch.Tensor,
                     pose_idx: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """rays [N, 7] (dir, rgb, depth), poses [K, 4, 4] and a pose index per
    ray -> (points [N, 3], valid [N])."""
    T = poses[pose_idx]
    d = rays[:, 6:7]
    dirs = torch.einsum("nj,nij->ni", rays[:, :3], T[:, :3, :3])
    return T[:, :3, 3] + dirs * d, d[:, 0] > 0.0


def svd_transform(src: torch.Tensor, dst: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Weighted closed-form rigid transform src -> dst (Kabsch)."""
    w = weights / (weights.sum() + 1e-12)
    cs = (src * w[:, None]).sum(0)
    cd = (dst * w[:, None]).sum(0)
    H = ((src - cs) * w[:, None]).T @ (dst - cd)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    R = Vt.T @ D @ U.T
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


def icp_point_to_point(src: torch.Tensor, src_valid: torch.Tensor,
                       dst: torch.Tensor, dst_valid: torch.Tensor,
                       threshold: float, n_iters: int = 20) -> ICPResult:
    """Nearest-neighbour + Kabsch ICP (point-to-point); correspondences
    beyond ``threshold`` get weight 0."""
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    for _ in range(n_iters):
        p = src @ T[:3, :3].T + T[:3, 3]
        j, dmin = _nearest(p, dst, dst_valid)
        w = (src_valid & (dmin < threshold)).to(src.dtype)
        T = svd_transform(p, dst[j], w) @ T
    return _inlier_stats(T, src, src_valid, dst, dst_valid, threshold)

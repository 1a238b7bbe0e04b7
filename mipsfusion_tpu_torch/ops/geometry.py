"""SE(3) / quaternion geometry and camera rays in float32.

Port of ``mipsfusion_tpu/ops/geometry.py``. Quaternions are real-first
[w, x, y, z]. Matmuls run in full float32: the package turns TF32 off
(``mipsfusion_tpu_torch/__init__.py``), the counterpart of the
reference's ``Precision.HIGHEST`` pose-math rule.
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) [..., 4] (wxyz, normalized internally) -> [..., 3, 3]."""
    q = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> quaternions [..., 4] (wxyz), by the
    four-branch construction with a nonnegative real part."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1), min=0.0))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    cands = cands / (2.0 * torch.clamp(q_abs, min=0.1))[..., None]
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    quat = torch.gather(cands, -2, idx)[..., 0, :]
    return torch.where(quat[..., 0:1] < 0, -quat, quat)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """The rows [0, 0, 0, 1] under top [..., 3, 4], made on its device
    (an element set from a Python number would copy from the host, which
    a CUDA graph cannot capture)."""
    row = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return row.expand(top.shape[:-2] + (1, 4))


def qt_to_matrix(rot_quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[..., 4] quaternion + [..., 3] translation -> [..., 4, 4] SE3."""
    R = quaternion_to_matrix(rot_quat)
    top = torch.cat([R, trans[..., :, None]], dim=-1)            # [..., 3, 4]
    return torch.cat([top, _bottom_row(top)], dim=-2)


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    """Invert SE3 matrices [..., 4, 4] using the rigid structure."""
    R_T = T[..., :3, :3].transpose(-1, -2)
    t = -(R_T @ T[..., :3, 3:])
    top = torch.cat([R_T, t], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exp map from twist [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-10
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    wx = _skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(wx.shape)
    wx2 = phi[..., :, None] * phi[..., None, :] - theta2[..., None, None] * eye
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2_safe)
    R = eye + A[..., None, None] * wx + B[..., None, None] * wx2
    V = eye + B[..., None, None] * wx + C[..., None, None] * wx2
    t = (V @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map -> twist [..., 6] (rho, phi). Safe near identity."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w_hat = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                         R[..., 0, 2] - R[..., 2, 0],
                         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w2 = torch.sum(w_hat * w_hat, dim=-1)
    small = w2 < 1e-10
    one = torch.ones_like(w2)
    sin_theta = torch.where(small, torch.zeros_like(w2),
                            0.5 * torch.sqrt(torch.where(small, one, w2)))
    theta = torch.atan2(sin_theta, cos_theta)
    sin_safe = torch.where(small, one, sin_theta)
    scale = torch.where(small, 0.5 + theta ** 2 / 12.0,
                        theta / (2.0 * sin_safe))
    phi = w_hat * scale[..., None]
    wx = _skew(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta2_safe = torch.where(small, one, theta2)
    th = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - (th * torch.cos(th / 2.0))
                     / (2.0 * torch.sin(th / 2.0))) / theta2_safe)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(wx.shape)
    V_inv = eye - 0.5 * wx + A[..., None, None] * (wx @ wx)
    rho = (V_inv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def get_camera_rays(H: int, W: int, fx: float, fy: float, cx: float,
                    cy: float, device=None,
                    convention: str = "OpenGL") -> torch.Tensor:
    """Per-pixel camera-frame ray directions [H, W, 3] (OpenGL: +x right,
    +y up, looking down -z)."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    if convention == "OpenGL":
        return torch.stack([(i - cx) / fx, -(j - cy) / fy,
                            -torch.ones_like(i)], dim=-1)
    if convention == "OpenCV":
        return torch.stack([(i - cx) / fx, (j - cy) / fy,
                            torch.ones_like(i)], dim=-1)
    raise NotImplementedError(convention)


def get_frame_surface_bbox(c2w: torch.Tensor, depth: torch.Tensor,
                           rays_d_cam: torch.Tensor, dist_near: float,
                           dist_far: float):
    """Axis-aligned bbox (center, length) of a frame's back-projected
    surface; depths outside (near, far) are excluded."""
    d = depth.reshape(-1, 1)
    dirs = rays_d_cam.reshape(-1, 3)
    pts = c2w[:3, 3] + (dirs @ c2w[:3, :3].T) * d
    valid = ((d[:, 0] > dist_near) & (d[:, 0] < dist_far))[:, None]
    xyz_max = torch.where(valid, pts, -1e10).amax(dim=0)
    xyz_min = torch.where(valid, pts, 1e10).amin(dim=0)
    any_valid = valid.any()
    xyz_max = torch.where(any_valid, xyz_max, torch.zeros_like(xyz_max))
    xyz_min = torch.where(any_valid, xyz_min, torch.zeros_like(xyz_min))
    xyz_len = xyz_max - xyz_min
    return xyz_min + 0.5 * xyz_len, xyz_len


def rays_to_world(rays_d_cam: torch.Tensor, c2w: torch.Tensor):
    """Rotate camera-frame ray dirs [N, 3] by c2w [4, 4]; returns
    (rays_o, rays_d)."""
    rays_d = rays_d_cam @ c2w[:3, :3].T
    return c2w[:3, 3].expand_as(rays_d), rays_d


def pts_in_bbox(pts: torch.Tensor, xyz_min: torch.Tensor,
                xyz_max: torch.Tensor) -> torch.Tensor:
    """Strict containment of pts [N, 3] in boxes [M, 3] -> bool [N, M]."""
    return ((pts[:, None, :] > xyz_min[None]).all(-1)
            & (pts[:, None, :] < xyz_max[None]).all(-1))


def project_to_pixel(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] (OpenGL) -> pixel coords [..., 2]:
    x is flipped before K is applied."""
    flipped = torch.cat([-pts_cam[..., :1], pts_cam[..., 1:]], dim=-1)
    uvw = flipped @ K.T
    return uvw[..., :2] / (uvw[..., 2:3] + 1e-5)

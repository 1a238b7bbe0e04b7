"""Procedural synthetic RGB-D sequence: an analytic box room with props.

Port of ``mipsfusion_tpu/datasets/synthetic.py`` (the classic prop scene
and the ``orbit``, ``corridor`` and ``outback`` trajectories). Frames are
rendered on the port's device by sphere-tracing the analytic SDF along the
OpenGL pixel rays; depth and the procedural albedo are exact, so ATE has a
clean ground truth. The other trajectories, the tiled prop field and the
sensor-noise model are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.geometry import get_camera_rays


def _sd_box(p: torch.Tensor, center, half) -> torch.Tensor:
    q = torch.abs(p - center) - half
    return (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
            + torch.clamp(q.amax(dim=-1), max=0.0))


def _sd_sphere(p: torch.Tensor, center, r: float) -> torch.Tensor:
    return torch.linalg.norm(p - center, dim=-1) - r


def _sd_box_rot(p: torch.Tensor, center, half, yaw: float) -> torch.Tensor:
    """Box rotated by ``yaw`` about +y."""
    c, s = float(np.cos(yaw)), float(np.sin(yaw))
    q = p - center
    qr = torch.stack([c * q[..., 0] - s * q[..., 2], q[..., 1],
                      s * q[..., 0] + c * q[..., 2]], dim=-1)
    return _sd_box(qr, 0.0, half)


# (kind, center, half extent or radius, yaw) of the classic props
_PROPS = (
    ("box", (1.2, -0.8, -1.0), (0.5, 0.5, 0.5), 0.6),
    ("box", (-1.5, 0.6, 1.2), (0.4, 0.9, 0.4), -0.8),
    ("sphere", (0.3, 1.0, 0.8), 0.55, 0.0),
    ("box", (-0.2, -1.4, 0.2), (0.9, 0.25, 0.6), 0.35),
    ("sphere", (-1.8, -1.2, -1.4), 0.5, 0.0),
    ("box", (1.8, 1.2, 1.5), (0.45, 0.6, 0.3), -0.4),
)


def props_on(device) -> list:
    """The props with centers and box extents as tensors on ``device``."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return [(kind, t(c), t(h) if kind == "box" else h, yaw)
            for kind, c, h, yaw in _PROPS]


def scene_sdf(p: torch.Tensor, room_half: torch.Tensor,
              props: list) -> torch.Tensor:
    """SDF of the scene (negative inside solid matter); ``props`` from
    ``props_on``."""
    d = -_sd_box(p, 0.0, room_half)
    for kind, c, h, yaw in props:
        if kind == "box":
            d = torch.minimum(d, _sd_box_rot(p, c, h, yaw))
        else:
            d = torch.minimum(d, _sd_sphere(p, c, h))
    return d


def scene_albedo(p: torch.Tensor) -> torch.Tensor:
    """Procedural color in [0,1]^3: smooth base + two higher octaves."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    base = torch.stack([torch.sin(1.7 * x + 0.5 * y),
                        torch.sin(1.3 * y + 0.7 * z + 2.0),
                        torch.sin(1.1 * z + 0.9 * x + 4.0)], dim=-1)
    mid = torch.stack([torch.sin(7.9 * x + 5.3 * z),
                       torch.sin(6.7 * y + 7.1 * x + 1.0),
                       torch.sin(7.3 * z + 6.1 * y + 3.0)], dim=-1)
    fine = torch.stack([torch.sin(24.0 * x + 19.0 * y + 1.3),
                        torch.sin(21.0 * y + 23.0 * z + 4.1),
                        torch.sin(26.0 * z + 20.0 * x + 2.2)], dim=-1)
    return 0.5 + 0.3 * base + 0.14 * mid + 0.06 * fine


def raycast(rays_o: torch.Tensor, rays_d: torch.Tensor,
            room_half: torch.Tensor, props: list, far: float,
            n_steps: int = 96):
    """Sphere-trace [N, 3] rays -> (distance [N], hit mask [N])."""
    t = torch.full(rays_o.shape[:1], 1e-3, dtype=rays_o.dtype,
                   device=rays_o.device)
    done = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(n_steps):
        d = scene_sdf(rays_o + rays_d * t[:, None], room_half, props)
        done = done | (torch.abs(d) < 1e-3)
        t = torch.where(done, t, t + torch.clamp(d, 1e-3, 0.5))
    valid = done & (t < far)
    return torch.where(valid, t, torch.zeros_like(t)), valid


def trajectory_pose(trajectory: str, i: int, n_frames: int,
                    span: float) -> np.ndarray:
    """c2w of frame i (yaw about +y; the OpenGL camera looks along -z):
    ``orbit``, a slow yaw sweep from near the room center; ``corridor``,
    a translation along x while yawing; ``outback``, straight out along
    +x and back along the same path with the same heading, so the return
    leg revisits the starting views."""
    t = span * i / max(n_frames - 1, 1)
    if trajectory == "orbit":
        ang = 0.9 * np.sin(2 * np.pi * t)
        pos = np.array([0.8 * np.sin(2 * np.pi * t),
                        0.3 * np.sin(4 * np.pi * t),
                        0.5 * np.cos(2 * np.pi * t)])
    elif trajectory == "corridor":
        ang = 0.3 * np.sin(2 * np.pi * t)
        pos = np.array([-2.0 + 4.0 * t, 0.2 * np.sin(2 * np.pi * t), 0.0])
    elif trajectory == "outback":
        tri = 1.0 - abs(2.0 * t - 1.0)   # 0 -> 1 -> 0
        ang = 0.25 * np.sin(2 * np.pi * t)
        pos = np.array([2.4 * tri, 0.15 * np.sin(4 * np.pi * t), 0.0])
    else:
        raise NotImplementedError(
            f"trajectory {trajectory!r}: the port has orbit, corridor and "
            "outback")
    c, s = np.cos(ang), np.sin(ang)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    c2w[:3, 3] = pos
    return c2w


class SyntheticDataset:
    """Frames rendered on ``device`` (None: the card; ``"cpu"`` for a CPU
    run): ``packed(i)`` is [H, W, 7] = (direction, rgb, depth), cached;
    ``gt_pose(i)`` the numpy c2w."""

    def __init__(self, cfg: Dict, n_frames: int = 200,
                 trajectory: str = "orbit", span: float = 1.0, device=None):
        cam = cfg["cam"]
        ds = cfg["data"].get("downsample", 1)
        self.H, self.W = cam["H"] // ds, cam["W"] // ds
        self.fx, self.fy = cam["fx"] / ds, cam["fy"] / ds
        self.cx, self.cy = cam["cx"] / ds, cam["cy"] / ds
        self.far = cam["far"]
        self.num_frames = n_frames
        self.device = resolve_device(device)
        syn = cfg.get("synthetic", {})
        if syn.get("props", "classic") != "classic" or syn.get("noise"):
            raise NotImplementedError(
                "synthetic.props other than 'classic' and synthetic.noise "
                "are not ported")
        self.room_half = torch.tensor(syn.get("room_half", [3.0, 2.2, 2.5]),
                                      dtype=torch.float32, device=self.device)
        self.props = props_on(self.device)
        self.rays_d = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                      self.cx, self.cy, device=self.device)
        self.poses = [trajectory_pose(trajectory, i, n_frames, span)
                      for i in range(n_frames)]
        self._cache: Dict[int, torch.Tensor] = {}

    def gt_pose(self, index: int) -> np.ndarray:
        return self.poses[index]

    def render(self, c2w: torch.Tensor) -> torch.Tensor:
        dirs = self.rays_d.reshape(-1, 3)            # OpenGL dirs, dz = -1
        norms = torch.linalg.norm(dirs, dim=-1)
        rays_d_w = dirs @ c2w[:3, :3].T
        unit_d = rays_d_w / norms[:, None]
        rays_o = c2w[:3, 3].expand_as(rays_d_w)
        s, valid = raycast(rays_o, unit_d, self.room_half, self.props,
                           self.far * 2.0)
        pts = rays_o + unit_d * s[:, None]
        rgb = torch.where(valid[:, None], scene_albedo(pts),
                          torch.zeros_like(pts))
        # z-depth: pts = o + dirs * depth with |dir_z| = 1
        depth = s / norms
        depth = torch.where(valid & (depth < self.far), depth,
                            torch.zeros_like(depth))
        return torch.cat([self.rays_d, rgb.reshape(self.H, self.W, 3),
                          depth.reshape(self.H, self.W, 1)], dim=-1)

    def packed(self, index: int) -> torch.Tensor:
        if index not in self._cache:
            c2w = torch.as_tensor(self.poses[index], device=self.device)
            self._cache[index] = self.render(c2w)
        return self._cache[index]

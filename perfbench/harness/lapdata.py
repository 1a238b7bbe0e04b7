"""The benchmark's frames: a frozen copy of the synthetic scenes, the
camera paths and the sphere-tracing renderer, and the lap stream.

Copied from the port's ``datasets/synthetic.py`` (``scene_sdf``,
``scene_sdf_tiled``, ``scene_albedo``, ``raycast``, ``render_many``,
``trajectory_pose``) and ``ops/geometry.get_camera_rays`` when the
benchmark was written, so that the yardstick's frames do not move with
the program. Plain torch, on the device the stream is given.

A trajectory is made periodic by t -> frac(t): frame i of the stream is
lap frame i mod L, at t = (i mod L) / L. ``outback`` and ``snake`` return
to their start at t = 1, so the path is continuous across the seam. One
lap is rendered once; with no sensor noise the frames of every lap are
the same bits.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _sd_box(p, center, half):
    q = torch.abs(p - center) - half
    return (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
            + torch.clamp(q.amax(dim=-1), max=0.0))


def _sd_sphere(p, center, r: float):
    return torch.linalg.norm(p - center, dim=-1) - r


def _sd_box_rot(p, center, half, yaw: float):
    """Box rotated by ``yaw`` about +y."""
    c, s = float(np.cos(yaw)), float(np.sin(yaw))
    q = p - center
    qr = torch.stack([c * q[..., 0] - s * q[..., 2], q[..., 1],
                      s * q[..., 0] + c * q[..., 2]], dim=-1)
    return _sd_box(qr, 0.0, half)


# (kind, center, half extent or radius, yaw) of the classic room's props
_PROPS = (
    ("box", (1.2, -0.8, -1.0), (0.5, 0.5, 0.5), 0.6),
    ("box", (-1.5, 0.6, 1.2), (0.4, 0.9, 0.4), -0.8),
    ("sphere", (0.3, 1.0, 0.8), 0.55, 0.0),
    ("box", (-0.2, -1.4, 0.2), (0.9, 0.25, 0.6), 0.35),
    ("sphere", (-1.8, -1.2, -1.4), 0.5, 0.0),
    ("box", (1.8, 1.2, 1.5), (0.45, 0.6, 0.3), -0.4),
)


def props_on(device) -> list:
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return [(kind, t(c), t(h) if kind == "box" else h, yaw)
            for kind, c, h, yaw in _PROPS]


def scene_sdf(p, room_half, props):
    """The classic room: walls and six props (negative inside matter)."""
    d = -_sd_box(p, 0.0, room_half)
    for kind, c, h, yaw in props:
        if kind == "box":
            d = torch.minimum(d, _sd_box_rot(p, c, h, yaw))
        else:
            d = torch.minimum(d, _sd_sphere(p, c, h))
    return d


# the tiled prop field's cells (i, j) for |i|, |j| < _CELLS, 2.4 m each
_CELLS = 64


def cell_hash_table() -> np.ndarray:
    """[2 _CELLS, 2 _CELLS, 4] float32 jitter in [-1, 1) of every cell:
    2 frac(v) - 1, v = sinf(fma(i, 12.9898, j 78.233) + k 37.719) *
    43758.5453, with the C library's ``sinf`` (the hash scales the sine
    by 4.4e4, so it is evaluated on the host, the same on every card)."""
    import ctypes
    import ctypes.util
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.sinf.restype = ctypes.c_float
    libm.sinf.argtypes = [ctypes.c_float]
    f32 = np.float32
    c = np.arange(-_CELLS, _CELLS, dtype=f32)
    ci, cj = np.meshgrid(c, c, indexing="ij")
    fused = (ci.astype(np.float64) * np.float64(f32(12.9898))
             + (cj * f32(78.233)).astype(np.float64)).astype(f32)
    out = np.empty(ci.shape + (4,), f32)
    for k in range(4):
        arg = (fused + f32((k + 1) * 37.719)).ravel()
        sin = np.fromiter((libm.sinf(float(x)) for x in arg), f32, arg.size)
        v = sin.reshape(ci.shape) * f32(43758.5453)
        out[..., k] = f32(2.0) * (v - np.floor(v)) - f32(1.0)
    return out


def scene_sdf_tiled(p, room_half, table):
    """The large room: walls and a floor box and a floating sphere in
    every 2.4 m cell, jittered by ``table`` (``cell_hash_table`` on the
    points' device)."""
    d_room = -_sd_box(p, 0.0, room_half)
    cell = 2.4
    ci = torch.floor(p[..., 0] / cell)
    cj = torch.floor(p[..., 2] / cell)
    hij = table[torch.clamp(ci.long() + _CELLS, 0, 2 * _CELLS - 1),
                torch.clamp(cj.long() + _CELLS, 0, 2 * _CELLS - 1)]
    q = torch.stack([p[..., 0] - (ci + 0.5) * cell, p[..., 1],
                     p[..., 2] - (cj + 0.5) * cell], dim=-1)
    jx, jz, jy = 0.45 * hij[..., 0], 0.45 * hij[..., 1], hij[..., 2]
    yaw = 1.2 * hij[..., 3]
    box_half = torch.tensor([0.38, 0.55, 0.32], dtype=p.dtype,
                            device=p.device)
    box_c = torch.stack([jx, torch.broadcast_to(-room_half[1] + box_half[1],
                                                jx.shape), jz], dim=-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    qb = q - box_c
    qr = torch.stack([c * qb[..., 0] - s * qb[..., 2], qb[..., 1],
                      s * qb[..., 0] + c * qb[..., 2]], dim=-1)
    d_box = _sd_box(qr, 0.0, box_half)
    sph_c = torch.stack([-jx, 0.3 + 0.5 * jy, -jz], dim=-1)
    d_sph = torch.linalg.norm(q - sph_c, dim=-1) - 0.35
    return torch.minimum(d_room, torch.minimum(d_box, d_sph))


def scene_albedo(p):
    """Procedural colour in [0, 1]^3: a smooth base and two octaves."""
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


def raycast(rays_o, rays_d, sdf, far: float, n_steps: int = 96):
    """Sphere-trace [N, 3] rays through ``sdf`` -> (distance, hit)."""
    t = torch.full(rays_o.shape[:1], 1e-3, dtype=rays_o.dtype,
                   device=rays_o.device)
    done = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(n_steps):
        d = sdf(rays_o + rays_d * t[:, None])
        done = done | (torch.abs(d) < 1e-3)
        t = torch.where(done, t, t + torch.clamp(d, 1e-3, 0.5))
    valid = done & (t < far)
    return torch.where(valid, t, torch.zeros_like(t)), valid


def trajectory_pose(trajectory: str, t: float) -> np.ndarray:
    """c2w at path parameter t in [0, 1) (yaw about +y; the OpenGL camera
    looks along -z): ``outback``, out 2.4 m along +x and back on the same
    path; ``snake``, a serpentine across the large room and back."""
    if trajectory == "outback":
        tri = 1.0 - abs(2.0 * t - 1.0)
        ang = 0.25 * np.sin(2 * np.pi * t)
        pos = np.array([2.4 * tri, 0.15 * np.sin(4 * np.pi * t), 0.0])
    elif trajectory == "snake":
        tri = 1.0 - abs(2.0 * t - 1.0)
        ang = 0.2 * np.sin(2 * np.pi * t)
        pos = np.array([-4.4 + 8.8 * tri, 0.12 * np.sin(4 * np.pi * t),
                        2.2 * np.sin(1.5 * np.pi * tri)])
    else:
        raise ValueError(f"trajectory {trajectory!r}")
    c, s = np.cos(ang), np.sin(ang)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    c2w[:3, 3] = pos
    return c2w


def lap_t(i: int, lap: int) -> float:
    """Path parameter of stream frame i: frac(i / lap)."""
    return (i % lap) / lap


def camera_rays(H: int, W: int, fx: float, fy: float, cx: float, cy: float,
                device=None) -> torch.Tensor:
    """OpenGL pixel directions [H, W, 3] (+x right, +y up, -z ahead)."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([(i - cx) / fx, -(j - cy) / fy,
                        -torch.ones_like(i)], dim=-1)


class LapStream:
    """The stream of one traffic mix: ``n_frames`` frames (the session
    length, which sizes the system's state), frame i being lap frame i
    mod ``lap``. Gives the port's dataset interface: ``H``, ``W``,
    intrinsics, ``num_frames``, ``packed(i)`` [H, W, 7] (direction, rgb,
    depth), ``gt_pose(i)``, ``prerender``, ``room_half``. A frame at or
    past ``n_frames`` raises: the stream never wraps the session."""

    def __init__(self, cam: Dict, traffic: Dict, device):
        self.H, self.W = int(cam["H"]), int(cam["W"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.far = float(cam["far"])
        self.num_frames = int(traffic["session_frames"])
        self.lap = int(traffic["lap_frames"])
        self.trajectory = traffic["trajectory"]
        self.device = torch.device(device)
        self.room_half = torch.tensor(traffic["room_half"],
                                      dtype=torch.float32, device=self.device)
        kind = traffic["props"]
        if kind == "tiled":
            table = torch.from_numpy(cell_hash_table()).to(self.device)
            self._sdf = lambda p: scene_sdf_tiled(p, self.room_half, table)
        elif kind == "classic":
            props = props_on(self.device)
            self._sdf = lambda p: scene_sdf(p, self.room_half, props)
        else:
            raise ValueError(f"props {kind!r}")
        self.render_batch = int(traffic.get("render_batch", 16))
        self.rays_d = camera_rays(self.H, self.W, self.fx, self.fy, self.cx,
                                  self.cy, self.device)
        self.poses = [trajectory_pose(self.trajectory, lap_t(j, self.lap))
                      for j in range(self.lap)]
        self.frames: List[torch.Tensor] = []

    def gt_pose(self, i: int) -> np.ndarray:
        return self.poses[i % self.lap]

    def render_many(self, c2ws: List[torch.Tensor]) -> List[torch.Tensor]:
        dirs = self.rays_d.reshape(-1, 3)
        norms = torch.linalg.norm(dirs, dim=-1)
        unit_d, rays_o = [], []
        for c2w in c2ws:
            rays_d_w = dirs @ c2w[:3, :3].T
            unit_d.append(rays_d_w / norms[:, None])
            rays_o.append(c2w[:3, 3].expand_as(rays_d_w))
        unit_d, rays_o = torch.cat(unit_d), torch.cat(rays_o)
        s, valid = raycast(rays_o, unit_d, self._sdf, self.far * 2.0)
        pts = rays_o + unit_d * s[:, None]
        rgb = torch.where(valid[:, None], scene_albedo(pts),
                          torch.zeros_like(pts))
        depth = s / norms.repeat(len(c2ws))
        depth = torch.where(valid & (depth < self.far), depth,
                            torch.zeros_like(depth))
        hw = (self.H, self.W)
        n = len(dirs)
        return [torch.cat([self.rays_d, r.reshape(hw + (3,)),
                           d.reshape(hw + (1,))], dim=-1)
                for r, d in zip(rgb.split(n), depth.split(n))]

    def render_lap(self) -> None:
        """Render the lap once, ``render_batch`` frames a sphere trace."""
        if self.frames:
            return
        b = self.render_batch
        for k in range(0, self.lap, b):
            self.frames += self.render_many([
                torch.as_tensor(p, device=self.device)
                for p in self.poses[k:k + b]])

    def packed(self, i: int) -> torch.Tensor:
        if not 0 <= i < self.num_frames:
            raise IndexError(f"frame {i} outside the session of "
                             f"{self.num_frames} frames: the traffic's "
                             "session_frames is too small for this rate")
        self.render_lap()
        return self.frames[i % self.lap]

    def prerender(self, indices=None, batch: int = 16) -> None:
        self.render_lap()


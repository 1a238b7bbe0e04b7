"""Procedural synthetic RGB-D sequence: an analytic box room with props.

Port of ``mipsfusion_tpu/datasets/synthetic.py``: the classic prop scene
and the tiled prop field of the large rooms, every trajectory, and the
optional sensor-noise stage. Frames are rendered on the port's device by
sphere-tracing the analytic SDF along the OpenGL pixel rays; depth and the
procedural albedo are exact, so ATE has a clean ground truth.

The noise stage is split in two: ``apply_noise`` is a pure function of the
frame and its draws, so tests can feed it the JAX package's draws, and the
dataset makes its own draws from a ``torch.Generator`` on its device,
seeded from ``synthetic.noise_seed`` (default: the dataset's ``seed``) and
the frame index, so a frame re-renders with the same bits.
"""

from __future__ import annotations

from typing import Dict, List, Optional

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


# the tiled prop field's cells: (i, j) for |i|, |j| < _CELLS (cells of
# 2.4 m: 153 m each way from the origin; farther cells repeat the edge's)
_CELLS = 64
_HASH: Dict[str, torch.Tensor] = {}


def _cell_hash_table() -> np.ndarray:
    """[2 _CELLS, 2 _CELLS, 4] float32: the jitter h_k(i, j) in [-1, 1) of
    every cell, 2 frac(v) - 1 with v = sin(i 12.9898 + j 78.233 +
    k 37.719) * 43758.5453, evaluated in float32 exactly as the JAX
    package evaluates it on the CPU: the argument as fma(i, 12.9898,
    j * 78.233) + k * 37.719 and the sine as the C library's ``sinf``.
    The hash multiplies the sine by 4.4e4, so a sine one ulp off moves a
    prop by millimetres: this table is what keeps the scene the same on
    the card, whose ``sinf`` rounds otherwise."""
    import ctypes
    import ctypes.util
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.sinf.restype = ctypes.c_float
    libm.sinf.argtypes = [ctypes.c_float]
    f32 = np.float32
    c = np.arange(-_CELLS, _CELLS, dtype=f32)
    ci, cj = np.meshgrid(c, c, indexing="ij")
    # the f32 product i * 12.9898 is exact in float64: one rounding, as fma
    fused = (ci.astype(np.float64) * np.float64(f32(12.9898))
             + (cj * f32(78.233)).astype(np.float64)).astype(f32)
    out = np.empty(ci.shape + (4,), f32)
    for k in range(4):
        arg = (fused + f32((k + 1) * 37.719)).ravel()
        sin = np.fromiter((libm.sinf(float(x)) for x in arg), f32, arg.size)
        v = sin.reshape(ci.shape) * f32(43758.5453)
        out[..., k] = f32(2.0) * (v - np.floor(v)) - f32(1.0)
    return out


def _cell_hash(device) -> torch.Tensor:
    key = str(device)
    if key not in _HASH:
        if "cpu" not in _HASH:
            _HASH["cpu"] = torch.from_numpy(_cell_hash_table())
        _HASH[key] = _HASH["cpu"].to(device)
    return _HASH[key]


def scene_sdf_tiled(p: torch.Tensor, room_half: torch.Tensor) -> torch.Tensor:
    """SDF of the large rooms: the walls and a prop field repeated on a
    2.4 m grid in x and z with a per-cell jitter (``_cell_hash_table``).
    Each cell holds a floor box and a floating sphere well inside the
    cell, so the repeated SDF stays exact for the sphere tracer."""
    d_room = -_sd_box(p, 0.0, room_half)
    cell = 2.4
    ci = torch.floor(p[..., 0] / cell)
    cj = torch.floor(p[..., 2] / cell)
    hij = _cell_hash(p.device)[
        torch.clamp(ci.long() + _CELLS, 0, 2 * _CELLS - 1),
        torch.clamp(cj.long() + _CELLS, 0, 2 * _CELLS - 1)]   # [..., 4]

    def h(k: int) -> torch.Tensor:
        return hij[..., k - 1]

    q = torch.stack([p[..., 0] - (ci + 0.5) * cell, p[..., 1],
                     p[..., 2] - (cj + 0.5) * cell], dim=-1)
    jx, jz, jy = 0.45 * h(1), 0.45 * h(2), h(3)
    yaw = 1.2 * h(4)
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
            room_half: torch.Tensor, props, far: float,
            n_steps: int = 96):
    """Sphere-trace [N, 3] rays -> (distance [N], hit mask [N]) through
    the classic scene (``props`` from ``props_on``) or, with ``props ==
    "tiled"``, the tiled prop field."""
    t = torch.full(rays_o.shape[:1], 1e-3, dtype=rays_o.dtype,
                   device=rays_o.device)
    done = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(n_steps):
        p = rays_o + rays_d * t[:, None]
        d = (scene_sdf_tiled(p, room_half) if props == "tiled"
             else scene_sdf(p, room_half, props))
        done = done | (torch.abs(d) < 1e-3)
        t = torch.where(done, t, t + torch.clamp(d, 1e-3, 0.5))
    valid = done & (t < far)
    return torch.where(valid, t, torch.zeros_like(t)), valid


def trajectory_pose(trajectory: str, i: int, n_frames: int, span: float,
                    revisit_amp: float = 0.9,
                    revisit_phase: float = 0.5) -> np.ndarray:
    """c2w of frame i (yaw about +y; the OpenGL camera looks along -z):
    ``orbit``, a slow yaw sweep from near the room center; ``corridor``,
    a translation along x while yawing; ``loop``, out and back to the
    start; ``outback``, straight out along +x and back along the same
    path with the same heading, so the return leg revisits the starting
    views; ``sweep``, the fast-motion stressor (a fast jerky yaw term on
    a slow sweep); ``revisit``, the outback with a yaw bump of
    ``revisit_amp`` rad on the return leg peaking at ``revisit_phase`` of
    it (the wait-loop scene); ``snake``, a serpentine across the large
    tiled room and back along the same path."""
    t = span * i / max(n_frames - 1, 1)
    if trajectory == "orbit":
        ang = 0.9 * np.sin(2 * np.pi * t)
        pos = np.array([0.8 * np.sin(2 * np.pi * t),
                        0.3 * np.sin(4 * np.pi * t),
                        0.5 * np.cos(2 * np.pi * t)])
    elif trajectory == "corridor":
        ang = 0.3 * np.sin(2 * np.pi * t)
        pos = np.array([-2.0 + 4.0 * t, 0.2 * np.sin(2 * np.pi * t), 0.0])
    elif trajectory == "loop":
        s = np.sin(np.pi * t)
        ang = 1.4 * s
        pos = np.array([2.2 * s, 0.0, 0.8 * np.sin(2 * np.pi * t)])
    elif trajectory == "outback":
        tri = 1.0 - abs(2.0 * t - 1.0)   # 0 -> 1 -> 0
        ang = 0.25 * np.sin(2 * np.pi * t)
        pos = np.array([2.4 * tri, 0.15 * np.sin(4 * np.pi * t), 0.0])
    elif trajectory == "sweep":
        ang = 0.45 * np.sin(2 * np.pi * t) + 0.09 * np.sin(12 * np.pi * t)
        pos = np.array([0.6 * np.sin(2 * np.pi * t),
                        0.15 * np.sin(4 * np.pi * t),
                        0.4 * np.cos(2 * np.pi * t)])
    elif trajectory == "revisit":
        tri = 1.0 - abs(2.0 * t - 1.0)
        ret = max(0.0, 2.0 * t - 1.0)    # 0 on the way out, -> 1 home
        bump = np.sin(np.pi * np.clip(ret / (2.0 * revisit_phase), 0.0, 1.0))
        ang = 0.25 * np.sin(2 * np.pi * t) + revisit_amp * bump
        pos = np.array([2.4 * tri, 0.15 * np.sin(4 * np.pi * t), 0.0])
    elif trajectory == "snake":
        tri = 1.0 - abs(2.0 * t - 1.0)
        ang = 0.2 * np.sin(2 * np.pi * t)
        pos = np.array([-4.4 + 8.8 * tri, 0.12 * np.sin(4 * np.pi * t),
                        2.2 * np.sin(1.5 * np.pi * tri)])
    else:
        raise ValueError(trajectory)
    c, s = np.cos(ang), np.sin(ang)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    c2w[:3, 3] = pos
    return c2w


def apply_noise(packed: torch.Tensor, eps_depth: Optional[torch.Tensor],
                u_drop: Optional[torch.Tensor],
                eps_rgb: Optional[torch.Tensor], noise_cfg: Dict
                ) -> torch.Tensor:
    """The sensor-noise stage on a packed [H, W, 7] frame, its draws passed
    in (each may be None when its term is off):

    - ``depth_sigma`` [a, b]: depth += (a + b d^2) * ``eps_depth`` [H, W]
      (standard normal), axial noise growing with range;
    - ``dropout``: a valid pixel becomes a hole where ``u_drop`` [H, W]
      (uniform in [0, 1)) < dropout;
    - ``quantize``: depth rounded to this step (metres);
    - ``rgb_sigma``: rgb += rgb_sigma * ``eps_rgb`` [H, W, 3], clipped to
      [0, 1].
    """
    a, b = noise_cfg.get("depth_sigma", (0.0, 0.0))
    dropout = float(noise_cfg.get("dropout", 0.0))
    quant = float(noise_cfg.get("quantize", 0.0))
    rgb_sigma = float(noise_cfg.get("rgb_sigma", 0.0))
    rgb, depth = packed[..., 3:6], packed[..., 6]
    valid = depth > 0.0
    if a > 0.0 or b > 0.0:
        depth = depth + (a + b * depth ** 2) * eps_depth
    if dropout > 0.0:
        valid = valid & (u_drop >= dropout)
    if quant > 0.0:
        depth = torch.round(depth / quant) * quant
    depth = torch.where(valid & (depth > 0.0), depth, torch.zeros_like(depth))
    if rgb_sigma > 0.0:
        rgb = torch.clamp(rgb + rgb_sigma * eps_rgb, 0.0, 1.0)
    return torch.cat([packed[..., :3], rgb, depth[..., None]], dim=-1)


class SyntheticDataset:
    """Frames rendered on ``device`` (None: the card; ``"cpu"`` for a CPU
    run): ``packed(i)`` is [H, W, 7] = (direction, rgb, depth), cached
    (``device_cache`` > 0 keeps only the newest that many frames);
    ``gt_pose(i)`` the numpy c2w. ``n_frames``, ``trajectory`` and
    ``span`` default to the config's ``synthetic`` block (200, "orbit",
    1.0 where it has none); the block also gives ``room_half``, ``props``
    ("classic" or "tiled"), ``revisit_amp`` / ``revisit_phase``,
    ``noise`` (see ``apply_noise``) and ``noise_seed`` (default ``seed``)."""

    def __init__(self, cfg: Dict, n_frames: Optional[int] = None,
                 trajectory: Optional[str] = None, seed: int = 0,
                 span: Optional[float] = None, device_cache: int = 0,
                 device=None):
        syn = cfg.get("synthetic", {}) or {}
        n_frames = syn.get("n_frames", 200) if n_frames is None else n_frames
        trajectory = trajectory or syn.get("trajectory", "orbit")
        span = syn.get("span", 1.0) if span is None else span
        cam = cfg["cam"]
        ds = cfg["data"].get("downsample", 1)
        self.H, self.W = cam["H"] // ds, cam["W"] // ds
        self.fx, self.fy = cam["fx"] / ds, cam["fy"] / ds
        self.cx, self.cy = cam["cx"] / ds, cam["cy"] / ds
        self.far = cam["far"]
        self.num_frames = n_frames
        self.device = resolve_device(device)
        self.room_half = torch.tensor(syn.get("room_half", [3.0, 2.2, 2.5]),
                                      dtype=torch.float32, device=self.device)
        kind = syn.get("props", "classic")
        if kind not in ("classic", "tiled"):
            raise ValueError(f"synthetic.props {kind!r}")
        self.props = "tiled" if kind == "tiled" else props_on(self.device)
        self.noise = syn.get("noise") or None
        self.noise_seed = int(syn.get("noise_seed", seed))
        self.rays_d = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                      self.cx, self.cy, device=self.device)
        amp = syn.get("revisit_amp", 0.9)
        phase = syn.get("revisit_phase", 0.5)
        self.poses = [trajectory_pose(trajectory, i, n_frames, span, amp,
                                      phase) for i in range(n_frames)]
        self._device_cache_max = int(device_cache)
        self._cache: Dict[int, torch.Tensor] = {}

    def gt_pose(self, index: int) -> np.ndarray:
        return self.poses[index]

    def render_many(self, c2ws: List[torch.Tensor]) -> List[torch.Tensor]:
        """Packed frames of several poses, sphere-traced as one batch of
        rays (every op after the per-frame rotation is per ray, so a
        frame's bits do not depend on the batch)."""
        dirs = self.rays_d.reshape(-1, 3)            # OpenGL dirs, dz = -1
        norms = torch.linalg.norm(dirs, dim=-1)
        unit_d, rays_o = [], []
        for c2w in c2ws:
            rays_d_w = dirs @ c2w[:3, :3].T
            unit_d.append(rays_d_w / norms[:, None])
            rays_o.append(c2w[:3, 3].expand_as(rays_d_w))
        unit_d, rays_o = torch.cat(unit_d), torch.cat(rays_o)
        s, valid = raycast(rays_o, unit_d, self.room_half, self.props,
                           self.far * 2.0)
        pts = rays_o + unit_d * s[:, None]
        rgb = torch.where(valid[:, None], scene_albedo(pts),
                          torch.zeros_like(pts))
        # z-depth: pts = o + dirs * depth with |dir_z| = 1
        depth = s / norms.repeat(len(c2ws))
        depth = torch.where(valid & (depth < self.far), depth,
                            torch.zeros_like(depth))
        hw = (self.H, self.W)
        return [torch.cat([self.rays_d, r.reshape(hw + (3,)),
                           d.reshape(hw + (1,))], dim=-1)
                for r, d in zip(rgb.split(len(dirs)), depth.split(len(dirs)))]

    def noise_draws(self, index: int):
        """The noise stage's draws for frame ``index`` (eps_depth, u_drop,
        eps_rgb; None where the term is off), from a generator on the
        dataset's device seeded by (noise_seed, index)."""
        nz = self.noise
        g = torch.Generator(device=self.device)
        g.manual_seed(self.noise_seed * 1_000_003 + index + 1)
        hw, dev = (self.H, self.W), self.device
        a, b = nz.get("depth_sigma", (0.0, 0.0))
        eps_d = (torch.randn(hw, generator=g, device=dev)
                 if a > 0.0 or b > 0.0 else None)
        u = (torch.rand(hw, generator=g, device=dev)
             if float(nz.get("dropout", 0.0)) > 0.0 else None)
        eps_rgb = (torch.randn(hw + (3,), generator=g, device=dev)
                   if float(nz.get("rgb_sigma", 0.0)) > 0.0 else None)
        return eps_d, u, eps_rgb

    def packed(self, index: int) -> torch.Tensor:
        if index not in self._cache:
            self.prerender([index])
        return self._cache[index]

    def prerender(self, indices, batch: int = 16) -> None:
        """Render and cache the frames ``indices`` not cached yet, ``batch``
        at a time (one sphere trace for the batch: a few kernels a step
        instead of a few per frame). A bounded cache (``device_cache``)
        takes only the first that many of them: the rest would be evicted
        before they are read."""
        todo = [i for i in indices if i not in self._cache]
        if self._device_cache_max:
            todo = todo[:self._device_cache_max]
        for k in range(0, len(todo), batch):
            chunk = todo[k:k + batch]
            frames = self.render_many([torch.as_tensor(
                self.poses[i], device=self.device) for i in chunk])
            for i, frame in zip(chunk, frames):
                if self.noise:
                    frame = apply_noise(frame, *self.noise_draws(i),
                                        self.noise)
                self._cache[i] = frame
                if self._device_cache_max:
                    while len(self._cache) > self._device_cache_max:
                        del self._cache[next(iter(self._cache))]

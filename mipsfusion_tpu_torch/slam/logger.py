"""Logger: full-image re-rendering, comparison panels, trajectory plots.

Port of ``mipsfusion_tpu/slam/logger.py``. ``render_full_img`` renders a
frame through the field with ``models/scene_rep.render_rays_T`` (so K1
runs there on the card). The card's machine has no matplotlib, so the
PNGs are written by a small standard-library encoder (``zlib``,
``struct``): ``img_render_save`` a 2x2 panel (ground-truth colour and
depth above the rendered ones; depth in grey, 0 to the ground truth's
maximum), ``plot_traj`` the top-down (x, z) ground-truth (black) and
estimated (blue) polylines on a white canvas. Titles go into the line
the caller prints, not into the image.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import scene_rep as sr


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] image with values in [0, 1] as an 8-bit RGB PNG."""
    img = (np.clip(np.nan_to_num(rgb), 0.0, 1.0) * 255.0 + 0.5).astype(
        np.uint8)
    H, W, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(H))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


@torch.no_grad()
def render_full_img(params: Dict, fcfg: sr.FieldConfig,
                    consts: sr.FieldConsts, c2w_local: torch.Tensor,
                    rays_dir_img: torch.Tensor, depth_img: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    chunk: int = 16384) -> Tuple[np.ndarray, np.ndarray]:
    """Re-render a full frame (rgb [H, W, 3], depth [H, W]) through the
    field; the z perturbation (``fcfg.perturb``) draws from
    ``generator``."""
    H, W, _ = rays_dir_img.shape
    dirs = rays_dir_img.reshape(-1, 3)
    rays_dT = c2w_local[:3, :3] @ dirs.T                     # [3, N]
    rays_oT = c2w_local[:3, 3:4].expand_as(rays_dT)
    target_d = depth_img.reshape(-1, 1)
    rgbs, depths = [], []
    for s in range(0, rays_dT.shape[1], chunk):
        ret = sr.render_rays_T(params, rays_oT[:, s:s + chunk],
                               rays_dT[:, s:s + chunk],
                               target_d[s:s + chunk], fcfg, consts,
                               generator)
        rgbs.append(ret["rgbT"].T.cpu().numpy())
        depths.append(ret["depth"].cpu().numpy())
    rgb = np.concatenate(rgbs).reshape(H, W, 3)
    depth = np.concatenate(depths).reshape(H, W)
    return rgb, depth


def img_render_save(params: Dict, fcfg: sr.FieldConfig,
                    consts: sr.FieldConsts, c2w_local: torch.Tensor,
                    rgb_gt: np.ndarray, depth_gt: np.ndarray,
                    rays_dir_img: torch.Tensor, out_dir: str,
                    frame_id: int,
                    generator: Optional[torch.Generator] = None):
    """2x2 panel render_<frame_id>.png: ground-truth rgb and depth above
    the rendered ones. Returns (psnr, depth_l1)."""
    dev = c2w_local.device
    rgb, depth = render_full_img(
        params, fcfg, consts, c2w_local, rays_dir_img,
        torch.as_tensor(depth_gt, dtype=torch.float32, device=dev),
        generator)
    mse = float(np.mean((rgb - rgb_gt) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    valid = depth_gt > 0
    depth_l1 = float(np.abs(depth - depth_gt)[valid].mean()) \
        if valid.any() else 0.0

    vmax = max(float(depth_gt.max()), 1e-3)

    def grey(d):
        return np.repeat((np.clip(d, 0.0, vmax) / vmax)[..., None], 3, -1)

    panel = np.concatenate([
        np.concatenate([rgb_gt, grey(depth_gt)], axis=1),
        np.concatenate([rgb, grey(depth)], axis=1)], axis=0)
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, f"render_{frame_id:05d}.png"), panel)
    return psnr, depth_l1


def plot_traj(gt: np.ndarray, est: np.ndarray, out_path: str) -> None:
    """Top-down (x, z) trajectory image, 512 px square: ground truth black,
    estimate blue, one scale for both axes."""
    size, margin = 512, 16
    xz = np.concatenate([gt[:, [0, 2], 3], est[:, [0, 2], 3]])
    xz = xz[np.isfinite(xz).all(1)]
    lo = xz.min(0) if len(xz) else np.zeros(2)
    span = max(float((xz.max(0) - lo).max()) if len(xz) else 0.0, 1e-6)
    scale = (size - 2 * margin - 1) / span
    img = np.ones((size, size, 3))

    def draw(poses, color):
        p = poses[:, [0, 2], 3]
        p = p[np.isfinite(p).all(1)]
        if len(p) == 0:
            return
        px = margin + (p - lo) * scale
        pts = [px[:1]]
        for a, b in zip(px[:-1], px[1:]):
            n = int(np.ceil(np.abs(b - a).max())) + 1
            pts.append(a + (b - a) * np.linspace(0.0, 1.0, n)[:, None])
        q = np.rint(np.concatenate(pts)).astype(int)
        # image rows run downward: z grows upward in the plot
        img[size - 1 - q[:, 1], q[:, 0]] = color

    draw(gt, (0.0, 0.0, 0.0))
    draw(est, (0.0, 0.0, 1.0))
    write_png(out_path, img)

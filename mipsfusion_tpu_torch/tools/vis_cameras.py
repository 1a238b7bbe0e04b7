"""Camera frusta and trajectory of a TUM trajectory file, as a PNG.

    python3 -m mipsfusion_tpu_torch.tools.vis_cameras --traj <tum_file> \
        [--out cams.png] [--every 5]

The counterpart of the JAX package's ``tools/vis_cameras.py`` (the
reference's open3d tool, matplotlib there): a frustum for every
``every``-th pose (blue), the camera path (red) and, from the code, an
axis-aligned bound (black), in an orthographic view from matplotlib's
default 3D viewpoint (elevation 30, azimuth -60 degrees). The card's
machine has no matplotlib, so the lines are rasterized here and written
by ``slam/logger.write_png``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np

FRUSTUM_RGB = (0.12, 0.47, 0.71)
PATH_RGB = (0.84, 0.15, 0.16)
BOUND_RGB = (0.0, 0.0, 0.0)
# the frustum's 8 edges between its apex (0) and far corners (1-4)
SEGMENTS = ((0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1))


def frustum_points(c2w: np.ndarray, scale: float = 0.1,
                   aspect: float = 1.333) -> np.ndarray:
    """The apex and four far corners [5, 3] of a camera's frustum in world
    coordinates (the camera looks down -z)."""
    w, h = scale * aspect, scale
    corners = np.array([[0, 0, 0], [-w, -h, -2 * scale], [w, -h, -2 * scale],
                        [w, h, -2 * scale], [-w, h, -2 * scale]])
    return corners @ np.asarray(c2w)[:3, :3].T + np.asarray(c2w)[:3, 3]


def frustum_lines(c2w: np.ndarray, scale: float = 0.1,
                  aspect: float = 1.333):
    """The frustum's 8 edges as (start, end) world points."""
    pts = frustum_points(c2w, scale, aspect)
    return [(pts[a], pts[b]) for a, b in SEGMENTS]


def view_axes(elev: float = 30.0, azim: float = -60.0) -> np.ndarray:
    """Screen x (right) and y (up) axes [2, 3] of an orthographic view
    from elevation ``elev`` and azimuth ``azim`` (degrees)."""
    e, a = np.radians(elev), np.radians(azim)
    return np.array([[-np.sin(a), np.cos(a), 0.0],
                     [-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a),
                      np.cos(e)]])


def _draw(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color) -> None:
    """A straight line of pixels from p0 to p1 (column, row)."""
    n = int(np.ceil(np.abs(p1 - p0).max())) + 1
    q = np.rint(p0 + (p1 - p0) * np.linspace(0.0, 1.0, n)[:, None]).astype(
        int)
    H, W, _ = img.shape
    ok = (q[:, 0] >= 0) & (q[:, 0] < W) & (q[:, 1] >= 0) & (q[:, 1] < H)
    img[q[ok, 1], q[ok, 0]] = color


def draw_cameras(poses, bound: Optional[np.ndarray] = None,
                 out_path: str = "cameras.png", every: int = 1,
                 size: int = 640, margin: int = 16) -> Dict[str, np.ndarray]:
    """Write the frusta of poses[::every], the camera path and ``bound``
    ([3, 2] lo/hi per axis) as a ``size``-pixel square PNG. Returns the
    pixel (column, row) of every drawn frustum's five points [K, 5, 2]
    and of the path's points [N, 2]."""
    from ..slam.logger import write_png
    poses = np.asarray(poses, np.float64)
    ax = view_axes()
    frusta = np.stack([frustum_points(poses[i])
                       for i in range(0, len(poses), every)])  # [K, 5, 3]
    path = poses[:, :3, 3]
    pts = [frusta.reshape(-1, 3), path]
    box = None
    if bound is not None:
        b = np.asarray(bound, np.float64)
        idx = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)])
        box = b[np.arange(3)[None], idx]                      # [8, 3]
        pts.append(box)
    flat = np.concatenate(pts) @ ax.T                         # [*, 2]
    lo = flat.min(0)
    span = max(float((flat.max(0) - lo).max()), 1e-6)
    scale = (size - 2 * margin - 1) / span

    def px(p):
        s = margin + (p @ ax.T - lo) * scale
        return np.stack([s[..., 0], size - 1 - s[..., 1]], -1)

    img = np.ones((size, size, 3))
    if box is not None:
        bp = px(box)
        for i in range(8):
            for j in range(i + 1, 8):
                if bin(i ^ j).count("1") == 1:               # a box edge
                    _draw(img, bp[i], bp[j], BOUND_RGB)
    pp = px(path)
    for a, b in zip(pp[:-1], pp[1:]):
        _draw(img, a, b, PATH_RGB)
    fp = px(frusta)                                           # [K, 5, 2]
    for f in fp:
        for a, b in SEGMENTS:
            _draw(img, f[a], f[b], FRUSTUM_RGB)
    write_png(out_path, img)
    return {"frusta_px": np.rint(fp).astype(int),
            "path_px": np.rint(pp).astype(int)}


def poses_from_tum(path: str) -> np.ndarray:
    """[N, 4, 4] camera-to-world poses of a TUM file, in timestamp
    order."""
    import torch
    from ..ops.geometry import quaternion_to_matrix
    from .eval_ate import read_tum
    data = read_tum(path)
    rows = np.asarray([data[t] for t in sorted(data)], np.float64)
    quat = rows[:, [6, 3, 4, 5]]                              # qw qx qy qz
    R = quaternion_to_matrix(torch.as_tensor(quat, dtype=torch.float32))
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = R.numpy()
    poses[:, :3, 3] = rows[:, :3]
    return poses


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python3 -m mipsfusion_tpu_torch.tools.vis_cameras",
        description="Camera frusta of a TUM trajectory as a PNG")
    parser.add_argument("--traj", type=str, required=True,
                        help="TUM trajectory file")
    parser.add_argument("--out", type=str, default="cameras.png")
    parser.add_argument("--every", type=int, default=5)
    args = parser.parse_args(argv)
    poses = poses_from_tum(args.traj)
    draw_cameras(poses, out_path=args.out, every=args.every)
    print(f"{os.path.basename(args.traj)}: {len(poses)} poses -> "
          f"{args.out}")


if __name__ == "__main__":
    main()

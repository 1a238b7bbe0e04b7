"""RGB-D datasets: the port of ``mipsfusion_tpu/datasets/dataset.py``.

``get_dataset`` dispatches on ``config["dataset"]``: the synthetic scene
(``SyntheticDataset``) or a file reader (Replica, ScanNet, FastCaMo-synth
and FastCaMo-large) with the JAX package's arguments (``data.trainskip``,
``data.downsample``, ``data.sc_factor``). The readers keep the JAX
readers' semantics, quirks included:

- ``ds[i]`` is JAX's frame dict in numpy: ``frame_id``, ``c2w`` (the
  ground-truth pose in the OpenGL convention), ``rgb`` [H, W, 3] in
  [0, 1], metric ``depth`` [H, W] and the camera-frame ``direction``
  [H, W, 3];
- ``frame_id`` is the frame's position in the reader's list before
  ``trainskip`` (the pose-directory layouts count it from
  ``starting_frame``);
- ``_PoseDirDataset`` does not scale its poses by ``sc_factor`` (Replica
  does), and skips the first ``starting_frame`` pose files by position in
  the sorted list where it skips images by their number;
- lens distortion (``cam.distortion``, 5 coefficients) is corrected at the
  native resolution before any resize, bilinear for colour and nearest for
  depth, as the JAX reader corrects it;
- Replica with ``cam.crop_edge > 0`` raises here: JAX's Replica reader
  crops the frames but not its rays, and fails when it packs a frame.

The system reads a reader through ``num_frames``, ``packed(i)``,
``gt_pose(i)`` and ``prerender(indices)``. ``packed(i)`` is frame ``i`` of
the loop (not its ``frame_id``) on the dataset's device, [H, W, 7] =
(direction, rgb, depth) packed on the host by ``slam.state.
make_frame_rays`` and moved in one copy, the last one cached.
``prerender`` starts a thread that decodes the frames ahead of the loop,
at most ``PREFETCH`` of them at a time (the JAX loop's producer queue of
4); the copy to the device stays on the caller's thread and stream. An
error in the thread is raised by the ``packed`` call that wanted the
frame.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.geometry import get_camera_rays
from . import image

# frames the prefetch thread decodes ahead of the loop
PREFETCH = 4


def get_dataset(config: Dict, device=None):
    """The dataset ``config["dataset"]`` names, on ``device`` (None: the
    card; ``"cpu"`` for a CPU run). The synthetic scene reads its whole
    ``synthetic:`` block (frames, trajectory, span, props, noise,
    ``noise_seed``), as the JAX package's does; the readers read
    ``data.datadir`` with ``data.trainskip``, ``data.downsample`` and
    ``data.sc_factor``."""
    name = config["dataset"]
    if name == "synthetic":
        from .synthetic import SyntheticDataset
        return SyntheticDataset(config, device=device)
    readers = {"replica": ReplicaDataset, "scannet": ScannetDataset,
               "fastcamo_synth": FastCaMoDataset,
               "fastcamo_large": FastCaMoDataset}
    if name not in readers:
        raise ValueError(f"unknown dataset '{name}'")
    data = config["data"]
    return readers[name](config, data["datadir"],
                         trainskip=data.get("trainskip", 1),
                         downsample_factor=data.get("downsample", 1),
                         sc_factor=data.get("sc_factor", 1.0),
                         device=device)


def _opengl_pose(mat: np.ndarray, sc_factor: float = 1.0) -> np.ndarray:
    """4x4 gt pose -> OpenGL camera convention (negate columns 1, 2)."""
    c2w = mat.astype(np.float64).copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    c2w[:3, 3] *= sc_factor
    return c2w.astype(np.float32)


def _stem(path: str) -> int:
    return int(os.path.basename(path).split(".")[0])


def _sorted_by_stem(pattern: str) -> List[str]:
    return sorted(glob.glob(pattern), key=_stem)


def _apply_trainskip(ds, trainskip: int) -> None:
    """Keep every ``trainskip``-th frame of every per-frame list."""
    if trainskip <= 1:
        return
    sl = slice(None, None, trainskip)
    ds.img_files = ds.img_files[sl]
    ds.depth_paths = ds.depth_paths[sl]
    ds.poses = ds.poses[sl]
    ds.frame_ids = ds.frame_ids[sl]


class _Prefetch:
    """A thread decoding ``load(i)`` for ``indices`` in order, at most
    ``PREFETCH`` frames ahead of the consumer (a slot is taken before a
    decode and given back when ``take`` hands the frame out)."""

    def __init__(self, load, indices):
        self.indices = list(indices)
        self.next = 0                       # position of the next take
        self._load = load
        self._q: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(PREFETCH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="frame-prefetch")
        self._thread.start()

    def _run(self):
        for i in self.indices:
            while not self._slots.acquire(timeout=0.1):
                if self._stop.is_set():
                    return
            if self._stop.is_set():
                return
            try:
                self._q.put((i, self._load(i), None))
            except Exception as e:          # raised by take, in the loop
                self._q.put((i, None, e))
                return

    def wants(self, index: int) -> bool:
        return (self.next < len(self.indices)
                and self.indices[self.next] == index)

    def take(self, index: int):
        i, frame, err = self._q.get()
        self.next += 1
        self._slots.release()
        if err is not None:
            raise RuntimeError(f"prefetching frame {i} failed") from err
        if i != index:
            raise RuntimeError(f"prefetch order: frame {i} where {index} "
                               "was wanted")
        return frame

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10.0)


class BaseDataset:
    """Camera and config handling shared by the readers (JAX
    ``BaseDataset``), and the system's view of a reader: ``packed``,
    ``gt_pose``, ``prerender``."""

    def __init__(self, cfg: Dict, device=None):
        cam, data = cfg["cam"], cfg["data"]
        ds = data.get("downsample", 1)
        self.png_depth_scale = cam["png_depth_scale"]
        self.H, self.W = cam["H"] // ds, cam["W"] // ds
        self.fx, self.fy = cam["fx"] / ds, cam["fy"] / ds
        self.cx, self.cy = cam["cx"] / ds, cam["cy"] / ds
        self.distortion = (np.array(cam["distortion"])
                           if cam.get("distortion") else None)
        # undistortion runs at the native resolution (before any resize)
        self._K_native = np.array(
            [[cam["fx"], 0.0, cam["cx"]],
             [0.0, cam["fy"], cam["cy"]],
             [0.0, 0.0, 1.0]], np.float64)
        self._undistort_maps = None
        self.crop_size = cam.get("crop_edge", 0)
        self.ignore_w = cfg.get("tracking", {}).get("ignore_edge_W", 0)
        self.ignore_h = cfg.get("tracking", {}).get("ignore_edge_H", 0)
        self.total_pixels = ((self.H - self.crop_size * 2)
                             * (self.W - self.crop_size * 2))
        self.rays_d = None
        self.device = resolve_device(device)
        self._last: Optional[tuple] = None        # (index, packed frame)
        self._prefetch: Optional[_Prefetch] = None
        # host seconds: decoding colour and depth (a decode's whole frame,
        # packed, in "pack"), and the loop's wait on the prefetch thread
        self.decode_s = {"color": 0.0, "depth": 0.0, "pack": 0.0,
                         "wait": 0.0, "frames": 0}
        self._stats_lock = threading.Lock()

    def _apply_crop(self):
        """Shrink the image and the principal point by crop_edge."""
        edge = self.crop_size
        if edge > 0:
            self.H -= edge * 2
            self.W -= edge * 2
            self.cx -= edge
            self.cy -= edge

    def _make_rays(self):
        self.rays_d = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                      self.cx, self.cy, device="cpu").numpy()

    def _undistort(self, color: np.ndarray, depth: np.ndarray):
        """Lens-distortion correction at the native resolution: bilinear
        for colour, nearest for depth (bilinear would blend depths across
        occlusion boundaries)."""
        if self._undistort_maps is None:
            h, w = depth.shape
            self._undistort_maps = image.undistort_maps(
                self._K_native, self.distortion, (w, h))
        m1, m2 = self._undistort_maps
        return (image.remap_linear(color, m1, m2),
                image.remap_nearest(depth, m1, m2))

    def _load_frame(self, color_path: str, depth_path: str,
                    downsample_factor: int, sc_factor: float):
        t0 = time.perf_counter()
        color = image.read_color(color_path)
        t1 = time.perf_counter()
        depth = image.read_depth(depth_path)
        t2 = time.perf_counter()
        with self._stats_lock:
            self.decode_s["color"] += t1 - t0
            self.decode_s["depth"] += t2 - t1
            self.decode_s["frames"] += 1
        color = color.astype(np.float32) / 255.0
        depth = depth.astype(np.float32) / self.png_depth_scale * sc_factor
        if self.distortion is not None:
            H0, W0 = depth.shape
            if color.shape[:2] != (H0, W0):
                color = image.resize_linear(color, (W0, H0))
            color, depth = self._undistort(color, depth)

        H, W = depth.shape
        color = image.resize_linear(color, (W, H))
        if downsample_factor > 1:
            H, W = H // downsample_factor, W // downsample_factor
            color = image.resize_area(color, (W, H))
            depth = image.resize_nearest(depth, (W, H))

        edge = self.crop_size
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        return color.astype(np.float32), depth

    def __len__(self):
        return self.num_frames

    def frame(self, index: int, color_path: str, depth_path: str,
              downsample_factor: int, sc_factor: float) -> Dict:
        rgb, depth = self._load_frame(color_path, depth_path,
                                      downsample_factor, sc_factor)
        if self.rays_d is None:
            self._make_rays()
        return {
            "frame_id": self.frame_ids[index],
            "c2w": self.poses[index],
            "rgb": rgb,
            "depth": depth,
            "direction": self.rays_d,
        }

    def __getitem__(self, index: int) -> Dict:
        return self.frame(index, self.img_files[index],
                          self.depth_paths[index], self.downsample_factor,
                          self.sc_factor)

    # -- the system's view ------------------------------------------------

    def gt_pose(self, index: int) -> np.ndarray:
        return self.poses[index]

    def host_packed(self, index: int) -> torch.Tensor:
        """Frame ``index`` decoded and packed on the host, [H, W, 7]."""
        from ..slam.state import make_frame_rays
        t0 = time.perf_counter()
        f = self[index]
        out = make_frame_rays(torch.from_numpy(f["direction"]),
                              torch.from_numpy(f["rgb"]),
                              torch.from_numpy(f["depth"]))
        with self._stats_lock:
            self.decode_s["pack"] += time.perf_counter() - t0
        return out

    def packed(self, index: int) -> torch.Tensor:
        """Frame ``index`` of the loop on the dataset's device (the last
        one cached)."""
        if self._last is not None and self._last[0] == index:
            return self._last[1]
        pf = self._prefetch
        if pf is not None and pf.wants(index):
            t0 = time.perf_counter()
            host = pf.take(index)
            self.decode_s["wait"] += time.perf_counter() - t0
        else:
            host = self.host_packed(index)
        frame = host.to(self.device)
        self._last = (index, frame)
        return frame

    def prerender(self, indices) -> None:
        """Decode the frames ``indices`` on a thread, ``PREFETCH`` ahead of
        the ``packed`` calls that take them in this order."""
        self.close()
        self._prefetch = _Prefetch(self.host_packed, indices)

    def close(self) -> None:
        """Stop the prefetch thread, if one runs."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None


class ReplicaDataset(BaseDataset):
    """results/frame*.jpg + results/depth*.png + traj.txt."""

    def __init__(self, cfg, basedir, trainskip=1, downsample_factor=1,
                 sc_factor=1.0, device=None):
        if cfg["cam"].get("crop_edge", 0) > 0:
            raise ValueError(
                "cam.crop_edge > 0 with dataset 'replica': the Replica "
                "reader crops its frames but not its rays (the JAX package "
                "fails when it packs such a frame); set cam.crop_edge: 0")
        super().__init__(cfg, device)
        self.basedir = basedir
        self.downsample_factor = downsample_factor
        self.sc_factor = sc_factor
        self.img_files = sorted(glob.glob(f"{basedir}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{basedir}/results/depth*.png"))
        self.poses = self._load_poses(os.path.join(basedir, "traj.txt"))
        self.frame_ids = list(range(len(self.img_files)))
        _apply_trainskip(self, trainskip)
        self.num_frames = len(self.frame_ids)

    def _load_poses(self, path):
        with open(path) as f:
            lines = f.readlines()
        return [_opengl_pose(np.array(list(map(float, lines[i].split())))
                             .reshape(4, 4), self.sc_factor)
                for i in range(len(self.img_files))]


class _PoseDirDataset(BaseDataset):
    """Common layout: color/<i>.<ext> + depth/<i>.png + pose/<i>.txt."""

    color_ext = "jpg"

    def __init__(self, cfg, basedir, trainskip=1, downsample_factor=1,
                 sc_factor=1.0, device=None):
        super().__init__(cfg, device)
        self.basedir = basedir
        self.downsample_factor = downsample_factor
        self.sc_factor = sc_factor
        start = cfg["data"].get("starting_frame", 0)
        self.img_files = [p for p in _sorted_by_stem(
            os.path.join(basedir, "color", f"*.{self.color_ext}"))
            if _stem(p) >= start]
        self.depth_paths = [p for p in _sorted_by_stem(
            os.path.join(basedir, "depth", "*.png")) if _stem(p) >= start]
        self.poses = self._load_poses(os.path.join(basedir, "pose"), start)
        self.frame_ids = list(range(len(self.img_files)))
        _apply_trainskip(self, trainskip)
        self.num_frames = len(self.frame_ids)
        self._apply_crop()
        self._make_rays()

    def _load_poses(self, path, start):
        poses = []
        for i, pose_path in enumerate(
                _sorted_by_stem(os.path.join(path, "*.txt"))):
            if i < start:
                continue
            with open(pose_path) as f:
                vals = [list(map(float, line.split())) for line in f
                        if line.strip()]
            poses.append(_opengl_pose(np.array(vals).reshape(4, 4)))
        return poses


class ScannetDataset(_PoseDirDataset):
    color_ext = "jpg"


class FastCaMoDataset(_PoseDirDataset):
    color_ext = "png"

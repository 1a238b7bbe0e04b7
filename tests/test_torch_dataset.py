"""The port's file readers (``mipsfusion_tpu_torch/datasets/dataset.py``)
against the JAX package's (``mipsfusion_tpu/datasets/dataset.py``, cv2) on
the same fabricated trees: Replica, ScanNet and FastCaMo with
``trainskip``, ``starting_frame``, ``crop_edge``, ``downsample`` 2,
``sc_factor`` and lens distortion on and off. The frame dicts agree:
``depth``, ``c2w``, ``direction`` and ``frame_id`` bit for bit, ``rgb``
within 1e-6 (cv2's float32 resizes and remap sum in their own order; the
decoded bytes are equal). Then ``get_dataset``'s dispatch and errors, and
the system's view of a reader: ``packed(i)`` keyed on the loop index, the
prefetch's bound and its errors."""

import itertools
import os
import time

import cv2
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets import dataset as J
from mipsfusion_tpu_torch.datasets import dataset as P

RGB_TOL = 1e-6


def _texture(h, w, i, rng):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 90 * np.sin(x / 3.0 + i + k)
                     * np.cos(y / 4.0 - k) for k in range(3)], -1)
    return np.clip(base + rng.normal(0, 15, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _depth(h, w, i, rng):
    y, x = np.mgrid[0:h, 0:w]
    return (1000 + 37 * x + 11 * y + 50 * i
            + rng.integers(0, 30, (h, w))).astype(np.uint16)


def _pose(rng):
    T = np.eye(4)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, 3] = rng.normal(size=3)
    return T


def make_posedir(root, n=7, ext="png", H=40, W=64, color_hw=None, seed=0):
    """color/<i>.<ext> + depth/<i>.png + pose/<i>.txt (the recipe of
    tests/test_dataset_fidelity.py:_make_posedir, textured)."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "scene")
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    ch, cw = color_hw or (H, W)
    for i in range(n):
        cv2.imwrite(os.path.join(d, "color", f"{i}.{ext}"),
                    _texture(ch, cw, i, rng))
        cv2.imwrite(os.path.join(d, "depth", f"{i}.png"),
                    _depth(H, W, i, rng))
        np.savetxt(os.path.join(d, "pose", f"{i}.txt"), _pose(rng))
    return d


def make_replica_dir(root, n=6, H=40, W=64, seed=0):
    """results/frame*.jpg + results/depth*.png + traj.txt (the recipe of
    tests/test_dataset_fidelity.py:_make_replica_dir, textured)."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "seq")
    os.makedirs(os.path.join(d, "results"), exist_ok=True)
    lines = []
    for i in range(n):
        cv2.imwrite(os.path.join(d, "results", f"frame{i:06d}.jpg"),
                    _texture(H, W, i, rng), [cv2.IMWRITE_JPEG_QUALITY, 90])
        cv2.imwrite(os.path.join(d, "results", f"depth{i:06d}.png"),
                    _depth(H, W, i, rng))
        lines.append(" ".join(repr(float(v)) for v in _pose(rng).ravel()))
    with open(os.path.join(d, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return d


def cam_cfg(H=40, W=64, crop=0, start=0, ds=1, dist=None, scale=1000.0):
    cfg = {"cam": {"H": H, "W": W, "fx": 0.8 * W, "fy": 0.8 * W,
                   "cx": W / 2 - 0.5, "cy": H / 2 - 0.5,
                   "png_depth_scale": scale, "crop_edge": crop},
           "data": {"downsample": ds, "starting_frame": start}}
    if dist:
        cfg["cam"]["distortion"] = dist
    return cfg


DIST = [-0.2, 0.05, 0.001, -0.002, 0.01]


def assert_same_frames(a, b):
    assert a.num_frames == b.num_frames
    assert (a.H, a.W, a.fx, a.fy, a.cx, a.cy) == (b.H, b.W, b.fx, b.fy,
                                                  b.cx, b.cy)
    assert a.frame_ids == b.frame_ids
    for i in range(a.num_frames):
        fa, fb = a[i], b[i]
        assert fa["frame_id"] == fb["frame_id"]
        for k in ("depth", "c2w", "direction", "rgb"):
            x, y = np.asarray(fa[k]), fb[k]
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if k == "rgb":
                assert np.abs(x - y).max() <= RGB_TOL
            else:
                assert np.array_equal(x, y), (k, i)


@pytest.mark.parametrize("layout", ["fastcamo", "scannet",
                                    "scannet_colour_larger"])
def test_posedir_readers_match_jax(tmp_path, layout):
    """FastCaMo (PNG) and ScanNet (JPEG, also with colour frames larger
    than depth: INTER_LINEAR to the depth size) over every combination of
    crop_edge, starting_frame, downsample, trainskip, sc_factor and
    distortion."""
    ext = "png" if layout == "fastcamo" else "jpg"
    d = make_posedir(str(tmp_path), ext=ext, color_hw=(
        (57, 83) if layout == "scannet_colour_larger" else None))
    jcls, pcls = ((J.FastCaMoDataset, P.FastCaMoDataset) if ext == "png"
                  else (J.ScannetDataset, P.ScannetDataset))
    for crop, start, ds, skip, sc, dist in itertools.product(
            [0, 3], [0, 2], [1, 2], [1, 3], [1.0, 0.5], [None, DIST]):
        cfg = cam_cfg(crop=crop, start=start, ds=ds, dist=dist)
        kw = dict(trainskip=skip, downsample_factor=ds, sc_factor=sc)
        assert_same_frames(jcls(cfg, d, **kw),
                           pcls(cfg, d, device="cpu", **kw))


def test_replica_reader_matches_jax(tmp_path):
    """Replica (JPEG colour, traj.txt poses scaled by sc_factor) with
    trainskip, downsample 2 and distortion."""
    d = make_replica_dir(str(tmp_path))
    for ds, skip, sc, dist in itertools.product([1, 2], [1, 2], [1.0, 0.7],
                                                [None, DIST]):
        cfg = cam_cfg(ds=ds, dist=dist, scale=6553.5)
        kw = dict(trainskip=skip, downsample_factor=ds, sc_factor=sc)
        a = J.ReplicaDataset(cfg, d, **kw)
        b = P.ReplicaDataset(cfg, d, device="cpu", **kw)
        assert_same_frames(a, b)
        assert b.rays_d is not None


def test_quirks_as_jax_has_them(tmp_path):
    """Pose-directory poses are not scaled by sc_factor; their first
    starting_frame pose files are skipped by position while images are
    skipped by number (a tree whose numbering starts at 3 shows it);
    frame_id is the index before trainskip."""
    d = make_posedir(str(tmp_path), n=8)
    for name in sorted(os.listdir(os.path.join(d, "pose"))):
        i = int(name.split(".")[0])
        for sub, ext in (("color", "png"), ("depth", "png"),
                         ("pose", "txt")):
            os.rename(os.path.join(d, sub, f"{i}.{ext}"),
                      os.path.join(d, sub, f"{i + 3}.{ext}.tmp"))
    for sub in ("color", "depth", "pose"):
        for name in os.listdir(os.path.join(d, sub)):
            os.rename(os.path.join(d, sub, name),
                      os.path.join(d, sub, name[:-4]))
    cfg = cam_cfg(start=4)
    a = J.FastCaMoDataset(cfg, d, trainskip=2, sc_factor=0.5)
    b = P.FastCaMoDataset(cfg, d, trainskip=2, sc_factor=0.5, device="cpu")
    # images 4..10 by number (7, every 2nd: 4), poses 7..10 by position
    # (4, every 2nd: 2): both readers pair image 4 with pose file 7 and
    # run out of poses at the third frame
    assert a.num_frames == b.num_frames == 4
    assert a.frame_ids == b.frame_ids == [0, 2, 4, 6]
    assert len(a.poses) == len(b.poses) == 2
    for i in range(2):
        fa, fb = a[i], b[i]
        for k in ("depth", "c2w", "direction"):
            assert np.array_equal(np.asarray(fa[k]), fb[k])
        assert np.abs(np.asarray(fa["rgb"]) - fb["rgb"]).max() <= RGB_TOL
    for ds in (a, b):
        with pytest.raises(IndexError):
            ds[2]
    raw = np.loadtxt(os.path.join(d, "pose", "7.txt"))
    assert np.allclose(b.poses[0][:3, 3], raw[:3, 3])    # not scaled


def test_get_dataset_dispatch_and_errors(tmp_path):
    trees = {"posedir": make_posedir(str(tmp_path), n=3),
             "replica": make_replica_dir(str(tmp_path), n=3)}
    base = {**cam_cfg(), "data": {"trainskip": 2, "downsample": 1,
                                  "sc_factor": 1.0, "starting_frame": 0}}
    for name, cls in (("fastcamo_synth", P.FastCaMoDataset),
                      ("fastcamo_large", P.FastCaMoDataset),
                      ("scannet", P.ScannetDataset),
                      ("replica", P.ReplicaDataset)):
        cfg = {**base, "dataset": name, "data": {
            **base["data"], "datadir": trees[
                "replica" if name == "replica" else "posedir"]}}
        if name == "scannet":
            for f in os.listdir(os.path.join(cfg["data"]["datadir"],
                                             "color")):
                img = cv2.imread(os.path.join(cfg["data"]["datadir"],
                                              "color", f))
                cv2.imwrite(os.path.join(cfg["data"]["datadir"], "color",
                                         f.replace(".png", ".jpg")), img)
        ds = P.get_dataset(cfg, device="cpu")
        assert type(ds) is cls
        jds = J.get_dataset(cfg)
        assert type(jds).__name__ == cls.__name__
        assert ds.num_frames == jds.num_frames == 2
    base["data"]["datadir"] = trees["posedir"]
    with pytest.raises(ValueError, match="unknown dataset"):
        P.get_dataset({**base, "dataset": "tum"}, device="cpu")
    crop = {**base, "dataset": "replica",
            "cam": {**base["cam"], "crop_edge": 2}}
    with pytest.raises(ValueError, match="cam.crop_edge"):
        P.get_dataset(crop, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.get_dataset({**base, "dataset": "fastcamo_synth"})


def test_packed_is_the_loop_index_and_one_copy(tmp_path):
    """packed(i) takes the loop index (after trainskip, not frame_id),
    holds make_frame_rays of the frame dict, and the last one is cached."""
    d = make_posedir(str(tmp_path), n=7)
    ds = P.FastCaMoDataset(cam_cfg(), d, trainskip=3, device="cpu")
    assert ds.frame_ids == [0, 3, 6]
    p1 = ds.packed(1)
    f = ds[1]
    assert f["frame_id"] == 3
    assert p1.shape == (ds.H, ds.W, 7) and p1.dtype == torch.float32
    assert torch.equal(p1, torch.from_numpy(np.concatenate(
        [f["direction"], f["rgb"], f["depth"][..., None]], axis=-1)))
    assert ds.packed(1) is p1
    assert np.array_equal(ds.gt_pose(2), ds.poses[2])


def test_prefetch_is_bounded_ordered_and_raises(tmp_path):
    """prerender decodes at most PREFETCH frames ahead; packed takes them
    in order and gives the frames a direct decode gives; an index out of
    order is decoded directly; a failed decode raises in the caller."""
    d = make_posedir(str(tmp_path), n=9)
    ds = P.FastCaMoDataset(cam_cfg(), d, device="cpu")
    ref = [ds.host_packed(i) for i in range(9)]
    ds.decode_s["frames"] = 0
    ds.prerender(range(9))
    t0 = time.time()
    while ds.decode_s["frames"] < P.PREFETCH and time.time() - t0 < 20:
        time.sleep(0.01)
    time.sleep(0.3)
    assert ds.decode_s["frames"] == P.PREFETCH == 4
    for i in range(9):
        assert torch.equal(ds.packed(i), ref[i])
        if i == 4:                                   # out of order
            assert torch.equal(ds.packed(7), ref[7])
    ds.close()
    os.remove(os.path.join(d, "depth", "5.png"))
    ds.prerender(range(9))
    for i in range(5):
        ds.packed(i)
    with pytest.raises(RuntimeError, match="prefetching frame 5") as e:
        ds.packed(5)
    assert isinstance(e.value.__cause__, FileNotFoundError)
    ds.close()

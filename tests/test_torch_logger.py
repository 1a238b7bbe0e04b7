"""The port's logger (``mipsfusion_tpu_torch/slam/logger.py``) against the
JAX package's: full-frame renders on the same field, frame and pose with
the z perturbation off, the panel's (psnr, depth_l1), and the PNGs the
standard-library writer makes."""

import dataclasses
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.slam import logger as jlog
from mipsfusion_tpu_torch.convert import params_from_jax
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.slam import logger as tlog

from test_torch_field import small_fcfg, small_params
from test_torch_losses import port_fcfg

torch.set_num_threads(1)

def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG of ``write_png`` with zlib -> [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    W, H, depth, color = hdr[:4]
    if (depth, color) != (8, 2):
        raise ValueError(f"{path}: only 8-bit RGB is read")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter type 0 is read")
    return rows[:, 1:].reshape(H, W, 3).copy()


BOUND = np.array([[-4.0, 4.0], [-3.2, 3.2], [-3.5, 3.5]], np.float32)


@pytest.fixture(scope="module")
def frame():
    """A 30x40 frame of the port's synthetic orbit, its pose, a random
    small field (planes at O(1)) and both packages' configs."""
    from mipsfusion_tpu_torch.config import flagship_orbit
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    cfg = flagship_orbit()
    cfg["cam"].update(H=30, W=40, fx=20.0, fy=20.0, cx=19.5, cy=14.5)
    ds = SyntheticDataset(cfg, n_frames=4, trajectory="orbit", span=0.02,
                          device="cpu")
    packed = ds.packed(2).numpy()
    jf = dataclasses.replace(small_fcfg(), n_samples_d=12, n_range_d=9,
                             far=8.0, trunc=0.1)
    params = small_params(jf, seed=4)
    pose = ds.gt_pose(2).astype(np.float32)
    return packed, pose, jf, params


def test_render_full_img_matches_jax(frame):
    """perturb off: no draws on either side; rgb and depth within 1e-4,
    in one chunk and in ragged chunks of 500 rays."""
    packed, pose, jf, params = frame
    rgb_j, d_j = jlog.render_full_img(
        params, jf, jsr.FieldConsts.from_bound(jnp.asarray(BOUND)),
        jnp.asarray(pose), jnp.asarray(packed[..., :3]),
        jnp.asarray(packed[..., 6]), jax.random.PRNGKey(0))
    for chunk in (16384, 500):
        rgb_t, d_t = tlog.render_full_img(
            params_from_jax(params).params(detach=True), port_fcfg(jf),
            tsr.FieldConsts.from_bound(torch.tensor(BOUND)),
            torch.tensor(pose), torch.tensor(packed[..., :3]),
            torch.tensor(packed[..., 6]), chunk=chunk)
        assert rgb_t.shape == (30, 40, 3) and d_t.shape == (30, 40)
        np.testing.assert_allclose(rgb_t, rgb_j, atol=1e-4, rtol=0)
        np.testing.assert_allclose(d_t, d_j, atol=1e-4, rtol=0)
    assert d_t.std() > 1e-3                       # the field varies


def test_img_render_save_matches_jax_and_writes_a_png(frame, tmp_path):
    """(psnr, depth_l1) of the panel within 1e-4 of the JAX package's;
    the PNG decodes with zlib to the 2x2 panel's size."""
    packed, pose, jf, params = frame
    psnr_j, l1_j = jlog.img_render_save(
        params, jf, jsr.FieldConsts.from_bound(jnp.asarray(BOUND)),
        jnp.asarray(pose), packed[..., 3:6], packed[..., 6],
        jnp.asarray(packed[..., :3]), str(tmp_path / "jax"), 2)
    psnr_t, l1_t = tlog.img_render_save(
        params_from_jax(params).params(detach=True), port_fcfg(jf),
        tsr.FieldConsts.from_bound(torch.tensor(BOUND)), torch.tensor(pose),
        packed[..., 3:6], packed[..., 6], torch.tensor(packed[..., :3]),
        str(tmp_path / "port"), 2)
    assert abs(psnr_t - psnr_j) < 1e-4 and abs(l1_t - l1_j) < 1e-4
    img = read_png(str(tmp_path / "port" / "render_00002.png"))
    assert img.shape == (60, 80, 3) and img.dtype == np.uint8
    # top left: the ground-truth colour, to 8 bits
    np.testing.assert_array_equal(
        img[:30, :40], (np.clip(packed[..., 3:6], 0, 1) * 255 + 0.5).astype(
            np.uint8))


def test_png_writer_round_trip_and_trajectory_plot(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(7, 11, 3))
    tlog.write_png(str(tmp_path / "x.png"), rgb)
    np.testing.assert_array_equal(read_png(str(tmp_path / "x.png")),
                                  (rgb * 255 + 0.5).astype(np.uint8))
    t = np.linspace(0, 1, 30)
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, 0, 3], gt[:, 2, 3] = np.cos(3 * t), np.sin(3 * t)
    est = gt.copy()
    est[:, 0, 3] += 0.05
    est[3, 0, 3] = np.nan
    tlog.plot_traj(gt, est, str(tmp_path / "traj.png"))
    img = read_png(str(tmp_path / "traj.png"))
    assert img.shape == (512, 512, 3)
    black = (img == 0).all(-1).sum()
    blue = ((img[..., 2] == 255) & (img[..., 0] == 0)).sum()
    assert black > 100 and blue > 100
    assert os.path.getsize(str(tmp_path / "traj.png")) < 20000

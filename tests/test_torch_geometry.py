"""Parity of the port's fp32 geometry (mipsfusion_tpu_torch/ops/geometry.py)
with mipsfusion_tpu/ops/geometry.py on the same numpy inputs. Both sides
are float32 (JAX at Precision.HIGHEST, the port with TF32 off):
tolerance 2e-6 absolute on unit-scale quantities."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.ops import geometry as jgeo
from mipsfusion_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)
ATOL = 2e-6


def _quats(n=16, seed=0):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(n=8, seed=1):
    rng = np.random.default_rng(seed)
    R = np.asarray(jgeo.quaternion_to_matrix(jnp.asarray(_quats(n, seed))))
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(n, 3))
    return T


def _cmp(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


def test_quaternion_to_matrix():
    q = _quats() * 1.7          # unnormalized input is normalized inside
    _cmp(tgeo.quaternion_to_matrix(torch.tensor(q)),
         jgeo.quaternion_to_matrix(jnp.asarray(q)))


def test_matrix_to_quaternion():
    R = np.asarray(jgeo.quaternion_to_matrix(jnp.asarray(_quats(seed=3))))
    _cmp(tgeo.matrix_to_quaternion(torch.tensor(R)),
         jgeo.matrix_to_quaternion(jnp.asarray(R)))


def test_qt_to_matrix():
    q, t = _quats(), np.random.default_rng(5).normal(size=(16, 3))
    t = t.astype(np.float32)
    _cmp(tgeo.qt_to_matrix(torch.tensor(q), torch.tensor(t)),
         jgeo.qt_to_matrix(jnp.asarray(q), jnp.asarray(t)))


def test_pose_inverse():
    T = _poses()
    _cmp(tgeo.pose_inverse(torch.tensor(T)), jgeo.pose_inverse(jnp.asarray(T)),
         atol=1e-5)


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5])
def test_se3_exp_log(scale):
    """exp at three twist magnitudes (the first inside the small-angle
    branch), and log of the result."""
    xi = (np.random.default_rng(6).normal(size=(8, 6)) * scale
          ).astype(np.float32)
    Tt = tgeo.se3_exp(torch.tensor(xi))
    _cmp(Tt, jgeo.se3_exp(jnp.asarray(xi)))
    T = Tt.numpy()
    _cmp(tgeo.se3_log(torch.tensor(T)), jgeo.se3_log(jnp.asarray(T)),
         atol=1e-5)


@pytest.mark.parametrize("convention", ["OpenGL", "OpenCV"])
def test_camera_rays(convention):
    _cmp(tgeo.get_camera_rays(30, 40, 25.0, 24.0, 19.5, 14.5,
                              convention=convention),
         jgeo.get_camera_rays(30, 40, 25.0, 24.0, 19.5, 14.5,
                              convention=convention))


def test_frame_surface_bbox():
    rng = np.random.default_rng(7)
    dirs = np.asarray(jgeo.get_camera_rays(20, 24, 20.0, 20.0, 11.5, 9.5))
    depth = rng.uniform(0.5, 4.0, (20, 24)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0       # invalid pixels
    c2w = _poses(1)[0]
    jc, jl = jgeo.get_frame_surface_bbox(jnp.asarray(c2w), jnp.asarray(depth),
                                         jnp.asarray(dirs), 0.0, 3.5)
    tc, tl = tgeo.get_frame_surface_bbox(torch.tensor(c2w),
                                         torch.tensor(depth),
                                         torch.tensor(dirs), 0.0, 3.5)
    _cmp(tc, jc, atol=1e-5)
    _cmp(tl, jl, atol=1e-5)

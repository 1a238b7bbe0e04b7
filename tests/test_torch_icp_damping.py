"""The loop-closure ICP's relative damping, against the JAX package.

The port damps the switch-pose ICP (``system.SWITCH_ICP_DAMPING``, 0.01;
the JAX package solves undamped). On the flagship outback's
forced switch back at frame 90 the clouds are nearly degenerate (walls and
floor seen from 1-2 m apart): the undamped Gauss-Newton solve, the JAX
package's and the port's alike, slides along the planes by tens of
centimetres; the damped one keeps the pose.

    python -m pytest -q -s tests/test_torch_icp_damping.py
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mipsfusion_tpu.slam import icp as jicp
from mipsfusion_tpu_torch.slam import icp as ticp
from mipsfusion_tpu_torch.slam.system import SWITCH_ICP_DAMPING


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("damping", [0.01, 0.05])
def test_damped_icp_matches_jax(damping):
    """A moved copy of a bumpy patch: the port's damped solve equals the
    JAX function's with the same ``rel_damping``."""
    rng = np.random.default_rng(3)
    uv = rng.uniform(-1, 1, (400, 2))
    z = 0.2 * np.sin(2 * uv[:, 0]) + 0.1 * np.cos(3 * uv[:, 1])
    dst = np.concatenate([uv, z[:, None]], -1).astype(np.float32)
    ang, axis = 0.04, np.array([0.3, -0.5, 0.8]) / np.linalg.norm(
        [0.3, -0.5, 0.8])
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    src = ((dst[:300] - [0.02, -0.01, 0.015]) @ R).astype(np.float32)
    valid_s = rng.uniform(size=300) > 0.2
    valid_d = np.ones(400, bool)
    normals = np.asarray(jicp.estimate_normals(jnp.asarray(dst)))
    ref = jicp.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(valid_s), jnp.asarray(dst),
        jnp.asarray(valid_d), jnp.asarray(normals), 0.1, n_iters=10,
        rel_damping=damping)
    out = ticp.icp_point_to_plane(t(src), t(valid_s), t(dst), t(valid_d),
                                  t(normals), 0.1, n_iters=10,
                                  rel_damping=damping)
    np.testing.assert_allclose(out.transform.numpy(),
                               np.asarray(ref.transform), atol=1e-5)
    assert int(out.n_inliers) == int(ref.n_inliers)


def _cloud(ds, frame, n, pose):
    """n evenly spread pixels of a rendered frame, back-projected at pose
    (the loop's ray layout: direction, rgb, depth)."""
    fr = ds.packed(frame).reshape(-1, 7)
    idx = torch.as_tensor(np.linspace(0, fr.shape[0] - 1, n).astype(np.int64))
    r = fr[idx]
    T = torch.as_tensor(pose, dtype=torch.float32)
    return ticp.backproject_rays(r, T[None], torch.zeros(n, dtype=torch.long))


def test_outback_switch_back_icp_slides_undamped():
    """The clouds of the outback's switch back at frame 90, rendered on
    the CPU with exact depth and true keyframe poses: target 4095 points
    of submap 0's keyframes (frames 0-40), source 2048 points of frame 90
    at a pose 1 cm off. The undamped solve (JAX and port agree) moves the
    pose by more than 10 cm along the planes; the damped one ends within
    5 mm of where it started."""
    from mipsfusion_tpu_torch.config import flagship_outback
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    ds = SyntheticDataset(flagship_outback(), n_frames=200,
                          trajectory="outback", span=1.0, device="cpu")
    inv0 = np.linalg.inv(ds.gt_pose(0))
    parts = [_cloud(ds, f, 819, inv0 @ ds.gt_pose(f))
             for f in (0, 10, 20, 30, 40)]
    dst = torch.cat([p for p, _ in parts])
    dst_valid = torch.cat([v for _, v in parts])
    normals = ticp.estimate_normals(dst, k=10)
    truth = inv0 @ ds.gt_pose(90)
    start = truth.copy()
    start[:3, 3] += np.random.default_rng(0).normal(scale=0.01, size=3)
    src, src_valid = _cloud(ds, 90, 2048, start)

    def err_mm(T):
        return 1e3 * float(np.linalg.norm((T @ start)[:3, 3] - truth[:3, 3]))

    undamped = ticp.icp_point_to_plane(src, src_valid, dst, dst_valid,
                                       normals, 0.08, n_iters=15)
    ref = jicp.icp_point_to_plane(
        jnp.asarray(src.numpy()), jnp.asarray(src_valid.numpy()),
        jnp.asarray(dst.numpy()), jnp.asarray(dst_valid.numpy()),
        jnp.asarray(normals.numpy()), 0.08, n_iters=15)
    damped = ticp.icp_point_to_plane(src, src_valid, dst, dst_valid,
                                     normals, 0.08, n_iters=15,
                                     rel_damping=SWITCH_ICP_DAMPING)
    e0, e_ref, e_und, e_damp = (err_mm(np.eye(4)),
                                err_mm(np.asarray(ref.transform)),
                                err_mm(undamped.transform.numpy()),
                                err_mm(damped.transform.numpy()))
    print(f"frame 90 ICP: start {e0:.1f} mm, undamped JAX {e_ref:.1f} mm, "
          f"undamped port {e_und:.1f} mm, damped port {e_damp:.1f} mm")
    assert e_und > 100 and e_ref > 100
    assert abs(e_und - e_ref) < 5
    assert e_damp < e0 + 5

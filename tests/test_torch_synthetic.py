"""Parity of the port's synthetic orbit sequence with the JAX package's
SyntheticDataset: poses, and frames rendered by both sphere tracers on the
same poses. The tracers march 96 float32 steps; a pixel grazing an edge
can stop one step apart, so depth and colour must agree to 1e-4 on all
but 1% of the pixels, and the valid-depth masks on all but 1%."""

import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset

torch.set_num_threads(1)


def _cfg():
    return {"cam": {"H": 40, "W": 56, "fx": 28.0, "fy": 28.0, "cx": 27.5,
                    "cy": 19.5, "far": 8.0},
            "data": {"downsample": 1},
            "synthetic": {"room_half": [3.0, 2.2, 2.5]}}


@pytest.fixture(scope="module")
def datasets():
    n = 12
    return (JDataset(_cfg(), n_frames=n, trajectory="orbit", span=n / 200),
            SyntheticDataset(_cfg(), n_frames=n, trajectory="orbit",
                             span=n / 200, device="cpu"))


def test_orbit_poses(datasets):
    jd, td = datasets
    for i in range(jd.num_frames):
        np.testing.assert_allclose(td.gt_pose(i), jd.gt_pose(i), atol=1e-7)


@pytest.mark.parametrize("frame", [0, 7])
def test_frames_match(datasets, frame):
    jd, td = datasets
    ref = np.asarray(jd.packed(frame))
    out = td.packed(frame).numpy()
    assert out.shape == ref.shape == (40, 56, 7)
    np.testing.assert_allclose(out[..., :3], ref[..., :3], atol=1e-6)
    valid_j, valid_t = ref[..., 6] > 0, out[..., 6] > 0
    assert np.mean(valid_j != valid_t) <= 0.01
    both = valid_j & valid_t
    close = np.all(np.abs(out[..., 3:7] - ref[..., 3:7]) < 1e-4, axis=-1)
    assert np.mean(~close[both]) <= 0.01
    assert both.mean() > 0.9

"""The frozen yardstick: the lap stream, the renderer's bits, the Horn
ATE, and the field's operations, bytes and work counts."""

import numpy as np
import pytest
import torch

from harness import work
from harness.ate import ate_rmse
from harness.lapdata import LapStream, lap_t, trajectory_pose

CAM = {"H": 8, "W": 10, "fx": 5.0, "fy": 5.0, "cx": 4.5, "cy": 3.5,
       "far": 8.0}
# recorded when the renderer was frozen (CPU, float32)
DIGESTS = {
    "classic": "0a319bd469d18b9d83744f6bbaed62421fc30503485e6a2d473e2d65ac62aa09",
    "tiled": "990d18b63cee5552e24386c5dab807ae6c4316054e62c55ba1d4411d159dd1a0",
}
SCENES = {"classic": ("outback", [3.0, 2.2, 2.5]),
          "tiled": ("snake", [5.6, 2.2, 3.2])}


def frame_digest(frames) -> str:
    """SHA-256 of frames' bytes (float32, host order)."""
    import hashlib
    h = hashlib.sha256()
    for f in frames:
        h.update(f.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def stream(props, lap=4, n=10):
    traj, room = SCENES[props]
    return LapStream(CAM, {"session_frames": n, "lap_frames": lap,
                           "trajectory": traj, "room_half": room,
                           "props": props}, "cpu")


@pytest.mark.parametrize("traj", ["outback", "snake"])
def test_lap_is_periodic_and_continuous(traj):
    L = 200
    poses = [trajectory_pose(traj, lap_t(i, L)) for i in range(2 * L + 1)]
    for i in range(L + 1):
        assert np.array_equal(poses[i], poses[i + L])
    steps = [np.abs(poses[i + 1] - poses[i]).max() for i in range(L - 1)]
    seam = np.abs(poses[L] - poses[L - 1]).max()
    assert seam <= 1.5 * max(steps)
    assert np.abs(trajectory_pose(traj, 1.0 - 1e-9)
                  - trajectory_pose(traj, 0.0)).max() < 1e-6


@pytest.mark.parametrize("props", ["classic", "tiled"])
def test_renderer_digest(props):
    s = stream(props)
    s.render_lap()
    assert frame_digest(s.frames) == DIGESTS[props]


@pytest.mark.parametrize("props", ["classic", "tiled"])
def test_renderer_is_the_ports_at_freezing(props):
    """The frozen copy gives the port's renderer's bits at the same poses."""
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    traj, room = SCENES[props]
    cfg = {"cam": dict(CAM, near=0.0), "data": {},
           "synthetic": {"room_half": room, "props": props}}
    ds = SyntheticDataset(cfg, n_frames=4, trajectory=traj, device="cpu")
    s = stream(props)
    s.render_lap()
    theirs = ds.render_many([torch.as_tensor(p) for p in s.poses])
    for a, b in zip(s.frames, theirs):
        assert torch.equal(a, b)


def test_stream_never_wraps_the_session():
    s = stream("classic", lap=4, n=6)
    assert torch.equal(s.packed(5), s.packed(1))
    assert np.array_equal(s.gt_pose(5), s.gt_pose(1))
    with pytest.raises(IndexError):
        s.packed(6)


def test_ate_aligns_a_rigid_motion():
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = gt.copy()
    est[:, :3, 3] = gt[:, :3, 3] @ R.T + [1.0, 2.0, 3.0]
    assert ate_rmse(gt, est) < 1e-9
    est[0, 0, 3] += 0.1
    assert 0.0 < ate_rmse(gt, est) < 0.1


SMALL = {"grid": {"enc": "Triplane", "tri_resolutions": [4],
                  "tri_features": 2, "cp_resolution": 5,
                  "cp_components": 3},
         "pos": {"n_bins": 1},
         "decoder": {"hidden_dim": 4, "geo_feat_dim": 2,
                     "hidden_dim_color": 3}}


def test_ops_and_bytes_by_hand():
    """At S 1, F 2, C 3 (CP 5), one PE band (pe 9), hidden 4, geo 2, rgb
    3: layers 9x4, 4x5, 12x3, 7x4, 4x5 -> 140 MACs a point, 92 sdf-only,
    161 weights; encode 96 + 33, K3 60 + 63, K4 120 + 60 + 3; embed 5,
    the table 3 x 16 x 2 + 3 x 5 x 3 = 141 floats."""
    d = work.field_dims(SMALL)
    assert work.n_weights(d) == 161
    f = {k: work.flops_per_point(k, d) for k in work.KINDS}
    assert f == {"field_forward": (280, 129), "field_forward_sdf": (184, 129),
                 "decoder_backward": (810, 0), "decoder_backward_go": (488, 0),
                 "plane_backward": (0, 123), "x_backward_add": (0, 183)}
    b = {k: work.bytes_per_point(k, d) for k in work.KINDS}
    assert b == {"field_forward": (72, 1208), "field_forward_sdf": (16, 1208),
                 "decoder_backward": (104, 1288),
                 "decoder_backward_go": (104, 644),
                 "plane_backward": (32, 744), "x_backward_add": (56, 564)}


def test_flagship_counts(run_module):
    """The flagship's numbers of the port's chip_smoke comment: 38,233 MACs
    a point, 29,696 sdf-only, 38,625 weights, encode 632, K3 960, K4
    1,040 (+3 for the PE gradient's add)."""
    import json
    import os
    from conftest import PB
    with open(os.path.join(PB, "configs", "flag-full.json")) as f:
        cfg = json.load(f)["config"]
    d = work.field_dims(cfg)
    assert work.n_weights(d) == 38_625
    assert work.flops_per_point("field_forward", d) == (2 * 38_233, 632)
    assert work.flops_per_point("field_forward_sdf", d) == (2 * 29_696, 632)
    assert work.flops_per_point("plane_backward", d) == (0, 960)
    assert work.flops_per_point("x_backward_add", d) == (0, 1_043)


def test_work_from_a_stage_calls_delta():
    """Two BA calls and one track call of the flagship at its budgets:
    BA 15 launches of each of four kinds at 2600 x 75 points, the track 5
    sdf-only RO queries of 2000 x 384 points and 10 GO steps of 1000 x 75
    (forward, backward without weight gradients, point gradients)."""
    import json
    import os
    from conftest import PB
    with open(os.path.join(PB, "configs", "flag-full.json")) as f:
        cfg = json.load(f)["config"]
    d = work.field_dims(cfg)
    fl = {k: sum(work.flops_per_point(k, d)) for k in work.KINDS}
    ba = 15 * 195_000 * (fl["field_forward"] + fl["decoder_backward"]
                         + fl["plane_backward"] + fl["x_backward_add"])
    track = (5 * 768_000 * fl["field_forward_sdf"]
             + 10 * 75_000 * (fl["field_forward"] + fl["decoder_backward_go"]
                              + fl["x_backward_add"]))
    got = work.least_times(cfg, {"ba": 2, "track": 1, "keyframe": 7})
    assert got["flops"] == 2 * ba + track
    assert 0 < got["arith"] <= got["bound"]
    assert got["bytes"] <= got["bound"]

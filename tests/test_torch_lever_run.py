"""A short CPU run of both packages with every robustness lever on (the
fast-motion sweep scene at half its speed, a tiny Triplane+CP field,
60 x 80 frames, smoke-size budgets): the two systems stay under the same
ATE bound, and the drift gate arms, reads and refreshes its anchor without
firing on the healthy trajectory.

At this size the gate's reading on a healthy run is not its 240 x 320
floor: the correction the ICP proposes from a tracked pose to an anchor
up to five frames old reads 20-170 mm in both packages (measured on this
run, gate never firing), so the gate runs at thresh 0.5 m here. Its
firing and rescue are held by test_torch_levers.py's injected slips on
the CPU and by chip_smoke.py's stress phase at full size on the card."""

import copy

import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.slam.system import MIPSFusionTPU
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_smoke_e2e import smoke_config

torch.set_num_threads(1)
N = 12
ATE_BOUND = 0.05      # test_torch_slice.py's smoke runs hold 0.10


def lever_config():
    cfg = smoke_config(N)
    cfg["use_manager"] = False
    cfg["cam"].update({"H": 60, "W": 80, "fx": 40.0, "fy": 40.0,
                       "cx": 39.5, "cy": 29.5})
    cfg["sampling"].update({"kf_n_rays_h": 30, "kf_n_rays_w": 40})
    cfg["grid"] = {"enc": "Triplane", "tri_resolutions": [8, 16],
                   "tri_features": 4, "cp_resolution": 32,
                   "cp_components": 8, "hash_size": 13,
                   "use_bound_normalize": True}
    cfg["training"]["perturb"] = 0
    t = cfg["tracking"]
    t.update(iter=6, iter_RO=3)
    t["drift_gate"] = {"thresh": 0.5}
    t["motion_prior_w"] = 1.0
    t["RO"].update(particle_size=256, n_rows=16, n_cols=24, escalate=4.0,
                   screen_px=96, screen_keep=64)
    cfg["mapping"]["kf_strain_mask"] = 2.5
    return cfg


@pytest.fixture(scope="module")
def runs():
    cfg = lever_config()
    span = N / 240.0          # the first 12 frames of a 240-frame sweep
    jds = JDataset(copy.deepcopy(cfg), n_frames=N, trajectory="sweep",
                   span=span)
    jslam = MIPSFusionTPU(copy.deepcopy(cfg), dataset=jds)
    for i in range(N):
        jslam.process_frame({"frame_id": i, "c2w": jds.gt_pose(i)}, i)
    j_ate = float(jslam.evaluate(N - 1)["absolute_translational_error.rmse"])
    tds = SyntheticDataset(copy.deepcopy(cfg), n_frames=N, trajectory="sweep",
                           span=span, device="cpu")
    slam = MIPSFusionTorch(copy.deepcopy(cfg), dataset=tds, device="cpu")
    return jslam, j_ate, slam, slam.run(verbose=False)


def test_lever_run_both_packages(runs):
    jslam, j_ate, slam, res = runs
    ate = res["absolute_translational_error.rmse"]
    assert ate < ATE_BOUND and j_ate < ATE_BOUND, (ate, j_ate)
    assert slam.dgcfg is not None and slam.rcfg.screen_keep == 64
    # the gate armed on every frame after the first and never fired
    tc = slam.track_counts()
    assert tc["frames"] == tc["armed"] == N - 1
    assert tc["fired"] == tc["rescued"] == 0
    assert not any(bool(r) for r in jslam.track_rescued)
    # the anchor kept refreshing (anchor_every 5)
    assert int(slam._gate.kf_frame) >= N - 6
    assert all(float(r.ss_scale) >= 1.0 for r in slam.track_log)
    assert len(slam.kf_strained) == (N - 1) // slam.keyframe_every
    assert np.isfinite([float(v) for v in slam.track_losses]).all()
    # the gate read every frame in both packages; readings as in JAX's
    # run (the same order of size: a tenth to twice its median)
    d_port = np.asarray([float(r.drift_res) for r in slam.track_log])
    d_jax = np.asarray([float(d) for d in jslam.track_drift])
    assert len(d_port) == len(d_jax) == N - 1
    assert 0.1 < np.median(d_port) / np.median(d_jax) < 2.0

"""The drift gate as the loop runs it, in both packages: a slip injected
into the pose chain fires the gate inside ``track``, the rescue (verify
ICP, polish GO) brings the pose back, the next frame's prediction falls
back to the rescued pose instead of extrapolating the correction, and the
anchor refreshes as in JAX.

Both systems resume from one JAX checkpoint of the first frame's fit and
then only track (no mapping), so they hold the same field; the GO ray
budget equals RO's pixel grid and perturbation is off, so neither draws,
and the port takes JAX's particle template. Every lever is on (the lever
run's tiny Triplane+CP field and 60 x 80 frames) with the gate at 0.05 m:
on this orbit the healthy frames read 19-33 mm in both packages
(measured; the first frame after the resume arms the anchor)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.slam.system import MIPSFusionTPU
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.slam import tracker as ttracker
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_torch_lever_run import lever_config

torch.set_num_threads(1)
N = 6            # frame 0 fitted, 1-5 tracked
SLIP_AT = 3      # est_c2w[3] slips after frame 3 is tracked
SLIP = 0.1       # m, along the camera's x


@pytest.fixture(scope="module")
def gate_loop(tmp_path_factory):
    cfg = lever_config()
    cfg["tracking"]["drift_gate"] = {"thresh": 0.05}
    ro = cfg["tracking"]["RO"]
    cfg["tracking"]["sample"] = ro["n_rows"] * ro["n_cols"]
    cfg["data"]["output"] = str(tmp_path_factory.mktemp("gate_loop"))
    span = N / 400.0
    jds = JDataset(copy.deepcopy(cfg), n_frames=N, trajectory="orbit",
                   span=span)
    first = MIPSFusionTPU(copy.deepcopy(cfg), dataset=jds)
    first.process_frame({"frame_id": 0, "c2w": jds.gt_pose(0)}, 0)
    ckpt = first.save_checkpoint("0")
    jslam = MIPSFusionTPU(copy.deepcopy(cfg), dataset=jds)
    assert jslam.resume_from(ckpt) == 1
    tds = SyntheticDataset(copy.deepcopy(cfg), n_frames=N,
                           trajectory="orbit", span=span, device="cpu")
    slam = MIPSFusionTorch(copy.deepcopy(cfg), dataset=tds, device="cpu")
    assert slam.resume_from(ckpt) == 1
    slam.pst = torch.tensor(np.asarray(jslam.pst))

    preds = []                  # the port's prediction: GO's prior pose
    go = ttracker.go_optimize

    def spy(*args, **kw):
        preds.append(kw["prior_pose"].clone())
        return go(*args, **kw)

    slip = np.eye(4, dtype=np.float32)
    slip[0, 3] = SLIP
    rows = []
    mp = pytest.MonkeyPatch()
    mp.setattr(ttracker, "go_optimize", spy)
    try:
        for i in range(1, N):
            preds.clear()
            jslam.track({"frame_id": i, "c2w": jds.gt_pose(i)}, i)
            slam.track(tds.packed(i), i)
            r = slam.track_log[-1]
            rows.append(dict(
                i=i, pred=preds[0].numpy(),
                prev=slam.state.est_c2w[i - 1].numpy().copy(),
                jax_pose=np.asarray(jslam.state.est_c2w[i]),
                pose=slam.state.est_c2w[i].numpy().copy(),
                jax_drift=float(jslam.track_drift[-1]),
                drift=float(r.drift_res),
                jax_rescued=bool(jslam.track_rescued[-1]),
                rescued=bool(r.rescued), fired=bool(r.fired),
                jax_anchor=int(jslam._gate_kf_frame),
                anchor=int(slam._gate.kf_frame)))
            if i == SLIP_AT:
                jest = jslam.state.est_c2w
                jslam.state = jslam.state._replace(est_c2w=jest.at[i].set(
                    jnp.asarray(rows[-1]["jax_pose"] @ slip)))
                slam.state.est_c2w[i] = torch.tensor(rows[-1]["pose"] @ slip)
    finally:
        mp.undo()
    gt0_inv = np.linalg.inv(tds.gt_pose(0))
    gt = [gt0_inv @ tds.gt_pose(i) for i in range(N)]
    return rows, gt, jslam, slam


def test_injected_slip_fires_and_is_rescued_in_the_loop(gate_loop):
    """Frame by frame the port equals JAX: pose to 1e-4 (float32 rounding
    through RO and GO, measured under 2e-5; Adam's bound would be 6e-3),
    reading to 5e-4 m (test_torch_levers.py's), the same fire and rescue
    verdicts and the same anchor frame. The healthy frames do not fire;
    the slipped one does, in both, and is rescued to under a quarter of
    the slip."""
    rows, gt, jslam, slam = gate_loop
    for r in rows:
        np.testing.assert_allclose(r["pose"], r["jax_pose"], atol=1e-4,
                                   err_msg=f"frame {r['i']}")
        assert abs(r["drift"] - r["jax_drift"]) < 5e-4, r
        assert r["rescued"] == r["jax_rescued"], r
        assert r["anchor"] == r["jax_anchor"], r
        assert r["fired"] == (r["i"] == SLIP_AT + 1), r
    hit = rows[SLIP_AT]
    assert hit["rescued"] and hit["jax_rescued"]
    err = np.linalg.norm(hit["pose"][:3, 3] - gt[SLIP_AT + 1][:3, 3])
    assert err < 0.25 * SLIP, err
    tc = slam.track_counts()
    assert (tc["fired"], tc["rescued"]) == (1, 1)
    assert sum(bool(x) for x in jslam.track_rescued) == 1


def test_prediction_after_a_rescue_is_the_rescued_pose(gate_loop):
    """The constant-velocity model extrapolates the slip into the slipped
    frame's prediction, and after the rescue the next frame predicts the
    rescued pose itself (JAX's prev_rescued), exactly, and JAX tracks
    that frame to the port's pose (above); the flag clears on the next
    healthy frame in both."""
    rows, gt, jslam, slam = gate_loop
    hit, after = rows[SLIP_AT], rows[SLIP_AT + 1]
    # the slipped frame: a constant-velocity prediction, off the
    # previous (slipped) pose by about the slip
    assert np.linalg.norm(hit["pred"][:3, 3] - hit["prev"][:3, 3]) > \
        0.5 * SLIP
    # the frame after the rescue: the rescued pose, bit for bit
    np.testing.assert_array_equal(after["pred"], after["prev"])
    np.testing.assert_array_equal(after["prev"], hit["pose"])
    assert not after["rescued"]
    assert not bool(slam._prev_rescued) and not bool(jslam._prev_rescued)

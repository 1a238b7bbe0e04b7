"""Parity of the port's robustness levers with the JAX package's, on the
same numpy inputs: the Cauchy-weighted ICP, RO's two-stage screen and
search escalation, GO's motion prior, the drift gate's anchor, the gate's
three injected slips and its healthy case (tests/test_drift_gate.py on the
port's tracker), and the keyframe strain mask; and that every lever at its
default leaves the tracker's bits as they were before the levers existed.
No test draws at random on one side only: perturbation is off and the GO
ray budgets equal the pixel grids, unless both sides share the draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.slam import icp as jicp
from mipsfusion_tpu.slam import tracker as jtracker
from mipsfusion_tpu_torch.convert import params_from_jax
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.ops.geometry import (matrix_to_quaternion,
                                               pose_inverse, qt_to_matrix,
                                               quaternion_to_matrix)
from mipsfusion_tpu_torch.slam import icp as ticp
from mipsfusion_tpu_torch.slam import state as tstate
from mipsfusion_tpu_torch.slam import tracker as ttracker

from test_slam_single import tiny_config
from test_smoke_e2e import smoke_config
from test_torch_field import small_fcfg, small_params
from test_torch_losses import port_fcfg

torch.set_num_threads(1)
LW = (1.0, 0.1, 1000.0, 10.0)


# ------------------------------------------------------------------ ICP

def _icp_clouds():
    """A box corner (three planes) seen twice, 2 cm and 1.5 degrees apart,
    with 8% of the source points pushed 5-15 cm off their planes (the
    occlusion outliers the Cauchy weight is for)."""
    rng = np.random.default_rng(1)
    u = rng.uniform(0.0, 1.0, (3, 300, 2))
    dst = np.concatenate([
        np.stack([u[0, :, 0], u[0, :, 1], np.zeros(300)], -1),
        np.stack([u[1, :, 0], np.zeros(300), u[1, :, 1]], -1),
        np.stack([np.zeros(300), u[2, :, 0], u[2, :, 1]], -1)]) \
        .astype(np.float32)
    a = np.radians(1.5)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    src = (dst[::2] @ R.T + np.array([0.02, -0.01, 0.015])).astype(np.float32)
    bad = rng.random(len(src)) < 0.08
    src[bad] += rng.uniform(0.05, 0.15, (bad.sum(), 3)).astype(np.float32)
    normals = np.asarray(jicp.estimate_normals(jnp.asarray(dst), k=10))
    return src, dst, normals


@pytest.mark.parametrize("robust_delta", [0.0, 0.02])
def test_icp_robust_delta_matches_jax(robust_delta):
    """The gate's ICP (relative damping 0.05) with and without the Cauchy
    weight: the port's transform equals JAX's to 1e-5 and its inlier count
    exactly; at robust_delta 0 the port gives the bits of a call without
    the argument (the loop-closure ICP's)."""
    src, dst, normals = _icp_clouds()
    sv, dv = np.ones(len(src), bool), np.ones(len(dst), bool)
    ref = jicp.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst), jnp.asarray(dv),
        jnp.asarray(normals), 0.2, n_iters=10, rel_damping=0.05,
        robust_delta=robust_delta)
    args = (torch.tensor(src), torch.tensor(sv), torch.tensor(dst),
            torch.tensor(dv), torch.tensor(normals), 0.2)
    out = ticp.icp_point_to_plane(*args, n_iters=10, rel_damping=0.05,
                                  robust_delta=robust_delta)
    np.testing.assert_allclose(out.transform.numpy(),
                               np.asarray(ref.transform), atol=1e-5)
    assert int(out.n_inliers) == int(ref.n_inliers)
    plain = ticp.icp_point_to_plane(*args, n_iters=10, rel_damping=0.05)
    same = torch.equal(out.transform, plain.transform)
    assert same == (robust_delta == 0.0)


# ------------------------------------------------------------- RO and GO

@pytest.fixture(scope="module")
def field_setup():
    jf = dataclasses.replace(small_fcfg(), n_range_d=7, n_samples_d=9,
                             near=0.0, far=8.0)
    p = small_params(jf)
    cfg = smoke_config(4)
    ds = JDataset(cfg, n_frames=4, trajectory="orbit", span=4 / 400)
    frame = np.asarray(ds.packed(1))
    pst = np.asarray(jtracker.make_pst(jax.random.PRNGKey(3),
                                       jtracker.ROConfig(particle_size=64)))
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    return jf, p, frame, pst, bound


@pytest.mark.parametrize("screen,scale", [(True, None), (False, 2.5),
                                          (True, 2.5)])
def test_ro_screen_and_escalation_match_jax(field_setup, screen, scale):
    """ro_optimize on one PST (64 particles, 8 x 12 pixels, 3 iterations)
    with the screen (24 pixels, keep 16) and/or the search size scaled by
    2.5: the port's pose equals JAX's to 1e-5, and differs from the plain
    search (the lever took effect)."""
    jf, p, frame, pst, bound = field_setup
    lev = dict(screen_px=24, screen_keep=16) if screen else {}
    kw = dict(particle_size=64, n_rows=8, n_cols=12,
              initial_scaling_factor=0.02, **lev)
    jr, tr = jtracker.ROConfig(**kw), ttracker.ROConfig(**kw)
    H, W = frame.shape[:2]
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.01, -0.02, 0.015]
    rows, cols = jtracker.ro_pixel_grid(H, W, jr)
    ref = jtracker.ro_optimize(
        jax.tree.map(jnp.asarray, p), jf,
        jsr.FieldConsts.from_bound(jnp.asarray(bound)), jr, jnp.asarray(pst),
        jnp.asarray(frame[..., 6]), jnp.asarray(frame[..., :3]),
        jnp.asarray(init), rows, cols, 3,
        ss_scale=None if scale is None else jnp.asarray(scale, jnp.float32))
    f = torch.tensor(frame)
    tp = params_from_jax(p).params(detach=True)
    consts = tsr.FieldConsts.from_bound(torch.tensor(bound))

    def port(rcfg, s):
        r, c = ttracker.ro_pixel_grid(H, W, rcfg)
        return ttracker.ro_optimize(
            tp, port_fcfg(jf), consts, rcfg, torch.tensor(pst), f[..., 6],
            f[..., :3], torch.tensor(init), r, c, 3,
            ss_scale=None if s is None else torch.tensor(s)).numpy()

    out = port(tr, scale)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    plain = port(ttracker.ROConfig(particle_size=64, n_rows=8, n_cols=12,
                                   initial_scaling_factor=0.02), None)
    assert not np.allclose(out, plain, atol=1e-5)


def test_go_motion_prior_matches_jax(field_setup):
    """go_optimize with motion_prior_w 1000 anchored to a prior 3 cm and
    2 degrees from the start (the last iterate, best off, so every Adam
    step counts): the port's pose equals JAX's within Adam's lr per step
    (4 x 1e-3), its loss to 1e-4 relative, and the prior pulls the pose
    toward itself against the plain GO."""
    jf, p, frame, pst, bound = field_setup
    n_it = 4
    H, W = frame.shape[:2]
    rr, cc = np.meshgrid(np.arange(4, H - 4, 4), np.arange(4, W - 4, 4),
                         indexing="ij")
    rr, cc = rr.ravel(), cc.ravel()
    init = np.eye(4, dtype=np.float32)
    prior = np.eye(4, dtype=np.float32)
    a = np.radians(2.0)
    prior[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
    prior[:3, 3] = [0.03, 0.0, -0.01]
    kw = dict(n_iters=n_it, n_rays=len(rr), lr_rot=1e-3, lr_trans=1e-3,
              best=False)
    jg = jtracker.GOConfig(motion_prior_w=1000.0, **kw)
    lw = jsr.LossWeights(*LW)
    ref_pose, ref_loss = jtracker.go_optimize(
        jax.tree.map(jnp.asarray, p), jf,
        jsr.FieldConsts.from_bound(jnp.asarray(bound)), jg,
        jax.random.PRNGKey(0), jnp.asarray(frame[rr, cc, :3]),
        jnp.asarray(frame[rr, cc, 3:6]), jnp.asarray(frame[rr, cc, 6:7]),
        jnp.asarray(init), n_it, lw, prior_pose=jnp.asarray(prior))
    f = torch.tensor(frame)

    def port(w):
        return ttracker.go_optimize(
            params_from_jax(p).params(detach=True), port_fcfg(jf),
            tsr.FieldConsts.from_bound(torch.tensor(bound)),
            ttracker.GOConfig(motion_prior_w=w, **kw), f[rr, cc, :3],
            f[rr, cc, 3:6], f[rr, cc, 6:7], torch.tensor(init), n_it,
            tsr.LossWeights(*LW), prior_pose=torch.tensor(prior))

    pose, loss = port(1000.0)
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref_pose),
                               atol=n_it * 1e-3)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    plain, _ = port(0.0)
    t_prior = prior[:3, 3]
    assert (np.linalg.norm(pose.numpy()[:3, 3] - t_prior)
            < np.linalg.norm(plain.numpy()[:3, 3] - t_prior))


# ------------------------------------------------------------ drift gate

@pytest.fixture(scope="module")
def gate_frames():
    cfg = tiny_config(n_frames=8)
    ds = JDataset(cfg, n_frames=8, trajectory="orbit", span=8 / 200.0)
    return ({i: np.asarray(ds.packed(i)) for i in (0, 5)},
            {i: np.asarray(ds.gt_pose(i)) for i in (0, 5)})


def test_gate_anchor_matches_jax(gate_frames):
    """The anchor of a 60 x 80 frame: points and validity equal JAX's
    (atol 1e-6), normals equal up to sign (|dot| > 1 - 1e-4) at valid
    points."""
    frames, _ = gate_frames
    pts, nrm, valid = jtracker.gate_anchor(jnp.asarray(frames[0]), 24, 43)
    tp, tn, tv = ttracker.gate_anchor(torch.tensor(frames[0]), 24, 43)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(valid))
    np.testing.assert_allclose(tp.numpy(), np.asarray(pts), atol=1e-6)
    v = np.asarray(valid)
    dots = np.abs((tn.numpy() * np.asarray(nrm)).sum(-1))[v]
    assert v.sum() > 900 and dots.min() > 1 - 1e-4


def _yaw_slip(deg, t):
    a = np.radians(deg)
    T = np.eye(4)
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2] = np.sin(a)
    T[2, 0] = -np.sin(a)
    T[:3, 3] = t
    return T


SLIPS = {"healthy": _yaw_slip(0.0, [0.0, 0.0, 0.0]),
         "translation": _yaw_slip(0.0, [0.06, 0.0, 0.0]),
         "rotation": _yaw_slip(3.0, [0.02, 0.0, -0.03]),
         "disarmed": _yaw_slip(0.0, [0.1, 0.0, 0.0])}


def _slip_case(gate_frames, case, n_go=0):
    """tests/test_drift_gate.py's setup on both trackers: anchor from frame
    0, frame 5 at its ground truth times the slip, RO and GO at 0
    iterations, so the pose before the gate is the slipped one (const speed
    off: the prediction is est_c2w[4], set to the slipped pose too). With
    ``n_go`` > 0, GO and the rescue's polish GO (polish_prior_w 3,
    anchored to the ICP pose) run that many iterations on the 4 x 6 pixel
    grid (no draws: the ray budget equals the grid, perturbation off)."""
    frames, gt = gate_frames
    slipped = (gt[5] @ SLIPS[case]).astype(np.float32)
    kf = -1 if case == "disarmed" else 0
    est = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    est[0], est[4], est[5] = gt[0], slipped, slipped
    dg = dict(thresh=0.02, polish=n_go > 0)
    n_rays = 24 if n_go else 64
    jf = dataclasses.replace(small_fcfg(), n_range_d=5, n_samples_d=6)
    p = small_params(jf, scale=False)
    pts, nrm, valid = jtracker.gate_anchor(jnp.asarray(frames[0]), 24, 43)
    cur = frames[5]
    ref = jtracker.track_frame(
        jax.tree.map(jnp.asarray, p), jf,
        jsr.FieldConsts.from_norm_factor(jnp.asarray([3.0, 3.0, 3.0])),
        jtracker.ROConfig(particle_size=8, n_rows=4, n_cols=6, n_iters=0),
        jtracker.GOConfig(n_iters=n_go, n_rays=n_rays),
        jtracker.make_pst(jax.random.PRNGKey(1),
                          jtracker.ROConfig(particle_size=8)),
        jax.random.PRNGKey(2), jnp.asarray(cur[..., 3:6]),
        jnp.asarray(cur[..., 6]), jnp.asarray(cur[..., :3]),
        jnp.asarray(est), jnp.asarray(5), jnp.asarray(False),
        jsr.LossWeights(), 0, n_go, dgcfg=jtracker.DriftGateConfig(**dg),
        gate_pts=pts, gate_normals=nrm, gate_valid=valid,
        gate_kf_frame=jnp.asarray(kf, jnp.int32))
    tp, tn, tv = ttracker.gate_anchor(torch.tensor(frames[0]), 24, 43)
    f = torch.tensor(cur)
    out = ttracker.track_frame(
        params_from_jax(p).params(detach=True), port_fcfg(jf),
        tsr.FieldConsts.from_norm_factor(torch.tensor([3.0, 3.0, 3.0])),
        ttracker.ROConfig(particle_size=8, n_rows=4, n_cols=6, n_iters=0),
        ttracker.GOConfig(n_iters=n_go, n_rays=n_rays), torch.zeros((8, 6)),
        None, f[..., 3:6], f[..., 6], f[..., :3], torch.tensor(est), 5,
        False, tsr.LossWeights(), 0, n_go, torch.tensor(-1.0),
        dgcfg=ttracker.DriftGateConfig(**dg),
        gate=ttracker.GateAnchor(tp, tn, tv, torch.tensor(kf)))
    return ref, out, gt[5], slipped


@pytest.mark.parametrize("case", list(SLIPS))
def test_drift_gate_slips_on_port(gate_frames, case):
    """The bounds of tests/test_drift_gate.py on the port's tracker, and
    the JAX tracker's verdict, pose (1e-4) and reading on the same frames
    (5e-4 m: the reading is an ICP's proposed correction, and at the
    healthy pose, the 9.5 mm sampling floor, a nearest neighbour chosen
    otherwise on float32 rounding moves it by 0.2 mm): healthy stays
    quiet at the ground truth; a 60 mm slip is rescued to under a quarter
    of it with a reading under 20 mm; a 3 degree + 36 mm slip to under 1
    degree; a disarmed anchor never fires."""
    ref, out, gt, slipped = _slip_case(gate_frames, case)
    pose = out.pose.numpy()
    assert bool(out.rescued) == bool(ref.rescued)
    np.testing.assert_allclose(float(out.drift_res), float(ref.drift_res),
                               atol=5e-4)
    np.testing.assert_allclose(pose, np.asarray(ref.pose), atol=1e-4)
    if case == "healthy":
        assert float(out.drift_res) < 0.02 and not bool(out.rescued)
        np.testing.assert_allclose(pose, gt, atol=1e-5)
    elif case == "translation":
        err_before = np.linalg.norm(slipped[:3, 3] - gt[:3, 3])
        err_after = np.linalg.norm(pose[:3, 3] - gt[:3, 3])
        assert bool(out.rescued) and bool(out.fired)
        assert err_after < 0.25 * err_before, (err_before, err_after)
        assert float(out.drift_res) < 0.02
    elif case == "rotation":
        R = pose[:3, :3] @ gt[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
        assert bool(out.rescued) and ang < 1.0, ang
        assert float(out.drift_res) < 0.02
    else:
        assert not bool(out.armed) and not bool(out.rescued)
        np.testing.assert_allclose(pose, slipped, atol=1e-6)


@pytest.mark.parametrize("case", ["translation", "rotation"])
def test_drift_gate_polish_on_port(gate_frames, case):
    """The rescue as the loop runs it: GO (3 iterations) before the gate
    and the polish GO after the verify ICP. The port fires and rescues as
    JAX does, its reading equals JAX's to 5e-4 m (as above) and its pose
    to 1e-5 (float32 rounding through both GOs; Adam's lr of 1e-3 a step
    would bound it at 6e-3, the two agree far closer); the polish moved
    the pose off the ICP's (the rescue without it), and the slip is still
    rescued to the bounds above."""
    ref, out, gt, slipped = _slip_case(gate_frames, case, n_go=3)
    assert bool(ref.rescued) and bool(out.rescued) and bool(out.fired)
    np.testing.assert_allclose(float(out.drift_res), float(ref.drift_res),
                               atol=5e-4)
    pose = out.pose.numpy()
    np.testing.assert_allclose(pose, np.asarray(ref.pose), atol=1e-5)
    _, unpolished, _, _ = _slip_case(gate_frames, case)
    assert np.abs(pose - unpolished.pose.numpy()).max() > 1e-4
    if case == "translation":
        err_before = np.linalg.norm(slipped[:3, 3] - gt[:3, 3])
        assert np.linalg.norm(pose[:3, 3] - gt[:3, 3]) < 0.25 * err_before
    else:
        R = pose[:3, :3] @ gt[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
        assert ang < 1.0, ang


# ----------------------------------------------------- strain mask

@pytest.mark.parametrize("strained", [False, True])
def test_add_keyframe_strain_mask_matches_jax(strained):
    """mapping.kf_strain_mask 2.5: with the frame's loss 3x (strained) or
    2x the accepted-loss EWMA, both systems store the same keyframe rays,
    with zero depth exactly when strained."""
    from mipsfusion_tpu.slam.system import MIPSFusionTPU
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    n = 8
    cfg = tiny_config(n)
    cfg["grid"] = {"enc": "Triplane", "tri_resolutions": [8, 16],
                   "hash_size": 13,
                   "tri_features": 4, "cp_resolution": 32,
                   "cp_components": 8, "use_bound_normalize": True}
    cfg["mapping"]["kf_strain_mask"] = 2.5
    jds = JDataset(cfg, n_frames=n, trajectory="orbit", span=n / 200)
    jslam = MIPSFusionTPU(cfg, dataset=jds)
    tslam = MIPSFusionTorch(cfg, dataset=SyntheticDataset(
        cfg, n_frames=n, trajectory="orbit", span=n / 200, device="cpu"),
        device="cpu")
    loss = 3.0 if strained else 2.0
    jslam._loss_ewma = jnp.asarray(1.0, jnp.float32)
    jslam._prev_loss = jnp.asarray(loss, jnp.float32)
    tslam._loss_ewma = torch.tensor(1.0)
    tslam._prev_loss = torch.tensor(loss)
    frame = np.asarray(jds.packed(6))
    jslam.add_keyframe({"frame_id": 6, "c2w": jds.gt_pose(6)}, 6)
    tslam.add_keyframe(torch.tensor(frame), 6)
    ref = np.asarray(jslam.state.kf_rays[0])
    out = tslam.state.kf_rays[0].numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[:, 6] == 0).all() == strained
    assert bool(tslam.kf_strained[-1]) == strained


# ------------------------------------------------------- levers off

def _ro_before(params, fcfg, consts, rcfg, pst, depth_img, rays_dir_img,
               initial_pose, row_idx, col_idx, n_iters):
    """ro_optimize as it stood before the levers, verbatim."""
    dev = pst.device
    rot, trans = initial_pose[:3, :3], initial_pose[:3, 3]
    search_size = torch.full((1, 6), rcfg.initial_scaling_factor, device=dev)
    identity7 = torch.zeros(7, device=dev)
    identity7[0] = 1.0
    P = pst.shape[0]
    for i in range(n_iters):
        off = i % 5
        d = depth_img[row_idx + off, col_idx + off][:, None]
        dirs = rays_dir_img[row_idx + off, col_idx + off]
        ptsT = (dirs * d).T
        valid = (d[:, 0] > 0.0).to(d.dtype)
        pst7 = ttracker._pose_6d_to_7d(pst * search_size)
        abs_rot = rot[None] @ quaternion_to_matrix(pst7[:, :4])
        abs_trans = trans[None] + pst7[:, 4:]
        worldT = (abs_rot @ ptsT + abs_trans[:, :, None])
        worldT = worldT.permute(1, 0, 2).reshape(3, -1)
        sdf = tsr.run_network_sdf_T(params, worldT, fcfg, consts)
        sdf = sdf.reshape(P, -1) * fcfg.trunc
        mean_sdf = (valid[None] * sdf.abs()).mean(-1)
        fit = mean_sdf * rcfg.sdf_weight
        f0 = fit[0]
        better = (fit < f0).to(fit.dtype)
        weights = (f0 - fit) * better
        wsum = weights.sum() + 1e-5
        success = better.sum() > 0
        mean_sdf_aps = torch.where(success, (weights * mean_sdf).sum() / wsum,
                                   mean_sdf[0])
        mean_tf = (pst7 * weights[:, None]).sum(0) / wsum
        quat = mean_tf[:4] / (torch.linalg.norm(mean_tf[:4]) + 1e-5)
        mean_tf = torch.where(success, torch.cat([quat, mean_tf[4:]]),
                              identity7)
        dR = quaternion_to_matrix(mean_tf[:4])
        rot = torch.where(success, rot @ dR, rot)
        trans = torch.where(success, trans + mean_tf[4:], trans)
        s = mean_tf[1:].abs() + 1e-4
        ss = (rcfg.rescaling_factor * mean_sdf_aps * s / torch.linalg.norm(s)
              + 1e-4)
        search_size = torch.where(success, ss, ss * 2.0)[None]
    T = torch.eye(4, device=dev)
    T[:3, :3] = rot
    T[:3, 3] = trans
    return T


def _go_before(params, fcfg, consts, gcfg, rays_d_cam, target_rgb, target_d,
               initial_pose, n_iters, lw, generator):
    """go_optimize as it stood before the levers, verbatim."""
    dev = rays_d_cam.device
    p = [matrix_to_quaternion(initial_pose[:3, :3]), initial_pose[:3, 3]]
    opt = ttracker.MaskedAdam(p, [gcfg.lr_rot, gcfg.lr_trans])
    rays_d_camT, target_rgbT = rays_d_cam.T, target_rgb.T
    best_loss = torch.full((), float("inf"), device=dev)
    best_p = list(p)
    thresh = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(n_iters):
        rot = p[0].detach().requires_grad_(True)
        trans = p[1].detach().requires_grad_(True)
        T = qt_to_matrix(rot, trans)
        rays_dT = T[:3, :3] @ rays_d_camT
        rays_oT = T[:3, 3][:, None].expand_as(rays_dT)
        ret = tsr.forward_losses_T(params, rays_oT, rays_dT, target_rgbT,
                                   target_d, fcfg, consts, emd_w=0.0,
                                   generator=generator)
        loss = tsr.total_loss(ret, lw)
        g = torch.autograd.grad(loss, [rot, trans])
        loss = loss.detach()
        improved = alive & (loss < best_loss)
        best_loss = torch.where(improved, loss, best_loss)
        best_p = [torch.where(improved, c, b) for c, b in zip(p, best_p)]
        thresh = torch.where(alive, torch.where(improved & (i > 0),
                                                torch.zeros_like(thresh),
                                                thresh + 1), thresh)
        do = alive & (thresh <= gcfg.wait_iters)
        p = opt.step(p, list(g), do)
        alive = do
    final = best_p if gcfg.best else p
    return qt_to_matrix(final[0], final[1]), best_loss


def _track_before(params, fcfg, consts, rcfg, gcfg, pst, generator, frame,
                  est, i, lw, n_ro, n_go, loss_ewma):
    """track_frame_update's tracking as it stood before the levers:
    constant-velocity prediction, RO, GO, pose gate."""
    rgb, depth, dirs = frame[..., 3:6], frame[..., 6], frame[..., :3]
    H, W = depth.shape
    prev = est[i - 1]
    pred = (prev @ pose_inverse(est[max(i - 2, 0)])) @ prev
    r, c = ttracker.ro_pixel_grid(H, W, rcfg)
    pose = _ro_before(params, fcfg, consts, rcfg, pst, depth, dirs, pred, r,
                      c, n_ro)
    rr, cc = ttracker.sample_pixels_mix(
        generator, H, W, rcfg.n_rows, rcfg.n_cols, depth, gcfg.n_rays,
        edge_h=gcfg.ignore_edge_h, edge_w=gcfg.ignore_edge_w)
    pose, loss = _go_before(params, fcfg, consts, gcfg, dirs[rr, cc],
                            rgb[rr, cc], depth[rr, cc][:, None], pose, n_go,
                            lw, generator)
    seeded = loss_ewma > 0.0
    ok = (~seeded) | (loss <= gcfg.gate_abs) \
        | (loss <= gcfg.gate_rel * loss_ewma)
    pose = torch.where(ok, pose, pred)
    ewma_upd = torch.where(seeded, 0.9 * loss_ewma + 0.1 * loss, loss)
    return pose, loss, torch.where(ok, ewma_upd, loss_ewma * 1.25)


@pytest.mark.parametrize("gate_configured", [False, True])
def test_levers_off_keep_the_default_bits(field_setup, gate_configured):
    """Every lever at its default (no screen, no escalation, no motion
    prior, the drift gate off: absent, or configured with thresh 0 beside
    an anchor), track_frame_update gives bit for bit the pose, loss, EWMA
    and pose-store entries of the tracker before the levers existed, with
    perturbation on and random GO pixels drawn from the same seed on both
    sides."""
    jf, p, frame, pst, bound = field_setup
    fcfg = dataclasses.replace(port_fcfg(jf), perturb=True)
    rcfg = ttracker.ROConfig(particle_size=64, n_rows=8, n_cols=12,
                             initial_scaling_factor=0.02)
    gcfg = ttracker.GOConfig(n_iters=3, n_rays=160, ignore_edge_w=4,
                             ignore_edge_h=4, gate_rel=6.0)
    params = params_from_jax(p).params(detach=True)
    consts = tsr.FieldConsts.from_bound(torch.tensor(bound))
    f = torch.tensor(frame)
    lw = tsr.LossWeights(*LW)
    est = torch.eye(4).repeat(6, 1, 1)
    est[1, :3, 3] = torch.tensor([0.004, -0.002, 0.003])
    ewma = torch.tensor(0.5)

    def gen():
        g = torch.Generator()
        g.manual_seed(11)
        return g

    st = tstate.init_state(6, 2, 2, 16, [3.5, 3.5, 3.5], "cpu")
    st.est_c2w[:] = est
    kw = {}
    if gate_configured:
        pts, nrm, val = ttracker.gate_anchor(f, 24, 43)
        kw = dict(dgcfg=ttracker.DriftGateConfig(thresh=0.0),
                  gate=ttracker.GateAnchor(pts, nrm, val, torch.tensor(0)),
                  prev_loss=torch.tensor(0.7),
                  prev_rescued=torch.tensor(False))
    res = ttracker.track_frame_update(
        params, fcfg, consts, rcfg, gcfg, torch.tensor(pst), gen(), f, st, 2,
        True, lw, 2, 3, 4, ewma, **kw)
    pose, loss, new_ewma = _track_before(params, fcfg, consts, rcfg, gcfg,
                                         torch.tensor(pst), gen(), f, est, 2,
                                         lw, 2, 3, ewma)
    assert torch.equal(res.pose, pose) and torch.equal(res.loss, loss)
    assert torch.equal(res.loss_ewma, new_ewma)
    assert torch.equal(st.est_c2w[2], pose)
    assert torch.equal(st.est_c2w_rel[2], pose_inverse(est[0]) @ pose)
    assert not bool(res.rescued) and res.gate is None

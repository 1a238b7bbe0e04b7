"""The multi-submap path of the port against the JAX package: the
flagship outback config, the corridor and outback trajectories and
frames, switch BA and the refinement form of local BA (draws passed in
to both), the motion-model rule after a switch, and runs of
MIPSFusionTorch with the submap manager: a tiny corridor run in tier-1
and the 220-frame loop-closure run under ``slow``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.ops.geometry import qt_to_matrix as jqt
from mipsfusion_tpu.slam import mapper as jmapper
from mipsfusion_tpu_torch.config import FLAGSHIP_OUTBACK, flagship_outback
from mipsfusion_tpu_torch.convert import params_from_jax, params_to_numpy
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.ops.geometry import qt_to_matrix as tqt
from mipsfusion_tpu_torch.slam import mapper as tmapper
from mipsfusion_tpu_torch.slam import tracker
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_torch_field import small_fcfg, small_params
from test_torch_losses import port_fcfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LW = (1.0, 0.1, 1000.0, 10.0)


def test_flagship_outback_equals_yaml(monkeypatch):
    """FLAGSHIP_OUTBACK is the merged outback yaml (every key, so every
    key the slice reads)."""
    from mipsfusion_tpu.config import load_config
    monkeypatch.chdir(ROOT)
    assert load_config("configs/synthetic/outback.yaml") == FLAGSHIP_OUTBACK
    cfg = flagship_outback(use_manager=True)
    assert cfg["use_manager"] and "use_manager" not in FLAGSHIP_OUTBACK


# ------------------------------------------------------------ the scene

def _cam():
    return {"cam": {"H": 40, "W": 56, "fx": 28.0, "fy": 28.0, "cx": 27.5,
                    "cy": 19.5, "far": 8.0},
            "data": {"downsample": 1},
            "synthetic": {"room_half": [3.0, 2.2, 2.5]}}


@pytest.mark.parametrize("trajectory,span", [("outback", 1.0),
                                             ("corridor", 0.55)])
def test_trajectory_matches_jax(trajectory, span):
    """Poses of every frame to 1e-7, and two rendered frames with the
    tolerance of tests/test_torch_synthetic.py (1e-4 on all but 1% of
    the pixels: the sphere tracers may stop a step apart at an edge)."""
    n = 30
    jd = JDataset(_cam(), n_frames=n, trajectory=trajectory, span=span)
    td = SyntheticDataset(_cam(), n_frames=n, trajectory=trajectory,
                          span=span, device="cpu")
    for i in range(n):
        np.testing.assert_allclose(td.gt_pose(i), jd.gt_pose(i), atol=1e-7)
    for frame in (0, 17):
        ref = np.asarray(jd.packed(frame))
        out = td.packed(frame).numpy()
        valid_j, valid_t = ref[..., 6] > 0, out[..., 6] > 0
        assert np.mean(valid_j != valid_t) <= 0.01
        both = valid_j & valid_t
        close = np.all(np.abs(out[..., 3:7] - ref[..., 3:7]) < 1e-4, -1)
        assert np.mean(~close[both]) <= 0.01 and both.mean() > 0.9


# ------------------------------------------------- BA with given draws

def _rand_rays(rng, shape):
    """(direction, rgb, depth) rays looking down -z."""
    d = rng.normal(size=shape + (3,))
    d[..., 2] = -np.abs(d[..., 2]) - 1.0
    return np.concatenate([d, rng.uniform(size=shape + (3,)),
                           rng.uniform(0.5, 2.0, shape + (1,))], -1)


def _ba_inputs(seed=0, K=4, R=32, P=40):
    """Keyframe rays and poses near the origin; with the box consts below
    every sample lies inside [0, 1]^3, where the composite JAX path and
    the port agree on coordinate gradients."""
    rng = np.random.default_rng(seed)
    rays = _rand_rays(rng, (K, R))
    rays[0, :3, 6] = 0.0                       # invalid depths
    ovlp = _rand_rays(rng, (P,))
    poses = np.tile(np.eye(4), (K, 1, 1))
    poses[:, :3, 3] = rng.uniform(-0.3, 0.3, (K, 3))
    ovlp_pose = np.eye(4)
    ovlp_pose[:3, 3] = [0.1, -0.05, 0.2]
    f = np.float32
    return rays.astype(f), ovlp.astype(f), poses.astype(f), ovlp_pose.astype(f)


def _jax_draws(key, logits, n_iters, n_total, R, P):
    """The draws of mapper.local_ba / switch_ba: per iteration the source
    slot, the keyframe ray index and the current-frame ray index."""
    out = []
    for k in jax.random.split(key, n_iters):
        k1, kr, ku, _ = jax.random.split(k, 4)
        out.append(tuple(torch.tensor(np.asarray(a)).long() for a in (
            jax.random.categorical(k1, logits, shape=(n_total,)),
            jax.random.randint(kr, (n_total,), 0, R),
            jax.random.randint(ku, (n_total,), 0, P))))
    return out


@pytest.fixture(scope="module")
def ba_field():
    # range samples at depth +-0.125 and +-0.25: none on the truncation
    # boundary (trunc 0.1), where a rounding difference flips a mask
    jf = dataclasses.replace(small_fcfg(), n_range_d=5, n_samples_d=6,
                             range_d=0.25, near=0.0, far=2.5, perturb=False)
    return jf, port_fcfg(jf), small_params(jf)


def test_switch_ba_matches_jax(ba_field):
    """Pose-only switch BA on a frozen field: 6 iterations, a pose step
    every 3 on the accumulated gradient. The pose to 1e-5 (two Adam steps
    of lr 1e-3 move it by ~2e-3), the last loss to 1e-5 relative."""
    jf, tf, p = ba_field
    rays, ovlp, poses, ovlp_pose = _ba_inputs()
    mask = np.array([True, True, False, True])
    n_iters, n_total = 6, 48
    key = jax.random.PRNGKey(3)
    jc = jsr.FieldConsts(jnp.full(3, -10.0), jnp.full(3, 0.047))
    ref, ref_loss = jmapper.switch_ba(
        jax.tree.map(jnp.asarray, p), key, jnp.asarray(rays),
        jnp.asarray(mask), jnp.asarray(poses), jnp.asarray(ovlp),
        jnp.asarray(ovlp_pose), jf, jc, jsr.LossWeights(*LW), 0.001,
        0.001, n_iters, n_total, 3)
    n = max(mask.sum(), 1)
    w = np.concatenate([mask / max(mask.sum(), 1.0),
                        [max(n_total / n, n_total / 5.0) / n_total]])
    draws = _jax_draws(key, jnp.log(jnp.asarray(w, jnp.float32) + 1e-12),
                       n_iters, n_total, rays.shape[1], ovlp.shape[0])
    out, loss = tmapper.switch_ba(
        params_from_jax(p).params(detach=True), torch.tensor(rays),
        torch.tensor(mask), torch.tensor(poses), torch.tensor(ovlp),
        torch.tensor(ovlp_pose), tf,
        tsr.FieldConsts(torch.full((3,), -10.0), torch.full((3,), 0.047)),
        tsr.LossWeights(*LW), 0.001, 0.001, n_iters, n_total, 3,
        draws=draws)
    assert np.abs(np.asarray(ref) - ovlp_pose).max() > 5e-4     # it moved
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)


def test_refine_local_ba_matches_jax(ba_field):
    """local_ba(include_current=False), the background-refinement round:
    no ray from the current frame, a fresh map Adam, 4 iterations with a
    pose step every 2. Keyframe poses, every field parameter and the last
    loss to 1e-5."""
    jf, tf, p = ba_field
    rays, _, poses, _ = _ba_inputs(seed=1)
    mask = np.array([True, True, False, True])
    first_kf, last_kf, n_total = 0, 3, 48
    jm = jmapper.MapConfig(sample=n_total, pixels_cur=16, iters=4,
                           pose_accum_step=2)
    key = jax.random.PRNGKey(5)
    jp = jax.tree.map(jnp.asarray, p)
    jc = jsr.FieldConsts(jnp.full(3, -10.0), jnp.full(3, 0.047))
    ref = jmapper.local_ba(
        jp, jmapper.make_map_optimizer(jm).init(jp), key,
        jnp.asarray(rays), jnp.asarray(mask), 0, 3, jnp.asarray(poses),
        jnp.zeros((8, 7)), jnp.eye(4), jf, jc, jm, jsr.LossWeights(*LW),
        n_total, include_current=False)
    w, _ = jmapper._kf_sampling_weights(jnp.asarray(mask), first_kf,
                                        last_kf, n_total, 0)
    draws = _jax_draws(key, jnp.log(w + 1e-12), jm.iters, n_total,
                       rays.shape[1], 8)
    assert all(int(d[0].max()) < len(mask) for d in draws)
    field = params_from_jax(p)
    tm = tmapper.MapConfig(sample=n_total, pixels_cur=16, iters=4,
                           pose_accum_step=2)
    res = tmapper.local_ba(
        field, tmapper.make_map_optimizer(field, tm), torch.tensor(rays),
        torch.tensor(mask), first_kf, torch.tensor(last_kf),
        torch.tensor(poses), torch.zeros((8, 7)), torch.eye(4), tf,
        tsr.FieldConsts(torch.full((3,), -10.0), torch.full((3,), 0.047)),
        tm, tsr.LossWeights(*LW), n_total, include_current=False,
        draws=draws)
    ref_poses = np.asarray(jqt(ref.kf_quat, ref.kf_trans))
    assert np.abs(ref_poses[1] - poses[1]).max() > 1e-4        # it moved
    np.testing.assert_allclose(
        tqt(res.kf_quat, res.kf_trans).numpy(), ref_poses, atol=1e-5)
    assert float(res.loss) == pytest.approx(float(ref.loss), rel=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-5), params_to_numpy(field),
        ref.field_params)


# ------------------------------------------------------------ full runs

def corridor_config(n):
    """The flagship config cut to CPU size: 30x40 frames, a narrow field
    (Triplane [8, 16] x F4 + CP 32 x 8, decoder 32), a few iterations per
    stage, 1 m submaps and a short forced-binding window, so the corridor
    leaves submap 0 within a few keyframes."""
    cfg = flagship_outback(use_manager=True)
    cfg["data"]["output"] = None
    cfg["cam"].update(H=30, W=40, fx=20.0, fy=20.0, cx=19.5, cy=14.5)
    cfg["grid"].update(tri_resolutions=[8, 16], cp_resolution=32,
                       cp_components=8)
    cfg["decoder"].update(hidden_dim=32, geo_feat_dim=16,
                          hidden_dim_color=16)
    cfg["training"].update(n_samples_d=6, n_range_d=5)
    cfg["tracking"].update(iter=3, iter_RO=2, sample=64, ignore_edge_W=2,
                           ignore_edge_H=2, switch_interval=6)
    cfg["tracking"]["RO"].update(particle_size=64, n_rows=6, n_cols=8)
    cfg["mapping"].update(sample=96, pixels_cur=48, iters=3, first_iters=40,
                          first_iters_chunk=16, keyframe_every=3,
                          map_every=3)
    cfg["sampling"].update(kf_n_rays_h=15, kf_n_rays_w=20)
    return cfg


@pytest.mark.parametrize("i,last_switch", [(1, 0), (2, 0), (9, 8), (10, 8)])
def test_motion_model_restarts_after_switch(monkeypatch, i, last_switch):
    """The constant-velocity prediction is used from the second frame
    after the last switch on (a switch re-expresses poses in another
    local frame): JAX's rule (i - last_switch_frame) >= 2."""
    cfg = corridor_config(12)
    ds = SyntheticDataset(cfg, n_frames=12, trajectory="corridor", span=0.55,
                          device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    slam.state.last_switch_frame = last_switch
    seen = []

    def spy(*args):
        seen.append(args[10])          # (.., state, i, use_cs, ..)
        raise StopIteration

    # the track program (the drift gate off) and the function take the
    # same arguments
    monkeypatch.setattr(tracker, "track_frame_update", spy)
    monkeypatch.setattr(slam.programs, "track_frame_update", spy)
    with pytest.raises(StopIteration):
        slam.track(ds.packed(i), i)
    assert seen == [bool(cfg["tracking"]["const_speed"]
                         and i - last_switch >= 2)]


def test_port_multi_submap_corridor():
    """20 corridor frames with the manager: a second submap is created
    (msg3 on a keyframe), its 40-iteration first fit drains in chunks of
    16 over the next frames, background refinement runs on submap 0, and
    the keyframe bindings mirror the device table."""
    n = 20
    cfg = corridor_config(n)
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="corridor", span=0.55,
                          device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    res = slam.run(verbose=False)
    calls = slam.stage_calls
    assert res["n_submaps"] >= 2, res
    assert any(flag == 3 for _, flag in slam.switch_events)
    assert calls["switch_new"] >= 1
    # one chunk on the switch frame, the rest on the following frames
    assert calls["init_chunk"] >= 1 and slam._pending_init_iters == 0
    assert calls["refine"] >= 1
    assert np.isfinite([float(v) for v in slam.track_losses]).all()
    st = slam.state
    np.testing.assert_array_equal(
        st.keyframe_localMLP[:st.n_kf].numpy(), slam._host_kf_bind[:st.n_kf])
    for m in range(res["n_submaps"]):
        fk = int(st.localMLP_first_kf[m])
        assert int(st.keyframe_ref[fk]) == -1
        assert slam.fields[m] is not None
    world = slam.world_trajectory(n - 1)
    assert world.shape == (n, 4, 4) and np.isfinite(world).all()


@pytest.mark.slow
def test_port_outback_loop_closure():
    """The tiny 220-frame out-and-back run of
    tests/test_loop_closure_e2e.py with the flagship field widths: a
    switch back with switch BA and PGO, overlapping keyframes bound to
    two submaps, ATE < 0.045 m, valid anchors."""
    from test_loop_closure_e2e import loop_config
    from test_torch_slice import _triplane
    cfg = _triplane(loop_config(220))
    cfg["use_manager"] = True
    ds = SyntheticDataset(cfg, n_frames=220, trajectory="outback", span=1.0,
                          device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    res = slam.run(verbose=False)
    assert any(flag == 1 for _, flag in slam.switch_events), \
        slam.switch_events
    assert slam.optim_cur and res["n_submaps"] >= 2
    assert slam.stage_calls["switch_ba"] >= 1
    assert slam.stage_calls["pgo"] >= 1
    st = slam.state
    kf_ref = st.keyframe_ref[:st.n_kf].numpy()
    assert (kf_ref == -2).sum() >= 1
    assert (st.keyframe_localMLP[:st.n_kf].numpy()[kf_ref == -2, 1]
            >= 0).all()
    assert res["absolute_translational_error.rmse"] < 0.045, res
    for m in range(res["n_submaps"]):
        A = st.kf_c2w[int(st.localMLP_first_kf[m])].numpy()
        assert np.isfinite(A).all()
        np.testing.assert_allclose(A[:3, :3] @ A[:3, :3].T, np.eye(3),
                                   atol=1e-3)

"""Parity of the port's loop closure with the JAX package: ICP (normals up
to sign, point-to-plane, Kabsch, point-to-point), the pose graph, and the
submap bookkeeping, overlap verification and switch ICP of the system on
one scripted two-submap state that holds first, ordinary and overlapping
keyframes (frames rendered by the JAX synthetic dataset on the outback
path, poses perturbed). Float32 on both sides; tolerances are stated per
test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.ops.geometry import se3_exp as jexp
from mipsfusion_tpu.slam import icp as jicp
from mipsfusion_tpu.slam import pose_graph as jpg
from mipsfusion_tpu.slam import state as jstate
from mipsfusion_tpu.slam import system as jsys
from mipsfusion_tpu_torch.slam import icp as ticp
from mipsfusion_tpu_torch.slam import pose_graph as tpg
from mipsfusion_tpu_torch.slam import system as tsys

from test_torch_manager import port_state

torch.set_num_threads(1)
H, W, KF_EVERY = 30, 40, 4


def t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(rng, scale):
    return np.asarray(jexp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * scale)))


# ------------------------------------------------------------------- ICP

def _cloud(rng, n):
    """A bumpy surface patch (well-defined normals)."""
    uv = rng.uniform(-1, 1, (n, 2))
    z = 0.2 * np.sin(2 * uv[:, 0]) + 0.1 * np.cos(3 * uv[:, 1])
    return np.concatenate([uv, z[:, None]], -1).astype(np.float32)


def test_estimate_normals_match_up_to_sign():
    """Point-to-plane residuals ignore a normal's sign, and eigh may
    return either: |cos| between the two normals >= 1 - 1e-4."""
    pts = _cloud(np.random.default_rng(0), 300)
    ref = np.asarray(jicp.estimate_normals(jnp.asarray(pts), k=10))
    out = ticp.estimate_normals(t(pts), k=10).numpy()
    cos = np.abs((out * ref).sum(-1))
    assert cos.min() >= 1 - 1e-4, cos.min()


@pytest.mark.parametrize("kind", ["plane", "point"])
def test_icp_matches_jax(kind):
    """Register a moved copy of a cloud (20% of the source masked): same
    transform to 1e-5, same inlier count."""
    rng = np.random.default_rng(1)
    dst = _cloud(rng, 400)
    T = _rel(rng, 0.05)
    src = (dst[:300] - T[:3, 3]) @ T[:3, :3]        # T^-1 applied
    src_valid = rng.uniform(size=300) > 0.2
    dst_valid = np.ones(400, bool)
    dst_valid[::17] = False
    if kind == "plane":
        normals = np.asarray(jicp.estimate_normals(jnp.asarray(dst)))
        ref = jicp.icp_point_to_plane(
            jnp.asarray(src), jnp.asarray(src_valid), jnp.asarray(dst),
            jnp.asarray(dst_valid), jnp.asarray(normals), 0.1, n_iters=10)
        out = ticp.icp_point_to_plane(
            t(src), t(src_valid), t(dst), t(dst_valid), t(normals), 0.1,
            n_iters=10)
    else:
        ref = jicp.icp_point_to_point(
            jnp.asarray(src), jnp.asarray(src_valid), jnp.asarray(dst),
            jnp.asarray(dst_valid), 0.1, n_iters=10)
        out = ticp.icp_point_to_point(t(src), t(src_valid), t(dst),
                                      t(dst_valid), 0.1, n_iters=10)
    np.testing.assert_allclose(out.transform.numpy(),
                               np.asarray(ref.transform), atol=1e-5)
    np.testing.assert_allclose(out.transform.numpy(), T, atol=2e-3)
    assert int(out.n_inliers) == int(ref.n_inliers)
    assert float(out.rmse) == pytest.approx(float(ref.rmse), abs=1e-5)


def test_svd_transform_matches_jax():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(50, 3)).astype(np.float32)
    T = _rel(rng, 0.3)
    dst = src @ T[:3, :3].T + T[:3, 3]
    w = rng.uniform(size=50).astype(np.float32)
    ref = np.asarray(jicp.svd_transform(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(w)))
    out = ticp.svd_transform(t(src), t(dst), t(w)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, T, atol=1e-5)


# ------------------------------------------------------------ pose graph

def test_pose_graph_matches_jax():
    """Problem assembly exactly, the optimized nodes to 1e-5 (10 damped GN
    steps on 4 nodes, node 0 and an unused node frozen)."""
    rng = np.random.default_rng(3)
    nodes = np.stack([_rel(rng, 0.3) for _ in range(4)])
    adj = np.ones((4, 4), np.float32)
    key_rel = _rel(rng, 0.1)
    e, r, w = jpg.build_pose_graph_problem(jnp.asarray(nodes), adj, (2, 0),
                                           jnp.asarray(key_rel), 0.1, 3)
    te, tr, tw = tpg.build_pose_graph_problem(t(nodes), t(adj), (2, 0),
                                              t(key_rel), 0.1, 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(e))
    np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=1e-6)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w))
    mask = np.array([False, True, True, False])
    jn, jc = jpg.optimize_pose_graph(jnp.asarray(nodes), e, r, w,
                                     jnp.asarray(mask))
    tn, tc = tpg.optimize_pose_graph(t(nodes), te, tr, tw, t(mask))
    assert np.abs(np.asarray(jn) - nodes).max() > 1e-3       # it moved
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    assert float(tc) == pytest.approx(float(jc), rel=1e-4, abs=1e-8)


# ------------------------------------------- scripted two-submap state

@pytest.fixture(scope="module")
def scene():
    """Keyframes every 4 frames of a 40-frame outback: kf 0 first of
    submap 0, kfs 1-2 ordinary in 0, kf 3 first of submap 1 (active),
    kf 4 ordinary in 1, kf 5 overlapping first-bound to 1, kf 6
    overlapping first-bound to 0. Stored poses carry small errors."""
    cfg = {"cam": {"H": H, "W": W, "fx": 20.0, "fy": 20.0, "cx": 19.5,
                   "cy": 14.5, "far": 8.0},
           "data": {"downsample": 1},
           "synthetic": {"room_half": [3.0, 2.2, 2.5]}}
    ds = JDataset(cfg, n_frames=40, trajectory="outback", span=0.35)
    rng = np.random.default_rng(4)
    cap = jstate.StateCapacity(n_frames=64, n_keyframes=16, n_submaps=4,
                               rays_per_kf=12 * 16, kf_rays_h=12,
                               kf_rays_w=16)
    st = jstate.init_state(cap, [2.0, 2.0, 2.0])
    rows, cols = jstate.kf_downsample_indices(H, W, 12, 16)
    gt = [np.asarray(ds.gt_pose(i)) for i in range(40)]
    noisy = [g @ _rel(rng, 0.01) for g in gt]
    anchors = {0: noisy[0], 1: noisy[12]}
    bind = [(0, -1), (0, -1), (0, -1), (1, 0), (1, -1), (1, 0), (0, 1)]
    ref = [-1, 0, 0, -1, 3, -2, -2]
    for k in range(7):
        f = k * KF_EVERY
        st = jstate.add_keyframe(st, ds.packed(f), f, rows, cols)
        sub = bind[k][0]
        local = (np.eye(4, dtype=np.float32) if ref[k] == -1 else
                 np.linalg.inv(anchors[sub]) @ noisy[f]).astype(np.float32)
        st = st._replace(
            est_c2w=st.est_c2w.at[f].set(local),
            keyframe_localMLP=st.keyframe_localMLP.at[k].set(bind[k]),
            keyframe_ref=st.keyframe_ref.at[k].set(ref[k]))
        if ref[k] == -1:
            st = st._replace(kf_c2w=st.kf_c2w.at[k].set(anchors[sub]))
    info = np.zeros((4, 7), np.float32)
    info[0] = [1, 0.5, 0.0, -1.5, 2.0, 2.0, 2.0]
    info[1] = [1, 1.5, 0.0, -1.5, 2.0, 2.0, 2.0]
    adj = np.zeros((4, 4), np.float32)
    adj[0, 1] = adj[1, 0] = 1.0
    st = st._replace(
        localMLP_info=jnp.asarray(info),
        localMLP_adjacent=jnp.asarray(adj),
        localMLP_first_kf=st.localMLP_first_kf.at[0].set(0).at[1].set(3),
        active_submap_id=jnp.asarray(1, jnp.int32),
        prev_active_submap_id=jnp.asarray(0, jnp.int32),
        active_first_kf=jnp.asarray(3, jnp.int32))
    # the current frame (28, on kf 7's slot) back near submap 0's views
    cur = 28
    st = st._replace(est_c2w=st.est_c2w.at[cur].set(
        np.linalg.inv(anchors[1]) @ noisy[6]))
    kf_frames = np.minimum(np.arange(16) * KF_EVERY, 63)
    return ds, st, kf_frames, cur, gt


def _kf(scene):
    return jnp.asarray(scene[2]), torch.tensor(scene[2])


@pytest.mark.parametrize("submap", [0, 1])
def test_extract_submap_kf_poses_matches_jax(scene, submap):
    _, st, _, _, _ = scene
    jkf, tkf = _kf(scene)
    ref = np.asarray(jsys._extract_submap_kf_poses(st, submap, jkf))
    out = tsys.extract_submap_kf_poses(port_state(st), submap, tkf).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_single_submap_shortcut_differs(scene):
    """The slice-1 shortcut (stored local poses, the first keyframe set to
    the identity) is wrong for submap 1: kf 0 (submap 0's first
    keyframe) and kf 6 (overlapping, first-bound to 0) must come through
    the anchors; the ordinary and own keyframes agree."""
    _, st, _, _, _ = scene
    _, tkf = _kf(scene)
    pst = port_state(st)
    good = tsys.extract_submap_kf_poses(pst, 1, tkf)
    shortcut = pst.est_c2w[tkf].clone()
    shortcut[3] = torch.eye(4)
    diff = (good - shortcut).abs().amax(dim=(1, 2)).numpy()
    assert diff[0] > 0.1 and diff[6] > 0.1, diff
    assert diff[[3, 4, 5]].max() < 1e-6, diff


@pytest.mark.parametrize("submap", [0, 1])
def test_writeback_ba_poses_matches_jax(scene, submap):
    """Perturbed BA output written back by keyframe type: frame poses of
    ordinary and overlapping keyframes, world anchors of other submaps'
    first keyframes (1e-5)."""
    _, st, _, _, _ = scene
    jkf, tkf = _kf(scene)
    rng = np.random.default_rng(5 + submap)
    poses = np.asarray(jsys._extract_submap_kf_poses(st, submap, jkf))
    opt = np.stack([p @ _rel(rng, 0.02) for p in poses]).astype(np.float32)
    mask = np.asarray(jstate.submap_kf_mask(st, submap))
    ref = jsys._writeback_ba_poses(st, submap, jnp.asarray(mask),
                                   jnp.asarray(opt), jkf)
    pst = port_state(st)
    tsys.writeback_ba_poses(pst, submap, t(mask), t(opt), tkf)
    assert np.abs(np.asarray(ref.est_c2w) - np.asarray(st.est_c2w)).max() \
        > 1e-3
    np.testing.assert_allclose(pst.est_c2w.numpy(), np.asarray(ref.est_c2w),
                               atol=1e-5)
    np.testing.assert_allclose(pst.kf_c2w.numpy(), np.asarray(ref.kf_c2w),
                               atol=1e-5)


def test_switch_state_update_and_pgo_match_jax(scene):
    """Switch back to submap 0 on frame 28 with a rectified pose, then the
    deferred PGO of the anchors (1e-5)."""
    _, st, _, cur, _ = scene
    rng = np.random.default_rng(7)
    rect = (np.asarray(st.est_c2w[cur]) @ _rel(rng, 0.02)).astype(np.float32)
    jst, jtemp = jsys._switch_state_update(st, jnp.asarray(cur),
                                           jnp.asarray(rect), jnp.asarray(0))
    pst = port_state(st)
    temp = tsys.switch_state_update(pst, cur, t(rect), 0)
    np.testing.assert_allclose(temp.numpy(), np.asarray(jtemp), atol=0)
    assert pst.last_switch_frame == int(jst.last_switch_frame) == cur
    assert int(pst.active_first_kf) == int(jst.active_first_kf) == 0
    np.testing.assert_allclose(pst.est_c2w.numpy(), np.asarray(jst.est_c2w),
                               atol=0)
    ref = jsys._global_pgo(jst, jtemp, jnp.asarray(rect), jnp.asarray(0),
                           jnp.asarray(1), jnp.asarray(2),
                           jnp.asarray(0.1, jnp.float32))
    tsys.global_pgo(pst, temp, t(rect), 0, 1, 2, 0.1)
    assert np.abs(np.asarray(ref.kf_c2w) - np.asarray(st.kf_c2w)).max() > 1e-4
    np.testing.assert_allclose(pst.kf_c2w.numpy(), np.asarray(ref.kf_c2w),
                               atol=1e-5)


def _verify_args(scene):
    ds, st, kf_frames, cur, _ = scene
    packed = np.asarray(ds.packed(24))
    rows, cols = jstate.kf_downsample_indices(H, W, 10, 12)
    K_mat = np.array([[ds.fx, 0, ds.cx], [0, ds.fy, ds.cy], [0, 0, 1]],
                     np.float32)
    anchor1 = np.asarray(st.kf_c2w[3])
    pose_world = (anchor1 @ np.asarray(st.est_c2w[cur])).astype(np.float32)
    return packed, np.asarray(rows), np.asarray(cols), K_mat, pose_world


def test_overlap_verify_matches_jax(scene):
    """Verification of submap 0 from the active submap 1: related
    keyframes, the k = 4 nearest, visibility votes, box membership
    (exact counts and ids)."""
    _, st, _, _, _ = scene
    jkf, tkf = _kf(scene)
    packed, rows, cols, K_mat, pose_world = _verify_args(scene)
    ref = jsys._overlap_verify(
        st, jnp.asarray(packed[..., 6]), jnp.asarray(packed[..., :3]),
        jnp.asarray(pose_world), 0, 1, jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(K_mat), jkf, k=4, edge=2, H=H, W=W)
    out = tsys.overlap_verify(
        port_state(st), t(packed[..., 6]), t(packed[..., :3]), t(pose_world),
        0, 1, t(rows), t(cols), t(K_mat), tkf, 4, 2, H, W)
    assert int(ref["n_related"]) == 4 and int(ref["n_valid"]) > 10
    for k in ("top_kf_ids", "top_valid", "counts", "vis", "mask_final",
              "n_related", "n_visible", "n_in_bbox", "n_valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_overlap_verify_icp_matches_jax(scene):
    """Keyframe selection, cycle padding and switch ICP (15 point-to-plane
    steps, including the last keyframe's rays): inlier count within 1 and
    the rectified pose to 1e-4; then the distrust rule (min_trans below
    the correction) must return the initial pose exactly."""
    _, st, _, cur, _ = scene
    jkf, tkf = _kf(scene)
    packed, rows, cols, K_mat, pose_world = _verify_args(scene)
    kr, kc = jstate.kf_downsample_indices(H, W, 12, 16)
    sub = np.linspace(0, 191, 64).astype(np.int32)
    rr, cc = np.asarray(kr)[sub], np.asarray(kc)[sub]
    pst = port_state(st)
    common = dict(k=4, edge=2, H=H, W=W, n_per=48, n_incl=1,
                  keyframe_every=KF_EVERY, R=192)
    outs = []
    for min_trans in (0.5, 1e-4):
        ref = jsys._overlap_verify_icp(
            st, jnp.asarray(packed[..., 6]), jnp.asarray(packed[..., :3]),
            jnp.asarray(pose_world), 0, 1, jnp.asarray(rows),
            jnp.asarray(cols), jnp.asarray(K_mat), jkf, jnp.asarray(cur),
            jnp.asarray(rr), jnp.asarray(cc), jnp.asarray(sub), 0.08,
            min_trans, jnp.asarray(5), **common)
        out = tsys.overlap_verify_icp(
            pst, t(packed[..., 6]), t(packed[..., :3]), t(pose_world), 0, 1,
            t(rows), t(cols), t(K_mat), tkf, cur, t(rr).long(), t(cc).long(),
            t(sub).long(), 0.08, min_trans, 5, **common)
        assert abs(int(out["n_inliers"]) - int(ref["n_inliers"])) <= 1
        np.testing.assert_allclose(out["pose_ini"].numpy(),
                                   np.asarray(ref["pose_ini"]), atol=1e-6)
        np.testing.assert_allclose(out["pose_final"].numpy(),
                                   np.asarray(ref["pose_final"]), atol=1e-4)
        outs.append(out)
    assert int(outs[0]["n_inliers"]) > 20
    moved = (outs[0]["pose_final"] - outs[0]["pose_ini"]).abs().max()
    assert float(moved) > 1e-4                       # ICP corrected
    np.testing.assert_array_equal(outs[1]["pose_final"].numpy(),
                                  outs[1]["pose_ini"].numpy())

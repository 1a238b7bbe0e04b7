"""The port's mesher (``mipsfusion_tpu_torch/mesher/mesher.py``) and
reconstruction metrics (``eval/recon.py``) against the JAX package's, on
the same numpy inputs; and the slice as a whole: a checkpoint written by
the JAX package (two submaps, keyframe rays rendered from the JAX
synthetic outback at its ground-truth poses, two small random fields),
meshed by the JAX system and by the port's."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from mipsfusion_tpu.mesher import mesher as jm
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu_torch.config import FLAGSHIP_ORBIT, flagship_outback
from mipsfusion_tpu_torch.convert import params_from_jax
from mipsfusion_tpu_torch.mesher import mesher as tm
from mipsfusion_tpu_torch.mesher.marching import marching_cubes
from mipsfusion_tpu_torch.models import scene_rep as tsr

from test_torch_field import small_fcfg, small_params
from test_torch_losses import port_fcfg
from test_torch_marching import sphere_tsdf

torch.set_num_threads(1)

BOUND = np.array([[-4.0, 4.0], [-3.2, 3.2], [-3.5, 3.5]], np.float32)


def _consts():
    return (jsr.FieldConsts.from_bound(jnp.asarray(BOUND)),
            tsr.FieldConsts.from_bound(torch.tensor(BOUND)))


def _meshers(jfcfg, voxel=0.1):
    jc, tc = _consts()
    cfg_j = jm.MeshConfig(voxel_size=voxel)
    cfg_t = tm.MeshConfig(voxel_size=voxel)
    return (jm.Mesher(jfcfg, jc, cfg_j),
            tm.Mesher(port_fcfg(jfcfg), tc, cfg_t))


def _tree(p):
    return params_from_jax(p).params(detach=True)


def _flagship_jax_fcfg():
    return jsr.FieldConfig.from_dict(FLAGSHIP_ORBIT)


@pytest.mark.parametrize("width", ["small", "flagship"])
def test_query_grid_matches_jax(width):
    """Chunked grid queries (rows rgb, sdf, entropy) on local points in
    and around the bound, with a ragged last chunk; 1e-5 abs. The
    flagship width is one K1-sized query at a few thousand points."""
    jfcfg = small_fcfg() if width == "small" else _flagship_jax_fcfg()
    params = small_params(jfcfg, seed=3)
    jmesh, tmesh = _meshers(jfcfg)
    tmesh.cfg.query_chunk = 1000
    rng = np.random.default_rng(0)
    pts = rng.uniform(BOUND[:, 0] * 1.05, BOUND[:, 1] * 1.05,
                      (2500 if width == "small" else 4000, 3)
                      ).astype(np.float32)
    ref = jmesh.query_grid(params, pts)
    out = tmesh.query_grid(_tree(params), pts)
    assert out.shape == ref.shape == (len(pts), 5)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    mask = rng.random(len(pts)) < 0.4
    np.testing.assert_allclose(
        tmesh.query_grid_masked(_tree(params), pts, mask),
        jmesh.query_grid_masked(params, pts, mask), atol=1e-5, rtol=0)


def _two_submaps(seed=0):
    """Two small random fields, their anchors, centers, lengths and
    occupancies of one shape (as the joint mesh's device path wants)."""
    jfcfg = small_fcfg()
    params = [small_params(jfcfg, seed=seed + k) for k in range(2)]
    anchors = np.tile(np.eye(4), (2, 1, 1))
    c, s = np.cos(0.3), np.sin(0.3)
    anchors[1, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    anchors[1, :3, 3] = [1.5, 0.1, -0.2]
    centers = np.array([[-0.5, 0.0, 0.0], [1.0, 0.1, 0.0]])
    lengths = np.array([[3.0, 3.0, 3.0], [3.0, 3.0, 3.0]])
    rng = np.random.default_rng(seed)
    surf = rng.uniform([-2.5, -1.8, -2.0], [2.5, 1.8, 2.0], (400, 3))
    occs_j = [jm.surface_occupancy(surf[k::2], BOUND[:, 0], BOUND[:, 1])
              for k in range(2)]
    occ_j = jm.surface_occupancy(surf, BOUND[:, 0], BOUND[:, 1])
    occs_t = [tm.surface_occupancy(surf[k::2], BOUND[:, 0], BOUND[:, 1])
              for k in range(2)]
    occ_t = tm.surface_occupancy(surf, BOUND[:, 0], BOUND[:, 1])
    return jfcfg, params, anchors, centers, lengths, (occ_j, occs_j), \
        (occ_t, occs_t)


def test_surface_occupancy_matches_jax():
    *_, (occ_j, occs_j), (occ_t, occs_t) = _two_submaps()
    for a, b in zip([occ_j] + occs_j, [occ_t] + occs_t):
        np.testing.assert_array_equal(a.occ, b.occ)
        np.testing.assert_array_equal(a.lo, b.lo)
        assert a.cvox == b.cvox
    q = np.random.default_rng(1).uniform(-5, 5, (3000, 3))
    np.testing.assert_array_equal(occ_j(q), occ_t(q))
    kf_world = np.tile(np.eye(4), (2, 1, 1))
    kf_world[1, :3, 3] = [0.5, 0, 0]
    rays = np.random.default_rng(2).uniform(-1, 1, (2, 50, 7))
    rays[..., 6] = np.abs(rays[..., 6]) * (rays[..., 6] > -0.5)
    np.testing.assert_array_equal(jm.kf_surface_points(kf_world, rays),
                                  tm.kf_surface_points(kf_world, rays))


def test_fused_volume_matches_jax():
    """The fused TSDF volume, M = 2 with the same occupancies: within one
    float16 ulp of the JAX package's (both come back as float16). In
    float16's subnormal range (|v| < 6.1e-5) an ulp is 6e-8, below the
    float32 sums' own rounding, so there the bound is 2.5e-7."""
    jfcfg, params, anchors, centers, _, (occ_j, occs_j), (occ_t, occs_t) = \
        _two_submaps()
    jmesh, tmesh = _meshers(jfcfg)
    tmesh.cfg.query_chunk = 20000
    lo = np.array([-2.6, -1.9, -2.1], np.float32)
    shape = (27, 20, 23)
    args = (anchors, centers, 2.0)
    ref = jmesh.fused_sdf_volume_device(params, *args, occ_j, occs_j, lo,
                                        shape, 0.2, 0.99)
    out = tmesh.fused_sdf_volume_device([_tree(p) for p in params], *args,
                                        occ_t, occs_t, lo, shape, 0.2, 0.99)
    assert out.shape == ref.shape == shape
    ulp = np.maximum(np.spacing(np.maximum(np.abs(ref), np.abs(out)).astype(
        np.float16)).astype(np.float32), 2.5e-7)
    assert (np.abs(out - ref) <= ulp).all(), np.abs(out - ref).max()
    inside = np.abs(ref) < 0.99
    assert 0.1 < inside.mean() < 1.0                  # observed and not
    assert (ref[inside] < 0).any() and (ref[inside] > 0).any()


def _analytic_query(params, pts):
    """A deterministic stand-in for a field query: sphere SDFs and smooth
    colours and entropy in the local frame ([N, 5])."""
    d = np.linalg.norm(pts - np.float32([0.3, 0.1, -0.2]), axis=1) - 1.1
    rgb = np.stack([np.sin(2 * pts[:, 0]), np.cos(3 * pts[:, 1]),
                    pts[:, 2]], 1)
    ent = 0.5 + 0.4 * np.sin(pts.sum(1))
    return np.concatenate([rgb, d[:, None], ent[:, None]], 1).astype(
        np.float32)


def test_extraction_identical_on_the_same_volume(monkeypatch):
    """extract_single_mesh and extract_mesh_jointly (device and host
    fusion) fed the same queries and the same fused volume: the same
    vertices, faces and colours, bit for bit."""
    jfcfg, params, anchors, centers, lengths, (occ_j, occs_j), \
        (occ_t, occs_t) = _two_submaps()
    jmesh, tmesh = _meshers(jfcfg, voxel=0.15)
    for mesh in (jmesh, tmesh):
        monkeypatch.setattr(mesh, "query_grid", _analytic_query)
    vol = {}

    def jax_volume(*a, **k):
        vol["v"] = jm.Mesher.fused_sdf_volume_device(jmesh, *a, **k)
        return vol["v"]

    monkeypatch.setattr(jmesh, "fused_sdf_volume_device", jax_volume)
    monkeypatch.setattr(tmesh, "fused_sdf_volume_device",
                        lambda *a, **k: vol["v"])
    tp = [_tree(p) for p in params]
    gb = (np.array([-2.4, -1.7, -2.0]), np.array([2.4, 1.7, 2.0]))
    cases = [
        ("single", lambda m, p, oo, oos: m.extract_single_mesh(
            p[0], anchors[0], centers[0], lengths[0], trunc=0.99,
            bound_world=BOUND, observed_fn=oo, grid_bounds=gb)),
        ("joint device", lambda m, p, oo, oos: m.extract_mesh_jointly(
            p, anchors, centers, lengths, trunc=0.99, bound_world=BOUND,
            observed_fn=oo, submap_observed_fns=oos, grid_bounds=gb)),
        ("joint host", lambda m, p, oo, oos: m.extract_mesh_jointly(
            p, anchors, centers, lengths, trunc=0.99, bound_world=BOUND,
            observed_fn=oo)),
    ]
    for name, fn in cases:
        ref = fn(jmesh, params, occ_j, occs_j)
        out = fn(tmesh, tp, occ_t, occs_t)
        assert len(ref[1]) > 50, name
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(a, b, err_msg=name)


def _mesh_with_islands():
    vol, ax = sphere_tsdf(n=24, r=0.25)
    verts, faces = marching_cubes(vol, 0.0, 0.25)
    verts = -0.5 + verts * (ax[1] - ax[0])
    island_v = verts[:40] * 0.05 + np.array([0.8, 0.0, 0.0])
    island_f = faces[faces.max(1) < 40][:20]
    verts = np.concatenate([verts * 4.0, island_v])
    faces = np.concatenate([faces, island_f + len(verts) - len(island_v)])
    colors = np.random.default_rng(0).uniform(size=verts.shape)
    return verts, faces, colors


def test_visibility_filters_match_jax():
    """point_seen_mask, filter_unseen_faces, remove_small_components and
    apply_visibility_filters on the same mesh and keyframes: identical."""
    verts, faces, colors = _mesh_with_islands()
    rng = np.random.default_rng(4)
    kf = np.tile(np.eye(4), (3, 1, 1))
    for k in range(3):
        a = rng.uniform(-0.6, 0.6)
        kf[k, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]]
        kf[k, :3, 3] = [rng.uniform(-0.5, 0.5), 0.0, 2.2]
    K = np.array([[30.0, 0, 27.5], [0, 30.0, 19.5], [0, 0, 1]])
    max_d = np.array([2.0, 1.8, 2.5])
    seen_j = jm.point_seen_mask(verts, kf, K, 40, 56, max_d)
    seen_t = tm.point_seen_mask(verts, kf, K, 40, 56, max_d)
    np.testing.assert_array_equal(seen_j, seen_t)
    assert 0 < seen_t.sum() < len(seen_t)
    np.testing.assert_array_equal(jm.filter_unseen_faces(faces, seen_j),
                                  tm.filter_unseen_faces(faces, seen_t))
    for area in (0.05, 0.5, 100.0):
        for a, b in zip(jm.remove_small_components(verts, faces, colors,
                                                   area),
                        tm.remove_small_components(verts, faces, colors,
                                                   area)):
            np.testing.assert_array_equal(a, b)
    ref = jm.apply_visibility_filters(verts, faces, colors, kf, K, 40, 56,
                                      max_d, 0.05)
    out = tm.apply_visibility_filters(verts, faces, colors, kf, K, 40, 56,
                                      max_d, 0.05)
    assert 0 < len(out[1]) < len(faces)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)


def test_ply_round_trip_and_concat(tmp_path):
    """The port writes what the JAX package writes, and reads it back;
    concat_meshes offsets the indices as the JAX one does."""
    verts, faces, colors = _mesh_with_islands()
    for c in (colors, None):
        tm.save_mesh_ply(str(tmp_path / "t.ply"), verts, faces, c)
        jm.save_mesh_ply(str(tmp_path / "j.ply"), verts, faces, c)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
        v, f, cc = tm.load_mesh_ply(str(tmp_path / "t.ply"))
        np.testing.assert_allclose(v, verts, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(f, faces)
        if c is None:
            assert cc is None
        else:
            np.testing.assert_array_equal(
                np.round(cc * 255), np.clip(c * 255, 0, 255).astype(
                    np.uint8))
    parts = [(verts, faces, colors), (verts[:50], faces[:10], None)]
    for a, b in zip(jm.concat_meshes(parts), tm.concat_meshes(parts)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- the slice


def slice_config(tmp_path=None):
    """The flagship outback config at a CPU test's size: 40 frames,
    40x56 images, 20x28 keyframe rays, small field widths, voxel 0.12."""
    cfg = flagship_outback()
    cfg["synthetic"]["n_frames"] = 40
    cfg["data"]["output"] = str(tmp_path) if tmp_path else None
    cfg["cam"].update(H=40, W=56, fx=28.0, fy=28.0, cx=27.5, cy=19.5)
    cfg["sampling"].update(kf_n_rays_h=20, kf_n_rays_w=28)
    cfg["grid"].update(tri_resolutions=[8, 16], cp_resolution=32,
                       cp_components=8)
    cfg["decoder"].update(hidden_dim=32, geo_feat_dim=16,
                          hidden_dim_color=16)
    cfg["mesh"].update(voxel_final=0.12)
    return cfg


def jax_checkpoint(path, cfg, jds, seed=0):
    """Write a JAX checkpoint of two submaps to ``path``: keyframes at
    frames 0, 10 (submap 0, anchored at frame 0) and 20, 30 (submap 1,
    anchored at frame 20), their rays from the JAX dataset at the ground-
    truth poses, the state at the JAX system's padded capacity, and two
    random fields (planes brought to O(1)). Returns the fields."""
    from mipsfusion_tpu.slam import state as jstate
    from mipsfusion_tpu.slam.checkpoint import save_ckpt
    from mipsfusion_tpu.slam.system import MIPSFusionTPU
    jslam = MIPSFusionTPU(cfg, dataset=jds)
    st = jslam.state
    H, W = jds.H, jds.W
    samp = cfg["sampling"]
    rows, cols = (np.asarray(a) for a in jstate.kf_downsample_indices(
        H, W, samp["kf_n_rays_h"], samp["kf_n_rays_w"]))
    K = st.kf_rays.shape[0]
    kf_rays = np.zeros(st.kf_rays.shape, np.float32)
    kf_frame_ids = np.full(K, -1, np.int32)
    kf_c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    est = np.tile(np.eye(4, dtype=np.float32), (st.est_c2w.shape[0], 1, 1))
    kf_ref = np.zeros(K, np.int32)
    bind = np.full((K, 2), -1, np.int32)
    M = st.localMLP_info.shape[0]
    info = np.zeros((M, 7), np.float32)
    first = np.full(M, -1, np.int32)
    adj = np.zeros((M, M), np.float32)
    plan = [(0, 0, True), (10, 0, False), (20, 1, True), (30, 1, False)]
    surf = {0: [], 1: []}
    for k, (f, m, is_first) in enumerate(plan):
        packed = np.asarray(jds.packed(f))
        kf_rays[k] = packed[rows, cols]
        kf_frame_ids[k] = f
        gt = np.asarray(jds.gt_pose(f), np.float32)
        if is_first:
            first[m], kf_c2w[k], kf_ref[k] = k, gt, -1
            bind[k] = (m, m - 1 if m else -1)
        else:
            est[f] = np.linalg.inv(kf_c2w[first[m]]) @ gt
            kf_ref[k] = first[m]
            bind[k] = (m, -1)
        d = kf_rays[k, :, 6:7]
        pts = gt[:3, 3] + (kf_rays[k, :, :3] @ gt[:3, :3].T) * d
        surf[m].append(pts[d[:, 0] > 0])
    for m in (0, 1):
        p = np.concatenate(surf[m])
        lo, hi = p.min(0), p.max(0)
        info[m] = [1.0, *((lo + hi) / 2), *(hi - lo)]
    adj[0, 1] = adj[1, 0] = 1.0
    st = st._replace(
        kf_rays=jnp.asarray(kf_rays), kf_frame_ids=jnp.asarray(kf_frame_ids),
        n_kf=jnp.asarray(4, jnp.int32), kf_c2w=jnp.asarray(kf_c2w),
        est_c2w=jnp.asarray(est), keyframe_ref=jnp.asarray(kf_ref),
        localMLP_info=jnp.asarray(info), localMLP_adjacent=jnp.asarray(adj),
        keyframe_localMLP=jnp.asarray(bind),
        localMLP_first_kf=jnp.asarray(first),
        active_submap_id=jnp.asarray(1, jnp.int32),
        prev_active_submap_id=jnp.asarray(0, jnp.int32),
        active_first_kf=jnp.asarray(2, jnp.int32),
        last_switch_frame=jnp.asarray(20, jnp.int32))
    fcfg = jsr.FieldConfig.from_dict(cfg)
    fields = [small_params(fcfg, seed=seed + m) for m in range(2)]
    save_ckpt(str(path), st, fields + [None] * (M - 2),
              extra={"active_id": 1})
    return fields


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    """(JAX system, port system) both resumed from one JAX checkpoint,
    and their joint meshes."""
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDS
    from mipsfusion_tpu.slam.system import MIPSFusionTPU
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    cfg = slice_config()
    ckpt = tmp_path_factory.mktemp("jax_ckpt") / "ckpt_final"
    jds = JDS(cfg, n_frames=40, trajectory="outback", span=1.0)
    jax_checkpoint(ckpt, copy.deepcopy(cfg), jds)
    jslam = MIPSFusionTPU(copy.deepcopy(cfg), dataset=jds)
    jslam.resume_from(str(ckpt))
    tslam = MIPSFusionTorch(copy.deepcopy(cfg), SyntheticDataset(
        cfg, n_frames=40, trajectory="outback", span=1.0, device="cpu"),
        device="cpu")
    tslam.resume_from(str(ckpt))
    return jslam, tslam, jslam.extract_mesh(joint=True), \
        tslam.extract_mesh(joint=True)


def test_slice_jax_checkpoint_to_both_meshes(slice_pair):
    """A JAX checkpoint meshed by both systems (the joint mesh of two
    submaps, fused on the device path): vertex counts within 1%, the
    symmetric mean nearest-vertex distance under voxel / 10, mesh accuracy
    and completion within 1e-3."""
    from mipsfusion_tpu.eval.recon import evaluate_synthetic_mesh as jev
    from mipsfusion_tpu_torch.eval.recon import evaluate_synthetic_mesh
    jslam, tslam, (jv, jf, jc), (tv, tf, tc) = slice_pair
    assert len(jv) > 500 and len(tv) > 500
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv), (len(tv), len(jv))
    sym = 0.5 * (cKDTree(jv).query(tv)[0].mean()
                 + cKDTree(tv).query(jv)[0].mean())
    assert sym < 0.12 / 10, sym
    assert np.isfinite(tc).all() and tc.shape == tv.shape
    mj, mt = jev(jslam, verts=jv), evaluate_synthetic_mesh(tslam, verts=tv)
    for k in ("mesh_accuracy_m", "mesh_completion@5cm"):
        assert abs(mj[k] - mt[k]) < 1e-3, (k, mj[k], mt[k])


def test_recon_metrics_match_jax(slice_pair):
    """evaluate_synthetic_mesh, mesh_accuracy_vs_sdf, mesh_completion and
    depth_l1 on the same vertices: within 1e-6."""
    from mipsfusion_tpu.eval import recon as jr
    from mipsfusion_tpu_torch.eval import recon as tr
    jslam, tslam, (jv, _, _), _ = slice_pair
    mj = jr.evaluate_synthetic_mesh(jslam, verts=jv)
    mt = tr.evaluate_synthetic_mesh(tslam, verts=jv)
    assert mj.keys() == mt.keys()
    for k in mj:
        assert abs(mj[k] - mt[k]) <= 1e-6, (k, mj[k], mt[k])
    assert 0.0 < mt["mesh_completion@5cm"] <= 1.0
    rng = np.random.default_rng(5)
    gt = rng.uniform(-1, 1, (500, 3))
    assert tr.mesh_completion(gt, jv[:300], 0.3) == jr.mesh_completion(
        gt, jv[:300], 0.3)
    pred, dgt = rng.uniform(0, 3, (2, 40, 56))
    dgt[dgt < 0.5] = 0.0
    assert tr.depth_l1(pred, dgt) == jr.depth_l1(pred, dgt)
    assert tr.mesh_accuracy_vs_sdf(np.zeros((0, 3)), None) == float("inf")


def test_mesh_error_split_places_shells_behind_the_walls():
    """mesh_error_split on vertices placed by hand in the synthetic room
    (half extents 3, 2.2, 2.5): four on the walls, two 0.3 m behind the
    +x wall, one 0.02 m inside the floor's plane; the shares and means
    follow, and the accuracy of all of them is mesh_accuracy_vs_sdf's."""
    from mipsfusion_tpu_torch.datasets.synthetic import props_on, scene_sdf
    from mipsfusion_tpu_torch.eval import recon as tr
    half = np.array([3.0, 2.2, 2.5], np.float32)
    verts = np.array([[-2.999, 0.0, 0.0], [0.0, 2.199, 0.5],
                      [0.5, 0.0, -2.499], [0.0, -0.5, 2.499],
                      [3.3, 0.0, 0.0], [3.3, 1.0, -1.0],
                      [0.2, -2.18, 1.9]], np.float32)
    split = tr.mesh_error_split(verts, torch.tensor(half))

    def sdf_fn(p):
        return scene_sdf(torch.as_tensor(p), torch.tensor(half),
                         props_on("cpu")).numpy()

    d = np.abs(sdf_fn(verts))
    assert d[4] == pytest.approx(0.3, abs=1e-5)
    assert d[5] == pytest.approx(0.3, abs=1e-5)
    assert split["outside_share"] == pytest.approx(2 / 7)
    assert split["inside_accuracy_m"] == pytest.approx(
        float(np.r_[d[:4], d[6]].mean()), abs=1e-7)
    assert split["inside_accuracy_m"] < 0.01
    assert split["far_share"] == pytest.approx(2 / 7)
    assert split["far_mean_m"] == pytest.approx(0.3, abs=1e-5)
    assert tr.mesh_accuracy_vs_sdf(verts, sdf_fn) == pytest.approx(
        float(d.mean()), abs=1e-7)

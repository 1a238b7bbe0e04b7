"""The port's HashGrid field against the JAX package on the CPU: the
encoding (forward, table gradient, coordinate gradient) at the default
width and at a small one with dense and hashed levels and points outside
[0, 1]; the field query; one GO step and a BA round on the same inputs;
the config read from a grid block; a short run of the port's loop.

Tolerances: XLA fuses ``x * scale + 0.5`` into one multiply-add on the
CPU, torch rounds twice, so the position inside a cell differs by up to
an ulp of the grid coordinate (2^-24 * 256 = 1.5e-5 at the finest
level); a value moves by that times the table's spread, a coordinate
gradient by that times the level's scale squared. Every bound below is a
few times the product."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.ops import encoding as jenc
from mipsfusion_tpu.slam import mapper as jmapper
from mipsfusion_tpu.slam import tracker as jtracker
from mipsfusion_tpu_torch.convert import params_from_jax, params_to_numpy
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.ops import encoding as tenc
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops.geometry import qt_to_matrix as tqt
from mipsfusion_tpu_torch.slam import mapper as tmapper
from mipsfusion_tpu_torch.slam import tracker as ttracker
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_slam_single import tiny_config
from test_smoke_e2e import smoke_config
from test_torch_losses import port_fcfg
from test_torch_multi import LW, _ba_inputs, _jax_draws

torch.set_num_threads(1)

# 4 levels from 8 to 64 in a 2^12 table: levels 0-1 dense (8^3, 16^3
# <= 4096), levels 2-3 hashed
SMALL = dict(n_levels=4, log2_hashmap_size=12, base_resolution=8,
             desired_resolution=64)


def _configs(**kw):
    return jenc.HashGridConfig(**kw), tenc.HashGridConfig(**kw)


def _encode_case(kw, n, lo, hi, seed):
    jc, tc = _configs(**kw)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (jc.n_levels, jc.table_size,
                                jc.n_features)).astype(np.float32)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    G = rng.normal(size=(n, jc.out_dim)).astype(np.float32)

    def f(t, xx):
        return jnp.sum(jenc.hash_encode(t, xx, jc) * G)

    ref = np.asarray(jenc.hash_encode(jnp.asarray(table), jnp.asarray(x), jc))
    gt, gx = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt = torch.tensor(table, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tenc.hash_encode(tt, xt, tc)
    (out * torch.tensor(G)).sum().backward()
    return (out.detach().numpy(), ref, tt.grad.numpy(), np.asarray(gt),
            xt.grad.numpy(), np.asarray(gx), jc)


def test_config_levels_match_jax():
    for kw in ({}, SMALL, dict(log2_hashmap_size=13)):
        jc, tc = _configs(**kw)
        np.testing.assert_array_equal(tc.level_scales(), jc.level_scales())
        np.testing.assert_array_equal(tc.level_resolutions(),
                                      jc.level_resolutions())
        assert tc.out_dim == jc.out_dim and tc.table_size == jc.table_size
        assert tc.n_dense == int((jc.level_resolutions() ** 3
                                  <= jc.table_size).sum())
    assert _configs(**SMALL)[1].n_dense == 2
    assert _configs()[1].n_dense == 9


@pytest.mark.parametrize("case", ["default", "small_outside"])
def test_hash_encode_matches_jax(case):
    """Forward, table gradient and x gradient. ``default``: 16 x 2 levels,
    2^19 rows, 3,000 points in [0, 1]; ``small_outside``: SMALL (dense and
    hashed levels) with points in [-0.5, 1.5], whose negative corners hash
    through the two's-complement low bits as JAX's uint32 does. Values
    1e-4 and table gradients 1e-4 of a table spread 1; x gradients 1e-4
    of their largest (1e3: a scale of 255 squared times a unit table)."""
    kw, n, lo, hi = ({}, 3000, 0.0, 1.0) if case == "default" else (
        SMALL, 700, -0.5, 1.5)
    out, ref, gt, gt_ref, gx, gx_ref, _ = _encode_case(kw, n, lo, hi, 0)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(gt, gt_ref, atol=1e-4)
    assert np.abs(gt_ref).max() > 0.5
    np.testing.assert_allclose(gx, gx_ref, atol=1e-4 * np.abs(gx_ref).max())


def test_negative_corners_hash_as_uint32():
    """The rows of corners at negative and large coordinates, against a
    numpy uint32 rendition of JAX's hash (no floating point involved)."""
    tc = tenc.HashGridConfig(**SMALL)
    T = tc.table_size
    # points whose finest-level corners are negative: x * 63 + 0.5 < 0
    x = torch.tensor([[-0.4, -1.3, 0.2], [-2.0, 0.7, -0.9],
                      [1.7, -0.05, 3.1]], dtype=torch.float32)
    rows, _, _ = tenc._hash_taps(x, tc)
    scales = tc.level_scales().astype(np.float32)
    for lv in range(tc.n_dense, tc.n_levels):
        pos = x.numpy() * scales[lv] + np.float32(0.5)
        g0 = np.floor(pos).astype(np.int64)
        for c in range(8):
            corner = g0 + np.array([(c >> 2) & 1, (c >> 1) & 1, c & 1])
            cu = corner.astype(np.int64).astype(np.uint32)
            h = ((cu[:, 0] * np.uint32(1))
                 ^ (cu[:, 1] * np.uint32(2654435761))
                 ^ (cu[:, 2] * np.uint32(805459861))) & np.uint32(T - 1)
            assert (corner < 0).any()
            np.testing.assert_array_equal(rows[c, lv].numpy(),
                                          h.astype(np.int64) + lv * T)


def test_table_gradient_is_order_free():
    """The fixed-point table gradient does not depend on the order of the
    points: a permutation gives the same bits (a float scatter would
    not), and it equals a float64 sum of the same shares to float32
    rounding."""
    tc = tenc.HashGridConfig(**SMALL)
    rng = np.random.default_rng(3)
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, 2)).astype(np.float32))
    x = torch.tensor(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(5000, 8)).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(5000))
    _, a = tenc._hash_backward(table, x, g, tc, False, True)
    _, b = tenc._hash_backward(table, x[perm], g[perm], tc, False, True)
    assert torch.equal(a, b)
    rows, wa, _ = tenc._hash_taps(x, tc)
    share = (g.reshape(-1, 4, 2).transpose(0, 1)[None]
             * tenc._weights(wa)[..., None]).double()      # [8, L, n, F]
    ref = torch.zeros((4 * 4096, 2), dtype=torch.float64).index_add_(
        0, rows.reshape(-1), share.reshape(-1, 2))
    np.testing.assert_allclose(a.reshape(-1, 2).numpy(), ref.numpy(),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- the field

def hash_fcfg(**grid):
    """The JAX HashGrid field config at test size: SMALL levels (or
    ``grid``), 8 PE bands, a narrow decoder."""
    g = jenc.HashGridConfig(**(grid or SMALL))
    fcfg = jsr.FieldConfig(enc="HashGrid", grid=g, perturb=False)
    return dataclasses.replace(fcfg, decoder=dataclasses.replace(
        fcfg.decoder, input_ch=g.out_dim, input_ch_pos=fcfg.freq.out_dim + 3,
        n_hidden=32, n_hidden_branch=32, n_hidden_sdf=16, n_hidden_rgb=16))


def port_hash_fcfg(jf):
    return dataclasses.replace(
        port_fcfg(jf), enc="HashGrid",
        grid=tenc.HashGridConfig(**dataclasses.asdict(jf.grid)))


def hash_params(jf, seed=0):
    """JAX-initialized params as numpy, the table brought to O(1)."""
    p = jax.tree.map(np.asarray, jsr.init_field_params(
        jax.random.PRNGKey(seed), jf))
    p["hash"] = p["hash"] * 1e4
    return p


def test_field_query_matches_jax():
    """query_color_sdf_T (differentiable) and field_outputs_T (the RO and
    mesher form, no kernel) against the JAX composite on [3, N] points,
    with the table and x gradients of a fixed cotangent: values 1e-4,
    gradients 1e-4 of each one's largest."""
    jf = hash_fcfg()
    tf = port_hash_fcfg(jf)
    p = hash_params(jf)
    rng = np.random.default_rng(5)
    x = rng.uniform(0.02, 0.98, (400, 3)).astype(np.float32)
    G = rng.normal(size=(10, 400)).astype(np.float32)

    def f(params, xx):
        return jnp.sum(jsr.query_color_sdf_T(params, xx.T, jf) * G)

    jp = jax.tree.map(jnp.asarray, p)
    ref = np.asarray(jsr.query_color_sdf_T(jp, jnp.asarray(x).T, jf))
    gp, gx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    field = params_from_jax(p)
    assert set(field.params()) == {"hash", "decoder"}
    xt = torch.tensor(x, requires_grad=True)
    fc.reset_launch_counts()
    out = tsr.query_color_sdf_T(field.params(), xt.T, tf)
    (out * torch.tensor(G)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4)
    free = tsr.field_outputs_T(field.params(), xt.detach().T, tf)
    np.testing.assert_allclose(free.numpy(), ref, atol=1e-4)
    sdf = tsr.field_outputs_T(field.params(), xt.detach().T, tf,
                              sdf_only=True)
    np.testing.assert_array_equal(sdf[0].numpy(), free[3].numpy())
    for a, b in ((field.hash.grad, gp["hash"]), (xt.grad, gx)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max())
    for n in ("trunk0", "sdf0", "rgb"):
        b = np.asarray(gp["decoder"][n]["w"])
        np.testing.assert_allclose(field.decoder[n]["w"].grad.numpy(), b,
                                   atol=1e-4 * np.abs(b).max())
    assert all(v == 0 for v in fc.launch_counts().values())
    np.testing.assert_array_equal(params_to_numpy(field)["hash"], p["hash"])


def test_go_step_matches_jax():
    """One track_frame with RO and one GO step on the HashGrid field, the
    same params, frame and particle template; no draws (perturb off, the
    GO ray budget equals the pixel grid). The pose to Adam's step (1e-3),
    as tests/test_torch_slice.py's GO bound."""
    jf = dataclasses.replace(hash_fcfg(), n_range_d=7, n_samples_d=9,
                             near=0.0, far=8.0)
    tf = port_hash_fcfg(jf)
    p = hash_params(jf)
    cfg = smoke_config(4)
    ds = JDataset(cfg, n_frames=4, trajectory="orbit", span=4 / 400)
    frame = np.asarray(ds.packed(1))
    pst = np.asarray(jtracker.make_pst(jax.random.PRNGKey(3),
                                       jtracker.ROConfig(particle_size=64)))
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    kw = dict(particle_size=64, n_rows=8, n_cols=12,
              initial_scaling_factor=0.02)
    gkw = dict(n_iters=1, n_rays=96, ignore_edge_w=4, ignore_edge_h=4,
               gate_rel=6.0, best=False)
    ref = jtracker.track_frame(
        jax.tree.map(jnp.asarray, p), jf,
        jsr.FieldConsts.from_bound(jnp.asarray(bound)),
        jtracker.ROConfig(**kw), jtracker.GOConfig(**gkw),
        jnp.asarray(pst), jax.random.PRNGKey(0), jnp.asarray(frame[..., 3:6]),
        jnp.asarray(frame[..., 6]), jnp.asarray(frame[..., :3]),
        jnp.tile(jnp.eye(4), (4, 1, 1)), jnp.asarray(1), jnp.asarray(False),
        jsr.LossWeights(*LW), 2, 1, loss_ewma=jnp.asarray(-1.0))
    f = torch.tensor(frame)
    out = ttracker.track_frame(
        params_from_jax(p).params(detach=True), tf,
        tsr.FieldConsts.from_bound(torch.tensor(bound)),
        ttracker.ROConfig(**kw), ttracker.GOConfig(**gkw), torch.tensor(pst),
        None, f[..., 3:6], f[..., 6], f[..., :3],
        torch.eye(4).repeat(4, 1, 1), 1, False, tsr.LossWeights(*LW), 2, 1,
        torch.tensor(-1.0))
    ref = np.asarray(ref.pose)
    assert not np.allclose(ref, np.eye(4), atol=1e-6)
    np.testing.assert_allclose(out.pose.numpy(), ref, atol=1e-3)


def test_ba_round_matches_jax():
    """A background-refinement BA round (local_ba without the current
    frame: 4 iterations, the map Adam stepping the hash table and the
    decoder, a pose step every 2) on the same draws: keyframe poses and
    every field parameter to 1e-5 (tests/test_torch_multi.py's bound for
    the Triplane field), the last loss to 1e-5 relative."""
    jf = dataclasses.replace(hash_fcfg(), n_range_d=5, n_samples_d=6,
                             range_d=0.25, near=0.0, far=2.5)
    tf = port_hash_fcfg(jf)
    p = hash_params(jf)
    rays, _, poses, _ = _ba_inputs(seed=1)
    mask = np.array([True, True, False, True])
    n_total = 48
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
    w, _ = jmapper._kf_sampling_weights(jnp.asarray(mask), 0, 3, n_total, 0)
    draws = _jax_draws(key, jnp.log(w + 1e-12), jm.iters, n_total,
                       rays.shape[1], 8)
    field = params_from_jax(p)
    tm = tmapper.MapConfig(sample=n_total, pixels_cur=16, iters=4,
                           pose_accum_step=2)
    opt = tmapper.make_map_optimizer(field, tm)
    assert opt.param_groups[1]["params"] == [field.hash]
    res = tmapper.local_ba(
        field, opt, torch.tensor(rays), torch.tensor(mask), 0,
        torch.tensor(3), torch.tensor(poses), torch.zeros((8, 7)),
        torch.eye(4), tf,
        tsr.FieldConsts(torch.full((3,), -10.0), torch.full((3,), 0.047)),
        tm, tsr.LossWeights(*LW), n_total, include_current=False,
        draws=draws)
    from mipsfusion_tpu.ops.geometry import qt_to_matrix as jqt
    ref_poses = np.asarray(jqt(ref.kf_quat, ref.kf_trans))
    assert np.abs(ref_poses[1] - poses[1]).max() > 1e-4
    np.testing.assert_allclose(tqt(res.kf_quat, res.kf_trans).numpy(),
                               ref_poses, atol=1e-5)
    assert float(res.loss) == pytest.approx(float(ref.loss), rel=1e-5)
    out = params_to_numpy(field)
    assert np.abs(out["hash"] - p["hash"]).max() > 1e-3      # it trained
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-5), out, ref.field_params)


# ------------------------------------------------- consistency losses

@pytest.mark.parametrize("enc,rgb_weight", [("HashGrid", 0.0),
                                            ("HashGrid", 0.5),
                                            ("Triplane", 0.0)])
def test_consistency_losses_match_jax(enc, rgb_weight):
    """sdf_consistency_loss, rgb_consistency_loss and
    cross_submap_consistency (two fields, two local poses, rays with an
    invalid depth) against the JAX package's, and the objective's
    gradient w.r.t. the second pose, on a HashGrid and a Triplane field:
    values to 1e-5 relative, the pose gradient to 1e-4 of its largest.
    The points stay inside the box, where the two packages' coordinate
    gradients agree (ROADMAP C, clamped-coordinate gradient)."""
    from mipsfusion_tpu.ops import losses as jl
    from mipsfusion_tpu_torch.ops import losses as tl
    from test_torch_field import small_fcfg, small_params
    if enc == "HashGrid":
        jf = hash_fcfg()
        tf = port_hash_fcfg(jf)
        p1, p2 = hash_params(jf, 0), hash_params(jf, 1)
    else:
        jf = small_fcfg()
        tf = port_fcfg(jf)
        p1, p2 = small_params(jf, 0), small_params(jf, 1)
    rng = np.random.default_rng(8)
    n = 96
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = rng.uniform(0.2, 0.8, (n, 1)).astype(np.float32)
    depth[[3, 50]] = 0.0
    pose1 = np.eye(4, dtype=np.float32)
    pose2 = np.eye(4, dtype=np.float32)
    pose2[:3, 3] = [0.05, -0.03, 0.02]
    bound = np.array([[-1.5, 1.5]] * 3, np.float32)
    jc = jsr.FieldConsts.from_bound(jnp.asarray(bound))
    tc = tsr.FieldConsts.from_bound(torch.tensor(bound))
    jp1, jp2 = (jax.tree.map(jnp.asarray, p) for p in (p1, p2))

    def jloss(pose):
        return jl.cross_submap_consistency(
            jp1, jp2, jf, jc, jc, jnp.asarray(d), jnp.asarray(depth),
            jnp.asarray(pose1), pose, rgb_weight=rgb_weight)

    ref, gref = jax.value_and_grad(jloss)(jnp.asarray(pose2))
    f1, f2 = params_from_jax(p1), params_from_jax(p2)
    tp2 = torch.tensor(pose2, requires_grad=True)
    out = tl.cross_submap_consistency(
        f1.params(detach=True), f2.params(detach=True), tf, tc, tc,
        torch.tensor(d).T, torch.tensor(depth)[:, 0], torch.tensor(pose1),
        tp2, rgb_weight=rgb_weight)
    out.backward()
    assert float(ref) > 1e-4
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-5)
    g = np.asarray(gref)
    np.testing.assert_allclose(tp2.grad.numpy(), g,
                               atol=1e-4 * np.abs(g).max())
    # the two losses alone, on the same numbers
    a = rng.normal(size=(n, 1)).astype(np.float32)
    b = rng.normal(size=(n, 1)).astype(np.float32)
    ra = rng.uniform(size=(n, 3)).astype(np.float32)
    rb = rng.uniform(size=(n, 3)).astype(np.float32)
    mask = (depth > 0).astype(np.float32)
    assert float(tl.sdf_consistency_loss(
        torch.tensor(a), torch.tensor(b), torch.tensor(mask))) == \
        pytest.approx(float(jl.sdf_consistency_loss(a, b, mask)), rel=1e-6)
    assert float(tl.rgb_consistency_loss(
        torch.tensor(ra), torch.tensor(rb), torch.tensor(mask))) == \
        pytest.approx(float(jl.rgb_consistency_loss(ra, rb, mask)),
                      rel=1e-6)


# -------------------------------------------------------- the config

def _grid_cfg(**grid):
    cfg = tiny_config(4)
    cfg["grid"] = {"hash_size": 13, "use_bound_normalize": True, **grid}
    return cfg


@pytest.mark.parametrize("grid", [
    dict(enc="Triplane", cp_resolution=384, cp_components=40),
    dict(enc="Triplane"),
    dict(),
    dict(tri_features=2)], ids=["triplane_cp", "triplane", "no_enc",
                                "no_enc_features"])
def test_from_dict_matches_jax(grid):
    """A grid block without tri_resolutions (and one without enc) reads
    into the same field in both packages: the plane stack (32, 64, 128,
    256), the decoder's input width (56 with the CP lines, 16 without;
    32 for the hash grid) and the enc default, HashGrid."""
    cfg = _grid_cfg(**grid)
    jf = jsr.FieldConfig.from_dict(cfg)
    tf = tsr.FieldConfig.from_dict(cfg)
    assert tf.enc == jf.enc == grid.get("enc", "HashGrid")
    assert tf.tri.resolutions == jf.tri.resolutions == (32, 64, 128, 256)
    assert tf.decoder.input_ch == jf.decoder.input_ch
    assert tf.grid == tenc.HashGridConfig(**dataclasses.asdict(jf.grid))
    assert dataclasses.asdict(tf.decoder) == {
        k: v for k, v in dataclasses.asdict(jf.decoder).items()
        if k != "bf16"}
    if grid.get("cp_resolution"):
        assert tf.decoder.input_ch == 56


def test_default_plane_stack_raises_on_the_card_only():
    """The default plane stack is no shape of the kernels' table: the CPU
    takes it (plain versions), a CUDA tensor is refused naming the
    table."""
    from mipsfusion_tpu_torch.ops import _build
    cfg = _grid_cfg(enc="Triplane", cp_resolution=384, cp_components=40)
    cfg["pos"]["n_bins"] = 8
    fcfg = tsr.FieldConfig.from_dict(cfg)
    g = torch.Generator()
    g.manual_seed(0)
    params = tsr.init_field(fcfg, g)
    with pytest.raises(ValueError, match=r"these shapes only: \[32, 64\] "
                       r".*got 4 plane scales"):
        _build.kernel_shape(params["planes"], *fcfg.meta)
    x = torch.rand(3, 64)
    assert tsr.field_outputs_T(params, x, fcfg).shape == (10, 64)


# --------------------------------------------------------- the loop

def test_port_hash_run_smoke():
    """Six frames of the tiny HashGrid orbit with small RO, GO, BA and
    fit budgets: the loop runs on the hash field end to end (a keyframe
    and a BA round included), no kernel launches, tracking stays finite
    and near the ground truth."""
    n = 6
    cfg = tiny_config(n)
    cfg["mapping"].update(first_iters=60, iters=4, sample=300,
                          pixels_cur=100)
    cfg["tracking"].update(iter=4, iter_RO=2, sample=200)
    cfg["tracking"]["RO"]["particle_size"] = 64
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="orbit", span=n / 200,
                          device="cpu")
    slam = MIPSFusionTorch(copy.deepcopy(cfg), dataset=ds, device="cpu")
    assert slam.fcfg.enc == "HashGrid"
    fc.reset_launch_counts()
    res = slam.run(verbose=False)
    assert all(v == 0 for v in fc.launch_counts().values())
    assert np.isfinite([float(v) for v in slam.track_losses]).all()
    assert res["absolute_translational_error.rmse"] < 0.05, res
    assert slam.field.hash.shape == (16, 1 << 13, 2)


@pytest.mark.slow
def test_port_tiny_hash_orbit():
    """tests/test_slam_single.py's tiny HashGrid orbit (24 frames) through
    the port: ATE under its 0.02 m. Slow: the hash grid's 16-level
    gathers at RO's 307,200 points a call take seconds on one CPU
    thread."""
    n = 24
    cfg = tiny_config(n)
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="orbit", span=n / 200,
                          device="cpu")
    res = MIPSFusionTorch(cfg, dataset=ds, device="cpu").run(verbose=False)
    assert res["absolute_translational_error.rmse"] < 0.02, res

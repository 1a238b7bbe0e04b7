"""The HashGrid field and the SDF-consistency global BA at the system
level, in both packages: a JAX HashGrid checkpoint (the tiny config of
tests/test_slam_single.py, first fit on frame 0 and two more keyframes at
their ground-truth poses) resumed in the port with its Adam moments, the
port's checkpoint resumed in JAX, and ``global_ba_consistency`` on
tests/test_consistency_ba.py's fabricated overlap: both systems resumed
from one JAX checkpoint, 5 iterations, 128 rays, the same anchors."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.slam.system import MIPSFusionTPU
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.slam import checkpoint as tckpt
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_slam_single import tiny_config

torch.set_num_threads(1)
N = 13                      # keyframes at frames 0, 6, 12


def _config(out):
    cfg = tiny_config(N)
    cfg["mapping"]["first_iters"] = 40
    cfg["data"]["output"] = str(out)
    return cfg


def _jax_frame(ds, i):
    return {"frame_id": i, "c2w": ds.gt_pose(i)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(config, checkpoint of the fit and keyframes, checkpoint of the
    fabricated overlap) written by the JAX package."""
    cfg = _config(tmp_path_factory.mktemp("hash_system"))
    span = N / 200.0
    jds = JDataset(copy.deepcopy(cfg), n_frames=N, trajectory="orbit",
                   span=span)
    slam = MIPSFusionTPU(copy.deepcopy(cfg), dataset=jds)
    slam.process_frame(_jax_frame(jds, 0), 0)
    gt0_inv = np.linalg.inv(jds.gt_pose(0))
    for i in (6, 12):
        st = slam.state
        slam.state = st._replace(est_c2w=st.est_c2w.at[i].set(
            jnp.asarray(gt0_inv @ jds.gt_pose(i), jnp.float32)))
        slam.add_keyframe(_jax_frame(jds, i), i)
    fit = slam.save_checkpoint("fit")
    # tests/test_consistency_ba.py's overlap: keyframe 2 bound to (0, 1),
    # submap 1 (the initial field) anchored 5 cm off submap 0
    st = slam.state
    slam.submap_params[1] = slam.initial_params
    perturb = np.eye(4, dtype=np.float32)
    perturb[0, 3] = 0.05
    slam.state = st._replace(
        localMLP_info=st.localMLP_info.at[1, 0].set(1.0),
        localMLP_first_kf=st.localMLP_first_kf.at[1].set(1),
        keyframe_ref=st.keyframe_ref.at[2].set(-2),
        keyframe_localMLP=st.keyframe_localMLP.at[2].set(
            jnp.asarray([0, 1], jnp.int32)),
        kf_c2w=st.kf_c2w.at[1].set(jnp.asarray(perturb) @ st.kf_c2w[0]))
    ovlp = slam.save_checkpoint("overlap")
    return cfg, fit, ovlp


def _port(cfg):
    ds = SyntheticDataset(copy.deepcopy(cfg), n_frames=N, trajectory="orbit",
                          span=N / 200.0, device="cpu")
    return MIPSFusionTorch(copy.deepcopy(cfg), dataset=ds, device="cpu")


def _jax(cfg):
    jds = JDataset(copy.deepcopy(cfg), n_frames=N, trajectory="orbit",
                   span=N / 200.0)
    return MIPSFusionTPU(copy.deepcopy(cfg), dataset=jds)


def test_jax_hash_checkpoint_resumes_in_the_port(ckpts):
    """The port reads the JAX HashGrid checkpoint: the field ({"hash",
    "decoder"}) and the keyframes exactly, and the map Adam's moments in
    JAX's leaf order (decoder group, then the embed group's one table):
    the port's leaves equal JAX's file bit for bit, step 40 each."""
    cfg, fit, _ = ckpts
    slam = _port(cfg)
    assert slam.fcfg.enc == "HashGrid"
    assert slam.resume_from(fit) == 13
    jslam = _jax(cfg)
    assert jslam.resume_from(fit) == 13
    p = slam.field.params(detach=True)
    assert set(p) == {"hash", "decoder"}
    np.testing.assert_array_equal(p["hash"].numpy(),
                                  np.asarray(jslam.submap_params[0]["hash"]))
    for n, d in p["decoder"].items():
        for k, t in d.items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jslam.submap_params[0]["decoder"][n][k]))
    np.testing.assert_array_equal(slam.state.kf_rays[:3].numpy(),
                                  np.asarray(jslam.state.kf_rays[:3]))
    leaves = tckpt.adam_to_leaves(slam.map_opt, slam.field)
    ref = [np.asarray(a) for a in jax.tree.leaves(jslam.map_opt_state)]
    assert len(leaves) == len(ref) == 1 + 2 * 10 + 1 + 2
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(a, b)
    assert int(leaves[0]) == int(leaves[21]) == 40
    # the embed group's moments are the table's
    assert leaves[22].shape == tuple(p["hash"].shape)
    assert np.abs(leaves[22]).max() > 0


def test_port_hash_checkpoint_resumes_in_jax(ckpts, tmp_path):
    """The port's checkpoint of the resumed run is read back by JAX: the
    same table, decoder and Adam leaves."""
    cfg, fit, _ = ckpts
    slam = _port(cfg)
    slam.resume_from(fit)
    slam.output_dir = str(tmp_path)
    out = slam.save_checkpoint("port")
    jslam = _jax(cfg)
    assert jslam.resume_from(out) == 13
    np.testing.assert_array_equal(np.asarray(jslam.submap_params[0]["hash"]),
                                  slam.field.hash.detach().numpy())
    ref = [np.asarray(a) for a in jax.tree.leaves(jslam.map_opt_state)]
    for a, b in zip(tckpt.adam_to_leaves(slam.map_opt, slam.field), ref):
        np.testing.assert_array_equal(a, b)


def test_global_ba_consistency_matches_jax(ckpts):
    """tests/test_consistency_ba.py's fabricated overlap in both systems:
    5 iterations on 128 rays of keyframe 2. Anchor 0 stays bit for bit,
    anchor 1 moves (Adam, lr 1e-3: up to 5e-3 in 5 steps) and agrees with
    JAX's to 2e-5 (float32 rounding through the fields and the pose math;
    a step's sign flip would be 1e-3), a rotation. Grouping every point of
    a submap into one query gives the same objective as a query per pair
    and side (ops/losses.cross_submap_consistency), to float32 rounding."""
    cfg, _, ovlp = ckpts
    jslam = _jax(cfg)
    jslam.resume_from(ovlp)
    before = np.asarray(jslam.state.kf_c2w[:2]).copy()
    jslam.global_ba_consistency(n_iters=5, n_rays=128)
    ref = np.asarray(jslam.state.kf_c2w[:2])
    slam = _port(cfg)
    slam.resume_from(ovlp)
    np.testing.assert_array_equal(slam.state.kf_c2w[:2].numpy(), before)
    slam.global_ba_consistency(n_iters=5, n_rays=128)
    out = slam.state.kf_c2w[:2].numpy()
    np.testing.assert_array_equal(out[0], before[0])
    assert np.abs(out[1] - before[1]).max() > 1e-4
    np.testing.assert_allclose(out, ref, atol=2e-5)
    R = out[1][:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    log = slam.consistency_log[-1]
    assert log["pairs"] == 1 and len(log["losses"]) == 5


def test_consistency_grouping_equals_per_pair_loss(ckpts):
    """The system's grouped objective against cross_submap_consistency on
    the same pair (the port's own per-pair form), at the checkpoint's
    anchors."""
    from mipsfusion_tpu_torch.ops.geometry import pose_inverse
    from mipsfusion_tpu_torch.ops.losses import cross_submap_consistency
    from mipsfusion_tpu_torch.slam.system import consistency_loss
    cfg, _, ovlp = ckpts
    slam = _port(cfg)
    slam.resume_from(ovlp)
    st = slam.state
    rays = st.kf_rays[2][torch.as_tensor(
        np.linspace(0, st.kf_rays.shape[1] - 1, 128).astype(np.int64))]
    anchors = st.kf_c2w[st.localMLP_first_kf[:2]]
    local1 = st.est_c2w[12]
    params = {m: slam.fields[m].params(detach=True) for m in (0, 1)}
    grouped = consistency_loss(params, [(2, 0, 1)], rays[None, :, :3]
                               .transpose(1, 2), rays[None, :, 6],
                               local1[None], anchors, slam.fcfg, slam.consts)
    per_pair = cross_submap_consistency(
        params[0], params[1], slam.fcfg, slam.consts, slam.consts,
        rays[:, :3].T, rays[:, 6], local1,
        pose_inverse(anchors[1]) @ anchors[0] @ local1)
    assert float(per_pair) > 0
    assert float(grouped) == pytest.approx(float(per_pair), rel=1e-6)


def test_consistency_on_triplane_launches_no_weight_gradient(ckpts):
    """On a Triplane field the consistency objective's backward asks the
    field for the coordinates' gradient alone: on the CPU the plain
    versions serve, so the launch counts stay 0, and no field parameter
    receives a gradient."""
    from mipsfusion_tpu_torch.models import scene_rep as tsr
    from mipsfusion_tpu_torch.slam.system import consistency_loss
    cfg, _, _ = ckpts
    tcfg = copy.deepcopy(cfg)
    tcfg["grid"].update(enc="Triplane", tri_resolutions=[8, 16],
                        cp_resolution=32, cp_components=8)
    fcfg = tsr.FieldConfig.from_dict(tcfg)
    g = torch.Generator()
    g.manual_seed(0)
    fields = [tsr.Field(tsr.init_field(fcfg, g)) for _ in range(2)]
    rng = np.random.default_rng(0)
    dirs = torch.tensor(rng.normal(size=(1, 3, 64)).astype(np.float32))
    depth = torch.tensor(rng.uniform(0.5, 2.0, (1, 64)).astype(np.float32))
    anchors = torch.eye(4).repeat(2, 1, 1)
    anchors[1, 0, 3] = 0.05
    anchors.requires_grad_(True)
    consts = tsr.FieldConsts.from_bound(torch.tensor(
        cfg["mapping"]["bound"], dtype=torch.float32))
    fc.reset_launch_counts()
    loss = consistency_loss({m: fields[m].params(detach=True)
                             for m in (0, 1)}, [(0, 0, 1)], dirs, depth,
                            torch.eye(4)[None], anchors, fcfg, consts)
    loss.backward()
    assert all(v == 0 for v in fc.launch_counts().values())
    assert anchors.grad is not None and anchors.grad[1].abs().max() > 0
    assert all(p.grad is None for f in fields for p in f.parameters())

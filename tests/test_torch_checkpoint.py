"""The port's checkpoints (``mipsfusion_tpu_torch/slam/checkpoint.py``)
against the JAX package's: the same files and keys read both ways, the
map optimizer's Adam moments in the JAX leaf order, the JAX capacity
padding, and on a tiny CPU run of the port a checkpoint, ``resume_from``
and the mesh after it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mipsfusion_tpu.slam import checkpoint as jck
from mipsfusion_tpu.slam import mapper as jmapper
from mipsfusion_tpu.slam import state as jstate
from mipsfusion_tpu_torch.convert import params_from_jax, params_to_numpy
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.slam import checkpoint as tck
from mipsfusion_tpu_torch.slam import mapper as tmapper
from mipsfusion_tpu_torch.slam import state as tstate
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_torch_field import small_fcfg, small_params
from test_torch_multi import corridor_config

torch.set_num_threads(1)

MCFG_DICT = {"mapping": {"sample": 96, "pixels_cur": 48, "iters": 3,
                         "lr_embed": 0.01, "lr_decoder": 0.01,
                         "lr_rot": 0.001, "lr_trans": 0.001,
                         "first_iters": 40, "optim_cur": False,
                         "min_pixels_cur": 20, "map_accum_step": 1,
                         "pose_accum_step": 5, "map_wait_step": 0}}


def _jax_state(n_frames=256, n_kf=26, M=4, R=12, seed=0):
    """A JAX state at the JAX system's padded capacity with n_kf = 3 used
    keyframes in 2 submaps (rows beyond them empty)."""
    cap = jstate.StateCapacity(n_frames=n_frames, n_keyframes=n_kf,
                               n_submaps=M, rays_per_kf=R, kf_rays_h=3,
                               kf_rays_w=4)
    st = jstate.init_state(cap, [2.0, 2.0, 2.0])
    rng = np.random.default_rng(seed)
    rays = np.zeros((n_kf, R, 7), np.float32)
    rays[:3] = rng.uniform(0.1, 2.0, (3, R, 7))
    ids = np.full(n_kf, -1, np.int32)
    ids[:3] = [0, 5, 10]
    kf_c2w = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    kf_c2w[2, :3, 3] = [0.5, 0.0, 0.1]
    est = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    est[1:10, :3, 3] = rng.normal(0, 0.1, (9, 3))
    bind = np.full((n_kf, 2), -1, np.int32)
    bind[:3] = [[0, -1], [0, -1], [1, 0]]
    info = np.zeros((M, 7), np.float32)
    info[:2] = rng.uniform(0.5, 2.0, (2, 7))
    info[:2, 0] = 1.0
    return st._replace(
        kf_rays=jnp.asarray(rays), kf_frame_ids=jnp.asarray(ids),
        n_kf=jnp.asarray(3, jnp.int32), kf_c2w=jnp.asarray(kf_c2w),
        est_c2w=jnp.asarray(est), est_c2w_rel=jnp.asarray(est),
        keyframe_ref=jnp.asarray(np.r_[-1, 0, -1, np.zeros(n_kf - 3)]
                                 .astype(np.int32)),
        localMLP_info=jnp.asarray(info),
        keyframe_localMLP=jnp.asarray(bind),
        localMLP_first_kf=jnp.asarray(np.r_[0, 2, -1, -1].astype(np.int32)),
        localMLP_adjacent=jnp.asarray(np.eye(M, k=1) + np.eye(M, k=-1),
                                      jnp.float32),
        active_submap_id=jnp.asarray(1, jnp.int32),
        prev_active_submap_id=jnp.asarray(0, jnp.int32),
        active_first_kf=jnp.asarray(2, jnp.int32),
        last_switch_frame=jnp.asarray(10, jnp.int32))


def _jax_opt_state(params, seed=1, steps=2):
    """The JAX map optimizer after ``steps`` updates with seeded grads;
    returns (optimizer, state, grads of one more step)."""
    opt = jmapper.make_map_optimizer(jmapper.MapConfig.from_dict(MCFG_DICT))
    st = opt.init(params)
    rng = np.random.default_rng(seed)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.normal(0, 1, p.shape), jnp.float32), params)

    for _ in range(steps):
        upd, st = opt.update(grads(), st, params)
        params = optax.apply_updates(params, upd)
    return opt, st, params, grads()


def _port_run_state(n_frames=12, n_kf=3):
    return tstate.init_state(n_frames, n_kf, 4, 12, [2.0, 2.0, 2.0], "cpu")


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """JAX save_ckpt -> the port's load_ckpt into a run of 12 frames and 3
    keyframes: every state field equal on the run's rows (the JAX padding
    rows are empty and dropped), fields equal, and the Adam moments load
    so that one more step moves the parameters as optax does."""
    fcfg = small_fcfg()
    p0, p1 = small_params(fcfg, seed=0), small_params(fcfg, seed=1)
    jopt, jst, p1, g = _jax_opt_state(p1)
    st = _jax_state()
    path = str(tmp_path / "ckpt_5")
    jck.save_ckpt(path, st, [p0, p1, None, None], extra={"active_id": 1},
                  opt_state=jst)
    like = _port_run_state()
    tst, fields, extra = tck.load_ckpt(path, like=like)
    assert int(extra["active_id"]) == 1 and fields[2] is None
    for name in tck.STATE_FIELDS:
        got, ref = getattr(tst, name), np.asarray(getattr(st, name))
        if name in ("n_kf", "active_submap_id", "prev_active_submap_id",
                    "last_switch_frame"):
            assert got == int(ref), name
            continue
        got = got.numpy()
        if got.shape != ref.shape:
            ref = ref[:got.shape[0]]
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert got.dtype in (np.float32, np.int64), name
    for f, p in zip(fields[:2], (p0, p1)):
        jax.tree.map(np.testing.assert_array_equal, params_to_numpy(f), p)

    # the moments: one more step with the same gradient on both sides
    field = fields[1]
    opt = tmapper.make_map_optimizer(
        field, tmapper.MapConfig.from_dict(MCFG_DICT))
    assert tck.load_opt_state(path, opt, field)
    upd, _ = jopt.update(g, jst, p1)
    ref = optax.apply_updates(p1, upd)
    tg = params_from_jax(g).params()
    for p, gg in zip(jax.tree.leaves(field.params()), jax.tree.leaves(tg)):
        p.grad = gg.detach().clone()
    opt.step()
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-5, atol=1e-7), params_to_numpy(field), ref)


def test_port_checkpoint_loads_into_jax(tmp_path):
    """The port's save_ckpt -> JAX load_ckpt and load_opt_state: state
    fields equal (int32 as the JAX package writes them), fields equal, and
    the Adam leaves are the port's moments in the JAX leaf order."""
    fcfg = small_fcfg()
    p0 = small_params(fcfg, seed=2)
    like = _port_run_state(n_frames=256, n_kf=26)
    jst_state = _jax_state()
    tst, _, _ = tck.load_ckpt(_write_jax(tmp_path, jst_state, p0), like=like)
    field = params_from_jax(p0)
    opt = tmapper.make_map_optimizer(
        field, tmapper.MapConfig.from_dict(MCFG_DICT))
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        for p in field.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    path = str(tmp_path / "ckpt_port")
    tck.save_ckpt(path, tst, [params_from_jax(p0), field, None, None],
                  extra={"active_id": 1}, opt=opt, opt_field=field)
    st, params, extra = jck.load_ckpt(path)
    assert int(extra["active_id"]) == 1 and params[2] is None
    for name in jstate.SlamState._fields:
        got, ref = np.asarray(getattr(st, name)), np.asarray(
            getattr(jst_state, name))
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, params[1]), params_to_numpy(field))
    jopt = jmapper.make_map_optimizer(jmapper.MapConfig.from_dict(MCFG_DICT))
    template = jopt.init(jax.tree.map(jnp.asarray, p0))
    restored = jck.load_opt_state(path, template)
    assert restored is not None
    leaves = jax.tree.leaves(restored)
    assert [int(leaves[0]), int(leaves[21])] == [3, 3]
    dec = ["rgb", "sdf0", "sdf1", "trunk0", "trunk1"]
    mu = [opt.state[field.decoder[n][k]]["exp_avg"] for n in dec
          for k in ("b", "w")]
    for a, b in zip(leaves[1:11], mu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    nu = [opt.state[field.planes[k]]["exp_avg_sq"] for k in ("cp", "s0",
                                                             "s1")]
    for a, b in zip(leaves[-3:], nu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _write_jax(tmp_path, st, p0):
    path = str(tmp_path / "ckpt_jax")
    jck.save_ckpt(path, st, [p0, p0, None, None], extra={"active_id": 1})
    return path


def test_padding_rows_must_be_empty_and_mismatched_optimizer_is_fresh(
        tmp_path):
    """A checkpoint row beyond the run's capacity that is not empty
    raises; optimizer leaves of another layout leave the Adam fresh."""
    st = _jax_state()
    st = st._replace(kf_frame_ids=st.kf_frame_ids.at[7].set(70))
    fcfg = small_fcfg()
    p0 = small_params(fcfg)
    path = _write_jax(tmp_path, st, p0)
    with pytest.raises(ValueError, match="kf_frame_ids.*not empty"):
        tck.load_ckpt(path, like=_port_run_state(n_kf=3))
    tck.load_ckpt(path, like=_port_run_state(n_kf=8))      # row 7 kept
    np.savez(os.path.join(path, "opt_state.npz"), leaf_0=np.zeros(3))
    field = params_from_jax(p0)
    opt = tmapper.make_map_optimizer(
        field, tmapper.MapConfig.from_dict(MCFG_DICT))
    assert not tck.load_opt_state(path, opt, field)
    assert not opt.state


def resume_config(n, out=None):
    """corridor_config at 5 cm a frame with larger budgets: a second
    submap at frame 12, background refinement, ATE ~2 cm on the CPU."""
    cfg = corridor_config(n)
    cfg["mapping"].update(first_iters=150, iters=6, first_iters_chunk=50)
    cfg["tracking"].update(iter=6, iter_RO=3)
    cfg["data"].update(output=out, exp_name="resume")
    cfg["mesh"].update(vis=0, ckpt_freq=15, voxel_final=0.15,
                       extract_final=False)
    return cfg


def test_resume_restores_mirrors_refines_and_meshes_the_same(tmp_path):
    """20 corridor frames with a checkpoint at frame 15 (two submaps);
    a fresh system's resume_from restores the host mirrors, starts at the
    frame after the last keyframe, refines and finishes under the ATE
    bound of test_port_run_smoke; the mesh after resume_from from the
    final checkpoint equals the live system's bit for bit."""
    n = 20
    cfg = resume_config(n, str(tmp_path))
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="corridor", span=0.25,
                          device="cpu")
    live = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    mirrors = {}
    save = live.save_checkpoint

    def spy(tag="final"):
        out = save(tag)
        mirrors[tag] = (live._host_used, live._host_kf_bind.copy(),
                        live.active_id)
        return out

    live.save_checkpoint = spy
    res = live.run(verbose=False)
    assert res["absolute_translational_error.rmse"] < 0.10, res
    assert res["n_submaps"] == 2 and set(mirrors) == {"15", "final"}
    exp = os.path.join(str(tmp_path), "resume")
    for f in ("ckpt.npz", "model_0.npz", "model_1.npz", "opt_state.npz"):
        assert os.path.exists(os.path.join(exp, "ckpt_15", f)), f

    again = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    start = again.resume_from(os.path.join(exp, "ckpt_15"))
    assert start == 16                       # after the keyframe at 15
    used, bind, active = mirrors["15"]
    assert again._host_used == used == 2 and again.active_id == active
    np.testing.assert_array_equal(again._host_kf_bind, bind)
    assert float(again._loss_ewma) == -1.0
    res2 = again.run(verbose=False, start=start)
    assert again.stage_calls["refine"] >= 1
    assert again.stage_calls["track"] == n - start
    assert res2["absolute_translational_error.rmse"] < 0.10, res2

    mesh = live.extract_mesh()
    fresh = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    fresh.resume_from(os.path.join(exp, "ckpt_final"))
    assert len(mesh[1]) > 100
    for a, b in zip(mesh, fresh.extract_mesh()):
        np.testing.assert_array_equal(a, b)

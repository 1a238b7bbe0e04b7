"""Ray data-parallel mapping: the port's ``local_ba`` and
``init_submap_fit`` with a mesh against the JAX package's with
``ray_sharding`` on its 8-device CPU mesh, on the same draws, and the
system's ray-budget rounding and switches against the JAX system's."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.ops.geometry import qt_to_matrix as jqt
from mipsfusion_tpu.slam import mapper as jmapper
from mipsfusion_tpu.slam.system import MIPSFusionTPU
from mipsfusion_tpu_torch.config import parallel_config
from mipsfusion_tpu_torch.convert import params_from_jax, params_to_numpy
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.ops.geometry import qt_to_matrix as tqt
from mipsfusion_tpu_torch.parallel.sharding import make_mesh
from mipsfusion_tpu_torch.slam import mapper as tmapper
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_torch_multi import (LW, _ba_inputs, _jax_draws, _rand_rays,
                              ba_field, corridor_config)  # noqa: F401

torch.set_num_threads(1)
BOX = (-10.0, 0.047)


def _sharding(n=8):
    assert len(jax.devices()) >= n, "conftest must provide 8 CPU devices"
    return NamedSharding(JMesh(np.array(jax.devices()[:n]), ("data",)),
                         P("data"))


def _jconsts():
    return jsr.FieldConsts(jnp.full(3, BOX[0]), jnp.full(3, BOX[1]))


def _tconsts():
    return tsr.FieldConsts(torch.full((3,), BOX[0]), torch.full((3,), BOX[1]))


def _mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


def _close(field, ref, atol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=atol), params_to_numpy(field), ref)


def test_sharded_local_ba_matches_jax(ba_field):
    """Local BA with the current frame (48 rays an iteration, 4
    iterations, a pose step every 2) at 8 shards in both packages on
    JAX's draws: keyframe poses and every field parameter to 1e-5, the
    last loss to rtol 1e-5; the port's sharded poses against its
    unsharded ones to 1e-6."""
    jf, tf, p = ba_field
    rays, cur, poses, cur_pose = _ba_inputs(seed=2)
    mask = np.array([True, True, False, True])
    first_kf, last_kf, n_total = 0, 3, 48
    jm = jmapper.MapConfig(sample=32, pixels_cur=16, iters=4,
                           pose_accum_step=2)
    key = jax.random.PRNGKey(6)
    jp = jax.tree.map(jnp.asarray, p)
    ref = jmapper.local_ba(
        jp, jmapper.make_map_optimizer(jm).init(jp), key, jnp.asarray(rays),
        jnp.asarray(mask), first_kf, last_kf, jnp.asarray(poses),
        jnp.asarray(cur), jnp.asarray(cur_pose), jf, _jconsts(), jm,
        jsr.LossWeights(*LW), n_total, ray_sharding=_sharding())
    w, _ = jmapper._kf_sampling_weights(jnp.asarray(mask), first_kf,
                                        last_kf, 32, 16)
    draws = _jax_draws(key, jnp.log(w + 1e-12), jm.iters, n_total,
                       rays.shape[1], cur.shape[0])
    assert any(int((d[0] == len(mask)).sum()) > 0 for d in draws)
    tm = tmapper.MapConfig(sample=32, pixels_cur=16, iters=4,
                           pose_accum_step=2)
    out = {}
    for n in (8, None):
        field = params_from_jax(p)
        res = tmapper.local_ba(
            field, tmapper.make_map_optimizer(field, tm), torch.tensor(rays),
            torch.tensor(mask), first_kf, torch.tensor(last_kf),
            torch.tensor(poses), torch.tensor(cur), torch.tensor(cur_pose),
            tf, _tconsts(), tm, tsr.LossWeights(*LW), n_total, draws=draws,
            mesh=None if n is None else _mesh(n))
        out[n] = (field, res)
    field, res = out[8]
    ref_poses = np.asarray(jqt(ref.kf_quat, ref.kf_trans))
    assert np.abs(ref_poses[1] - poses[1]).max() > 1e-4        # it moved
    got = tqt(res.kf_quat, res.kf_trans).numpy()
    np.testing.assert_allclose(got, ref_poses, atol=1e-5)
    assert float(res.loss) == pytest.approx(float(ref.loss), rel=1e-5)
    _close(field, ref.field_params, 1e-5)
    res1 = out[None][1]
    np.testing.assert_allclose(got, tqt(res1.kf_quat, res1.kf_trans).numpy(),
                               atol=1e-6)


def test_sharded_local_ba_takes_no_indivisible_batch(ba_field):
    """The system rounds every budget up to the mesh; a batch that does
    not divide is a caller's fault and raises (JAX's constraint needs the
    same)."""
    _, tf, p = ba_field
    rays, cur, poses, cur_pose = _ba_inputs()
    field = params_from_jax(p)
    tm = tmapper.MapConfig(sample=32, pixels_cur=16, iters=1)
    with pytest.raises(ValueError, match="do not split"):
        tmapper.local_ba(
            field, tmapper.make_map_optimizer(field, tm), torch.tensor(rays),
            torch.ones(4, dtype=torch.bool), 0, torch.tensor(3),
            torch.tensor(poses), torch.tensor(cur), torch.tensor(cur_pose),
            tf, _tconsts(), tm, tsr.LossWeights(*LW), 50, mesh=_mesh(8))


def test_sharded_init_fit_matches_jax(ba_field):
    """The first fit (5 iterations of 64 rays at the identity pose) at 8
    shards in both packages on JAX's ray indices: every parameter to 1e-4
    (Adam's steps of lr 1e-2 on gradients near zero, as
    tests/test_torch_sharding.py's map step), the last loss to rtol 1e-5,
    and to the port's unsharded fit to 1e-5."""
    jf, tf, p = ba_field
    frame = _rand_rays(np.random.default_rng(8), (200,)).astype(np.float32)
    n_iters, n_rays = 5, 64
    jm = jmapper.MapConfig()
    key = jax.random.PRNGKey(9)
    jp = jax.tree.map(jnp.asarray, p)
    ref_p, _, ref_loss = jmapper.init_submap_fit(
        jp, jmapper.make_map_optimizer(jm).init(jp), key,
        jnp.asarray(frame), jf, _jconsts(), jm, jsr.LossWeights(*LW),
        n_iters, n_rays, ray_sharding=_sharding())
    draws = [torch.tensor(np.asarray(jax.random.randint(
        jax.random.split(k)[0], (n_rays,), 0, frame.shape[0]))).long()
        for k in jax.random.split(key, n_iters)]
    out = {}
    for n in (8, None):
        field = params_from_jax(p)
        loss = tmapper.init_submap_fit(
            field, tmapper.make_map_optimizer(field, tmapper.MapConfig()),
            torch.tensor(frame), tf, _tconsts(), tmapper.MapConfig(),
            tsr.LossWeights(*LW), n_iters, n_rays,
            mesh=None if n is None else _mesh(n), draws=draws)
        out[n] = (field, loss)
    field, loss = out[8]
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    _close(field, ref_p, 1e-4)
    _close(field, params_to_numpy(out[None][0]), 1e-5)


@pytest.mark.parametrize("n", [601, 600, 2600, 1800, 1, 8])
def test_round_rays_matches_jax(n):
    """The budget rounded up to a multiple of the mesh at 8 devices (601
    -> 608), and left as it is without ray sharding, as the JAX system
    rounds it."""
    jax_dp = types.SimpleNamespace(_ray_sharding=object(), n_devices=8)
    jax_off = types.SimpleNamespace(_ray_sharding=None, n_devices=8)
    port_dp = types.SimpleNamespace(_ray_mesh=_mesh(8), mesh=_mesh(8))
    port_off = types.SimpleNamespace(_ray_mesh=None, mesh=_mesh(8))
    assert MIPSFusionTorch._round_rays(port_dp, n) == \
        MIPSFusionTPU._round_rays(jax_dp, n)
    assert MIPSFusionTorch._round_rays(port_off, n) == n == \
        MIPSFusionTPU._round_rays(jax_off, n)
    assert MIPSFusionTorch._round_rays(port_dp, 601) == 608


@pytest.mark.parametrize("n_dev,block,dp,refine", [
    (1, None, False, False), (2, None, True, True),
    (2, {"dp_hot_path": False}, False, True),
    (4, {"sharded_refine": False, "dp_hot_path": True}, True, False)])
def test_system_switches(n_dev, block, dp, refine):
    """parallel.dp_hot_path and parallel.sharded_refine, with JAX's
    defaults (True), act only on a mesh of more than one device."""
    cfg = corridor_config(4)
    if block is not None:
        cfg["parallel"] = block
    slam = MIPSFusionTorch(cfg, dataset=types.SimpleNamespace(
        H=30, W=40, num_frames=4), device="cpu", mesh=_mesh(n_dev))
    assert (slam.use_dp_hot, slam.use_sharded_refine) == (dp, refine)
    assert (slam._ray_mesh is not None) == dp
    assert slam._round_rays(2599) == (2599 if not dp else
                                      -(-2599 // n_dev) * n_dev)


def test_parallel_block():
    """The config's parallel block: bools, JAX's defaults filled in;
    anything else raises."""
    assert parallel_config({}) == {"sharded_refine": True,
                                   "dp_hot_path": True}
    assert parallel_config({"parallel": {"dp_hot_path": False}}) == {
        "sharded_refine": True, "dp_hot_path": False}
    for bad in ({"dp_hot_path": 1}, {"dp": True}, [True]):
        with pytest.raises(ValueError):
            parallel_config({"parallel": bad})


def test_system_mesh_must_start_at_its_device():
    cfg = corridor_config(4)
    ds = types.SimpleNamespace(H=30, W=40, num_frames=4)
    with pytest.raises(ValueError, match="first device"):
        MIPSFusionTorch(cfg, dataset=ds, device="cpu",
                        mesh=make_mesh(devices=["meta", "meta"]))


def test_system_default_mesh_is_its_device_alone():
    """Without mesh= the system runs on its own device, unsharded, with
    the parallel switches on in the config: sharding is the caller's
    choice."""
    cfg = corridor_config(4)
    cfg["parallel"] = {"dp_hot_path": True, "sharded_refine": True}
    slam = MIPSFusionTorch(cfg, dataset=types.SimpleNamespace(
        H=30, W=40, num_frames=4), device="cpu")
    assert slam.mesh.devices == (torch.device("cpu"),)
    assert not (slam.use_dp_hot or slam.use_sharded_refine)
    assert slam._ray_mesh is None and slam._round_rays(2599) == 2599

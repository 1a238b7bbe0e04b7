"""Ray data-parallel tracking: the port's ``track_frame`` with a mesh
against the JAX tracker with ``ray_sharding`` on its 8-device CPU mesh
(RO's particle queries split by columns, GO's rays and targets split),
on the same params, frame and particle template; and a batch that does
not divide by the mesh stays unsharded in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.slam import tracker as jtracker
from mipsfusion_tpu_torch.convert import params_from_jax
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.parallel.sharding import make_mesh
from mipsfusion_tpu_torch.slam import tracker as ttracker

from test_smoke_e2e import smoke_config
from test_torch_field import small_fcfg, small_params
from test_torch_losses import port_fcfg

torch.set_num_threads(1)
LW = (1.0, 0.1, 1000.0, 10.0)


@pytest.fixture(scope="module")
def setup():
    """The flagship Triplane+CP encoding at test widths, one orbit frame,
    a previous pose that moves the motion model's prediction."""
    jf = dataclasses.replace(small_fcfg(), n_range_d=7, n_samples_d=9,
                             near=0.0, far=8.0)
    cfg = smoke_config(4)
    ds = JDataset(cfg, n_frames=4, trajectory="orbit", span=4 / 400)
    frame = np.asarray(ds.packed(1))
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    return jf, small_params(jf), frame, bound


def _configs(pkg, n_go, P_, rows, cols):
    rcfg = pkg.ROConfig(particle_size=P_, n_rows=rows, n_cols=cols,
                        initial_scaling_factor=0.02)
    # the GO budget equals the pixel grid: no random pixel is drawn
    gcfg = pkg.GOConfig(n_iters=n_go, n_rays=rows * cols, ignore_edge_w=4,
                        ignore_edge_h=4, gate_rel=6.0, best=False)
    return rcfg, gcfg


def _pst(P_):
    return np.asarray(jtracker.make_pst(jax.random.PRNGKey(3),
                                        jtracker.ROConfig(particle_size=P_)))


def _jax(setup, n_go, n_dev, P_=64, rows=8, cols=12):
    jf, p, frame, bound = setup
    rcfg, gcfg = _configs(jtracker, n_go, P_, rows, cols)
    est = jnp.tile(jnp.eye(4), (4, 1, 1)).at[0, 0, 3].set(0.01)
    sh = None
    if n_dev > 1:
        assert len(jax.devices()) >= n_dev, "conftest provides 8 CPU devices"
        sh = NamedSharding(JMesh(np.array(jax.devices()[:n_dev]), ("data",)),
                           P("data"))
    res = jtracker.track_frame(
        jax.tree.map(jnp.asarray, p), jf,
        jsr.FieldConsts.from_bound(jnp.asarray(bound)), rcfg, gcfg,
        jnp.asarray(_pst(P_)), jax.random.PRNGKey(0),
        jnp.asarray(frame[..., 3:6]), jnp.asarray(frame[..., 6]),
        jnp.asarray(frame[..., :3]), est, jnp.asarray(1), jnp.asarray(False),
        jsr.LossWeights(*LW), 2, n_go, loss_ewma=jnp.asarray(-1.0),
        ray_sharding=sh)
    return np.asarray(res.pose), float(res.loss)


def _port(setup, n_go, n_dev, P_=64, rows=8, cols=12):
    jf, p, frame, bound = setup
    rcfg, gcfg = _configs(ttracker, n_go, P_, rows, cols)
    f = torch.tensor(frame)
    est = torch.eye(4).repeat(4, 1, 1)
    est[0, 0, 3] = 0.01
    mesh = None if n_dev is None else make_mesh(devices=["cpu"] * n_dev)
    res = ttracker.track_frame(
        params_from_jax(p).params(detach=True), port_fcfg(jf),
        tsr.FieldConsts.from_bound(torch.tensor(bound)), rcfg, gcfg,
        torch.tensor(_pst(P_)), None, f[..., 3:6], f[..., 6], f[..., :3],
        est, 1, False, tsr.LossWeights(*LW), 2, n_go, torch.tensor(-1.0),
        mesh=mesh)
    return res.pose.numpy(), float(res.loss)


class _Calls:
    """Counts the calls of the sharded field functions."""

    def __init__(self, monkeypatch):
        self.n = {"sdf": 0, "loss": 0}
        for key, name in (("sdf", "run_network_sdf_T_sharded"),
                          ("loss", "forward_losses_T_sharded")):
            inner = getattr(tsr, name)

            def spy(*a, _k=key, _f=inner, **kw):
                self.n[_k] += 1
                return _f(*a, **kw)

            monkeypatch.setattr(tsr, name, spy)


@pytest.mark.parametrize("n_go", [3, 10])
def test_sharded_track_frame_matches_jax(setup, monkeypatch, n_go):
    """8 shards: RO's 64 particles x 96 pixels and GO's 96 rays split over
    the mesh in both packages. The port's pose against JAX's to 1e-4 and
    its loss to rtol 1e-3 (JAX's own bounds between its sharded and
    unsharded tracker, tests/test_sharded_tracking.py:100-103); the
    port's sharded pose against its unsharded one to 1e-5."""
    calls = _Calls(monkeypatch)
    pose, loss = _port(setup, n_go, 8)
    assert calls.n == {"sdf": 2, "loss": n_go}      # 2 RO iterations
    ref_pose, ref_loss = _jax(setup, n_go, 8)
    assert not np.allclose(ref_pose, np.eye(4), atol=1e-3)   # it moved
    np.testing.assert_allclose(pose, ref_pose, atol=1e-4)
    assert loss == pytest.approx(ref_loss, rel=1e-3)
    np.testing.assert_allclose(pose, _port(setup, n_go, None)[0], atol=1e-5)


def test_indivisible_batch_stays_unsharded(setup, monkeypatch):
    """63 particles x 99 pixels (6,237 points) and 99 GO rays do not split
    over 8 devices: neither package shards them, so each gives its own
    unsharded result (the port bit for bit)."""
    kw = dict(P_=63, rows=9, cols=11)
    calls = _Calls(monkeypatch)
    pose, loss = _port(setup, 3, 8, **kw)
    assert calls.n == {"sdf": 0, "loss": 0}
    ref = _port(setup, 3, None, **kw)
    np.testing.assert_array_equal(pose, ref[0])
    assert loss == ref[1]
    jpose, jloss = _jax(setup, 3, 8, **kw)
    jref = _jax(setup, 3, 1, **kw)
    np.testing.assert_allclose(jpose, jref[0], atol=1e-7)
    assert jloss == pytest.approx(jref[1], rel=1e-6)
    np.testing.assert_allclose(pose, jpose, atol=1e-4)

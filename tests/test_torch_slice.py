"""Slice-level parity of the port: the flagship config, one track_frame
against the JAX tracker on the same params, frame and particle template,
and short end-to-end runs of MIPSFusionTorch on the synthetic orbit."""

import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets.synthetic import SyntheticDataset as JDataset
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.slam import tracker as jtracker
from mipsfusion_tpu_torch.config import FLAGSHIP_ORBIT
from mipsfusion_tpu_torch.convert import params_from_jax
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.slam import tracker as ttracker
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_slam_single import tiny_config
from test_smoke_e2e import smoke_config
from test_torch_field import small_fcfg, small_params
from test_torch_losses import port_fcfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flagship_config_equals_yaml(monkeypatch):
    """FLAGSHIP_ORBIT is the merged orbit yaml (load_config resolves
    inherit_from against the working directory, so run from the root)."""
    from mipsfusion_tpu.config import load_config
    monkeypatch.chdir(ROOT)
    assert load_config("configs/synthetic/orbit.yaml") == FLAGSHIP_ORBIT


# ------------------------------------------------------- one track_frame

@pytest.fixture(scope="module")
def track_setup():
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


def _track_jax(setup, n_go):
    jf, p, frame, pst, bound = setup
    rcfg = jtracker.ROConfig(particle_size=64, n_rows=8, n_cols=12,
                             initial_scaling_factor=0.02)
    gcfg = jtracker.GOConfig(n_iters=n_go, n_rays=96, ignore_edge_w=4,
                             ignore_edge_h=4, gate_rel=6.0, best=False)
    est = jnp.tile(jnp.eye(4), (4, 1, 1))
    res = jtracker.track_frame(
        jax.tree.map(jnp.asarray, p), jf,
        jsr.FieldConsts.from_bound(jnp.asarray(bound)), rcfg, gcfg,
        jnp.asarray(pst), jax.random.PRNGKey(0), jnp.asarray(frame[..., 3:6]),
        jnp.asarray(frame[..., 6]), jnp.asarray(frame[..., :3]), est,
        jnp.asarray(1), jnp.asarray(False),
        jsr.LossWeights(1.0, 0.1, 1000.0, 10.0), 2, n_go,
        loss_ewma=jnp.asarray(-1.0))
    return np.asarray(res.pose)


def _track_port(setup, n_go):
    jf, p, frame, pst, bound = setup
    rcfg = ttracker.ROConfig(particle_size=64, n_rows=8, n_cols=12,
                             initial_scaling_factor=0.02)
    gcfg = ttracker.GOConfig(n_iters=n_go, n_rays=96, ignore_edge_w=4,
                             ignore_edge_h=4, gate_rel=6.0, best=False)
    f = torch.tensor(frame)
    res = ttracker.track_frame(
        params_from_jax(p).params(detach=True), port_fcfg(jf),
        tsr.FieldConsts.from_bound(torch.tensor(bound)), rcfg, gcfg,
        torch.tensor(pst), None, f[..., 3:6], f[..., 6], f[..., :3],
        torch.eye(4).repeat(4, 1, 1), 1, False,
        tsr.LossWeights(1.0, 0.1, 1000.0, 10.0), 2, n_go,
        torch.tensor(-1.0))
    return res.pose.numpy()


@pytest.mark.parametrize("n_go", [0, 3])
def test_track_frame_matches_jax(track_setup, n_go):
    """Same params, frame and PST; perturb off and a GO ray budget equal
    to the pixel grid, so neither side draws anything; GO returns its last
    iterate (best=False), so every Adam step counts. RO alone (n_go=0)
    agrees to float32 rounding; with GO the bound is Adam's lr per step
    (each step moves a coordinate by at most about lr)."""
    ref = _track_jax(track_setup, n_go)
    out = _track_port(track_setup, n_go)
    assert not np.allclose(ref, np.eye(4), atol=1e-6)   # the pose moved
    bound = 1e-5 if n_go == 0 else n_go * 1e-3
    np.testing.assert_allclose(out, ref, atol=bound)


def test_tracking_z_ladder_override_matches_jax(monkeypatch):
    """tracking.n_samples_d / n_range_d override training.* for the tracker
    alone (the JAX system's fcfg_track): the port builds the same tracking
    field config as the JAX system from one config, its GO renders every
    ray with that z-ladder (5 + 3 samples) while the first-frame fit keeps
    training.* (8 + 7), and one track_frame with it gives the JAX
    tracker's pose on the same params, frame and PST (no draws: perturb
    off, the GO ray budget equals the pixel grid)."""
    from mipsfusion_tpu.slam.system import MIPSFusionTPU
    n = 4
    cfg = _triplane(smoke_config(n))
    cfg["grid"]["hash_size"] = 19              # read (unused) by JAX's config
    cfg["training"]["perturb"] = 0
    cfg["tracking"].update(n_samples_d=5, n_range_d=3)
    jds = JDataset(copy.deepcopy(cfg), n_frames=n, trajectory="orbit",
                   span=n / 400)
    jf = MIPSFusionTPU(copy.deepcopy(cfg), dataset=jds).fcfg_track
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="orbit", span=n / 400,
                          device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    assert (jf.n_samples_d, jf.n_range_d) == (5, 3)
    assert slam.fcfg_track == port_fcfg(jf)
    assert (slam.fcfg.n_samples_d, slam.fcfg.n_range_d) == (8, 7)
    seen = []
    inner = tsr.sample_z_vals

    def spy(target_d, fcfg, generator=None, u=None):
        z = inner(target_d, fcfg, generator, u)
        seen.append(z.shape[1])
        return z

    monkeypatch.setattr(tsr, "sample_z_vals", spy)
    slam.process_frame(0)                       # the first fit: training.*
    fit, seen[:] = set(seen), []
    slam.track(ds.packed(1), 1)
    assert fit == {15}
    assert seen == [8] * cfg["tracking"]["iter"]
    # the pose of one track_frame with the tracking config, both packages
    frame = np.asarray(jds.packed(1))
    pst = np.asarray(jtracker.make_pst(jax.random.PRNGKey(3),
                                       jtracker.ROConfig(particle_size=64)))
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    setup = (jf, small_params(jf), frame, pst, bound)
    np.testing.assert_allclose(_track_port(setup, 3), _track_jax(setup, 3),
                               atol=3e-3)


# ------------------------------------------------------------ end to end

def _triplane(cfg):
    cfg["use_manager"] = False
    cfg["grid"] = {"enc": "Triplane", "tri_resolutions": [32, 64],
                   "tri_features": 4, "cp_resolution": 384,
                   "cp_components": 40, "use_bound_normalize": True}
    cfg["pos"]["n_bins"] = 8
    return cfg


def test_port_run_smoke():
    """12 frames at the smoke-test size with the flagship field widths:
    tracking must not diverge (the slow test asserts millimetres)."""
    n = 12
    cfg = _triplane(smoke_config(n))
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="orbit", span=n / 400,
                          device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    res = slam.run(verbose=False)
    assert res["absolute_translational_error.rmse"] < 0.10, res
    assert res["n_submaps"] == 1
    assert len(slam.track_losses) == n - 1
    assert np.isfinite([float(v) for v in slam.track_losses]).all()
    assert int(slam.state.n_kf) == 3                   # frames 0, 4, 8
    world = slam.world_trajectory(n - 1)
    assert world.shape == (n, 4, 4) and np.isfinite(world).all()
    np.testing.assert_allclose(world[0], ds.gt_pose(0), atol=1e-6)


@pytest.mark.slow
def test_port_run_tiny_24_frames():
    n = 24
    cfg = _triplane(tiny_config(n))
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="orbit", span=n / 200,
                          device="cpu")
    res = MIPSFusionTorch(cfg, dataset=ds, device="cpu").run(verbose=False)
    assert res["absolute_translational_error.rmse"] < 0.02, res


def test_port_imports_no_jax():
    """Importing the port and running its CPU slice loads neither jax nor
    optax, nor any module of the JAX package."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})
import torch
torch.set_num_threads(1)
from mipsfusion_tpu_torch.config import flagship_orbit
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
from mipsfusion_tpu_torch.config import flagship_outback
from mipsfusion_tpu_torch.ops import triplane_cuda
from mipsfusion_tpu_torch.slam import icp, manager, pose_graph
cfg = flagship_orbit(use_manager=False)
cfg["cam"].update(H=24, W=32, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
cfg["tracking"].update(iter=2, iter_RO=1, sample=48, ignore_edge_W=2,
                       ignore_edge_H=2)
cfg["tracking"]["RO"].update(particle_size=16, n_rows=4, n_cols=6)
cfg["mapping"].update(sample=32, pixels_cur=16, iters=2, first_iters=3,
                      keyframe_every=2, map_every=2)
cfg["sampling"].update(kf_n_rays_h=6, kf_n_rays_w=8)
cfg["training"].update(n_samples_d=4, n_range_d=3)
ds = SyntheticDataset(cfg, n_frames=3, trajectory="orbit", span=0.01,
                      device="cpu")
res = MIPSFusionTorch(cfg, dataset=ds, device="cpu").run(verbose=False)
assert res["n_submaps"] == 1
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "optax", "mipsfusion_tpu")]
assert not bad, bad
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]

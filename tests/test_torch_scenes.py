"""Parity of the port's synthetic scenes with the JAX package's: every
trajectory, the tiled prop field of the large rooms, a rendered snake frame,
the sensor-noise stage fed the JAX package's own draws, the port's own
noise statistics and re-render bits, and get_dataset on the scale profile's
config."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.datasets import synthetic as jsyn
from mipsfusion_tpu_torch.datasets import synthetic as tsyn

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NOISE = {"depth_sigma": (0.005, 0.003), "dropout": 0.02, "quantize": 0.001,
         "rgb_sigma": 0.01}       # tests/test_sensor_noise.py's profile
SNAKE_HALF = [5.6, 2.2, 3.2]      # configs/synthetic/snake_fast.yaml


def _cfg(**syn):
    return {"cam": {"H": 40, "W": 56, "fx": 28.0, "fy": 28.0, "cx": 27.5,
                    "cy": 19.5, "far": 8.0},
            "data": {"downsample": 1},
            "synthetic": {"room_half": [3.0, 2.2, 2.5], **syn}}


@pytest.mark.parametrize("trajectory,syn", [
    ("orbit", {}), ("corridor", {}), ("loop", {}), ("outback", {}),
    ("sweep", {}), ("revisit", {}),
    ("revisit", {"revisit_amp": 0.6, "revisit_phase": 0.3}),
    ("snake", {})])
def test_trajectory_poses(trajectory, syn):
    """Every frame's c2w equals the JAX dataset's (atol 1e-7; both build
    the pose in float64 numpy and store float32)."""
    n = 37
    jd = jsyn.SyntheticDataset(_cfg(**syn), n_frames=n,
                               trajectory=trajectory, span=0.9)
    td = tsyn.SyntheticDataset(_cfg(**syn), n_frames=n,
                               trajectory=trajectory, span=0.9, device="cpu")
    for i in range(n):
        np.testing.assert_allclose(td.gt_pose(i), jd.gt_pose(i), atol=1e-7)


def test_scene_sdf_tiled_matches_jax():
    """10k seeded points over the snake's room and beyond it (about 30
    cells): the port's tiled SDF equals the JAX one as the renderer runs it
    (jitted; its per-cell hash is float32 sinf of a fused multiply-add,
    which the port's table reproduces) to 1e-5 m."""
    rng = np.random.default_rng(0)
    half = np.asarray(SNAKE_HALF, np.float32)
    p = (rng.uniform(-1.0, 1.0, (10000, 3)) * half * 1.3).astype(np.float32)
    ref = np.asarray(jax.jit(jsyn.scene_sdf_tiled)(jnp.asarray(p),
                                                   jnp.asarray(half)))
    out = tsyn.scene_sdf_tiled(torch.tensor(p), torch.tensor(half)).numpy()
    cells = {(int(np.floor(x / 2.4)), int(np.floor(z / 2.4)))
             for x, _, z in p}
    assert len(cells) >= 25
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("frame", [0, 17])
def test_snake_tiled_frame_matches_jax(frame):
    """A snake frame in the tiled room at 40 x 56, both sphere tracers on
    the same pose; test_torch_synthetic.py's tolerances: depth and colour
    within 1e-4 on all but 1% of the pixels both hit, valid masks equal on
    all but 1%."""
    cfg = _cfg(props="tiled")
    cfg["synthetic"]["room_half"] = SNAKE_HALF
    jd = jsyn.SyntheticDataset(cfg, n_frames=30, trajectory="snake")
    td = tsyn.SyntheticDataset(cfg, n_frames=30, trajectory="snake",
                               device="cpu")
    ref = np.asarray(jd.packed(frame))
    out = td.packed(frame).numpy()
    np.testing.assert_allclose(out[..., :3], ref[..., :3], atol=1e-6)
    valid_j, valid_t = ref[..., 6] > 0, out[..., 6] > 0
    assert np.mean(valid_j != valid_t) <= 0.01
    both = valid_j & valid_t
    close = np.all(np.abs(out[..., 3:7] - ref[..., 3:7]) < 1e-4, axis=-1)
    assert np.mean(~close[both]) <= 0.01
    assert both.mean() > 0.9


@pytest.mark.parametrize("index", [0, 3])
def test_apply_noise_with_jax_draws(index):
    """apply_noise on the JAX package's clean frame with the JAX package's
    own draws (fold_in(noise_key, i), split 3: normal, uniform, normal)
    gives its noisy frame to 1e-6 (one float32 rounding apart)."""
    cfg = _cfg(noise=dict(NOISE), noise_seed=5)
    jn = jsyn.SyntheticDataset(cfg, n_frames=4, trajectory="orbit",
                               span=0.02)
    jc = jsyn.SyntheticDataset(_cfg(), n_frames=4, trajectory="orbit",
                               span=0.02)
    key = jax.random.fold_in(jax.random.PRNGKey(5), index)
    k1, k2, k3 = jax.random.split(key, 3)
    eps_d = np.asarray(jax.random.normal(k1, (40, 56)))
    u = np.asarray(jax.random.uniform(k2, (40, 56)))
    eps_rgb = np.asarray(jax.random.normal(k3, (40, 56, 3)))
    out = tsyn.apply_noise(torch.tensor(np.asarray(jc.packed(index))),
                           torch.tensor(eps_d), torch.tensor(u),
                           torch.tensor(eps_rgb), NOISE).numpy()
    ref = np.asarray(jn.packed(index))
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_noise_stage_statistics():
    """The port's own draws: test_sensor_noise.py's statistics (holes,
    depth error scale against sigma(d), the quantization grid, rgb bounds)
    and the same bits when a fresh dataset re-renders the frame."""
    cfg = _cfg(noise=dict(NOISE))
    noisy_ds = tsyn.SyntheticDataset(cfg, n_frames=4, trajectory="orbit",
                                     span=0.02, device="cpu")
    clean_ds = tsyn.SyntheticDataset(_cfg(), n_frames=4, trajectory="orbit",
                                     span=0.02, device="cpu")
    clean = clean_ds.packed(1).numpy()
    noisy = noisy_ds.packed(1).numpy()
    d_c, d_n = clean[..., 6], noisy[..., 6]
    both = (d_c > 0) & (d_n > 0)
    holes = float(((d_c > 0) & (d_n == 0)).sum()) / max((d_c > 0).sum(), 1)
    assert 0.005 < holes < 0.06, holes
    err = np.abs(d_n[both] - d_c[both])
    sigma = NOISE["depth_sigma"][0] + NOISE["depth_sigma"][1] * d_c[both] ** 2
    ratio = err.mean() / sigma.mean()
    assert 0.5 < ratio < 1.6, ratio
    q = NOISE["quantize"]
    frac = np.abs(d_n[d_n > 0] / q - np.round(d_n[d_n > 0] / q))
    assert float(frac.max()) < 1e-3
    rgb_c, rgb_n = clean[..., 3:6], noisy[..., 3:6]
    assert 0.0 < float(np.abs(rgb_n - rgb_c).mean()) < 0.05
    assert float(rgb_n.min()) >= 0.0 and float(rgb_n.max()) <= 1.0
    again = tsyn.SyntheticDataset(cfg, n_frames=4, trajectory="orbit",
                                  span=0.02, device="cpu")
    np.testing.assert_array_equal(noisy, again.packed(1).numpy())
    # another frame draws other noise; another noise_seed too
    assert not np.array_equal(noisy_ds.packed(2).numpy()[..., 6] - d_c, 0)
    other = tsyn.SyntheticDataset(_cfg(noise=dict(NOISE), noise_seed=9),
                                  n_frames=4, trajectory="orbit", span=0.02,
                                  device="cpu")
    assert not np.array_equal(other.packed(1).numpy(), noisy)


def test_device_cache_keeps_newest():
    ds = tsyn.SyntheticDataset(_cfg(), n_frames=6, trajectory="orbit",
                               span=0.03, device_cache=2, device="cpu")
    first = ds.packed(0).clone()
    for i in range(1, 4):
        ds.packed(i)
    assert sorted(ds._cache) == [2, 3]
    assert torch.equal(ds.packed(0), first)      # re-rendered, same bits


def test_prerender_renders_each_frame_once_with_a_bounded_cache(
        monkeypatch):
    """The loop's access pattern (prerender the run's frames, then packed
    in order) renders every frame exactly once with device_cache 2: the
    prerender fills only the cache, the rest render on first use."""
    ds = tsyn.SyntheticDataset(_cfg(), n_frames=6, trajectory="orbit",
                               span=0.03, device_cache=2, device="cpu")
    rendered = []
    inner = ds.render_many

    def count(c2ws):
        rendered.append(len(c2ws))
        return inner(c2ws)

    monkeypatch.setattr(ds, "render_many", count)
    ds.prerender(range(6))
    assert sum(rendered) == 2 and sorted(ds._cache) == [0, 1]
    for i in range(6):
        ds.packed(i)
    assert sum(rendered) == 6 and sorted(ds._cache) == [4, 5]


def test_get_dataset_reads_the_scale_profile(monkeypatch):
    """The port's load_config on snake_fast.yaml, unmodified, and
    get_dataset: 600 snake frames in the tiled 11 m room, poses equal to
    the JAX package's get_dataset on the same config."""
    from mipsfusion_tpu.datasets.dataset import get_dataset as jget
    from mipsfusion_tpu_torch.config import load_config
    from mipsfusion_tpu_torch.datasets.dataset import get_dataset
    monkeypatch.chdir(ROOT)
    cfg = load_config("configs/synthetic/snake_fast.yaml")
    ds = get_dataset(cfg, device="cpu")
    assert ds.num_frames == 600 and ds.props == "tiled"
    assert ds.room_half.tolist() == pytest.approx(SNAKE_HALF)
    jd = jget(copy.deepcopy(cfg))
    for i in (0, 150, 299, 450, 599):
        np.testing.assert_allclose(ds.gt_pose(i), jd.gt_pose(i), atol=1e-7)


@pytest.mark.parametrize("props,trajectory", [("classic", "outback"),
                                               ("tiled", "snake")])
def test_prerender_batches_give_single_frame_bits(props, trajectory):
    """prerender sphere-traces several frames as one batch of rays (with
    noise after it, per frame): the same bits as rendering each frame
    alone."""
    cfg = _cfg(props=props, noise=dict(NOISE))
    if props == "tiled":
        cfg["synthetic"]["room_half"] = SNAKE_HALF
    one = tsyn.SyntheticDataset(cfg, n_frames=9, trajectory=trajectory,
                                device="cpu")
    batched = tsyn.SyntheticDataset(cfg, n_frames=9, trajectory=trajectory,
                                    device="cpu")
    batched.prerender(range(9), batch=4)
    for i in range(9):
        assert torch.equal(batched.packed(i), one.packed(i))

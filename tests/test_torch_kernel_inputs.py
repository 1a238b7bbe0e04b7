"""The kernel inputs chip_smoke.py builds, and the warp-cell count behind
K3's design, on the CPU.

K3's count: how many cells a 32-lane warp touches per tap in the plane
scatter, and the atomics that predicts. The per-lane scatter issues one
float32 atomic per valid tap and channel; the warp-run scatter issues one
64-bit integer atomic per channel of a run: four per run of lanes on a
plane cell and 40 per run of points on a CP cell.
``test_outback_ba_batch_atomics`` prints the count for one BA batch of
the flagship outback:

    python -m pytest -q -s tests/test_torch_kernel_inputs.py -k outback
"""

import json
from typing import Dict

import numpy as np
import pytest

import chip_smoke

RES = (32, 64)          # plane resolutions (csrc/common.cuh R0, R1)
RCP, CCP, FEAT = 384, 40, 4
PLANES = ((0, 1), (0, 2), (1, 2))


def taps(u: np.ndarray, R: int):
    """(i0, i1, has_next) as ``make_tap`` computes them in float32."""
    hi = np.float32(float(R - 1) - 1e-6)
    p = np.minimum(np.maximum(u.astype(np.float32) * np.float32(R - 1),
                              np.float32(0.0)), hi)
    i0 = np.floor(p).astype(np.int64)
    has_next = i0 + 1 <= R - 1
    return i0, np.where(has_next, i0 + 1, R - 1), has_next


def tap_keys(x: np.ndarray) -> Dict[str, np.ndarray]:
    """Cell keys [n_taps, N] per tap group (-1: the tap does not exist):
    the 12 plane taps of each scale and the 6 CP line taps."""
    out = {}
    for s, R in enumerate(RES):
        t = [taps(x[a], R) for a in range(3)]
        keys = []
        for a, b in PLANES:
            for iu, hu in ((t[a][0], True), (t[a][1], t[a][2])):
                for iv, hv in ((t[b][0], True), (t[b][1], t[b][2])):
                    keys.append(np.where(hu & hv, iu * R + iv, -1))
        out[f"s{s}"] = np.stack(keys)
    keys = []
    for a in range(3):
        i0, i1, hn = taps(x[a], RCP)
        keys += [i0, np.where(hn, i1, -1)]
    out["cp"] = np.stack(keys)
    return out


def _warps(keys: np.ndarray) -> np.ndarray:
    n = keys.shape[1]
    pad = (-n) % 32
    k = np.concatenate([keys, np.full((keys.shape[0], pad), -1)], axis=1)
    return k.reshape(keys.shape[0], -1, 32)


def plane_runs(keys: np.ndarray) -> np.ndarray:
    """[n_taps, n_warps] runs of equal valid keys among adjacent lanes
    (the atomics of ``warp_run_sum``)."""
    w = _warps(keys)
    nxt = np.concatenate([w[..., 1:], np.full(w.shape[:-1] + (1,), -2)], -1)
    return ((w >= 0) & (nxt != w)).sum(-1)


def cp_runs(keys: np.ndarray) -> np.ndarray:
    """[n_taps, n_warps] runs of a CP lane's running sum: the key changes
    along the warp's points, skipping points where the tap is missing."""
    w = _warps(keys)
    runs = np.zeros(w.shape[:2], np.int64)
    for i in range(w.shape[0]):
        for j in range(w.shape[1]):
            v = w[i, j][w[i, j] >= 0]
            runs[i, j] = 0 if v.size == 0 else 1 + int((v[1:] != v[:-1]).sum())
    return runs


def distinct(keys: np.ndarray) -> np.ndarray:
    """[n_taps, n_warps] distinct valid cells per warp."""
    w = _warps(keys)
    s = np.sort(w, -1)
    first = np.concatenate([np.ones(s.shape[:-1] + (1,), bool),
                            s[..., 1:] != s[..., :-1]], -1)
    return (first & (s >= 0)).sum(-1)


def warp_stats(xT: np.ndarray) -> Dict[str, float]:
    """Per tap group: mean distinct cells and runs per warp and tap; and
    the atomics per point of the per-lane and the warp-run scatter."""
    n = xT.shape[1]
    k = tap_keys(np.asarray(xT, np.float32))
    st = {}
    for name in ("s0", "s1", "cp"):
        st[f"distinct_{name}"] = float(distinct(k[name]).mean())
    r0, r1 = plane_runs(k["s0"]), plane_runs(k["s1"])
    rc = cp_runs(k["cp"])
    st["runs_s0"], st["runs_s1"] = float(r0.mean()), float(r1.mean())
    st["runs_cp"] = float(rc.mean())
    valid = {name: int((v >= 0).sum()) for name, v in k.items()}
    st["atomics_per_point_lane"] = (
        (valid["s0"] + valid["s1"]) * FEAT + valid["cp"] * CCP) / n
    st["atomics_per_point_warp_run"] = (
        (int(r0.sum()) + int(r1.sum())) * FEAT + int(rc.sum()) * CCP) / n
    st["predicted_factor"] = (st["atomics_per_point_lane"]
                              / st["atomics_per_point_warp_run"])
    return st


def outback_ba_batch(n_rays: int = 2600, seed: int = 0) -> np.ndarray:
    """x [3, n_rays * 75]: one BA batch of the flagship outback on the CPU.
    Rays are random pixels of the first submap's keyframes (frames 0, 10,
    ..., 50), with the loop's depth-guided z sampling and perturbation, in
    the frame of keyframe 0 and normalised by the bound."""
    import torch
    from mipsfusion_tpu_torch.config import flagship_outback
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.models import scene_rep as sr
    cfg = flagship_outback()
    ds = SyntheticDataset(cfg, n_frames=200, trajectory="outback", span=1.0,
                          device="cpu")
    fcfg = sr.FieldConfig.from_dict(cfg)
    consts = sr.FieldConsts.from_bound(torch.tensor(
        cfg["mapping"]["bound"], dtype=torch.float32))
    kfs = list(range(0, 60, cfg["mapping"]["keyframe_every"]))
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(len(kfs), (n_rays,), generator=g)
    pix = torch.randint(ds.H * ds.W, (n_rays,), generator=g)
    inv0 = np.linalg.inv(ds.gt_pose(0))
    rays_o, rays_d, depth = [], [], []
    for i, f in enumerate(kfs):
        sel = src == i
        frame = ds.packed(f).reshape(-1, 7)[pix[sel]]
        T = torch.tensor(inv0 @ ds.gt_pose(f), dtype=torch.float32)
        rays_d.append(frame[:, :3] @ T[:3, :3].T)
        rays_o.append(T[:3, 3].expand(frame.shape[0], 3))
        depth.append(frame[:, 6:7])
    rays_o, rays_d = torch.cat(rays_o), torch.cat(rays_d)
    z = sr.sample_z_vals(torch.cat(depth), fcfg, generator=g)
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]      # [R, S, 3]
    return sr.normalize_T(pts.reshape(-1, 3).T, consts).numpy()


def test_ray_points_layout():
    """Each ray's samples are contiguous, on one line and monotone in
    depth; 75 samples a ray; some samples leave the unit cube."""
    n_rays, n_s = 40, 75
    x = chip_smoke.ray_points(n_rays, n_s, 0, "cpu").numpy()
    assert x.shape == (3, n_rays * n_s) and x.dtype == np.float32
    r = x.T.reshape(n_rays, n_s, 3).astype(np.float64)
    step = np.diff(r, axis=1)
    direction = r[:, -1] - r[:, 0]
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    # every step runs along the ray's direction (collinear, forward)
    along = (step * direction[:, None]).sum(-1)
    assert (along >= -1e-6).all()
    off = np.linalg.norm(step - along[..., None] * direction[:, None], axis=-1)
    assert off.max() < 1e-5
    depth = ((r - r[:, :1]) * direction[:, None]).sum(-1)
    assert (np.diff(depth, axis=1) >= -1e-6).all()
    assert ((x < 0) | (x > 1)).any(0).mean() > 0.1


def test_bounds():
    """The bound of a call: K2's decoder products at the float32-accurate
    tensor-core rate (TF32 / 3, the 3xTF32 split), K1's beside its
    encode at the CUDA cores' float32 rate, K3 by the bytes it moves."""
    n = 195_000
    b, by = chip_smoke.bound("decoder_backward", n)
    assert by == "operations"
    assert b == pytest.approx(2 * 114_746 * n / (495e12 / 3) * 1e3)
    b, by = chip_smoke.bound("field_forward", n)
    assert by == "operations"
    assert b == pytest.approx((2 * 38_233 / (495e12 / 3) + 632 / 67e12)
                              * n * 1e3)
    b, by = chip_smoke.bound("plane_backward", n)
    assert by == "bytes" and 0.005 < b < 0.05


def _brute(keys):
    """distinct cells and runs per warp and tap, by plain loops."""
    n_taps, n = keys.shape
    dist, runs = [], []
    for t in range(n_taps):
        for w0 in range(0, n, 32):
            k = list(keys[t, w0:w0 + 32]) + [-1] * max(0, w0 + 32 - n)
            dist.append(len({v for v in k if v >= 0}))
            runs.append(sum(1 for i, v in enumerate(k)
                            if v >= 0 and (i == 31 or k[i + 1] != v)))
    return np.array(dist), np.array(runs)


@pytest.mark.parametrize("layout", ["rays", "uniform"])
def test_warp_cell_counts(layout):
    """warp_stats' counts against plain loops; on ray-ordered points a
    warp's 32 lanes share cells (runs = distinct cells, far below 32),
    on uniform points they do not."""
    if layout == "rays":
        x = chip_smoke.ray_points(20, 75, 1, "cpu").numpy()
    else:
        x = np.random.default_rng(0).uniform(-0.1, 1.1, (3, 1500))
        x = x.astype(np.float32)
    keys = tap_keys(x)
    for name in ("s0", "s1"):
        dist, runs = _brute(keys[name])
        assert distinct(keys[name]).ravel().tolist() == dist.tolist()
        assert plane_runs(keys[name]).ravel().tolist() == runs.tolist()
    st = warp_stats(x)
    if layout == "rays":
        assert st["distinct_s0"] < 16 and st["predicted_factor"] > 1.2
        assert abs(st["runs_s0"] - st["distinct_s0"]) < 0.1
    else:
        assert st["distinct_s0"] > 25
    # the per-lane scatter: 4 features per valid plane tap, 40 channels
    # per valid CP tap; 336 a point when every upper tap exists
    assert 200 < st["atomics_per_point_lane"] <= 336


def test_outback_ba_batch_atomics():
    """One BA batch of the flagship outback (2600 rays x 75 samples): a
    warp's lanes share cells in contiguous runs, and the warp-run scatter
    issues fewer atomics than the per-lane one (its 64-bit integer adds
    cost one atomic a channel, as the per-lane float32 adds do)."""
    st = warp_stats(outback_ba_batch())
    print(json.dumps({"points": 2600 * 75, **st}))
    for name in ("s0", "s1"):
        assert st[f"distinct_{name}"] < 24
        assert abs(st[f"runs_{name}"] - st[f"distinct_{name}"]) < 0.5
    assert 200 < st["atomics_per_point_lane"] <= 336
    assert 1.5 < st["predicted_factor"] < 2.5

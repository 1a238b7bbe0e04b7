"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device  - require CUDA; print nvidia-smi's name and power limit;
  2. build   - compile the field kernels (mipsfusion_tpu_torch/csrc) with
               nvcc for sm_90a, one process per source;
  3. kernels - each of K0-K4 against its plain PyTorch version at the SLAM
               loop's shapes (flagship widths, params from a fixed seed,
               points inside, outside and on the edge of [0, 1]^3): max
               abs / relative error beside the tolerance, median times;
  4. autograd - FieldQueryT's and TriplaneEncode's gradients against the
               plain path;
  5. orbit   - 45 frames of the flagship orbit at full budgets,
               single submap (use_manager: False), through
               MIPSFusionTorch.run(): ATE, tracked FPS, launch counts;
  6. outback - 200 frames of the flagship out-and-back scene at full
               budgets with the submap manager (use_manager: True): new
               submaps, a switch back with switch BA and PGO, background
               refinement; ATE, FPS, submaps, switch frames, stage times;
               then switch BA once more alone (K1, K2, K4, and no K3).
The kernels' JSON line comes second to last; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --outback-seeds 0,1,2,0

runs phases 1, 2 and then only phase 6, once per seed (repeatability).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return line


def phase_build():
    from mipsfusion_tpu_torch.ops import _build
    t0 = time.time()
    path = _build.build(verbose=True)
    _build.lib()
    print(f"build: {path} in {time.time() - t0:.1f} s")


def _time_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def flagship_params(seed: int, device):
    """Flagship-width field params (a tree) with features brought to O(1)
    (planes init at 1e-4 would make every comparison trivially small)."""
    import torch
    from mipsfusion_tpu_torch.models.scene_rep import FieldConfig, init_field
    from mipsfusion_tpu_torch.config import FLAGSHIP_ORBIT
    fcfg = FieldConfig.from_dict(FLAGSHIP_ORBIT)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = init_field(fcfg, g, device)
    p["planes"] = {k: v * (1e4 if k.startswith("s") else 4.0)
                   for k, v in p["planes"].items()}
    return p


def test_points(n: int, seed: int, device, inside_only: bool = False):
    """x [3, n]: mostly inside [0, 1]^3, with points outside it and
    coordinates exactly 0.0 and 1.0 (the clamp edges)."""
    import torch
    rng = np.random.default_rng(seed)
    if inside_only:
        x = rng.uniform(0.02, 0.98, (3, n))
    else:
        x = rng.uniform(-0.15, 1.15, (3, n))
        k = n // 16
        x[:, :k] = 1.0
        x[0, k:2 * k] = 1.0
        x[1, 2 * k:3 * k] = 0.0
        x[2, 3 * k:4 * k] = 1.0
    return torch.tensor(x, dtype=torch.float32, device=device).contiguous()


def _err(a, b):
    """(max abs error, max abs error / max |b|)."""
    a = a.double()
    b = b.double()
    abs_err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return abs_err, abs_err / max(scale, 1e-30)


def kink_free(g, x, embed, dec, margin: float = 1e-4):
    """Zero the cotangent g [10, N] at points where a ReLU pre-activation
    (computed in float64) lies within ``margin`` of 0. There the kernel's
    and the plain version's float32 sums can take different sides of the
    kink, which flips one hidden unit's gradient for that point (with
    195,000 points x 256 units a few such points occur); with g = 0 those
    points contribute nothing on either side."""
    import torch
    from mipsfusion_tpu_torch.ops.encoding import frequency_encode
    xt = x.T.double()
    d = {n: {k: t.double() for k, t in v.items()} for n, v in dec.items()}
    pe = torch.cat([xt, frequency_encode(xt, 8)], dim=-1)
    h0 = pe @ d["trunk0"]["w"] + d["trunk0"]["b"]
    h1 = torch.relu(h0) @ d["trunk1"]["w"] + d["trunk1"]["b"]
    h2 = (torch.cat([h1[:, :64], embed.T.double()], dim=-1)
          @ d["sdf0"]["w"] + d["sdf0"]["b"])
    near = (h0.abs() < margin).any(-1) | (h2.abs() < margin).any(-1)
    return torch.where(near[None], torch.zeros_like(g), g), float(
        near.double().mean())


# relative tolerances (max abs error / max |plain|). Both sides are
# float32; they differ in summation order (K2's point sums, K3's atomics),
# and the sums run over 1e5-1e6 terms. K2 and the autograd phase use a
# cotangent that is zero near ReLU kinks (kink_free).
TOL = {"encode_forward": 2e-5,
       "field_forward": 2e-5, "field_forward_sdf": 2e-5,
       "decoder_backward": 1e-4, "plane_backward": 1e-4,
       "x_backward": 1e-4}

REPLACES = {
    "encode_forward":
        "mipsfusion_tpu/ops/triplane_pallas.py:218 _fused_forward",
    "field_forward":
        "mipsfusion_tpu/ops/field_pallas.py:310 field_query_pallas",
    "decoder_backward":
        "mipsfusion_tpu/ops/field_pallas.py:572 _decoder_bwd_call",
    "plane_backward":
        "mipsfusion_tpu/ops/triplane_pallas.py:325 _fused_backward_plane",
    "x_backward":
        "mipsfusion_tpu/ops/triplane_pallas.py:453 _fused_backward_x",
}
SOURCE = {
    "encode_forward": "mipsfusion_tpu_torch/csrc/triplane.cu",
    "field_forward": "mipsfusion_tpu_torch/csrc/field.cu",
    "decoder_backward": "mipsfusion_tpu_torch/csrc/field.cu",
    "plane_backward": "mipsfusion_tpu_torch/csrc/triplane.cu",
    "x_backward": "mipsfusion_tpu_torch/csrc/triplane.cu",
}


def phase_kernels():
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    dev = torch.device("cuda")
    p = flagship_params(0, dev)
    planes, dec = p["planes"], p["decoder"]
    meta = (2, 8, 5)
    rows = {}

    def record(name, label, errs, ms, plain_ms, n):
        """errs: {output name: (max abs error, relative error)}"""
        part, (worst_abs, worst) = max(errs.items(), key=lambda kv: kv[1][1])
        tol = TOL[label]
        print(f"{label:18s} N={n:7d} max_abs={worst_abs:.3e} "
              f"max_rel={worst:.3e} ({part}) tol_rel={tol:.0e} "
              f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms")
        if not worst <= tol:
            _fail(f"{label}: relative error {worst:.3e} > {tol:.0e} in "
                  f"{part}; all: {errs}")
        r = rows.setdefault(name, {"name": name, "route": "cuda",
                                   "source": SOURCE[name],
                                   "replaces": REPLACES[name],
                                   "max_abs_err": 0.0, "ms": {},
                                   "plain_ms": {}})
        r["max_abs_err"] = max(r["max_abs_err"], worst_abs)
        r["ms"][label] = ms
        r["plain_ms"][label] = plain_ms

    # K0 at the BA shape (195,000 points), row layout [N, 3] -> [N, 48]
    x = test_points(195_000, 1, dev)
    xr0 = x.T.contiguous()
    out = tc.encode_forward(xr0, planes, 2)
    ref = tc.encode_forward_plain(planes, xr0, 2)
    record("encode_forward", "encode_forward", {"embed": _err(out, ref)},
           _time_ms(lambda: tc.encode_forward(xr0, planes, 2)),
           _time_ms(lambda: tc.encode_forward_plain(planes, xr0, 2)),
           x.shape[1])
    del xr0, out, ref

    # K1 full with return_embed at the BA shape
    out, emb = fc.field_forward(x, planes, dec, *meta, return_embed=True)
    ref, ref_emb = fc.field_forward_plain(x, planes, dec, *meta,
                                          return_embed=True)
    torch.cuda.synchronize()
    record("field_forward", "field_forward",
           {"out": _err(out, ref), "embed": _err(emb, ref_emb)},
           _time_ms(lambda: fc.field_forward(x, planes, dec, *meta,
                                             return_embed=True)),
           _time_ms(lambda: fc.field_forward_plain(x, planes, dec, *meta,
                                                   return_embed=True)),
           x.shape[1])
    # K1 sdf_only at the RO shape (2000 particles x 384 pixels)
    xr = test_points(768_000, 2, dev)
    out = fc.field_forward(xr, planes, dec, *meta, sdf_only=True)
    ref = fc.field_forward_plain(xr, planes, dec, *meta, sdf_only=True)
    record("field_forward", "field_forward_sdf", {"sdf": _err(out, ref)},
           _time_ms(lambda: fc.field_forward(xr, planes, dec, *meta,
                                             sdf_only=True)),
           _time_ms(lambda: fc.field_forward_plain(xr, planes, dec, *meta,
                                                   sdf_only=True), reps=3),
           xr.shape[1])
    del xr, out, ref

    # K2-K4 at the BA shape with a random cotangent
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    g = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    g, frac = kink_free(g, x, emb, dec)
    print(f"decoder_backward: cotangent zeroed at {frac:.4%} of points "
          "(ReLU pre-activation within 1e-4 of 0)")
    d_embed = torch.randn((48, x.shape[1]), generator=gen, device=dev) * 0.1
    k2 = fc.decoder_backward(x, g, emb, dec, 8, 5)
    r2 = fc.decoder_backward_plain(x, g, emb, dec, 8, 5)
    errs = {"d_x": _err(k2[0], r2[0]), "d_embed": _err(k2[1], r2[1])}
    for name in k2[2]:
        for w in ("w", "b"):
            errs[f"{name}.{w}"] = _err(k2[2][name][w], r2[2][name][w])
    record("decoder_backward", "decoder_backward", errs,
           _time_ms(lambda: fc.decoder_backward(x, g, emb, dec, 8, 5)),
           _time_ms(lambda: fc.decoder_backward_plain(x, g, emb, dec, 8, 5)),
           x.shape[1])
    k3 = tc.plane_backward(x, d_embed, planes, 2)
    r3 = tc.plane_backward_plain(x, d_embed, planes, 2)
    record("plane_backward", "plane_backward",
           {k: _err(k3[k], r3[k]) for k in ("s0", "s1", "cp")},
           _time_ms(lambda: tc.plane_backward(x, d_embed, planes, 2)),
           _time_ms(lambda: tc.plane_backward_plain(x, d_embed, planes, 2)),
           x.shape[1])
    k4 = tc.x_backward(x, d_embed, planes, 2)
    r4 = tc.x_backward_plain(x, d_embed, planes, 2)
    record("x_backward", "x_backward", {"d_x": _err(k4, r4)},
           _time_ms(lambda: tc.x_backward(x, d_embed, planes, 2)),
           _time_ms(lambda: tc.x_backward_plain(x, d_embed, planes, 2)),
           x.shape[1])
    torch.cuda.synchronize()
    return rows


def phase_autograd():
    """FieldQueryT gradients (kernels) vs the same Function on the plain
    path, on interior points (where the composite autodiff path and the
    kernels' coordinate gradient agree)."""
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    dev = torch.device("cuda")
    p = flagship_params(5, dev)
    x = test_points(60_000, 6, dev, inside_only=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    G = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    G, _ = kink_free(G, x, fc.field_forward(
        x, p["planes"], p["decoder"], 2, 8, 5, return_embed=True)[1],
        p["decoder"])

    def grads(run_plain: bool):
        leaves = {"planes": {k: v.detach().clone().requires_grad_(True)
                             for k, v in p["planes"].items()},
                  "decoder": {n: {k: t.detach().clone().requires_grad_(True)
                                  for k, t in d.items()}
                              for n, d in p["decoder"].items()}}
        xx = x.clone().requires_grad_(True)
        if run_plain:
            # composite autodiff of the plain forward
            out = fc.field_forward_plain(
                xx, leaves["planes"], leaves["decoder"], 2, 8, 5)
        else:
            out = fc.field_query_T(leaves, xx, 2, 8, 5)
        (out * G).sum().backward()
        flat = [t.grad for t in leaves["planes"].values()]
        flat += [t.grad for d in leaves["decoder"].values()
                 for t in d.values()]
        return flat, xx.grad

    gk, xk = grads(False)
    gp, xp = grads(True)
    worst = max(_err(a, b)[1] for a, b in zip(gk, gp))
    wx = _err(xk, xp)[1]
    print(f"autograd: params max_rel={worst:.3e} x max_rel={wx:.3e} "
          f"tol_rel=1e-4")
    if not (worst <= 1e-4 and wx <= 1e-4):
        _fail("FieldQueryT gradients disagree with the plain path")

    # TriplaneEncode (K0 forward, K3 + K4 backward) against autograd of
    # the plain composite encode
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    xe = x.T.contiguous()
    Ge = torch.randn((xe.shape[0], 48), generator=gen, device=dev) * 0.1

    def enc_grads(run_plain: bool):
        planes = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p["planes"].items()}
        xx = xe.clone().requires_grad_(True)
        fn = tc.encode_forward_plain if run_plain else tc.triplane_encode
        (fn(planes, xx, 2) * Ge).sum().backward()
        return [planes[k].grad for k in ("s0", "s1", "cp")], xx.grad

    gk, xk = enc_grads(False)
    gp, xp = enc_grads(True)
    worst = max(_err(a, b)[1] for a, b in zip(gk, gp))
    wx = _err(xk, xp)[1]
    print(f"autograd TriplaneEncode: planes max_rel={worst:.3e} "
          f"x max_rel={wx:.3e} tol_rel=1e-4")
    if not (worst <= 1e-4 and wx <= 1e-4):
        _fail("TriplaneEncode gradients disagree with the plain path")


# the kernels every SLAM path launches (K0 has no caller on the SLAM path,
# as triplane_encode_pallas has none in the JAX package)
SLAM_KERNELS = ("field_forward", "decoder_backward", "plane_backward",
                "x_backward")


def _run_path(slam):
    """Drive the port's entry point with every launch count set to 0 just
    before and read just after; returns (results, counts, wall s)."""
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    fc.reset_launch_counts()
    t0 = time.time()
    res = slam.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = fc.launch_counts()
    missing = [k for k in SLAM_KERNELS if counts[k] <= 0]
    if missing:
        _fail(f"kernels never launched by the SLAM loop: {missing}")
    losses = np.asarray([float(v) for v in slam.track_losses])
    if not np.isfinite(losses).all():
        _fail("non-finite tracking loss")
    if not all(t.is_cuda for f in slam.fields if f is not None
               for t in f.parameters()):
        _fail("field parameters are not on the GPU")
    return res, counts, wall


def phase_slam(n_frames: int = 45):
    import torch
    from mipsfusion_tpu_torch.config import flagship_orbit
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    dev = torch.device("cuda")
    cfg = flagship_orbit(use_manager=False)
    cfg["data"]["output"] = None
    ds = SyntheticDataset(cfg, n_frames=n_frames, trajectory="orbit",
                          span=n_frames / 200.0, device=dev)
    slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    res, counts, wall = _run_path(slam)
    ate = res["absolute_translational_error.rmse"]
    print(f"orbit: {n_frames} frames  ATE RMSE {ate * 1000:.2f} mm  "
          f"tracked FPS {res['fps']:.2f}  wall {wall:.1f} s  "
          f"submaps {res['n_submaps']}  launches {counts}")
    print("orbit stage ms (CUDA events, mean per call): "
          + json.dumps({k: round(v, 3) for k, v in slam.stage_ms().items()}))
    if not ate < 0.02:
        _fail(f"orbit ATE {ate:.4f} m >= 0.02 m")
    if res["n_submaps"] != 1:
        _fail(f"orbit n_submaps {res['n_submaps']} != 1")
    return counts


def phase_outback(n_frames: int = 200, seed: int = 0):
    """The slice's main path: the default multi-submap loop on the
    flagship out-and-back scene at full budgets (``seed``: the system's
    random draws and initial field)."""
    import torch
    from mipsfusion_tpu_torch.config import flagship_outback
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    dev = torch.device("cuda")
    cfg = flagship_outback(use_manager=True, seed=seed)
    cfg["data"]["output"] = None
    ds = SyntheticDataset(cfg, n_frames=n_frames, trajectory="outback",
                          span=1.0, device=dev)
    slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = _run_path(slam)
    ate = res["absolute_translational_error.rmse"]
    calls = dict(slam.stage_calls)
    print(f"outback: {n_frames} frames  seed {seed}  ATE RMSE "
          f"{ate * 1000:.2f} mm  tracked FPS {res['fps']:.2f}  "
          f"wall {wall:.1f} s  submaps {res['n_submaps']}  switches "
          f"(frame, flag) {slam.switch_events}  peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"outback launches {counts}  stage calls {calls}")
    print("outback stage ms (CUDA events, mean per call): "
          + json.dumps({k: round(v, 3) for k, v in slam.stage_ms().items()}))
    st = slam.state
    used = res["n_submaps"]
    anchors = st.kf_c2w[st.localMLP_first_kf[:used]].cpu().numpy()
    R = anchors[:, :3, :3]
    if not (np.isfinite(anchors).all() and np.allclose(
            R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-3)):
        _fail("a submap anchor is not finite and orthonormal")
    if not ate < 0.03:
        _fail(f"outback ATE {ate:.4f} m >= 0.03 m")
    if used < 2:
        _fail(f"outback n_submaps {used} < 2")
    for stage in ("switch_back", "switch_ba", "pgo", "refine"):
        if calls.get(stage, 0) < 1:
            _fail(f"outback: no {stage} ran")
    # switch BA again on the last switch-back frame, after the run: the
    # field is frozen, so K1, K2 and K4 launch and K3 (plane gradients)
    # must not
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    i_sw = max(f for f, flag in slam.switch_events if flag == 1)
    fc.reset_launch_counts()
    slam.local_ba_switch(ds.packed(i_sw), i_sw // slam.keyframe_every, i_sw)
    sw = fc.launch_counts()
    print(f"outback switch BA alone (frame {i_sw}): launches {sw}")
    if sw["plane_backward"] != 0 or not all(
            sw[k] > 0 for k in ("field_forward", "decoder_backward",
                                "x_backward")):
        _fail(f"switch BA launches {sw}: want K1, K2, K4 and no K3")
    return counts


def outback_seeds(seeds):
    """Repeatability: the outback phase once per seed, in one process
    after one build. Every seed runs; the exit is non-zero if any failed."""
    phase_device()
    phase_build()
    failed = []
    for s in seeds:
        try:
            phase_outback(seed=s)
        except SystemExit as e:
            print(e)
            failed.append(s)
    if failed:
        _fail(f"outback failed for seeds {failed}")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outback-seeds", default=None,
                    help="comma-separated seeds, e.g. 0,1,2,0: build, then "
                         "run only the outback phase once per seed")
    args = ap.parse_args(argv)
    if args.outback_seeds is not None:
        outback_seeds([int(s) for s in args.outback_seeds.split(",")])
        return 0
    phase_device()
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    phase_build()
    fc.reset_launch_counts()
    rows = phase_kernels()
    phase_autograd()
    k0_launches = fc.launch_counts()["encode_forward"]
    orbit_counts = phase_slam()
    counts = phase_outback()
    # K0 has no SLAM caller (as triplane_encode_pallas has none in the JAX
    # package): neither loop may launch it
    k0_loops = (orbit_counts["encode_forward"], counts["encode_forward"])
    if any(k0_loops):
        _fail(f"K0 launched by a SLAM loop (orbit, outback): {k0_loops}")
    kernels = []
    for name, r in rows.items():
        on_path = name in SLAM_KERNELS
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"],
            # the main path's launches (the outback run); K0's count is
            # from the kernel and autograd phases
            "launches": counts[name] if on_path else k0_launches,
            "launches_outback": counts[name],
            "launches_orbit": orbit_counts[name],
            "slam_caller": on_path,
            "max_abs_err": r["max_abs_err"],
            # "ms" at the first shape measured (the BA batch, 195,000
            # points); every shape's times ride beside it
            "ms": next(iter(r["ms"].values())),
            "plain_ms": next(iter(r["plain_ms"].values())),
            "ms_by_shape": r["ms"], "plain_ms_by_shape": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

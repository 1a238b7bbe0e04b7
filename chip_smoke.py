"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device  - require CUDA; print nvidia-smi's name and power limit;
  2. build   - compile the field kernels (mipsfusion_tpu_torch/csrc) with
               nvcc for sm_90a, one process per source; count the tensor-
               core (HMMA) instructions of K2's kernels in the SASS
               (cuobjdump -sass, where the toolkit has it);
  3. kernels - each of K0-K4 against its plain PyTorch version at the SLAM
               loop's shapes (flagship widths, params from a fixed seed,
               points inside, outside and on the edge of [0, 1]^3): max
               abs / relative error beside the tolerance, median times;
               then K2, K3 and K4 again on ray-ordered points (2600 rays x
               75 samples, each ray's samples contiguous, as the loop lays
               them out), and K2 without weight gradients at the GO shape;
               K2 and K3 called twice give the same bits;
  4. autograd - FieldQueryT's and TriplaneEncode's gradients against the
               plain path;
  5. orbit   - 45 frames of the flagship orbit at full budgets,
               single submap (use_manager: False), through
               MIPSFusionTorch.run(): ATE, tracked FPS, launch counts;
               then the same run again, which must give the same poses
               and field bit for bit;
  6. outback - 200 frames of the flagship out-and-back scene at full
               budgets with the submap manager (use_manager: True), once
               per seed of OUTBACK_SEEDS: each run ATE < 0.03 m, new
               submaps, background refinement; at least one run closes a
               loop (switch back with switch BA and PGO), and on it switch
               BA runs once more alone (K1, K2, K4, and no K3); FPS,
               switch frames, stage times.
The kernels' JSON line comes second to last; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --outback-seeds 0,1,2,0 [--outback-spawn 50]

runs phases 1, 2 and then only phase 6, once per seed (repeatability),
with the manager's predicates, the loop closures and the pose errors
printed at every keyframe; --outback-spawn pins the run to the branch
that opens its second submap at that keyframe.
"""

from __future__ import annotations

import json
import os
import re
import shutil
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


def sass_hmma(path: str):
    """{kernel (mangled name): HMMA instructions} from cuobjdump -sass, or
    None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.search(r"\bHMMA\b", line):
            counts[cur] += 1
    return counts


def phase_build(check_hmma: bool = True):
    try:
        from mipsfusion_tpu_torch.ops import _build
    except ImportError as e:
        _fail(f"the port's package is not beside chip_smoke.py: {e}")
    t0 = time.time()
    path = _build.build(verbose=True)
    _build.lib()
    print(f"build: {path} in {time.time() - t0:.1f} s")
    if not check_hmma:
        return
    hmma = sass_hmma(path)
    if hmma is None:
        print("sass: cuobjdump not found, HMMA count not taken")
        return
    k2 = {k: v for k, v in hmma.items() if "decoder_bwd" in k}
    print("sass HMMA instructions per K2 kernel: " + json.dumps(k2))
    if not k2 or not all(v > 0 for v in k2.values()):
        _fail(f"K2 kernels without tensor-core instructions: {k2}")


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


def ray_points(n_rays: int, n_samples: int, seed: int, device):
    """x [3, n_rays * n_samples]: ray samples laid out as the SLAM loop
    lays them out (models/scene_rep.py render_rays_T): each ray's samples
    contiguous and in increasing depth. A ray starts inside the unit cube
    (the camera is inside the room) and runs in a random direction; 72% of
    its samples are stratified over a depth of 1.2 (so they leave the cube,
    as the loop's samples out to the far plane do), the rest within 0.035
    of a surface depth, as the loop's depth-guided samples."""
    import torch
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.7, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n_near = int(round(0.28 * n_samples))
    n_far = n_samples - n_near
    edges = np.linspace(0.0, 1.2, n_far + 1)
    t_far = edges[:-1] + (edges[1] - edges[0]) * rng.uniform(
        size=(n_rays, n_far))
    surf = rng.uniform(0.15, 0.6, (n_rays, 1))
    t_near = surf + np.linspace(-0.035, 0.035, n_near) + rng.uniform(
        -1e-3, 1e-3, (n_rays, n_near))
    t = np.sort(np.concatenate([t_far, t_near], axis=1), axis=1)
    x = (o + d * t[..., None]).reshape(-1, 3).T
    return torch.tensor(x, dtype=torch.float32, device=device).contiguous()


def _flat(t):
    """Every tensor of a nested tuple/dict, in order."""
    if isinstance(t, dict):
        return [u for k in sorted(t) for u in _flat(t[k])]
    if isinstance(t, (tuple, list)):
        return [u for v in t for u in _flat(v)]
    return [t]


def same(label: str, a, b):
    """Fail unless two results of the same call are bitwise equal."""
    import torch
    if not all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b))):
        _fail(f"{label}: two calls on the same inputs differ")
    print(f"{label:24s} two calls bitwise equal")


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
TOL = {"encode_forward": 2e-5, "field_forward": 2e-5,
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


# The card's peaks for the bounds (NVIDIA's data sheet, H100 SXM, dense):
# float32 outside the tensor cores, TF32 on the tensor cores, and device
# memory. A product at float32 accuracy on the tensor cores takes three
# TF32 products (the 3xTF32 split, K2's route), so the decoder's matrix
# products are bound at a third of the TF32 rate.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_MM_F32 = PEAK_TF32 / 3
PEAK_BYTES = 3.35e12
# FLOPs per point, (decoder matrix products, the rest), from the flagship
# widths: encode 2 scales x 3 planes x 4 taps x 4 features x 2 plus CP 40
# x (3 lerps x 3 + 2 products) = 632; decoder forward 38,233 MACs (6,528 +
# 16,384 + 14,336 + 640 + 345), sdf-only 29,696 MACs; K2 forward recompute
# 37,888 + data backward 38,233 (+ weight gradients 38,625) MACs; K3 ~ 24
# taps x 5 + 40 x 21 = 960; K4 ~ 6 planes x 40 + 40 x 20 = 1,040.
FLOP_PT = {"encode_forward": (0, 632),
           "field_forward": (2 * 38_233, 632),
           "field_forward_sdf": (2 * 29_696, 632),
           "decoder_backward": (2 * (37_888 + 38_233 + 38_625), 0),
           "decoder_backward_go": (2 * (37_888 + 38_233), 0),
           "plane_backward": (0, 960), "x_backward": (0, 1_040)}
TABLE_BYTES = (3 * 32 * 32 * 4 + 3 * 64 * 64 * 4 + 3 * 384 * 40) * 4
WEIGHT_BYTES = 38_625 * 4
# bytes per point (each input read once, each output written once) and
# per call
BYTES = {"encode_forward": (12 + 192, TABLE_BYTES),
         "field_forward": (12 + 40 + 192, TABLE_BYTES + WEIGHT_BYTES),
         "field_forward_sdf": (12 + 4, TABLE_BYTES + WEIGHT_BYTES),
         "decoder_backward": (12 + 40 + 192 + 12 + 192, 2 * WEIGHT_BYTES),
         "decoder_backward_go": (12 + 40 + 192 + 12 + 192, WEIGHT_BYTES),
         "plane_backward": (12 + 192, TABLE_BYTES + 3 * 384 * 40 * 4),
         "x_backward": (12 + 192 + 12, TABLE_BYTES)}


def bound(kind: str, n: int):
    """(bound ms, "bytes" or "operations") of one call on n points."""
    mm, rest = FLOP_PT[kind]
    flop_ms = (mm / PEAK_MM_F32 + rest / PEAK_F32) * n * 1e3
    per_pt, fixed = BYTES[kind]
    byte_ms = (per_pt * n + fixed) / PEAK_BYTES * 1e3
    return (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms,
                                                                "bytes")


def phase_kernels():
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    dev = torch.device("cuda")
    p = flagship_params(0, dev)
    planes, dec = p["planes"], p["decoder"]
    meta = (2, 8, 5)
    rows = {}

    def record(name, label, errs, ms, plain_ms, n, kind=None):
        """errs: {output name: (max abs error, relative error)}"""
        part, (worst_abs, worst) = max(errs.items(), key=lambda kv: kv[1][1])
        tol = TOL[name]
        b_ms, b_by = bound(kind or label.split("@")[0], n)
        print(f"{label:24s} N={n:7d} max_abs={worst_abs:.3e} "
              f"max_rel={worst:.3e} ({part}) tol_rel={tol:.0e} "
              f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
              f"bound={b_ms:.3f} ms ({b_by})")
        if not worst <= tol:
            _fail(f"{label}: relative error {worst:.3e} > {tol:.0e} in "
                  f"{part}; all: {errs}")
        r = rows.setdefault(name, {"name": name, "route": "cuda",
                                   "source": SOURCE[name],
                                   "replaces": REPLACES[name],
                                   "max_abs_err": 0.0, "ms": {},
                                   "plain_ms": {}, "bound_ms": {},
                                   "bound_by": {}})
        r["max_abs_err"] = max(r["max_abs_err"], worst_abs)
        r["ms"][label] = ms
        r["plain_ms"][label] = plain_ms
        r["bound_ms"][label] = b_ms
        r["bound_by"][label] = b_by

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
    del xr, out, ref, emb, ref_emb

    # K2-K4 at the BA shape with a random cotangent: uniform points, then
    # ray-ordered points (2600 rays x 75 samples)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    xrays = ray_points(2600, 75, 8, dev)
    for suffix, xx in (("", x), ("@rays", xrays)):
        n = xx.shape[1]
        emb = fc.field_forward(xx, planes, dec, *meta, return_embed=True)[1]
        g = torch.randn((10, n), generator=gen, device=dev) * 0.1
        g, frac = kink_free(g, xx, emb, dec)
        print(f"decoder_backward{suffix}: cotangent zeroed at {frac:.4%} "
              "of points (ReLU pre-activation within 1e-4 of 0)")
        d_embed = torch.randn((48, n), generator=gen, device=dev) * 0.1
        r2 = fc.decoder_backward_plain(xx, g, emb, dec, 8, 5)
        plain2 = _time_ms(lambda: fc.decoder_backward_plain(xx, g, emb, dec,
                                                            8, 5))
        k2 = fc.decoder_backward(xx, g, emb, dec, 8, 5)
        errs = {"d_x": _err(k2[0], r2[0]), "d_embed": _err(k2[1], r2[1])}
        for name in k2[2]:
            for w in ("w", "b"):
                errs[f"{name}.{w}"] = _err(k2[2][name][w], r2[2][name][w])
        record("decoder_backward", f"decoder_backward{suffix}", errs,
               _time_ms(lambda: fc.decoder_backward(xx, g, emb, dec, 8, 5)),
               plain2, n, kind="decoder_backward")
        k3 = tc.plane_backward(xx, d_embed, planes, 2)
        r3 = tc.plane_backward_plain(xx, d_embed, planes, 2)
        # K2 and K3 give the same bits in every call (fixed-order partial
        # sums; fixed-point integer atomics)
        same(f"decoder_backward{suffix}", k2,
             fc.decoder_backward(xx, g, emb, dec, 8, 5))
        same(f"plane_backward{suffix}", k3,
             tc.plane_backward(xx, d_embed, planes, 2))
        record("plane_backward", f"plane_backward{suffix}",
               {k: _err(k3[k], r3[k]) for k in ("s0", "s1", "cp")},
               _time_ms(lambda: tc.plane_backward(xx, d_embed, planes, 2)),
               _time_ms(lambda: tc.plane_backward_plain(xx, d_embed, planes,
                                                        2)),
               n, kind="plane_backward")
        k4 = tc.x_backward(xx, d_embed, planes, 2)
        r4 = tc.x_backward_plain(xx, d_embed, planes, 2)
        record("x_backward", f"x_backward{suffix}", {"d_x": _err(k4, r4)},
               _time_ms(lambda: tc.x_backward(xx, d_embed, planes, 2)),
               _time_ms(lambda: tc.x_backward_plain(xx, d_embed, planes, 2)),
               n, kind="x_backward")
        del emb, g, d_embed, r2, r3, k2, k3, k4, r4

    # K2 without weight gradients (GO: pose gradients only) at the GO shape
    # (1000 rays x 75 samples)
    xg = ray_points(1000, 75, 9, dev)
    emb = fc.field_forward(xg, planes, dec, *meta, return_embed=True)[1]
    g = torch.randn((10, xg.shape[1]), generator=gen, device=dev) * 0.1
    g, _ = kink_free(g, xg, emb, dec)
    k2 = fc.decoder_backward(xg, g, emb, dec, 8, 5, weight_grads=False)
    r2 = fc.decoder_backward_plain(xg, g, emb, dec, 8, 5, weight_grads=False)
    record("decoder_backward", "decoder_backward_go@rays",
           {"d_x": _err(k2[0], r2[0]), "d_embed": _err(k2[1], r2[1])},
           _time_ms(lambda: fc.decoder_backward(xg, g, emb, dec, 8, 5,
                                                weight_grads=False)),
           _time_ms(lambda: fc.decoder_backward_plain(
               xg, g, emb, dec, 8, 5, weight_grads=False)),
           xg.shape[1], kind="decoder_backward_go")
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
    # a run is reproducible: the same config and seed again give the same
    # poses and field, bit for bit
    again = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    _run_path(again)
    same("orbit run twice", (slam.state.est_c2w, slam.state.est_c2w_rel,
                             slam.field.params(detach=True)),
         (again.state.est_c2w, again.state.est_c2w_rel,
          again.field.params(detach=True)))
    return counts


def phase_outback(n_frames: int = 200, seed: int = 0, spawn=None,
                  trace: bool = False):
    """The slice's main path: the default multi-submap loop on the
    flagship out-and-back scene at full budgets (``seed``: the system's
    random draws and initial field; ``trace``/``spawn``: see
    ``trace_outback``)."""
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
    if trace or spawn is not None:
        trace_outback(slam, ds, spawn)
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
    if calls.get("refine", 0) < 1:
        _fail("outback: no refine ran")
    closed = all(calls.get(k, 0) >= 1
                 for k in ("switch_back", "switch_ba", "pgo"))
    print(f"outback seed {seed}: loop closed (switch back, switch BA, PGO): "
          f"{closed}")
    if closed:
        switch_ba_alone(slam, ds)
    return counts, closed


def switch_ba_alone(slam, ds):
    """Switch BA again on the last switch-back frame, after the run: the
    field is frozen, so K1, K2 and K4 launch and K3 (plane gradients) must
    not."""
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


# The outback's seeds. A run is reproducible, so a seed fixes its branch of
# the manager's decisions; some seeds return to a previous submap's region
# and open a new submap instead of switching back (seeds 0 and 4 of 0-7:
# the most-overlapping earlier submap holds 45% and 27% of the view
# against the 50% a switch needs). Every run must hold the accuracy and submap checks, and at least
# one must close a loop, so that switch back, switch BA and PGO run.
OUTBACK_SEEDS = (0, 1, 2)


def phase_outbacks(seeds=OUTBACK_SEEDS):
    """The outback once per seed; returns the launch counts of every run
    and those of the first run that closed a loop (the main path)."""
    runs = [(s, *phase_outback(seed=s)) for s in seeds]
    closing = [counts for _, counts, closed in runs if closed]
    if not closing:
        _fail(f"outback: no run of seeds {list(seeds)} closed a loop "
              "(switch back with switch BA and PGO)")
    return {s: counts for s, counts, _ in runs}, closing[0]


def trace_outback(slam, ds, spawn=None):
    """Instrument one outback run: print the manager's predicates and
    decision at every keyframe, each loop-closure verification (the
    rectified pose's correction and the world position error before and
    after it), and after every keyframe the frame's world position error
    and each used submap anchor's; with ``spawn`` the manager must open a
    new submap at that frame (its containment test fails there), which
    pins the run to one branch of the decisions."""
    import dataclasses
    from mipsfusion_tpu_torch.slam import icp as icp_mod
    mgr = slam.manager
    st = slam.state
    pred_fn, normal_fn = mgr._predicates, mgr._process_normal
    find_fn, frame_fn = slam._find_overlapping_region, slam.process_frame
    last = {}

    def anchor(m):
        return st.kf_c2w[st.localMLP_first_kf[m]].cpu().numpy()

    def err_mm(pose, frame):
        return 1e3 * float(np.linalg.norm(np.asarray(pose)[:3, 3]
                                          - ds.gt_pose(frame)[:3, 3]))

    def predicates(st_, depth, rays_d, pose_local, wait_id):
        p = pred_fn(st_, depth, rays_d, pose_local, wait_id)
        last["pred"] = {k: np.round(np.asarray(p[k], np.float64), 4).tolist()
                        for k in ("cr_active", "cr_active_new", "mo_id",
                                  "cr_mo", "cr_wait")}
        return p

    def process_normal(st_, depth, rays_d, pose_local, frame_id, kf_id,
                       force, pred=None):
        if frame_id != spawn:
            return normal_fn(st_, depth, rays_d, pose_local, frame_id,
                             kf_id, force, pred=pred)
        cfg = mgr.cfg
        mgr.cfg = dataclasses.replace(cfg, min_containing_ratio=2.0)
        try:
            return normal_fn(st_, depth, rays_d, pose_local, frame_id,
                             kf_id, False, pred=pred)
        finally:
            mgr.cfg = cfg

    def find(mo_id, active_id, st_, depth, rays_d, pose_world):
        i = slam._last_tracked_frame
        ini = anchor(active_id) @ st.est_c2w[i].cpu().numpy()
        icp_fn = icp_mod.icp_point_to_plane
        spied = {}

        def icp_spy(*a, **kw):
            # the undamped solve on the same inputs (the JAX package's)
            spied["undamped"] = icp_fn(*a, **{**kw, "rel_damping": 0.0})
            return icp_fn(*a, **kw)

        icp_mod.icp_point_to_plane = icp_spy
        try:
            ok, data = find_fn(mo_id, active_id, st_, depth, rays_d,
                               pose_world)
        finally:
            icp_mod.icp_point_to_plane = icp_fn
        undamped = spied.get("undamped")
        rec = {"frame": i, "back_to": mo_id, "from": active_id, "ok": ok,
               "err_ini_mm": round(err_mm(ini, i), 2)}
        if ok:
            rect = anchor(mo_id) @ slam.rectified_local_pose.cpu().numpy()
            rec["err_rect_mm"] = round(err_mm(rect, i), 2)
            rec["correction_mm"] = round(1e3 * float(np.linalg.norm(
                rect[:3, 3] - ini[:3, 3])), 2)
        if undamped is not None:
            T = undamped.transform.cpu().numpy()
            if np.linalg.norm(T[:3, 3]) < slam.sw_min_trans:
                local = T @ np.linalg.inv(anchor(mo_id)) @ ini
                rec["err_rect_undamped_mm"] = round(
                    err_mm(anchor(mo_id) @ local, i), 2)
        print("outback trace verify " + json.dumps(rec))
        return ok, data

    def process_frame(i):
        last.pop("pred", None)
        n_ev = len(slam.switch_events)
        frame_fn(i)
        if i % slam.keyframe_every:
            return
        used = slam._host_used
        world = slam.world_trajectory(i)
        rec = {"frame": i, "active": slam.active_id,
               "flag": slam.switch_events[-1][1]
               if len(slam.switch_events) > n_ev else 2,
               "err_mm": round(err_mm(world[i], i), 2),
               "anchor_err_mm": [round(err_mm(anchor(m), int(
                   st.localMLP_first_kf[m]) * slam.keyframe_every), 2)
                   for m in range(used)], **last.get("pred", {})}
        print("outback trace kf " + json.dumps(rec))

    mgr._predicates, mgr._process_normal = predicates, process_normal
    slam._find_overlapping_region = find
    mgr.find_overlap_fn = find
    slam.process_frame = process_frame


def outback_seeds(seeds, spawn=None):
    """Repeatability: the outback phase once per seed, traced, in one
    process after one build. Every seed runs; the exit is non-zero if any
    failed."""
    phase_device()
    phase_build(check_hmma=False)
    failed, closed = [], []
    for s in seeds:
        try:
            if phase_outback(seed=s, spawn=spawn, trace=True)[1]:
                closed.append(s)
        except SystemExit as e:
            print(e)
            failed.append(s)
    print(f"outback seeds that closed a loop: {closed}")
    if failed:
        _fail(f"outback failed for seeds {failed}")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outback-seeds", default=None,
                    help="comma-separated seeds, e.g. 0,1,2,0: build, then "
                         "run only the outback phase once per seed, traced")
    ap.add_argument("--outback-spawn", type=int, default=None,
                    metavar="FRAME",
                    help="with --outback-seeds: the manager opens a new "
                         "submap at keyframe FRAME (pins the branch)")
    args = ap.parse_args(argv)
    if args.outback_seeds is not None:
        outback_seeds([int(s) for s in args.outback_seeds.split(",")],
                      args.outback_spawn)
        return 0
    phase_device()
    phase_build()
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    fc.reset_launch_counts()
    rows = phase_kernels()
    phase_autograd()
    k0_launches = fc.launch_counts()["encode_forward"]
    orbit_counts = phase_slam()
    by_seed, counts = phase_outbacks()
    # K0 has no SLAM caller (as triplane_encode_pallas has none in the JAX
    # package): no loop may launch it
    k0_loops = [orbit_counts["encode_forward"]] + [
        c["encode_forward"] for c in by_seed.values()]
    if any(k0_loops):
        _fail(f"K0 launched by a SLAM loop (orbit, outbacks): {k0_loops}")
    kernels = []
    for name, r in rows.items():
        on_path = name in SLAM_KERNELS
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"],
            # the main path's launches (the first outback run that closed
            # a loop); K0's count is from the kernel and autograd phases
            "launches": counts[name] if on_path else k0_launches,
            "launches_outback": counts[name],
            "launches_outback_by_seed": {s: c[name]
                                         for s, c in by_seed.items()},
            "launches_orbit": orbit_counts[name],
            "slam_caller": on_path,
            "max_abs_err": r["max_abs_err"],
            # "ms", "plain_ms" and the bound at the first shape measured
            # (the BA batch, 195,000 uniform points); every shape's
            # numbers ride beside them
            "ms": next(iter(r["ms"].values())),
            "plain_ms": next(iter(r["plain_ms"].values())),
            "bound_ms": next(iter(r["bound_ms"].values())),
            "bound_by": next(iter(r["bound_by"].values())),
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            "ms_by_shape": r["ms"], "plain_ms_by_shape": r["plain_ms"],
            "bound_ms_by_shape": r["bound_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

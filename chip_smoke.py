"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device  - require CUDA; print nvidia-smi's name and power limit;
  2. build   - compile the field kernels (mipsfusion_tpu_torch/csrc) with
               nvcc for sm_90a, one process per source; count the tensor-
               core (HMMA) instructions of K1's and K2's kernels in the
               SASS (cuobjdump -sass, where the toolkit has it);
  3. kernels - each of K0-K4 against its plain PyTorch version at every
               field shape the kernels are compiled for (ops/_build.SHAPES:
               the flagship's [32, 64] + CP 384 x 40, the CP profile's
               [32, 64, 128] + CP 512 x 32, the FastCaMo-large family's
               [32, 64, 128] + CP 384 x 40; labels of the latter two carry
               "cp:" or "fcl:"), at each shape's loop sizes, and the
               flagship's again at the scale profile's sizes and the
               stress screen's (labels "snake:")
               (KERNEL_SHAPES; params from a fixed seed, points inside,
               outside and on the edge of [0, 1]^3): max abs / relative
               error beside the tolerance, median times (device time of
               queued calls, and the time of one call launched on an idle
               device, wrapper included), the bound;
               K1 also at the GO shape on ray-ordered points, at the fit
               shape and sdf-only at RO's (a call, and for the CP profile
               a frame's four at once), and on one chunk of the mesher's
               grid; then K2, K3 and K4 again on ray-ordered
               points (each ray's samples contiguous, as the loop lays them
               out), K4 with the PE's share of d_x added, and K2 without
               weight gradients at the GO shape; K0 also on the BA's
               ray-ordered points and on 786,432 points, equal bit for bit
               to K1's embed at the BA shape and on those rays; K0-K4 at
               point counts that are no multiple of a tile (195,001 and
               63); K1's packed weights against the plain packer; K0-K4
               called twice give the same bits; a SHA-256 of K0-K4's
               outputs on fixed flagship inputs (two trees with the same
               kernels print the same digests);
  4. autograd - FieldQueryT's and TriplaneEncode's gradients against the
               plain path, at every shape;
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
               switch frames, stage times;
  7. mesh    - on that first loop-closing run (the main path), the joint
               mesh of its submaps at voxel 0.03 (MIPSFusionTorch.
               extract_mesh): K1 launched, no backward kernel, a finite
               non-empty mesh with accuracy < 0.05 m and completion@5cm
               > 0.85 against the scene's analytic SDF; its wall time by
               step; then save_checkpoint, a fresh system's resume_from
               and extract_mesh again: the same vertices and faces, bit
               for bit;
  8. cli     - python3 -m mipsfusion_tpu_torch on a yaml inheriting
               configs/synthetic/orbit.yaml (30 frames, a checkpoint at
               frame 15), then again with --resume <out>/ckpt_15: each
               exits 0 with ATE < 0.02 m and leaves its trajectory,
               checkpoints, render panel and mesh_final.ply; then the
               port's eval_ate tool (python3 -m
               mipsfusion_tpu_torch.tools.eval_ate) on the CLI's
               trajectory and the scene's ground truth must print the
               CLI's ATE within 1e-6 m;
  9. cp profile - configs/synthetic/orbit_fast_cp.yaml as a user runs it
               (the port's load_config, MIPSFusionTorch(cfg, dataset=
               SyntheticDataset(cfg)).run(), 200 frames, the manager as
               the config leaves it): K1-K4 at the cp shape, ATE < 0.02 m,
               launch counts; then the joint mesh at mesh.voxel_final:
               completion@5cm > 0.85 and the accuracy of its vertices
               inside the room < 0.015 m (the whole mesh's accuracy is
               printed beside the 0.05 m it does not hold);
 10. scale   - configs/synthetic/snake_fast.yaml as a user runs it (600
               frames of the snake across the tiled 11 m room and back,
               localMLP_num 20, the flagship field at full width, seed 0):
               ATE < 0.20 m, at least 4 submaps and 1 switch back, no
               submap past the capacity; the manager's wait-loop counts
               and its stage's p50 / p99 at <= 3 and >= 4 live submaps,
               FPS, stage times, launches, peak memory;
 11. stress  - the JAX package's stress recipe (outback.yaml at full
               budgets on the fast-motion sweep, 120 frames, one 8 m
               submap, sensor noise), seed 0: every lever off, then all
               five on (drift gate 0.03 m, motion prior 1.0, RO escalation
               4 and screen 96 px / keep 512, keyframe strain mask 2.5)
               twice, which must repeat bit for bit; ATE (a seed lottery:
               printed, not held), the gate's armed / fired / rescued
               frames, pose-gate rejections, escalated frames, strained
               keyframes, K1's launches at the screen's two sizes; then
               tests/test_drift_gate.py's injected slips on the card (60 mm
               and 3 degrees + 36 mm): the gate fires and rescues both;
 12. hash    - phase 5's orbit (45 frames, the same budgets) on the
               reference's HashGrid field at base.yaml's width (16 levels
               x 2 features, 2^19 rows, base 16 to 256; plain torch, as in
               the JAX package, which has no kernel for it): the hash
               backward at BA's 195,000 points the same bits twice; ATE <
               0.02 m, 1 submap, K0-K4 launched 0 times, the same poses
               and field over the whole run twice; its mesh at 3 cm with
               the accuracy of its vertices inside the room < 0.015 m, the
               same after a checkpoint and resume; FPS, stage ms, peak
               memory;
 13. consistency - the flagship outback (phase 6's config, 200 frames,
               the first seed of phase 6 that closed a loop) with
               mapping.global_BA.sdf_consistency: at least one PGO
               followed by a consistency stage with an overlapping pair,
               anchor 0 unchanged and a free anchor moved in every stage,
               ATE < 0.03 m; inside the stages K1, K2 (never with weight
               gradients) and K4 launch, K3 never; then K1 with the embed,
               K2 without weight gradients and K4 with d_x_pe at the
               stage's per-submap point counts against their plain
               versions (labels "consistency:");
 14. sharded - the multi-device path on every card, or with one card on
               the virtual mesh ["cuda:0", "cuda:0"] (printed as such;
               phases 5-13 run on one card, the system's default mesh):
               phase 5's orbit with parallel.dp_hot_path (RO, GO, BA and
               the first fit split over the mesh), twice, the same bits,
               its ATE within 0.005 m of phase 5's; phase 6's outback
               with both parallel switches on (every inactive submap
               refined in one step) at phase 6's first loop-closing
               seed: ATE < 0.03 m and within 0.02 m of phase 6's run of
               that seed, 2+ submaps, a sharded refine, a switch back,
               K1-K4 launched on every mesh device (per-device counts)
               and K0 never; track, BA and refine stage ms and FPS at 1
               shard and on the mesh. A run without a switch back must
               have parted from phase 6's decisions at a keyframe where
               the two runs' boxes and counted points (their median)
               lie closer than 0.02 m and, in both runs, moving the
               box's faces by that distance carries the containment
               ratio across its threshold (both runs' predicates printed
               at every keyframe up to it); the next closing seed is
               then held to every check;
 15. files   - the file readers: the committed JPEG and PNG fixtures
               (tests/data/{jpeg,png}) decode with csrc/image.cpp, built
               here with the host c++, to the SHA-256 recorded beside
               them; the flagship outback (200 frames, seed 0) rendered at
               configs/FastCaMo-large/fastcamo_large.yaml's camera (680 x
               1200, fx 600) and written as a FastCaMo tree (8-bit RGB
               and 16-bit depth PNGs, pose txt), then run as that config
               (the fcl field: [32, 64, 128] + CP 384 x 40, localMLP_num
               20, FastCaMo's budgets) through load_config, get_dataset
               and MIPSFusionTorch.run with only data.datadir and the
               outback's mapping bounds set: every packed frame equal to
               the written one bit for bit, K1-K4 at the fcl shape and K0
               never, ATE < 0.05 m; submaps, switch frames, FPS, stage
               ms, the decode ms a frame against the track ms; the joint
               mesh at mesh.voxel_final scored against the analytic SDF
               (printed, not held).
 16. programs - the stage programs (slam/programs.py: local BA, refine,
               track, the first fit's chunk as CUDA graphs, which phases
               5-15 ran through, printing per run the graphs, calls,
               replays, capture seconds and graph memory): on phase 5's
               orbit and phase 6's outback at seed 0, after their runs,
               each program's replay against the stage function called
               eagerly on copies of the same inputs from identically
               seeded generators, the same bits, three times; the stage
               ms of both ways (device, between CUDA events, and host);
               the graphs, their capture seconds and memory, the peak
               memory; the copies that pass a submap's parameters and
               moments to the BA program against one graph per submap.
The kernels' JSON line comes second to last; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --outback-seeds 0,1,2,0 [--outback-spawn 50]

runs phases 1, 2 and then only phase 6, once per seed (repeatability),
with the manager's predicates, the loop closures and the pose errors
printed at every keyframe; --outback-spawn pins the run to the branch
that opens its second submap at that keyframe.

    python3 chip_smoke.py --kernels-only

runs phases 1-4 alone (about a minute and a half).

    python3 chip_smoke.py --scale-only [--scale-trace]
    python3 chip_smoke.py --stress-only

run phases 1-2 and then phase 10 (with --scale-trace the manager's
predicates and pose errors at every keyframe) or phase 11 alone.

    python3 chip_smoke.py --hash-only
    python3 chip_smoke.py --consistency-only

run phases 1-2 and then phase 12, or phase 13 at seed 0 with its kernel
labels, alone.

    python3 chip_smoke.py --files-only

runs phases 1-2 and then phase 15 alone.

    python3 chip_smoke.py --programs-only

runs phases 1-2, the orbit and the outback at seed 0, and phase 16.

    python3 chip_smoke.py --sharded-only

runs phases 1-2 and then phase 14, with the unsharded orbit and outbacks
it is held against (phase 6's seeds in order, to its first closing one).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
    build_s = time.time() - t0
    print(f"build: {path} in {build_s:.1f} s")
    if not check_hmma:
        return build_s
    hmma = sass_hmma(path)
    if hmma is None:
        print("sass: cuobjdump not found, HMMA count not taken")
        return build_s
    # per shape of the table: K2's two instances, K1's three
    n_shapes = len(_build.SHAPES)
    for what, key, n_min in (("K2", "decoder_bwd", 2 * n_shapes),
                             ("K1", "field_forward_kernel", 3 * n_shapes)):
        found = {k: v for k, v in hmma.items() if key in k}
        print(f"sass HMMA instructions per {what} kernel: "
              + json.dumps(found))
        if len(found) < n_min or not all(v > 0 for v in found.values()):
            _fail(f"{what} kernels without tensor-core instructions: "
                  f"{found}")
    return build_s


def _time_ms(fn, reps: int = 10, groups: int = 3) -> float:
    """Device time of one call in ms: the median over ``groups`` of the
    time of ``reps`` calls in a row between two CUDA events, over ``reps``.
    A spin kernel goes first, so that the host has enqueued the calls
    before the device starts on them: the time is the device's, without
    the wrapper's host time (tens of microseconds, more than the smaller
    kernels take)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


# the spin before a timed group: ~3 ms at the card's clock, longer than the
# host takes to enqueue ten calls of a wrapper
SPIN_CYCLES = 5_000_000


def _time_idle_ms(fn, reps: int = 10) -> float:
    """Median time of one call launched on an idle device, between two
    CUDA events: the wrapper's host time and the launch are inside it, as
    a host-bound loop pays them."""
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


def field_params(shape_name: str, seed: int, device):
    """Field params (a tree) at a shape of the kernels' table, made from a
    seed, with features brought to O(1) (planes init at 1e-4 would make
    every comparison trivially small)."""
    import torch
    from mipsfusion_tpu_torch.models.scene_rep import FieldConfig, init_field
    from mipsfusion_tpu_torch.config import FLAGSHIP_ORBIT
    from mipsfusion_tpu_torch.ops import _build
    shape = next(s for s in _build.SHAPES.values() if s.name == shape_name)
    cfg = {**FLAGSHIP_ORBIT, "grid": {
        **FLAGSHIP_ORBIT["grid"], "tri_resolutions": list(shape.resolutions),
        "cp_resolution": shape.cp_resolution,
        "cp_components": shape.cp_components}}
    fcfg = FieldConfig.from_dict(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = init_field(fcfg, g, device)
    p["planes"] = {k: v * (1e4 if k.startswith("s") else 4.0)
                   for k, v in p["planes"].items()}
    return p


def flagship_params(seed: int, device):
    """``field_params`` at the flagship's shape."""
    return field_params("flag", seed, device)


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


def mesh_grid_points(device, n: int = 131_072):
    """x [3, n]: the first n points of the mesher's fused-volume grid
    (voxel 0.03 over the outback's observed box, flat index order, as
    ``Mesher.fused_sdf_volume_device`` generates them), carried into the
    frame of a submap anchored 1.2 m along +x and turned 0.2 rad about +y,
    and normalised by the flagship bound, as K1 takes them."""
    import torch
    from mipsfusion_tpu_torch.config import FLAGSHIP_OUTBACK
    bound = np.asarray(FLAGSHIP_OUTBACK["mapping"]["bound"], np.float32)
    lo = np.array([-3.4, -2.6, -2.9], np.float32)
    shape = (226, 174, 194)
    idx = np.arange(n)
    ijk = np.stack([idx // (shape[1] * shape[2]),
                    (idx // shape[2]) % shape[1], idx % shape[2]], -1)
    pts = lo + np.float32(0.03) * ijk.astype(np.float32)
    c, s_ = np.cos(0.2), np.sin(0.2)
    anchor = np.array([[c, 0, s_, 1.2], [0, 1, 0, 0.05], [-s_, 0, c, 0.0],
                       [0, 0, 0, 1]])
    w2l = np.linalg.inv(anchor)
    pl = pts @ w2l[:3, :3].T + w2l[:3, 3]
    x = (pl - bound[:, 0]) / (bound[:, 1] - bound[:, 0])
    return torch.tensor(x.T, dtype=torch.float32, device=device).contiguous()


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
# the kernels' bodies (templates over the field shape); csrc/shape.cu,
# compiled once per shape, instantiates them
SOURCE = {
    "encode_forward": "mipsfusion_tpu_torch/csrc/triplane.cuh",
    "field_forward": "mipsfusion_tpu_torch/csrc/field_forward.cuh",
    "decoder_backward": "mipsfusion_tpu_torch/csrc/field.cuh",
    "plane_backward": "mipsfusion_tpu_torch/csrc/triplane.cuh",
    "x_backward": "mipsfusion_tpu_torch/csrc/triplane.cuh",
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
# FLOPs per point, (decoder matrix products, the rest), at a shape with S
# plane scales, C CP channels and embed E = 4 S + C (flagship: S 2, C 40,
# E 48): encode S x 3 planes x 4 taps x 4 features x 2 plus C x (3 lerps
# x 3 + 2 products) = 632 at the flagship; the decoder forward 6,528 +
# 16,384 + (64 + E) 128 + 640 + 345 MACs (38,233 at the flagship), sdf
# only without the rgb half of trunk1 and the rgb layer (29,696); K2
# forward recompute without the rgb layer (37,888) + data backward (the
# forward's 38,233) + weight gradients (one per parameter, 38,625); K3 ~
# 12 S taps x 5 + C x 21 = 960; K4 ~ 3 S planes x 40 + C x 20 = 1,040.
def _flops_pt(kind: str, shape):
    S, C, E = shape.n_scales, shape.cp_components, shape.embed_dim
    sdf_in = (64 + E) * 128
    full = 6_528 + 16_384 + sdf_in + 640 + 345
    recompute = full - 345
    wgrad = shape.grad_offsets[-1]
    enc = 96 * S + 11 * C
    return {"encode_forward": (0, enc),
            "field_forward": (2 * full, enc),
            "field_forward_noembed": (2 * full, enc),
            "field_forward_sdf": (2 * (6_528 + 8_192 + sdf_in + 640), enc),
            "decoder_backward": (2 * (recompute + full + wgrad), 0),
            "decoder_backward_go": (2 * (recompute + full), 0),
            "plane_backward": (0, 60 * S + 21 * C),
            "x_backward": (0, 120 * S + 20 * C),
            "x_backward_add": (0, 120 * S + 20 * C + 3)}[kind]


# bytes per point (each input read once, each output written once) and
# per call
def _bytes(kind: str, shape):
    E4 = 4 * shape.embed_dim
    table = 4 * (sum(3 * r * r * 4 for r in shape.resolutions)
                 + 3 * shape.cp_resolution * shape.cp_components)
    cp = 4 * 3 * shape.cp_resolution * shape.cp_components
    weights = 4 * shape.grad_offsets[-1]
    return {"encode_forward": (12 + E4, table),
            "field_forward": (12 + 40 + E4, table + weights),
            "field_forward_noembed": (12 + 40, table + weights),
            "field_forward_sdf": (12 + 4, table + weights),
            "decoder_backward": (12 + 40 + E4 + 12 + E4, 2 * weights),
            "decoder_backward_go": (12 + 40 + E4 + 12 + E4, weights),
            "plane_backward": (12 + E4, table + cp),
            "x_backward": (12 + E4 + 12, table),
            "x_backward_add": (12 + E4 + 12 + 12, table)}[kind]


def bound(kind: str, n: int, shape=None):
    """(bound ms, "bytes" or "operations") of one call on n points at a
    table shape (the flagship's by default)."""
    if shape is None:
        from mipsfusion_tpu_torch.ops import _build
        shape = _build.SHAPES[((32, 64), 4, 384, 40)]
    mm, rest = _flops_pt(kind, shape)
    flop_ms = (mm / PEAK_MM_F32 + rest / PEAK_F32) * n * 1e3
    per_pt, fixed = _bytes(kind, shape)
    byte_ms = (per_pt * n + fixed) / PEAK_BYTES * 1e3
    return (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms,
                                                                "bytes")


# The shapes of the kernel phase: every entry of the kernels' table, with
# the point counts its loop gives the kernels. The flagship's and the
# FastCaMo-large family's (which inherits base.yaml's budgets): BA 2600
# rays x 75 samples = 195,000, GO 1000 x 75, the first fit and refine
# 1800 x 75 = 135,000, RO 2000 particles x 384 px = 768,000 a call. The
# CP profile's (orbit_fast_cp.yaml inherits orbit_fast.yaml's budgets and
# its z-ladder of 24 + 15 = 39 samples): BA (1024 + 400) x 39 = 55,536,
# GO 512 x 39 = 19,968, the first fit 1024 x 39 = 39,936, RO 1024
# particles x 12 x 16 px = 196,608 a call (786,432 over a frame's four).
# The scale profile (snake_fast.yaml) runs the flagship's field with the
# fast budgets and the same z-ladder of 39 samples: BA 55,536, GO 512 x 39,
# the first fit, its chunks, refine and switch BA 1024 x 39, RO 196,608 a
# call; the stress run's screen (flagship budgets) scores 2000 particles on
# 96 px (192,000) and the 512 it keeps on 384 px (196,608).
KERNEL_SHAPES = {
    "flag": {"ba": 195_000, "ba_rays": (2600, 75), "go_rays": (1000, 75),
             "fit": 135_000, "ro": 768_000},
    "snake": {"shape": "flag", "ba": 55_536, "ba_rays": (1424, 39),
              "go_rays": (512, 39), "fit": 39_936, "ro": 196_608,
              "ro_screen": 192_000},
    "cp": {"ba": 55_536, "ba_rays": (1424, 39), "go_rays": (512, 39),
           "fit": 39_936, "ro": 196_608, "ro_frame": 786_432},
    "fcl": {"ba": 195_000, "ba_rays": (2600, 75), "go_rays": (1000, 75),
            "fit": 135_000, "ro": 768_000},
}


def phase_kernels():
    """Every kernel against its plain version at every shape of the table
    (``kernel_shape_phase``), then the flagship's digests; returns the
    kernels' rows for the JSON line."""
    import torch
    rows = {}
    for name in KERNEL_SHAPES:
        kernel_shape_phase(name, rows)
    kernel_digests()
    torch.cuda.synchronize()
    return rows


def kernel_shape_phase(shape_name: str, rows: dict):
    """K0-K4 against their plain versions at one shape of the table, at
    that shape's loop sizes (KERNEL_SHAPES), each label's times beside its
    bound recorded in ``rows``. Labels at the flagship are as they were
    before other shapes existed; other shapes' carry the shape's name
    ("cp:field_forward")."""
    import torch
    from mipsfusion_tpu_torch.ops import _build
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    dev = torch.device("cuda")
    sz = KERNEL_SHAPES[shape_name]
    p = field_params(sz.get("shape", shape_name), 0, dev)
    planes, dec = p["planes"], p["decoder"]
    ns = len([k for k in planes if k.startswith("s")])
    shape = _build.kernel_shape(planes, ns)
    E = shape.embed_dim
    meta = (ns, 8, 5)
    pre = "" if shape_name == "flag" else f"{shape_name}:"
    print(f"kernel phase at shape {shape_name}: Triplane "
          f"{list(shape.resolutions)} x F4 + CP {shape.cp_resolution} x "
          f"{shape.cp_components}, embed {E}")

    def record(name, label, errs, fn, plain_ms, n, kind=None):
        record_label(rows, name, pre + label, errs, fn, plain_ms, n,
                     kind or name, shape)

    # K0, row layout [N, 3] -> [N, E]: at the BA shape on uniform points
    # and on the BA's ray-ordered points, where it must give the bits of
    # K1's embed (the same lookups: K0 is the oracle of K1's encode stage),
    # and on 786,432 uniform points (once per field shape), where the
    # launch's tail no longer hides the bound; each twice for the same bits
    x = test_points(sz["ba"], 1, dev)
    k0_labels = [("encode_forward", x),
                 ("encode_forward@rays", ray_points(*sz["ba_rays"], 8, dev))]
    if "shape" not in sz:
        k0_labels.append(("encode_forward@786k", test_points(786_432, 14,
                                                             dev)))
    for label, xx in k0_labels:
        xr0 = xx.T.contiguous()
        out = tc.encode_forward(xr0, planes, ns)
        ref = tc.encode_forward_plain(planes, xr0, ns)
        same(pre + label, out, tc.encode_forward(xr0, planes, ns))
        if label != "encode_forward@786k":
            emb = fc.field_forward(xx, planes, dec, *meta,
                                   return_embed=True)[1]
            if not torch.equal(out, emb.T):
                _fail(f"{pre}{label}: K0's encode and K1's embed differ in "
                      f"{int((out != emb.T).sum())} of {out.numel()} values")
            print(f"{pre + label:24s} K0 == K1's embed bit for bit")
        record("encode_forward", label, {"embed": _err(out, ref)},
               lambda: tc.encode_forward(xr0, planes, ns),
               _time_ms(lambda: tc.encode_forward_plain(planes, xr0, ns)),
               xx.shape[1])
    del k0_labels, xr0, out, ref, emb
    # K0 at point counts that are no multiple of its tile
    for n in (195_001, 63):
        xn = test_points(n, 12, dev).T.contiguous()
        e = _err(tc.encode_forward(xn, planes, ns),
                 tc.encode_forward_plain(planes, xn, ns))[1]
        print(f"{pre}encode_forward N={n}: max_rel={e:.3e}")
        if not e <= TOL["encode_forward"]:
            _fail(f"{pre}encode_forward at N={n}: relative error {e:.3e}")

    def k1(xx, **mode):
        return fc.field_forward(xx, planes, dec, *meta, **mode)

    def k1_plain(xx, **mode):
        return fc.field_forward_plain(xx, planes, dec, *meta, **mode)

    def k1_errs(xx, **mode):
        got, want = k1(xx, **mode), k1_plain(xx, **mode)
        torch.cuda.synchronize()
        if mode.get("return_embed"):
            return {"out": _err(got[0], want[0]),
                    "embed": _err(got[1], want[1])}
        return {"sdf" if mode.get("sdf_only") else "out": _err(got, want)}

    # K1's packed weights: the kernel's packer against the plain one
    if not torch.equal(fc.pack_decoder_weights(dec, shape),
                       fc.pack_decoder_weights_plain(dec, shape)):
        _fail(f"{pre}K1: the kernel's packed weights differ from the plain "
              "packer's")
    # K1 full with return_embed at the BA shape, at the GO shape on
    # ray-ordered points and at the shape of refine and the fits
    xgo = ray_points(*sz["go_rays"], 9, dev)
    xfit = test_points(sz["fit"], 10, dev)
    for label, xx in (("field_forward", x), ("field_forward_go@rays", xgo),
                      (f"field_forward@{round(sz['fit'] / 1000)}k", xfit)):
        record("field_forward", label, k1_errs(xx, return_embed=True),
               lambda: k1(xx, return_embed=True),
               _time_ms(lambda: k1_plain(xx, return_embed=True)),
               xx.shape[1], kind="field_forward")
    # K1 sdf_only at the RO shape (a call; and a frame's four at once)
    ro = [("field_forward_sdf", sz["ro"])]
    if "ro_frame" in sz:
        ro.append(("field_forward_sdf@frame", sz["ro_frame"]))
    if "ro_screen" in sz:
        ro.append(("field_forward_sdf@screen", sz["ro_screen"]))
    for label, n in ro:
        xr = test_points(n, 2, dev)
        record("field_forward", label, k1_errs(xr, sdf_only=True),
               lambda: k1(xr, sdf_only=True),
               _time_ms(lambda: k1_plain(xr, sdf_only=True), reps=3,
                        groups=1),
               xr.shape[1], kind="field_forward_sdf")
    # K1 full without the embed (the third instance), then each mode at
    # point counts that are no multiple of the 16-point tile, and twice
    # for the same bits
    record("field_forward", "field_forward_noembed", k1_errs(x),
           lambda: k1(x), _time_ms(lambda: k1_plain(x)),
           x.shape[1], kind="field_forward_noembed")
    # K1 as the mesher calls it: one chunk of 131,072 grid points of the
    # fused volume in a submap's local frame, full outputs, no embed
    xm = mesh_grid_points(dev)
    record("field_forward", "field_forward_mesh", k1_errs(xm),
           lambda: k1(xm), _time_ms(lambda: k1_plain(xm)),
           xm.shape[1], kind="field_forward_noembed")
    del xm
    for n in (195_001, 63):
        xn = test_points(n, 12, dev)
        for mode in ({"return_embed": True}, {}, {"sdf_only": True}):
            errs = k1_errs(xn, **mode)
            part, (_, worst) = max(errs.items(), key=lambda kv: kv[1][1])
            print(f"{pre}field_forward N={n} {mode}: max_rel={worst:.3e} "
                  f"({part})")
            if not worst <= TOL["field_forward"]:
                _fail(f"{pre}field_forward at N={n} {mode}: {errs}")
    for mode in ({"return_embed": True}, {}, {"sdf_only": True}):
        same(f"{pre}field_forward {'/'.join(mode) or 'full'}",
             k1(xgo, **mode), k1(xgo, **mode))
    del xr, xfit, xn

    # K2-K4 at the BA shape with a random cotangent: uniform points, then
    # ray-ordered points
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    xrays = ray_points(*sz["ba_rays"], 8, dev)
    for suffix, xx in (("", x), ("@rays", xrays)):
        n = xx.shape[1]
        emb = fc.field_forward(xx, planes, dec, *meta, return_embed=True)[1]
        g = torch.randn((10, n), generator=gen, device=dev) * 0.1
        g, frac = kink_free(g, xx, emb, dec)
        print(f"{pre}decoder_backward{suffix}: cotangent zeroed at "
              f"{frac:.4%} of points (ReLU pre-activation within 1e-4 of 0)")
        d_embed = torch.randn((E, n), generator=gen, device=dev) * 0.1
        r2 = fc.decoder_backward_plain(xx, g, emb, dec, 8, 5)
        plain2 = _time_ms(lambda: fc.decoder_backward_plain(xx, g, emb, dec,
                                                            8, 5))
        k2 = fc.decoder_backward(xx, g, emb, dec, 8, 5)
        errs = {"d_x": _err(k2[0], r2[0]), "d_embed": _err(k2[1], r2[1])}
        for name in k2[2]:
            for w in ("w", "b"):
                errs[f"{name}.{w}"] = _err(k2[2][name][w], r2[2][name][w])
        record("decoder_backward", f"decoder_backward{suffix}", errs,
               lambda: fc.decoder_backward(xx, g, emb, dec, 8, 5),
               plain2, n, kind="decoder_backward")
        k3 = tc.plane_backward(xx, d_embed, planes, ns)
        r3 = tc.plane_backward_plain(xx, d_embed, planes, ns)
        # K2 and K3 give the same bits in every call (fixed-order partial
        # sums; fixed-point integer atomics)
        same(f"{pre}decoder_backward{suffix}", k2,
             fc.decoder_backward(xx, g, emb, dec, 8, 5))
        same(f"{pre}plane_backward{suffix}", k3,
             tc.plane_backward(xx, d_embed, planes, ns))
        record("plane_backward", f"plane_backward{suffix}",
               {k: _err(k3[k], r3[k]) for k in r3},
               lambda: tc.plane_backward(xx, d_embed, planes, ns),
               _time_ms(lambda: tc.plane_backward_plain(xx, d_embed, planes,
                                                        ns)),
               n, kind="plane_backward")
        k4 = tc.x_backward(xx, d_embed, planes, ns)
        r4 = tc.x_backward_plain(xx, d_embed, planes, ns)
        record("x_backward", f"x_backward{suffix}", {"d_x": _err(k4, r4)},
               lambda: tc.x_backward(xx, d_embed, planes, ns),
               _time_ms(lambda: tc.x_backward_plain(xx, d_embed, planes,
                                                    ns)),
               n, kind="x_backward")
        # K4 with the PE's share of d_x added (K2's d_x), as FieldQueryT
        # calls it, and twice for the same bits
        k4a = tc.x_backward(xx, d_embed, planes, ns, d_x_pe=k2[0])
        record("x_backward", f"x_backward_add{suffix}",
               {"d_x": _err(k4a, k2[0] + r4)},
               lambda: tc.x_backward(xx, d_embed, planes, ns, d_x_pe=k2[0]),
               _time_ms(lambda: k2[0] + tc.x_backward_plain(
                   xx, d_embed, planes, ns)),
               n, kind="x_backward_add")
        same(f"{pre}x_backward{suffix}", (k4, k4a),
             (tc.x_backward(xx, d_embed, planes, ns),
              tc.x_backward(xx, d_embed, planes, ns, d_x_pe=k2[0])))
        del emb, g, d_embed, r2, r3, k2, k3, k4, r4, k4a

    # K2, K3 and K4 at point counts that are no multiple of a tile or block
    for n in (195_001, 63):
        xn = test_points(n, 13, dev)
        emb = fc.field_forward(xn, planes, dec, *meta, return_embed=True)[1]
        g, _ = kink_free(torch.randn((10, n), generator=gen, device=dev)
                         * 0.1, xn, emb, dec)
        d_embed = torch.randn((E, n), generator=gen, device=dev) * 0.1
        add = torch.randn((3, n), generator=gen, device=dev)
        k2, r2 = (fc.decoder_backward(xn, g, emb, dec, 8, 5),
                  fc.decoder_backward_plain(xn, g, emb, dec, 8, 5))
        k3, r3 = (tc.plane_backward(xn, d_embed, planes, ns),
                  tc.plane_backward_plain(xn, d_embed, planes, ns))
        errs = {"K2": max(_err(a, b)[1] for a, b in zip(_flat(k2),
                                                         _flat(r2))),
                "K3": max(_err(k3[k], r3[k])[1] for k in r3),
                "K4": max(_err(tc.x_backward(xn, d_embed, planes, ns),
                               tc.x_backward_plain(xn, d_embed, planes,
                                                   ns))[1],
                          _err(tc.x_backward(xn, d_embed, planes, ns,
                                             d_x_pe=add),
                               tc.x_backward_plain(xn, d_embed, planes, ns,
                                                   d_x_pe=add))[1])}
        print(f"{pre}K2/K3/K4 N={n}: max_rel "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
        for k, name in (("K2", "decoder_backward"), ("K3", "plane_backward"),
                        ("K4", "x_backward")):
            if not errs[k] <= TOL[name]:
                _fail(f"{pre}{name} at N={n}: relative error {errs[k]:.3e}")

    # K2 without weight gradients (GO: pose gradients only) at the GO shape
    emb = fc.field_forward(xgo, planes, dec, *meta, return_embed=True)[1]
    g = torch.randn((10, xgo.shape[1]), generator=gen, device=dev) * 0.1
    g, _ = kink_free(g, xgo, emb, dec)
    k2 = fc.decoder_backward(xgo, g, emb, dec, 8, 5, weight_grads=False)
    r2 = fc.decoder_backward_plain(xgo, g, emb, dec, 8, 5,
                                   weight_grads=False)
    record("decoder_backward", "decoder_backward_go@rays",
           {"d_x": _err(k2[0], r2[0]), "d_embed": _err(k2[1], r2[1])},
           lambda: fc.decoder_backward(xgo, g, emb, dec, 8, 5,
                                       weight_grads=False),
           _time_ms(lambda: fc.decoder_backward_plain(
               xgo, g, emb, dec, 8, 5, weight_grads=False)),
           xgo.shape[1], kind="decoder_backward_go")
    same(f"{pre}decoder_backward_go@rays", k2[:2],
         fc.decoder_backward(xgo, g, emb, dec, 8, 5, weight_grads=False)[:2])
    torch.cuda.synchronize()


def kernel_digests():
    """Print a SHA-256 of K2's and K3's outputs at the flagship's BA shape
    (uniform and ray-ordered points) and of K2's without weight gradients
    at the GO shape, then of K1's (full, with the embed), K4's and K0's on
    the same inputs. The embed comes from the plain forward and the
    cotangents from a seeded generator, so no other kernel shapes the
    inputs: two trees of the port whose kernels are the same print the
    same digests."""
    import hashlib
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    dev = torch.device("cuda")
    p = flagship_params(0, dev)
    planes, dec = p["planes"], p["decoder"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def sha(t):
        h = hashlib.sha256()
        for u in _flat(t):
            h.update(u.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    for label, xx in (("uniform", test_points(195_000, 1, dev)),
                      ("rays", ray_points(2600, 75, 8, dev)),
                      ("go", ray_points(1000, 75, 9, dev))):
        n = xx.shape[1]
        emb = fc.field_forward_plain(xx, planes, dec, 2, 8, 5,
                                     return_embed=True)[1].contiguous()
        g = torch.randn((10, n), generator=gen, device=dev) * 0.1
        d_embed = torch.randn((48, n), generator=gen, device=dev) * 0.1
        k2 = fc.decoder_backward(xx, g, emb, dec, 8, 5,
                                 weight_grads=label != "go")
        k3 = tc.plane_backward(xx, d_embed, planes, 2)
        k1 = fc.field_forward(xx, planes, dec, 2, 8, 5, return_embed=True)
        k4 = tc.x_backward(xx, d_embed, planes, 2)
        k0 = tc.encode_forward(xx.T.contiguous(), planes, 2)
        print(f"digest {label}: inputs {sha((xx, emb, g, d_embed))} "
              f"decoder_backward {sha([t for t in k2 if t is not None])} "
              f"plane_backward {sha(k3)} field_forward {sha(k1)} "
              f"x_backward {sha(k4)} encode_forward {sha(k0)}")


def phase_autograd():
    """At every shape of the table: FieldQueryT gradients (kernels) vs the
    same Function on the plain path, on interior points (where the
    composite autodiff path and the kernels' coordinate gradient agree),
    and TriplaneEncode's."""
    for name, sz in KERNEL_SHAPES.items():
        if "shape" not in sz:          # once per field shape
            autograd_shape(name)


def autograd_shape(shape_name: str):
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    dev = torch.device("cuda")
    p = field_params(shape_name, 5, dev)
    ns = len([k for k in p["planes"] if k.startswith("s")])
    pre = "" if shape_name == "flag" else f" {shape_name}"
    x = test_points(60_000, 6, dev, inside_only=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    G = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    G, _ = kink_free(G, x, fc.field_forward(
        x, p["planes"], p["decoder"], ns, 8, 5, return_embed=True)[1],
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
                xx, leaves["planes"], leaves["decoder"], ns, 8, 5)
        else:
            out = fc.field_query_T(leaves, xx, ns, 8, 5)
        (out * G).sum().backward()
        flat = [t.grad for t in leaves["planes"].values()]
        flat += [t.grad for d in leaves["decoder"].values()
                 for t in d.values()]
        return flat, xx.grad

    gk, xk = grads(False)
    gp, xp = grads(True)
    worst = max(_err(a, b)[1] for a, b in zip(gk, gp))
    wx = _err(xk, xp)[1]
    print(f"autograd{pre}: params max_rel={worst:.3e} x max_rel={wx:.3e} "
          f"tol_rel=1e-4")
    if not (worst <= 1e-4 and wx <= 1e-4):
        _fail(f"FieldQueryT gradients disagree with the plain path{pre}")

    # TriplaneEncode (K0 forward, K3 + K4 backward) against autograd of
    # the plain composite encode
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    xe = x.T.contiguous()
    E = 4 * ns + p["planes"]["cp"].shape[-1]
    Ge = torch.randn((xe.shape[0], E), generator=gen, device=dev) * 0.1

    def enc_grads(run_plain: bool):
        planes = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p["planes"].items()}
        xx = xe.clone().requires_grad_(True)
        fn = tc.encode_forward_plain if run_plain else tc.triplane_encode
        (fn(planes, xx, ns) * Ge).sum().backward()
        return [planes[k].grad for k in sorted(planes)], xx.grad

    gk, xk = enc_grads(False)
    gp, xp = enc_grads(True)
    worst = max(_err(a, b)[1] for a, b in zip(gk, gp))
    wx = _err(xk, xp)[1]
    print(f"autograd TriplaneEncode{pre}: planes max_rel={worst:.3e} "
          f"x max_rel={wx:.3e} tol_rel=1e-4")
    if not (worst <= 1e-4 and wx <= 1e-4):
        _fail(f"TriplaneEncode gradients disagree with the plain path{pre}")


# the kernels every SLAM path launches (K0 has no caller on the SLAM path,
# as triplane_encode_pallas has none in the JAX package)
SLAM_KERNELS = ("field_forward", "decoder_backward", "plane_backward",
                "x_backward")


def _run_path(slam):
    """Drive the port's entry point with every launch count set to 0 just
    before and read just after; returns (results, counts, wall s). The
    per-device counts of the run stay in fc.launch_counts(by_device=True)
    until the next reset."""
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    print(f"mesh: {slam.mesh}  dp_hot_path {slam.use_dp_hot}  "
          f"sharded_refine {slam.use_sharded_refine}")
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
    print("programs (per stage: graphs, calls, replays, capture s, graph "
          "bytes): " + json.dumps(slam.programs.stats()))
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
    RUNS["orbit"] = {"ate": ate, "fps": res["fps"],
                     "stage_ms": slam.stage_ms()}
    SYSTEMS["orbit"] = (slam, ds)
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
                  trace: bool = False, mesh: bool = False):
    """The slice's main path: the default multi-submap loop on the
    flagship out-and-back scene at full budgets (``seed``: the system's
    random draws and initial field; ``trace``/``spawn``: see
    ``trace_outback``). With ``mesh``, a run that closes a loop is also
    meshed (``phase_mesh``); the third value returned is then the
    mesher's launch counts, else None. The manager's predicates and
    decision at every keyframe go into ``RUNS`` (``record_decisions``)."""
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
    decisions = record_decisions(slam)
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
    if seed == 0:
        print(f"outback seed 0 launches {counts}, before the stage "
              f"programs' map optimizer "
              f"{PARENT_OUTBACK_LAUNCHES}: equal "
              f"{all(counts[k] == v for k, v in PARENT_OUTBACK_LAUNCHES.items())}")
        SYSTEMS["outback"] = (slam, ds)
    print("outback stage ms (CUDA events, mean per call): "
          + json.dumps({k: round(v, 3) for k, v in slam.stage_ms().items()}))
    RUNS[("outback", seed)] = {"ate": ate, "fps": res["fps"],
                               "stage_ms": slam.stage_ms(),
                               "switches": list(slam.switch_events),
                               "decisions": decisions}
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
    RUNS[("outback", seed)]["closed"] = closed
    mesh_counts = None
    if closed:
        switch_ba_alone(slam, ds)
        if mesh:
            mesh_counts = phase_mesh(slam, cfg, ds)
    return counts, closed, mesh_counts


def phase_mesh(slam, cfg, ds):
    """The joint mesh of the main path's run: K1 on the card and no
    backward kernel, a finite non-empty mesh within the accuracy and
    completion limits, and the same mesh again from a checkpoint through
    a fresh system's resume_from. Returns the mesher's launch counts."""
    used = int(slam.state.localMLP_info[:, 0].sum().item())
    voxel = cfg["mesh"]["voxel_final"]
    if used < 2:
        _fail(f"mesh: {used} submap(s), the joint path needs 2")
    counts, _, m = _mesh_and_resume(slam, cfg, ds, voxel, "mesh")
    if counts["field_forward"] <= 0 or any(
            counts[k] for k in ("decoder_backward", "plane_backward",
                                "x_backward", "encode_forward")):
        _fail(f"mesh launches {counts}: want K1 and no other kernel")
    if not m["mesh_accuracy_m"] < 0.05:
        _fail(f"mesh accuracy {m['mesh_accuracy_m']:.4f} m >= 0.05 m")
    if not m["mesh_completion@5cm"] > 0.85:
        _fail(f"mesh completion@5cm {m['mesh_completion@5cm']:.4f} <= 0.85")
    return counts


def phase_cli(n_frames: int = 30, ckpt_at: int = 15):
    """The CLI on the flagship orbit (30 frames at full budgets, a
    checkpoint at frame 15) in a subprocess, then resumed from that
    checkpoint: both exit 0, print an ATE under 0.02 m and leave their
    files."""
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="mf_cli_")
    try:
        out = os.path.join(tmp, "out")
        yaml = os.path.join(tmp, "orbit_cli.yaml")
        with open(yaml, "w") as f:
            f.write(f'inherit_from: "{root}/configs/synthetic/orbit.yaml"\n'
                    f'data:\n  output: "{out}"\n  exp_name: "cli"\n'
                    f"mesh:\n  ckpt_freq: {ckpt_at}\n")
        exp = os.path.join(out, "cli")
        for label, extra in (("run", []), ("resume", [
                "--resume", os.path.join(exp, f"ckpt_{ckpt_at}")])):
            if label == "resume":
                # the resumed run must write the end's outputs again
                shutil.rmtree(os.path.join(exp, "ckpt_final"))
                for w in ("mesh_final.ply", f"traj_{n_frames - 1}.txt",
                          "ate_final.txt"):
                    os.remove(os.path.join(exp, w))
            t0 = time.time()
            res = subprocess.run(
                [sys.executable, "-m", "mipsfusion_tpu_torch", "--config",
                 yaml, "--n_frames", str(n_frames)] + extra,
                cwd=root, capture_output=True, text=True, timeout=600)
            wall = time.time() - t0
            tail = res.stdout.strip().splitlines()[-2:]
            print(f"cli {label}: rc {res.returncode}  wall {wall:.1f} s  "
                  + " / ".join(tail))
            if res.returncode != 0:
                _fail(f"cli {label} exited {res.returncode}:\n"
                      f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            m = re.search(r"^ATE RMSE: ([0-9.]+) m \| ([0-9.]+) FPS$",
                          res.stdout, re.M)
            if m is None:
                _fail(f"cli {label}: no ATE line in its output")
            if not float(m.group(1)) < 0.02:
                _fail(f"cli {label}: ATE {m.group(1)} m >= 0.02 m")
            want = [f"ckpt_{ckpt_at}", "ckpt_final", "mesh_final.ply",
                    f"traj_{n_frames - 1}.txt", "render_00000.png",
                    "ate_final.txt"]
            missing = [w for w in want
                       if not os.path.exists(os.path.join(exp, w))]
            if missing:
                _fail(f"cli {label}: missing outputs {missing}")
            for w in ("ckpt.npz", "model_0.npz", "opt_state.npz"):
                if not os.path.exists(os.path.join(exp, "ckpt_final", w)):
                    _fail(f"cli {label}: ckpt_final lacks {w}")
        cli_eval_ate(yaml, exp, n_frames, root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_eval_ate(yaml: str, exp: str, n_frames: int, root: str):
    """The port's eval_ate tool on the CLI's trajectory file and the
    scene's ground truth (written as TUM from the config's dataset): it
    must print the ATE the CLI wrote to ate_final.txt, within 1e-6 m."""
    import torch
    from mipsfusion_tpu_torch.config import load_config
    from mipsfusion_tpu_torch.datasets.dataset import get_dataset
    from mipsfusion_tpu_torch.eval.ate import save_traj_tum
    ds = get_dataset(load_config(yaml), torch.device("cuda"))
    gt = os.path.join(exp, "gt_tum.txt")
    save_traj_tum(np.stack([ds.gt_pose(i) for i in range(n_frames)]), gt)
    est = os.path.join(exp, f"traj_{n_frames - 1}.txt")
    res = subprocess.run(
        [sys.executable, "-m", "mipsfusion_tpu_torch.tools.eval_ate", gt,
         est], cwd=root, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        _fail(f"eval_ate exited {res.returncode}: {res.stderr[-2000:]}")
    key = "absolute_translational_error.rmse"
    printed = float(re.search(rf"^{re.escape(key)}: (\S+)$", res.stdout,
                              re.M).group(1))
    with open(os.path.join(exp, "ate_final.txt")) as f:
        cli = float(re.search(rf"^{re.escape(key)}: (\S+)$", f.read(),
                              re.M).group(1))
    print(f"tools: eval_ate on the CLI's traj_{n_frames - 1}.txt: ATE "
          f"{printed:.9f} m, the CLI's {cli:.9f} m (|diff| "
          f"{abs(printed - cli):.2e})")
    if not abs(printed - cli) <= 1e-6:
        _fail(f"eval_ate printed {printed} m, the CLI {cli} m")


# The CP profile's joint mesh: what it must hold. Its vertices inside the
# room measured 11.21 mm (the flagship shape's on orbit_fast.yaml 6.91),
# NVIDIA H100 80GB HBM3 at 700 W; the whole mesh's accuracy (76 mm) is set
# by shells behind the walls and misses the 0.05 m of the outback's mesh.
CP_INSIDE_ACCURACY = 0.015
CP_MESH_COMPLETION = 0.85


def phase_cp_profile():
    """The CP-accelerated fast profile as a user runs it: the port's
    load_config on configs/synthetic/orbit_fast_cp.yaml (orbit_fast.yaml's
    budgets: RO 4 x 1024 particles x 12 x 16 px, GO 8 x 512 rays x 39
    samples, BA 15 x (1024 + 400) rays x 39, first fit 500 iterations; the
    manager as the config leaves it) and MIPSFusionTorch(cfg, dataset=
    SyntheticDataset(cfg)).run() on the card, all 200 frames at span 1.0,
    with K1-K4 at the shape [32, 64, 128] x F4 + CP 512 x 32; then the
    joint mesh at mesh.voxel_final, scored against the scene's analytic
    SDF. Fails unless the ATE is under the orbit's 0.02 m, the mesh's
    completion@5cm over CP_MESH_COMPLETION and the accuracy of its
    vertices inside the room under CP_INSIDE_ACCURACY. The whole mesh's
    accuracy is printed beside the 0.05 m it misses: shells the fields
    leave 0.2-0.4 m behind the walls, inside the keyframes' frustums, pass
    the mesher's filters (ROADMAP C). Returns the run's and the mesher's
    launch counts."""
    import torch
    from mipsfusion_tpu_torch.config import load_config
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.eval.recon import (evaluate_synthetic_mesh,
                                                 mesh_error_split)
    from mipsfusion_tpu_torch.ops import _build
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    cwd = os.getcwd()
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    try:                                     # inherit_from: from the root
        cfg = load_config("configs/synthetic/orbit_fast_cp.yaml")
    finally:
        os.chdir(cwd)
    cfg["data"]["output"] = None
    slam = MIPSFusionTorch(cfg, dataset=SyntheticDataset(
        cfg, n_frames=200, span=1.0))
    shape = _build.kernel_shape(slam.field.params(detach=True)["planes"],
                                slam.fcfg.n_scales)
    if shape.name != "cp":
        _fail(f"cp profile: the field's shape is {shape.name}, not cp")
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = _run_path(slam)
    ate = res["absolute_translational_error.rmse"]
    print(f"cp profile: 200 frames  shape {shape.name} (embed "
          f"{shape.embed_dim})  ATE RMSE {ate * 1000:.2f} mm  tracked FPS "
          f"{res['fps']:.2f}  wall {wall:.1f} s  submaps {res['n_submaps']}"
          f"  peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"cp profile launches {counts}  stage calls "
          f"{dict(slam.stage_calls)}")
    print("cp profile stage ms (CUDA events, mean per call): " + json.dumps(
        {k: round(v, 3) for k, v in slam.stage_ms().items()}))
    if not ate < 0.02:
        _fail(f"cp profile ATE {ate:.4f} m >= 0.02 m")
    voxel = cfg["mesh"]["voxel_final"]
    fc.reset_launch_counts()
    t0 = time.time()
    verts, faces, colors = slam.extract_mesh(voxel_size=voxel)
    torch.cuda.synchronize()
    mesh_wall = time.time() - t0
    mesh_counts = fc.launch_counts()
    if not (len(verts) and len(faces) and np.isfinite(verts).all()
            and np.isfinite(colors).all()):
        _fail("cp profile mesh: empty or non-finite")
    if mesh_counts["field_forward"] <= 0:
        _fail(f"cp profile mesh launches {mesh_counts}: no K1")
    m = evaluate_synthetic_mesh(slam, verts=verts)
    e = mesh_error_split(verts, slam.dataset.room_half.cpu())
    print(f"cp profile mesh: {res['n_submaps']} submap(s)  voxel {voxel}  "
          f"{len(verts)} vertices {len(faces)} faces  wall {mesh_wall:.2f} s"
          f"  launches {mesh_counts}")
    print(f"cp profile mesh error: accuracy {m['mesh_accuracy_m'] * 1000:.2f}"
          f" mm (0.05 m not held)  completion@5cm "
          f"{m['mesh_completion@5cm']:.4f} (limit {CP_MESH_COMPLETION})  "
          f"vertices outside the room {e['outside_share']:.4f}, accuracy of "
          f"those inside {e['inside_accuracy_m'] * 1000:.2f} mm (limit "
          f"{CP_INSIDE_ACCURACY * 1000:.0f}); vertices beyond 5 cm "
          f"{e['far_share']:.4f} at mean |SDF| "
          f"{e['far_mean_m'] * 1000:.1f} mm")
    if not m["mesh_completion@5cm"] > CP_MESH_COMPLETION:
        _fail(f"cp profile mesh completion@5cm "
              f"{m['mesh_completion@5cm']:.4f} <= {CP_MESH_COMPLETION}")
    if not e["inside_accuracy_m"] < CP_INSIDE_ACCURACY:
        _fail(f"cp profile mesh: accuracy inside the room "
              f"{e['inside_accuracy_m']:.4f} m >= {CP_INSIDE_ACCURACY} m")
    return counts, mesh_counts


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


def _load_yaml(path: str):
    """The port's load_config on a yaml of configs/, from the repo root
    (inherit_from resolves against the working directory)."""
    from mipsfusion_tpu_torch.config import load_config
    cwd = os.getcwd()
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    try:
        return load_config(path)
    finally:
        os.chdir(cwd)


SCALE_ATE = 0.20        # three times the reference's 65.9 mm (BENCH_r05)
SCALE_MIN_SUBMAPS = 4


def phase_scale(trace: bool = False):
    """The scale profile as a user runs it: configs/synthetic/snake_fast.yaml
    through the port's load_config and MIPSFusionTorch(cfg, dataset=
    SyntheticDataset(cfg)).run() on the card, all 600 frames of the snake
    across the tiled 11 m room and back, seed 0, the manager on with
    localMLP_num 20, the flagship field [32, 64] x F4 + CP 384 x 40 at full
    width (RO 4 x 1024 particles x 12 x 16 px, GO 8 x 512 rays and BA 15 x
    1424 rays at the config's 24 + 15 samples a ray). Fails unless ATE <
    SCALE_ATE, at least SCALE_MIN_SUBMAPS submaps and one switch back,
    and no submap past localMLP_num. Prints the manager's wait-loop
    counts and its stage's p50 / p99 ms at <= 3 and >= 4 live submaps.
    With ``trace`` the manager's predicates and pose errors print at
    every keyframe.
    Returns the run's launch counts."""
    import torch
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.ops import _build
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    cfg = _load_yaml("configs/synthetic/snake_fast.yaml")
    cfg["data"]["output"] = None
    ds = SyntheticDataset(cfg)
    slam = MIPSFusionTorch(cfg, dataset=ds)
    shape = _build.kernel_shape(slam.field.params(detach=True)["planes"],
                                slam.fcfg.n_scales)
    if shape.name != "flag" or ds.num_frames != 600 or ds.props != "tiled":
        _fail(f"scale profile: shape {shape.name}, {ds.num_frames} frames, "
              f"props {ds.props}")
    live = []                         # submaps in use at each manager call
    step = slam._manager_step

    def manager_step(*a):
        live.append(slam._host_used)
        return step(*a)

    slam._manager_step = manager_step
    if trace:
        trace_outback(slam, ds)
    torch.cuda.reset_peak_memory_stats()
    try:
        res, counts, wall = _run_path(slam)
    except RuntimeError as e:
        if "capacity" in str(e):
            _fail(f"scale profile: {e}")
        raise
    ate = res["absolute_translational_error.rmse"]
    used = res["n_submaps"]
    backs = [f for f, flag in slam.switch_events if flag == 1]
    news = [f for f, flag in slam.switch_events if flag == 3]
    mgr_ms = np.asarray([a.elapsed_time(b)
                         for a, b in slam._events["manager"]])
    live = np.asarray(live[:len(mgr_ms)])

    def pct(sel):
        if not sel.any():
            return None
        return [round(float(np.percentile(mgr_ms[sel], q)), 3)
                for q in (50, 99)]

    print(f"scale profile: 600 frames  ATE RMSE {ate * 1000:.2f} mm  "
          f"tracked FPS {res['fps']:.2f}  wall {wall:.1f} s  submaps {used} "
          f"(new at {news})  switch backs {len(backs)} at {backs}  "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"scale profile manager: wait loop armed "
          f"{slam.manager.n_wait_armed} matured {slam.manager.n_wait_matured}"
          f"  stage ms p50/p99 at <= 3 live submaps {pct(live <= 3)} "
          f"({int((live <= 3).sum())} calls), at >= 4 {pct(live >= 4)} "
          f"({int((live >= 4).sum())} calls)")
    print(f"scale profile launches {counts}  stage calls "
          f"{dict(slam.stage_calls)}")
    print("scale profile stage ms (CUDA events, mean per call): "
          + json.dumps({k: round(v, 3) for k, v in slam.stage_ms().items()}))
    cap = cfg["mapping"]["localMLP_num"]
    if not ate < SCALE_ATE:
        _fail(f"scale profile ATE {ate:.4f} m >= {SCALE_ATE} m")
    if not SCALE_MIN_SUBMAPS <= used <= cap:
        _fail(f"scale profile: {used} submaps, want {SCALE_MIN_SUBMAPS}-{cap}")
    if not backs:
        _fail("scale profile: no switch back")
    return counts


# sensor noise of the stress runs (tests/test_sensor_noise.py's profile)
STRESS_NOISE = {"depth_sigma": [0.005, 0.003], "dropout": 0.02,
                "quantize": 0.001, "rgb_sigma": 0.01}
STRESS_FRAMES = 120


def stress_config(levers: bool, seed: int = 0):
    """The JAX package's stress recipe (tools/ab_fullbudget.py run_stress):
    configs/synthetic/outback.yaml at full budgets on the fast-motion sweep,
    120 frames, one 8 m submap extent, with sensor noise; ``levers``: all
    five robustness levers on."""
    cfg = _load_yaml("configs/synthetic/outback.yaml")
    cfg["data"]["output"] = None
    cfg["seed"] = seed
    cfg["synthetic"].update(trajectory="sweep", n_frames=STRESS_FRAMES,
                            noise=dict(STRESS_NOISE))
    cfg["mapping"]["localMLP_max_len"] = [8.0, 8.0, 8.0]
    if levers:
        t = cfg["tracking"]
        t["drift_gate"] = {"thresh": 0.03}
        t["motion_prior_w"] = 1.0
        t["RO"].update(escalate=4.0, screen_px=96, screen_keep=512)
        cfg["mapping"]["kf_strain_mask"] = 2.5
    return cfg


def run_stress(levers: bool, label: str):
    """One stress run on the card; prints its ATE and the levers' counts
    and returns (slam, launch counts, K1's sdf-only launches by size)."""
    import torch
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    cfg = stress_config(levers)
    slam = MIPSFusionTorch(cfg, dataset=SyntheticDataset(cfg))
    res, counts, wall = _run_path(slam)
    sdf_by_n = dict(fc.field_forward.sdf_launches_by_n)

    tc = slam.track_counts()
    if slam.dgcfg is not None:
        # the gate's fires frame by frame: how many follow a rescued frame
        # (whose prediction is the previous pose, not constant velocity),
        # and the lengths of the runs of consecutive fires
        flags = torch.stack([torch.stack([r.fired, r.rescued])
                             for r in slam.track_log]).cpu().numpy()
        fired, rescued = flags[:, 0], flags[:, 1]
        after = int((fired[1:] & rescued[:-1]).sum())
        runs, n = [], 0
        for f in list(fired) + [False]:
            if f:
                n += 1
            elif n:
                runs.append(n)
                n = 0
        print(f"stress {label} gate: fires {int(fired.sum())}, on a frame "
              f"after a rescue {after}, runs of consecutive fires "
              f"{sorted(runs, reverse=True)}")
    print(f"stress {label}: {STRESS_FRAMES} sweep frames, noise, seed 0  "
          f"ATE RMSE {res['absolute_translational_error.rmse'] * 1000:.2f} mm"
          f"  tracked FPS {res['fps']:.2f}  wall {wall:.1f} s  submaps "
          f"{res['n_submaps']}  frames: gate armed {tc['armed']} fired "
          f"{tc['fired']} rescued {tc['rescued']}, pose-gate rejections "
          f"{tc['rejected']}, escalated {tc['escalated']}  strained "
          f"keyframes {int(sum(bool(k) for k in slam.kf_strained))}  K1 "
          f"sdf-only launches by points {sdf_by_n}")
    print(f"stress {label} launches {counts}  stage ms "
          + json.dumps({k: round(v, 3) for k, v in slam.stage_ms().items()}))
    return slam, counts, sdf_by_n


def stress_slips():
    """tests/test_drift_gate.py's injected slips on the card: an anchor
    from frame 0 of a 60 x 80 orbit, frame 5 at its ground truth times the
    slip, RO and GO at 0 iterations; the gate must fire and rescue the
    60 mm slip to under a quarter of it (reading < 20 mm) and the 3 degree
    + 36 mm slip to under 1 degree."""
    import torch
    from mipsfusion_tpu_torch.config import FLAGSHIP_ORBIT
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.models import scene_rep as sr
    from mipsfusion_tpu_torch.slam import tracker
    dev = torch.device("cuda")
    cfg = {"cam": {"H": 60, "W": 80, "fx": 40.0, "fy": 40.0, "cx": 39.5,
                   "cy": 29.5, "far": 8.0}, "data": {"downsample": 1},
           "synthetic": {"room_half": [3.0, 2.2, 2.5]}}
    ds = SyntheticDataset(cfg, n_frames=8, trajectory="orbit",
                          span=8 / 200.0, device=dev)
    pts, nrm, valid = tracker.gate_anchor(ds.packed(0), 24, 43)
    fcfg = sr.FieldConfig.from_dict(FLAGSHIP_ORBIT)
    params = field_params("flag", 0, dev)
    gt = ds.gt_pose(5)

    def slip(deg, t):
        a = np.radians(deg)
        T = np.eye(4)
        T[0, 0] = T[2, 2] = np.cos(a)
        T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
        T[:3, 3] = t
        return gt @ T

    for name, slipped in (("60 mm", slip(0.0, [0.06, 0.0, 0.0])),
                          ("3 deg + 36 mm", slip(3.0, [0.02, 0.0, -0.03]))):
        est = torch.eye(4, device=dev).repeat(16, 1, 1)
        est[0] = torch.as_tensor(ds.gt_pose(0), device=dev)
        est[4] = est[5] = torch.as_tensor(slipped, dtype=torch.float32,
                                          device=dev)
        f = ds.packed(5)
        res = tracker.track_frame(
            params, fcfg, sr.FieldConsts.from_norm_factor(
                torch.tensor([3.0, 3.0, 3.0], device=dev)),
            tracker.ROConfig(particle_size=8, n_rows=4, n_cols=6, n_iters=0),
            tracker.GOConfig(n_iters=0, n_rays=64),
            torch.zeros((8, 6), device=dev), None, f[..., 3:6], f[..., 6],
            f[..., :3], est, 5, False, sr.LossWeights(), 0, 0,
            torch.tensor(-1.0, device=dev),
            dgcfg=tracker.DriftGateConfig(thresh=0.02, polish=False),
            gate=tracker.GateAnchor(pts, nrm, valid, torch.tensor(
                0, device=dev)))
        pose = res.pose.cpu().numpy()
        err_before = float(np.linalg.norm(slipped[:3, 3] - gt[:3, 3]))
        err_after = float(np.linalg.norm(pose[:3, 3] - gt[:3, 3]))
        R = pose[:3, :3] @ gt[:3, :3].T
        ang = float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2,
                                                 -1, 1))))
        print(f"stress injected slip {name}: fired {bool(res.fired)} rescued "
              f"{bool(res.rescued)}  reading {float(res.drift_res) * 1000:.2f}"
              f" mm  position error {err_before * 1000:.1f} -> "
              f"{err_after * 1000:.2f} mm  rotation error {ang:.3f} deg")
        if not (bool(res.fired) and bool(res.rescued)
                and float(res.drift_res) < 0.02):
            _fail(f"injected slip {name}: the gate did not rescue it")
        if name == "60 mm" and not err_after < 0.25 * err_before:
            _fail(f"injected slip {name}: {err_after:.4f} m left")
        if name != "60 mm" and not ang < 1.0:
            _fail(f"injected slip {name}: {ang:.3f} deg left")


def phase_stress():
    """The fast-motion stress scene at full budgets (stress_config), seed
    0: (a) every lever off, (b) all five on, (b) again, which must give the
    same poses bit for bit; then the injected slips. Its ATE is a seed
    lottery (the JAX run read 22.5 / 377.6 / 436.8 mm on seeds 0-2), so
    the phase holds the mechanism and prints the ATE. Returns the launch
    counts of (a) and (b)."""
    import torch
    _, off_counts, off_by_n = run_stress(False, "(a) levers off")
    b, on_counts, on_by_n = run_stress(True, "(b) levers on")
    b2, _, _ = run_stress(True, "(b) again")
    same("stress (b) run twice", (b.state.est_c2w, b.state.est_c2w_rel),
         (b2.state.est_c2w, b2.state.est_c2w_rel))
    # the screen's two stages: every particle on 96 pixels, then the 512
    # best on the 384-pixel grid (the plain search: 2000 x 384)
    if set(on_by_n) != {2000 * 96, 512 * 384} or set(off_by_n) != {
            2000 * 384}:
        _fail(f"stress: K1 sdf-only sizes {on_by_n} with the screen, "
              f"{off_by_n} without")
    if not b.track_counts()["armed"]:
        _fail("stress (b): the drift gate never armed")
    if torch.stack([r.ss_scale for r in b.track_log]).min() < 1.0:
        _fail("stress (b): an escalation factor below 1")
    stress_slips()
    return off_counts, on_counts


# The HashGrid orbit's bounds: tests/test_slam_single.py:92's ATE, which
# the JAX package's HashGrid run meets on the CPU, and the CP profile's
# accuracy of the mesh's vertices inside the room.
HASH_ATE = 0.02
HASH_INSIDE_ACCURACY = 0.015
HASH_FRAMES = 45


def _mesh_and_resume(slam, cfg, ds, voxel: float, label: str):
    """The run's mesh at ``voxel``, scored against the scene's analytic
    SDF, and the same mesh bit for bit from save_checkpoint and a fresh
    system's resume_from. Returns (launch counts, mesh accuracy split,
    evaluation)."""
    import torch
    from mipsfusion_tpu_torch.eval.recon import (evaluate_synthetic_mesh,
                                                 mesh_error_split)
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    fc.reset_launch_counts()
    t0 = time.time()
    verts, faces, colors = slam.extract_mesh(voxel_size=voxel)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = fc.launch_counts()
    if not (len(verts) and len(faces) and np.isfinite(verts).all()
            and np.isfinite(colors).all()):
        _fail(f"{label}: empty or non-finite")
    m = evaluate_synthetic_mesh(slam, verts=verts)
    e = mesh_error_split(verts, slam.dataset.room_half.cpu())
    used = int(slam.state.localMLP_info[:, 0].sum().item())
    print(f"{label}: {used} submap(s)  voxel {voxel}  {len(verts)} "
          f"vertices {len(faces)} faces  wall {wall:.2f} s  launches "
          f"{counts}")
    print(f"{label} steps (s; volume_device_ms: CUDA events): " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in slam.mesh_times.items()}))
    print(f"{label} accuracy {m['mesh_accuracy_m'] * 1000:.2f} mm  "
          f"completion@5cm {m['mesh_completion@5cm']:.4f}  vertices outside "
          f"the room {e['outside_share']:.4f}, accuracy of those inside "
          f"{e['inside_accuracy_m'] * 1000:.2f} mm")
    tmp = tempfile.mkdtemp(prefix="mf_mesh_ckpt_")
    try:
        slam.output_dir = tmp
        ckpt = slam.save_checkpoint("mesh")
        fresh = MIPSFusionTorch(cfg, dataset=ds, device=slam.device)
        fresh.resume_from(ckpt)
        v2, f2, c2 = fresh.extract_mesh(voxel_size=voxel)
        if not (np.array_equal(verts, v2) and np.array_equal(faces, f2)
                and np.array_equal(colors, c2)):
            _fail(f"{label} after resume_from differs from the live mesh")
        print(f"{label} after save_checkpoint + resume_from: bitwise equal "
              "to the live mesh")
    finally:
        slam.output_dir = None
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, e, m


def phase_hash(n_frames: int = HASH_FRAMES):
    """The reference paper's own field: phase 5's flagship orbit (45
    frames, the same budgets, no manager) with grid.enc HashGrid at
    base.yaml's full width (16 levels x 2 features, 2^19 rows, base 16 to
    256), plain torch (no kernel: the JAX package has none for it), float32
    with TF32 off. Holds the hash backward at BA's 195,000 points to the
    same bits on two calls, the run (ATE < HASH_ATE, 1 submap, K0-K4 never
    launched) to the same poses and field bits over the whole run twice,
    its mesh at 3 cm (accuracy of the vertices inside the room <
    HASH_INSIDE_ACCURACY) and the same mesh after a checkpoint and resume.
    Returns the run's launch counts (all 0)."""
    import torch
    from mipsfusion_tpu_torch.config import flagship_orbit
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.ops import encoding as enc
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    dev = torch.device("cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        _fail("hash: TF32 is on for PyTorch's matrix products")
    cfg = flagship_orbit(use_manager=False)
    cfg["data"]["output"] = None
    cfg["grid"]["enc"] = "HashGrid"
    ds = SyntheticDataset(cfg, n_frames=n_frames, trajectory="orbit",
                          span=n_frames / 200.0, device=dev)
    slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    g = slam.fcfg.grid
    width = (slam.fcfg.enc, g.n_levels, g.n_features, g.log2_hashmap_size,
             g.base_resolution, g.desired_resolution,
             slam.fcfg.decoder.input_ch)
    if width != ("HashGrid", 16, 2, 19, 16, 256, 32):
        _fail(f"hash: the field is {width}, not base.yaml's hash grid")
    # the table gradient at BA's 195,000 points: int64 fixed point, the
    # same bits whatever order the atomics take
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    table = torch.rand(tuple(slam.field.hash.shape), generator=gen,
                       device=dev) * 2 - 1
    x = test_points(195_000, 14, dev).T.contiguous()
    gout = torch.randn((195_000, g.out_dim), generator=gen, device=dev)
    grads = [enc._hash_backward(table, x, gout, g, True, True)
             for _ in range(2)]
    same("hash backward at 195,000", grads[0], grads[1])
    fwd_ms = _time_idle_ms(lambda: enc.hash_encode(table, x, g))
    bwd_ms = _time_idle_ms(lambda: enc._hash_backward(table, x, gout, g,
                                                      True, True))
    print(f"hash encode at 195,000 points: forward {fwd_ms:.3f} ms, "
          f"backward (table and x) {bwd_ms:.3f} ms (one call on an idle "
          "device, host time included)")
    del table, x, gout, grads
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.time()
    res = slam.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = fc.launch_counts()
    ate = res["absolute_translational_error.rmse"]
    print(f"hash orbit: {n_frames} frames  ATE RMSE {ate * 1000:.2f} mm  "
          f"tracked FPS {res['fps']:.2f}  wall {wall:.1f} s  submaps "
          f"{res['n_submaps']}  peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  launches "
          f"{counts}")
    print("hash orbit stage ms (CUDA events, mean per call): "
          + json.dumps({k: round(v, 3) for k, v in slam.stage_ms().items()}))
    if any(counts.values()):
        _fail(f"hash orbit launched a Triplane kernel: {counts}")
    if not np.isfinite([float(v) for v in slam.track_losses]).all():
        _fail("hash orbit: non-finite tracking loss")
    if not ate < HASH_ATE:
        _fail(f"hash orbit ATE {ate:.4f} m >= {HASH_ATE} m")
    if res["n_submaps"] != 1:
        _fail(f"hash orbit n_submaps {res['n_submaps']} != 1")
    again = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    again.run(verbose=False)
    same("hash orbit run twice", (slam.state.est_c2w, slam.state.est_c2w_rel,
                                  slam.field.params(detach=True)),
         (again.state.est_c2w, again.state.est_c2w_rel,
          again.field.params(detach=True)))
    del again
    mesh_counts, e, _ = _mesh_and_resume(slam, cfg, ds, 0.03, "hash mesh")
    if any(mesh_counts.values()):
        _fail(f"hash mesh launched a Triplane kernel: {mesh_counts}")
    if not e["inside_accuracy_m"] < HASH_INSIDE_ACCURACY:
        _fail(f"hash mesh: accuracy inside the room "
              f"{e['inside_accuracy_m']:.4f} m >= {HASH_INSIDE_ACCURACY} m")
    return counts


def phase_consistency(seed: int = 0):
    """The SDF-consistency global BA on the main path's scene: the
    flagship outback (phase 6's config and budgets, 200 frames, the
    manager) with mapping.global_BA.sdf_consistency, at ``seed`` (the first
    seed of phase 6 that closes a loop). Every consistency stage (after
    each PGO) is watched: its overlapping pairs, the anchors before and
    after (anchor 0 bit for bit, some free anchor moved) and the launches
    inside it (K1, K2 without weight gradients, K4; no K3). Holds at least
    one stage with a pair, and the run's ATE < 0.03 m. Returns (the
    stages' launch counts, the run's, the points of each submap's query in
    the stages)."""
    import torch
    from mipsfusion_tpu_torch.config import flagship_outback
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    dev = torch.device("cuda")
    cfg = flagship_outback(use_manager=True, seed=seed)
    cfg["data"]["output"] = None
    cfg["mapping"]["global_BA"]["sdf_consistency"] = True
    ds = SyntheticDataset(cfg, n_frames=200, trajectory="outback", span=1.0,
                          device=dev)
    slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    inner = slam.global_ba_consistency
    stages = []
    stage_counts = {k: 0 for k in fc.KERNEL_WRAPPERS}
    stage_counts["decoder_backward_dw"] = 0

    def watched(*a, **kw):
        st = slam.state
        used = slam._host_used
        first = st.localMLP_first_kf[:used]
        before = st.kf_c2w[first].clone()
        c0, dw0 = fc.launch_counts(), fc.decoder_backward.dw_launches
        n_log = len(slam.consistency_log)
        inner(*a, **kw)
        c1, dw1 = fc.launch_counts(), fc.decoder_backward.dw_launches
        after = st.kf_c2w[first]
        delta = {k: c1[k] - c0[k] for k in c1}
        delta["decoder_backward_dw"] = dw1 - dw0
        for k, v in delta.items():
            stage_counts[k] += v
        log = slam.consistency_log[n_log:]
        moved = (after - before).abs().amax(dim=(1, 2)).cpu().numpy()
        rec = {"frame": slam._last_tracked_frame, "used": used,
               "pairs": log[0]["pairs"] if log else 0,
               "points": log[0]["points"] if log else {},
               "anchor0_same": bool(torch.equal(before[0], after[0])),
               "moved_max": float(moved[1:].max()) if used > 1 else 0.0,
               "launches": delta}
        if log:
            rec["loss_first_last"] = [float(log[0]["losses"][0]),
                                      float(log[0]["losses"][-1])]
        stages.append(rec)
        print("consistency stage " + json.dumps(rec))

    slam.global_ba_consistency = watched
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.time()
    res = slam.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = fc.launch_counts()
    ate = res["absolute_translational_error.rmse"]
    ms = slam.stage_ms()
    print(f"consistency outback: 200 frames  seed {seed}  ATE RMSE "
          f"{ate * 1000:.2f} mm  tracked FPS {res['fps']:.2f}  wall "
          f"{wall:.1f} s  submaps {res['n_submaps']}  switches "
          f"{slam.switch_events}  peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"consistency outback launches {counts}  stage calls "
          f"{dict(slam.stage_calls)}")
    print("consistency outback stage ms (CUDA events, mean per call): "
          + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    with_pairs = [r for r in stages if r["pairs"] >= 1]
    if slam.stage_calls.get("pgo", 0) < 1 or not with_pairs:
        _fail(f"consistency: no PGO followed by a consistency stage with "
              f"an overlapping pair (stages {stages})")
    if not all(r["anchor0_same"] for r in stages):
        _fail("consistency: anchor 0 moved")
    if not any(r["moved_max"] > 0 for r in with_pairs):
        _fail("consistency: no free anchor moved")
    if stage_counts["plane_backward"] or stage_counts["decoder_backward_dw"]:
        _fail(f"consistency stages launched K3 or K2 with weight gradients: "
              f"{stage_counts}")
    if not all(stage_counts[k] > 0 for k in ("field_forward",
                                             "decoder_backward",
                                             "x_backward")):
        _fail(f"consistency stages: want K1, K2 and K4, got {stage_counts}")
    if not ate < 0.03:
        _fail(f"consistency outback ATE {ate:.4f} m >= 0.03 m")
    sizes = sorted({n for r in with_pairs for n in r["points"].values()})
    return stage_counts, counts, sizes


def phase_consistency_kernels(rows: dict, sizes):
    """K1 with the embed, K2 without weight gradients and K4 with the PE's
    share of d_x added, as the consistency stage calls them, at each point
    count its per-submap queries had (``sizes``), against their plain
    versions (labels "consistency:"), and twice for the same bits."""
    import torch
    from mipsfusion_tpu_torch.ops import _build
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    dev = torch.device("cuda")
    p = field_params("flag", 0, dev)
    planes, dec = p["planes"], p["decoder"]
    shape = _build.kernel_shape(planes, 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    for n in sizes:
        x = test_points(n, 22, dev, inside_only=True)
        sfx = f"@{n}"
        out, emb = fc.field_forward(x, planes, dec, 2, 8, 5,
                                    return_embed=True)
        ref, ref_emb = fc.field_forward_plain(x, planes, dec, 2, 8, 5,
                                              return_embed=True)
        errs = {"out": _err(out, ref), "embed": _err(emb, ref_emb)}
        record_label(rows, "field_forward", "consistency:field_forward" + sfx,
                      errs, lambda: fc.field_forward(x, planes, dec, 2, 8, 5,
                                                     return_embed=True),
                      _time_ms(lambda: fc.field_forward_plain(
                          x, planes, dec, 2, 8, 5, return_embed=True)),
                      n, "field_forward", shape)
        same("consistency:field_forward" + sfx,
             fc.field_forward(x, planes, dec, 2, 8, 5, return_embed=True),
             fc.field_forward(x, planes, dec, 2, 8, 5, return_embed=True))
        g = torch.zeros((10, n), device=dev)
        g[3] = torch.randn((n,), generator=gen, device=dev) * 0.1
        g, _ = kink_free(g, x, emb, dec)
        k2 = fc.decoder_backward(x, g, emb, dec, 8, 5, weight_grads=False)
        r2 = fc.decoder_backward_plain(x, g, emb, dec, 8, 5,
                                       weight_grads=False)
        record_label(rows, "decoder_backward",
                      "consistency:decoder_backward_no_dW" + sfx,
                      {"d_x": _err(k2[0], r2[0]),
                       "d_embed": _err(k2[1], r2[1])},
                      lambda: fc.decoder_backward(x, g, emb, dec, 8, 5,
                                                  weight_grads=False),
                      _time_ms(lambda: fc.decoder_backward_plain(
                          x, g, emb, dec, 8, 5, weight_grads=False)),
                      n, "decoder_backward_go", shape)
        same("consistency:decoder_backward" + sfx, k2[:2],
             fc.decoder_backward(x, g, emb, dec, 8, 5,
                                 weight_grads=False)[:2])
        k4 = tc.x_backward(x, k2[1], planes, 2, d_x_pe=k2[0])
        r4 = tc.x_backward_plain(x, k2[1], planes, 2, d_x_pe=k2[0])
        record_label(rows, "x_backward", "consistency:x_backward_add" + sfx,
                      {"d_x": _err(k4, r4)},
                      lambda: tc.x_backward(x, k2[1], planes, 2,
                                            d_x_pe=k2[0]),
                      _time_ms(lambda: tc.x_backward_plain(
                          x, k2[1], planes, 2, d_x_pe=k2[0])),
                      n, "x_backward_add", shape)
        same("consistency:x_backward_add" + sfx, k4,
             tc.x_backward(x, k2[1], planes, 2, d_x_pe=k2[0]))
    torch.cuda.synchronize()


def record_label(rows, name, label, errs, fn, plain_ms, n, kind, shape):
    """One label of kernel ``name`` beside its plain version, recorded in
    ``rows`` for the kernels line. errs: {output name: (max abs error,
    relative error)}; fn: the kernel's call, timed here both ways;
    ``kind`` selects the bound at the table shape ``shape``."""
    ms, idle_ms = _time_ms(fn), _time_idle_ms(fn)
    part, (worst_abs, worst) = max(errs.items(), key=lambda kv: kv[1][1])
    b_ms, b_by = bound(kind, n, shape)
    print(f"{label:28s} N={n:7d} max_abs={worst_abs:.3e} "
          f"max_rel={worst:.3e} ({part}) tol_rel={TOL[name]:.0e} "
          f"kernel={ms:.3f} ms (launched idle {idle_ms:.3f} ms) "
          f"plain={plain_ms:.3f} ms bound={b_ms:.3f} ms ({b_by})")
    if not worst <= TOL[name]:
        _fail(f"{label}: relative error {worst:.3e} > {TOL[name]:.0e} in "
              f"{part}; all: {errs}")
    r = rows.setdefault(name, {"name": name, "route": "cuda",
                               "source": SOURCE[name],
                               "replaces": REPLACES[name],
                               "max_abs_err": 0.0, "ms": {},
                               "ms_idle_launch": {}, "plain_ms": {},
                               "bound_ms": {}, "bound_by": {}})
    r["max_abs_err"] = max(r["max_abs_err"], worst_abs)
    r["ms"][label] = ms
    r["ms_idle_launch"][label] = idle_ms
    r["plain_ms"][label] = plain_ms
    r["bound_ms"][label] = b_ms
    r["bound_by"][label] = b_by


# The outback's seeds. A run is reproducible, so a seed fixes its branch of
# the manager's decisions; some seeds return to a previous submap's region
# and open a new submap instead of switching back, where the
# most-overlapping earlier submap holds less of the view than the 50% a
# switch needs (seeds 0, 3 and 7 of 0-7 with the present kernels; which
# seeds do so moves when a kernel's summation order, and so the low bits
# of every sdf, changes). Every run must hold the accuracy and submap
# checks, and at least one must close a loop, so that switch back, switch
# BA and PGO run.
OUTBACK_SEEDS = (0, 1, 2)
# K1-K4's launches on the outback at seed 0 on the tree before the stage
# programs and their map optimizer (PERF.md section 6)
PARENT_OUTBACK_LAUNCHES = {"field_forward": 5767, "decoder_backward": 4772,
                           "plane_backward": 2752, "x_backward": 3760}
# the systems of phase 5's orbit and phase 6's outback at seed 0, which
# phase 16 holds each stage program's replay against
SYSTEMS = {}

# each SLAM run's ATE, FPS and stage times by phase ("orbit"; ("outback",
# seed)), for phase 14's bounds against the unsharded runs
RUNS = {}


def phase_outbacks(seeds=OUTBACK_SEEDS):
    """The outback once per seed, the first run that closes a loop (the
    main path) meshed; returns the launch counts of every run, those of
    the main path and the mesher's."""
    runs, mesh_counts = [], None
    for s in seeds:
        counts, closed, mc = phase_outback(seed=s, mesh=mesh_counts is None)
        runs.append((s, counts, closed))
        mesh_counts = mesh_counts or mc
    closing = [counts for _, counts, closed in runs if closed]
    if not closing:
        _fail(f"outback: no run of seeds {list(seeds)} closed a loop "
              "(switch back with switch BA and PGO)")
    return ({s: counts for s, counts, _ in runs}, closing[0], mesh_counts,
            {s: closed for s, _, closed in runs})


def record_decisions(slam):
    """Record the manager's predicates and decision at every keyframe of
    a run, as the run goes: a list of dicts (frame; the active submap
    after it; flag 3 new submap, 1 switch, 2 bound; the predicates; the
    submaps in use; whether the decision was forced, a switch being too
    recent; the keyframe's world position and rotation; ``boxes``, the
    active submap's box before the decision with the manager's floor on
    its lengths, and the expanded box without; ``pts`` and ``valid``, the
    world points of the manager's pixel grid that its containment test
    counts)."""
    import torch
    from mipsfusion_tpu_torch.ops.geometry import rays_to_world
    mgr = slam.manager
    pred_fn, frame_fn = mgr._predicates, slam.process_frame
    decide_fn = mgr.process_keyframe
    floor = mgr.min_cr_len.cpu().numpy()
    out, last = [], {}

    def process_keyframe(*args, force=False, **kw):
        last["force"] = force
        return decide_fn(*args, force=force, **kw)

    def predicates(st_, depth, rays_d, pose_local, wait_id):
        p = pred_fn(st_, depth, rays_d, pose_local, wait_id)
        rec = {k: float(p[k]) for k in ("cr_active", "cr_active_new",
                                        "cr_mo", "cr_wait")}
        info = np.asarray(p["localMLP_info"])
        pose = np.asarray(p["pose_world"])
        box = info[st_.active_submap_id, 1:7]
        d = depth[mgr.cr_rows, mgr.cr_cols][:, None]
        o, dirs = rays_to_world(rays_d[mgr.cr_rows, mgr.cr_cols],
                                torch.as_tensor(pose, device=depth.device))
        rec.update(mo_id=int(p["mo_id"]), used=int(info[:, 0].sum()),
                   xyz=pose[:3, 3].astype(np.float64),
                   rot=pose[:3, :3].astype(np.float64),
                   boxes=((box[:3], box[3:], floor),
                          (np.asarray(p["new_center"]),
                           np.asarray(p["new_len"]), np.zeros_like(floor))),
                   pts=(o + dirs * d).cpu().numpy(),
                   valid=(d[:, 0] > 0.0).cpu().numpy())
        last.update(rec)
        return p

    def process_frame(i):
        last.clear()
        n_ev = len(slam.switch_events)
        frame_fn(i)
        if last and i % slam.keyframe_every == 0:
            out.append({"frame": i, "active": slam.active_id,
                        "flag": slam.switch_events[-1][1]
                        if len(slam.switch_events) > n_ev else 2, **last})

    mgr._predicates, mgr.process_keyframe = predicates, process_keyframe
    slam.process_frame = process_frame
    return out


def containment_band(rec, eps: float):
    """The quantity the manager holds to min_containing_ratio at a
    recorded keyframe (``record_decisions``), the larger of the active
    and the expanded box's containment ratio, with every face of both
    boxes moved in by ``eps`` metres and out by ``eps``: [in, out]."""
    pts, valid = rec["pts"], rec["valid"]
    n_valid = max(int(valid.sum()), 1)
    band = []
    for sgn in (-1.0, 1.0):
        ratios = []
        for center, length, floor in rec["boxes"]:
            ln = np.maximum(length + np.float32(2.0 * eps * sgn), floor)
            lo, hi = center - 0.5 * ln, center + 0.5 * ln
            inside = ((pts > lo) & (pts < hi)).all(-1) & valid
            ratios.append(int(inside.sum()) / n_valid)
        band.append(max(ratios))
    return band


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


# phase 14's bounds against the unsharded runs: the JAX package's own
# between its sharded and unsharded systems (tests/test_sharded_ba.py:104,
# tests/test_sharded_whole_system.py:110)
SHARDED_ORBIT_DATE = 0.005
SHARDED_OUTBACK_DATE = 0.02


def sharded_mesh():
    """Every card when there are two or more, else the virtual mesh
    ["cuda:0", "cuda:0"] (every line of the sharded path; its copies
    between devices are no-ops)."""
    import torch
    from mipsfusion_tpu_torch.parallel.sharding import make_mesh
    n = torch.cuda.device_count()
    mesh = (make_mesh() if n >= 2
            else make_mesh(devices=["cuda:0", "cuda:0"]))
    print(f"sharded: {mesh} ("
          + ("every card" if n >= 2 else "virtual: one card, two shards")
          + ")")
    return mesh


def _sharded_run(cfg, ds, mesh):
    """One run of the system on ``mesh``; returns (slam, results, counts,
    wall s)."""
    import torch
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    slam = MIPSFusionTorch(cfg, dataset=ds, device=torch.device("cuda"),
                           mesh=mesh)
    return (slam,) + _run_path(slam)


def phase_sharded(seeds=OUTBACK_SEEDS, n_orbit: int = 45):
    """Phase 14: the multi-device path on ``sharded_mesh()``. The orbit
    of phase 5 with parallel.dp_hot_path (RO, GO, BA and the first fit
    split over the mesh, budgets rounded), twice, the same bits; then the
    outback of phase 6 with both switches on (every inactive submap
    refined in one step, slot s on mesh device s % n) at phase 6's first
    loop-closing seed. Each ATE within the JAX package's sharded-test
    bound of the unsharded run's (phases 5 and 6; run here when absent),
    K1-K4 launched on every device of the mesh and K0 never, stage ms and
    FPS beside the unsharded run's. A sharded outback that does not close
    a loop must have parted from the unsharded run's decisions at a
    keyframe where the containment test turns on the distance between the
    runs (``branch_point``); the next closing seed is then run. Returns the
    loop-closing run's (counts, per-device counts)."""
    mesh = sharded_mesh()
    sharded_orbit(mesh, n_orbit)
    tried = []
    for seed in seeds:
        key = ("outback", seed)
        if key not in RUNS:
            phase_outback(seed=seed)
        if not RUNS[key]["closed"]:
            continue
        closed, counts, by_dev, decisions, cfg = sharded_outback(mesh, seed)
        tried.append(seed)
        if closed:
            return counts, by_dev
        branch_point(seed, RUNS[key]["decisions"], decisions,
                     cfg.min_containing_ratio)
    _fail(f"sharded outback: no run of the closing seeds {tried} closed a "
          "loop")


def branch_point(seed: int, one, sharded, threshold: float):
    """Where a sharded run's manager decided a keyframe otherwise than the
    unsharded run's (the first keyframe whose active submap or flag
    differs), and why. Prints, at every keyframe up to it, both runs'
    containment ratios and how far apart their active boxes, keyframe
    poses and counted points lie. Fails unless the decision there was not
    forced, the two runs' boxes and points (the median point) lie closer
    than SHARDED_OUTBACK_DATE, and in both runs moving the boxes' faces
    by as much as the runs lie apart carries the containment ratio across
    ``threshold`` (min_containing_ratio) (``containment_band``): a
    perturbation the size of the one measured between the runs decides
    the branch."""
    k = next((j for j, (a, b) in enumerate(zip(one, sharded))
              if (a["frame"], a["active"], a["flag"])
              != (b["frame"], b["active"], b["flag"])), None)
    if k is None:
        _fail(f"sharded outback seed {seed}: no switch back, yet the "
              "manager decided every keyframe as the unsharded run did")
    for a, b in zip(one[:k + 1], sharded):
        both = a["valid"] & b["valid"]
        moved = np.linalg.norm(a["pts"] - b["pts"], axis=-1)[both]
        box_a, box_b = (np.concatenate(r["boxes"][0][:2]) for r in (a, b))
        # the typical perturbation: how far the boxes' faces and the
        # counted points (their median) lie apart
        apart = max(float(np.abs(box_a - box_b).max()),
                    float(np.median(moved)) if moved.size else 0.0)
        dR = a["rot"].T @ b["rot"]
        print(f"sharded outback seed {seed} keyframe " + json.dumps({
            "frame": a["frame"], "flag": [a["flag"], b["flag"]],
            "force": [a["force"], b["force"]],
            "cr_active": [round(a["cr_active"], 6), round(b["cr_active"], 6)],
            "cr_active_new": [round(a["cr_active_new"], 6),
                              round(b["cr_active_new"], 6)],
            "recomputed": [round(containment_band(r, 0.0)[0], 6)
                           for r in (a, b)],
            "apart_mm": round(1e3 * apart, 4),
            "pts_apart_max_mm": round(1e3 * float(moved.max(initial=0.0)),
                                      4),
            "pos_apart_mm": round(1e3 * float(np.linalg.norm(
                a["xyz"] - b["xyz"])), 4),
            "rot_apart_mrad": round(1e3 * float(np.arccos(np.clip(
                (np.trace(dR) - 1) / 2, -1, 1))), 4),
            "band_1mm": [np.round(containment_band(r, 1e-3), 4).tolist()
                         for r in (a, b)],
            "band_apart": [np.round(containment_band(r, apart), 4).tolist()
                           for r in (a, b)]}))
    a, b = one[k], sharded[k]
    bands = [containment_band(r, apart) for r in (a, b)]
    why = (f"the runs parted at frame {a['frame']} (flags {a['flag']} and "
           f"{b['flag']}) with boxes and counted points (median) "
           f"{1e3 * apart:.4f} mm apart; with the faces moved by that the "
           f"containment ratio spans {np.round(bands[0], 4).tolist()} and "
           f"{np.round(bands[1], 4).tolist()} against {threshold}")
    if (a["force"] or b["force"] or not apart < SHARDED_OUTBACK_DATE
            or not all(lo < threshold <= hi for lo, hi in bands)):
        _fail(f"sharded outback seed {seed}: no switch back, and the branch "
              f"is not the containment test's: {why}")
    print(f"sharded outback seed {seed}: no switch back; {why}; next "
          "closing seed")


def sharded_orbit(mesh, n_orbit: int):
    import torch
    from mipsfusion_tpu_torch.config import flagship_orbit
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    if "orbit" not in RUNS:
        phase_slam(n_orbit)
    cfg = flagship_orbit(use_manager=False)
    cfg["data"]["output"] = None
    cfg["parallel"] = {"dp_hot_path": True, "sharded_refine": True}
    ds = SyntheticDataset(cfg, n_frames=n_orbit, trajectory="orbit",
                          span=n_orbit / 200.0, device=torch.device("cuda"))
    slam, res, counts, wall = _sharded_run(cfg, ds, mesh)
    ate, ref = res["absolute_translational_error.rmse"], RUNS["orbit"]
    print(f"sharded orbit: {n_orbit} frames  ATE RMSE {ate * 1000:.2f} mm "
          f"(1 shard {ref['ate'] * 1000:.2f})  tracked FPS {res['fps']:.2f} "
          f"(1 shard {ref['fps']:.2f})  wall {wall:.1f} s  launches {counts}")
    print("sharded orbit stage ms (CUDA events, mean per call; 1 shard / "
          f"{mesh.size} shards): " + json.dumps({
              k: [round(ref["stage_ms"][k], 3), round(v, 3)]
              for k, v in slam.stage_ms().items() if k in ref["stage_ms"]}))
    if not slam.use_dp_hot:
        _fail("sharded orbit: dp_hot_path is not on")
    if not abs(ate - ref["ate"]) < SHARDED_ORBIT_DATE:
        _fail(f"sharded orbit ATE {ate:.4f} m vs {ref['ate']:.4f} m "
              f"unsharded: apart by {SHARDED_ORBIT_DATE} m or more")
    again = _sharded_run(cfg, ds, mesh)[0]
    same("sharded orbit twice", (slam.state.est_c2w,
                                 slam.field.params(detach=True)),
         (again.state.est_c2w, again.field.params(detach=True)))


def sharded_outback(mesh, seed: int):
    """The outback at ``seed`` with both switches on: every bound of
    phase 14 but the switch back checked against phase 6's run of the
    seed; returns (closed a loop, counts, per-device counts, the
    manager's decisions, its config)."""
    import torch
    from mipsfusion_tpu_torch.config import flagship_outback
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    ref = RUNS[("outback", seed)]
    cfg = flagship_outback(use_manager=True, seed=seed)
    cfg["data"]["output"] = None
    cfg["parallel"] = {"dp_hot_path": True, "sharded_refine": True}
    ds = SyntheticDataset(cfg, n_frames=200, trajectory="outback", span=1.0,
                          device=torch.device("cuda"))
    slam = MIPSFusionTorch(cfg, dataset=ds, device=torch.device("cuda"),
                           mesh=mesh)
    decisions = record_decisions(slam)
    res, counts, wall = _run_path(slam)
    by_dev = fc.launch_counts(by_device=True)
    ate = res["absolute_translational_error.rmse"]
    stage = slam.stage_ms()
    log = slam.sharded_refine_log
    print(f"sharded outback: seed {seed}  ATE RMSE {ate * 1000:.2f} mm "
          f"(1 shard {ref['ate'] * 1000:.2f})  tracked FPS {res['fps']:.2f} "
          f"(1 shard {ref['fps']:.2f})  wall {wall:.1f} s  submaps "
          f"{res['n_submaps']}  switches {slam.switch_events} (1 shard "
          f"{ref['switches']})  sharded refines {len(log)} (slots of the "
          f"last: {log[-1][1] if log else None})")
    print(f"sharded outback launches {counts}  by device {by_dev}")
    print("sharded outback stage ms (CUDA events, mean per call; 1 shard / "
          f"{mesh.size} shards): " + json.dumps({
              k: [round(ref["stage_ms"].get(k, float("nan")), 3),
                  round(stage.get(k, float("nan")), 3)]
              for k in ("track", "ba", "refine", "init_chunk")}))
    if not ate < 0.03:
        _fail(f"sharded outback ATE {ate:.4f} m >= 0.03 m")
    if not abs(ate - ref["ate"]) < SHARDED_OUTBACK_DATE:
        _fail(f"sharded outback ATE {ate:.4f} m vs {ref['ate']:.4f} m "
              f"unsharded: apart by {SHARDED_OUTBACK_DATE} m or more")
    if res["n_submaps"] < 2:
        _fail(f"sharded outback n_submaps {res['n_submaps']} < 2")
    if not log:
        _fail("sharded outback: no sharded refine ran")
    devices = sorted({d.index for d in mesh.devices})
    missing = [(k, d) for k in SLAM_KERNELS for d in devices
               if by_dev[k].get(d, 0) <= 0]
    if missing or counts["encode_forward"]:
        _fail(f"sharded outback: kernels not launched on a mesh device "
              f"{missing}, or K0 launched {counts['encode_forward']} times")
    return (any(flag == 1 for _, flag in slam.switch_events), counts, by_dev,
            decisions, slam.manager.cfg)


# ---------------------------------------------------------------------------
# phase 15: the file readers (FastCaMo-large on the outback)
# ---------------------------------------------------------------------------

FILES_ATE = 0.05
FILES_FRAMES = 200
FILES_CONFIG = "configs/FastCaMo-large/fastcamo_large.yaml"


def write_png(path: str, a: np.ndarray) -> None:
    """``a`` as a PNG: uint8 RGB [H, W, 3] or uint16 grey [H, W] (big-
    endian samples), every row with filter 2 (Up), zlib level 1."""
    import struct
    import zlib
    h, w = a.shape[:2]
    if a.dtype == np.uint16:
        raw, depth, ctype = a.astype(">u2").view(np.uint8).reshape(h, -1), \
            16, 0
    else:
        raw, depth, ctype = a.reshape(h, -1), 8, 2
    up = raw.copy()
    up[1:] -= raw[:-1]
    body = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body.tobytes(), 1))
                + chunk(b"IEND", b""))


def files_decoders():
    """(a) The committed JPEG and PNG fixtures (tests/data/{jpeg,png},
    written by cv2 on the CPU host) decode on this host to the SHA-256
    recorded beside them, and the PNG writer's files read back bit for
    bit; the decoders (csrc/image.cpp) are built here with this host's
    c++."""
    import hashlib
    from mipsfusion_tpu_torch.datasets import image
    from mipsfusion_tpu_torch.ops import _build
    t0 = time.time()
    _build.image_lib()
    print(f"files: image decoders built in {time.time() - t0:.2f} s "
          f"({os.path.basename(_build.host_lib_path(_build.IMAGE_SRC))})")
    root = os.path.dirname(os.path.abspath(__file__))
    n = 0
    for kind in ("jpeg", "png"):
        d = os.path.join(root, "tests", "data", kind)
        with open(os.path.join(d, "digests.json")) as f:
            rec = json.load(f)
        for name, r in sorted(rec.items()):
            path = os.path.join(d, name)
            px = (image.read_depth(path) if name.startswith("depth16")
                  else image.read_color(path))
            got = hashlib.sha256(np.ascontiguousarray(px).tobytes())
            if list(px.shape) != r["shape"] or got.hexdigest() != r["sha256"]:
                _fail(f"files: {kind}/{name} decodes to another digest")
            n += 1
    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="mf_png_")
    try:
        for a in (rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
                  rng.integers(0, 65536, (37, 53), dtype=np.uint16)):
            p = os.path.join(tmp, "x.png")
            write_png(p, a)
            back = (image.read_color(p) if a.ndim == 3
                    else image.read_depth(p))
            if not np.array_equal(back, a):
                _fail("files: the PNG writer's file reads back otherwise")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"files: {n} fixtures decode to their recorded SHA-256 "
          "(JPEG baseline 4:4:4 / 4:2:2 / 4:2:0, restarts, grey; PNG "
          "filters 0-4, RGB, RGBA, grey, 16-bit grey)")


def files_tree(cfg, root: str, n_frames: int, dev):
    """Render the outback (n_frames, span 1, seed 0) at the config's own
    camera with the port's SyntheticDataset and write it as a FastCaMo
    tree under ``root``: color/<i>.png (8-bit RGB), depth/<i>.png (16-bit
    at cam.png_depth_scale), pose/<i>.txt (the pose before the readers'
    OpenGL flip). Returns the written (rgb uint8, depth uint16) per frame
    and the render's room half-extent."""
    import concurrent.futures as cf
    import copy
    import torch
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    rcfg = copy.deepcopy(cfg)
    rcfg["synthetic"] = _load_yaml("configs/synthetic/outback.yaml")[
        "synthetic"]
    batch = 16
    ds = SyntheticDataset(rcfg, n_frames=n_frames, trajectory="outback",
                          span=1.0, seed=0, device_cache=batch, device=dev)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    scale = cfg["cam"]["png_depth_scale"]
    written, jobs = {}, []
    t0 = time.time()
    with cf.ThreadPoolExecutor(8) as pool:
        for k in range(0, n_frames, batch):
            chunk = range(k, min(k + batch, n_frames))
            ds.prerender(chunk)
            for i in chunk:
                p = ds.packed(i)
                rgb = torch.round(p[..., 3:6].clamp(0, 1) * 255).to(
                    torch.uint8).cpu().numpy()
                depth = torch.round(p[..., 6] * scale).to(
                    torch.int32).cpu().numpy().astype(np.uint16)
                T = ds.gt_pose(i).astype(np.float64).copy()
                T[:3, 1:3] *= -1
                np.savetxt(os.path.join(root, "pose", f"{i}.txt"), T)
                written[i] = (rgb, depth)
                jobs.append(pool.submit(write_png, os.path.join(
                    root, "color", f"{i}.png"), rgb))
                jobs.append(pool.submit(write_png, os.path.join(
                    root, "depth", f"{i}.png"), depth))
        for j in jobs:
            j.result()
    size = sum(os.path.getsize(os.path.join(root, s, f))
               for s in ("color", "depth")
               for f in os.listdir(os.path.join(root, s)))
    print(f"files: {n_frames} outback frames at {ds.H} x {ds.W} rendered "
          f"and written in {time.time() - t0:.1f} s ({size / 2**20:.0f} "
          "MiB of PNG)")
    return written, ds.room_half.cpu()


def phase_files(n_frames: int = FILES_FRAMES):
    """Phase 15: (a) the decoders (``files_decoders``); (b) the flagship
    outback (seed 0) written as a FastCaMo tree at FastCaMo-large's camera
    (``files_tree``) and run as a user runs a FastCaMo-large scene: the
    port's load_config on configs/FastCaMo-large/fastcamo_large.yaml with
    data.datadir and the outback's mapping bounds set (data.output None:
    no files written), get_dataset's FastCaMoDataset, MIPSFusionTorch.run.
    Every frame the loop packed must equal the written frame's quantised
    values bit for bit, K1-K4 launch at the fcl shape and K0 never, ATE <
    FILES_ATE; then the joint mesh at mesh.voxel_final, scored against
    the scene's analytic SDF (printed, not held). Returns the run's
    launch counts."""
    import torch
    from mipsfusion_tpu_torch.config import apply_overrides
    from mipsfusion_tpu_torch.eval.recon import (evaluate_synthetic_mesh,
                                                 mesh_error_split)
    from mipsfusion_tpu_torch.ops import _build
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    files_decoders()
    dev = torch.device("cuda")
    outback = _load_yaml("configs/synthetic/outback.yaml")["mapping"]
    tmp = tempfile.mkdtemp(prefix="mf_fastcamo_")
    try:
        cfg = apply_overrides(_load_yaml(FILES_CONFIG), {
            "data.datadir": tmp, "data.output": None,
            "mapping.bound": outback["bound"],
            "mapping.marching_cubes_bound": outback["marching_cubes_bound"]})
        written, room_half = files_tree(cfg, tmp, n_frames, dev)
        t0 = time.time()
        slam = MIPSFusionTorch(cfg)
        ds = slam.dataset
        print(f"files: {type(ds).__name__} ({cfg['dataset']}) of "
              f"{ds.num_frames} frames at {ds.H} x {ds.W}, system built in "
              f"{time.time() - t0:.1f} s")
        shape = _build.kernel_shape(slam.field.params(detach=True)["planes"],
                                    slam.fcfg.n_scales)
        if shape.name != "fcl":
            _fail(f"files: the field's shape is {shape.name}, not fcl")
        # every frame the loop takes, held on the card to the written
        # frame's values, made on the host with the reader's numpy
        # arithmetic (on the card, PyTorch divides by a Python scalar
        # through its reciprocal); per channel group, no host read inside
        # the loop
        rays = torch.from_numpy(ds.rays_d).to(dev)
        mismatch = torch.zeros(3, dtype=torch.int64, device=dev)
        seen = set()
        packed = ds.packed

        def checked(i):
            nonlocal mismatch
            f = packed(i)
            if i not in seen:
                seen.add(i)
                rgb, depth = written[i]
                rgb = torch.from_numpy(rgb.astype(np.float32) / 255.0)
                depth = torch.from_numpy(depth.astype(np.float32)
                                         / ds.png_depth_scale * ds.sc_factor)
                mismatch = mismatch + torch.stack([
                    (f[..., :3] != rays).sum(),
                    (f[..., 3:6] != rgb.to(dev)).sum(),
                    (f[..., 6] != depth.to(dev)).sum()])
            return f
        ds.packed = checked
        torch.cuda.reset_peak_memory_stats()
        res, counts, wall = _run_path(slam)
        ds.packed = packed
        ds.close()
        bad = mismatch.tolist()
        if any(bad) or len(seen) != n_frames:
            _fail(f"files: values of {len(seen)} packed frames differ from "
                  f"the written frames (direction, rgb, depth): {bad}")
        ate = res["absolute_translational_error.rmse"]
        stage = slam.stage_ms()
        d = ds.decode_s
        nf = max(d["frames"], 1)
        print(f"files: {n_frames} frames  shape {shape.name}  ATE RMSE "
              f"{ate * 1000:.2f} mm  tracked FPS {res['fps']:.2f}  wall "
              f"{wall:.1f} s  submaps {res['n_submaps']}  switches (frame, "
              f"flag) {slam.switch_events}  peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"files: every packed frame equals the written one "
              f"({len(seen)} frames, bit for bit)")
        print(f"files launches {counts}  stage calls {dict(slam.stage_calls)}")
        print("files stage ms (CUDA events, mean per call): " + json.dumps(
            {k: round(v, 3) for k, v in stage.items()}))
        print(f"files decode ms a frame (host, prefetch thread): PNG colour "
              f"{d['color'] / nf * 1000:.2f}  PNG depth "
              f"{d['depth'] / nf * 1000:.2f}  whole frame packed "
              f"{d['pack'] / nf * 1000:.2f}  against track "
              f"{stage.get('track', float('nan')):.2f} and the loop's "
              f"{1000.0 / res['fps']:.2f} a frame; the loop waited "
              f"{d['wait'] * 1000:.1f} ms in all on the prefetch "
              f"({nf} frames decoded)")
        RUNS["files"] = {"ate": ate, "fps": res["fps"], "stage_ms": stage,
                         "switches": list(slam.switch_events),
                         "decode_ms": {k: d[k] / nf * 1000 for k in (
                             "color", "depth", "pack")},
                         "wait_s": d["wait"]}
        if counts["encode_forward"]:
            _fail(f"files: K0 launched {counts['encode_forward']} times")
        if not ate < FILES_ATE:
            _fail(f"files: ATE {ate:.4f} m >= {FILES_ATE} m")
        voxel = cfg["mesh"]["voxel_final"]
        fc.reset_launch_counts()
        t0 = time.time()
        verts, faces, colors = slam.extract_mesh(voxel_size=voxel)
        torch.cuda.synchronize()
        mesh_wall = time.time() - t0
        mesh_counts = fc.launch_counts()
        if not (len(verts) and len(faces) and np.isfinite(verts).all()):
            _fail("files: mesh empty or non-finite")
        m = evaluate_synthetic_mesh(slam, verts=verts, room_half=room_half)
        e = mesh_error_split(verts, room_half)
        print(f"files mesh: voxel {voxel}  {len(verts)} vertices "
              f"{len(faces)} faces  wall {mesh_wall:.2f} s  launches "
              f"{mesh_counts}  accuracy {m['mesh_accuracy_m'] * 1000:.2f} mm"
              f"  completion@5cm {m['mesh_completion@5cm']:.4f}  (printed, "
              f"not held)  vertices outside the room "
              f"{e['outside_share']:.4f}, accuracy of those inside "
              f"{e['inside_accuracy_m'] * 1000:.2f} mm")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


# ------------------------------------------------------ 16. programs

TRACK_FIELDS = ("pose", "loss", "loss_ewma", "accepted", "drift_res",
                "armed", "fired", "rescued", "ss_scale")


def _field_copy(slam, m: int, fresh: bool = False):
    """A copy of submap m's field and a map optimizer for it: the active
    submap's moments, or a fresh one (``fresh``, or another submap)."""
    from mipsfusion_tpu_torch.models import scene_rep as sr
    from mipsfusion_tpu_torch.slam import checkpoint as ck
    from mipsfusion_tpu_torch.slam import mapper
    field = sr.Field(slam.fields[m].params(detach=True))
    opt = mapper.make_map_optimizer(field, slam.mcfg)
    if m == slam.active_id and not fresh:
        ck.adam_from_leaves(opt, field, ck.adam_to_leaves(slam.map_opt,
                                                          slam.field))
    return field, opt


def _moments(field, opt):
    """The map optimizer's counts and moments (in the JAX package's leaf
    order) as tensors."""
    import torch
    from mipsfusion_tpu_torch.slam import checkpoint as ck
    return [torch.as_tensor(a) for a in ck.adam_to_leaves(opt, field)]


def stage_pairs(slam, ds, i: int):
    """Per programmed stage at frame i of a finished run, (its program's
    call, the stage function's call): each runs the stage on its own
    copies of the field, the optimizer and the pose store from a
    generator seeded as the loop seeds it, records CUDA events around the
    stage call alone into the list it is given, and returns what the two
    must agree on bit for bit (results, parameters, moments, the
    committed poses). Refine takes the first inactive submap (the active
    one on a one-submap run) with a fresh optimizer; the fit one chunk of
    the first fit (``mapping.first_iters_chunk``) on the active field."""
    import dataclasses
    import torch
    from mipsfusion_tpu_torch.slam import mapper, tracker
    packed = ds.packed(i)

    def timed(ev, fn, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = fn(*a, **kw)
        e1.record()
        torch.cuda.synchronize()
        ev.append((e0, e1, time.perf_counter() - t0))
        return out

    def ba(run, m, args, stage, fresh, **kw):
        def call(ev):
            field, opt = _field_copy(slam, m, fresh)
            res = timed(ev, run, field, opt, *args,
                        slam._generator(stage, i), **kw)
            return tuple(res), field.params(detach=True), _moments(field, opt)
        return call

    inactive = [m for m in range(slam._host_used)
                if m != slam.active_id and slam.fields[m] is not None]
    m_ref = inactive[0] if inactive else slam.active_id
    bind = slam._host_kf_bind
    mask = ((np.arange(bind.shape[0]) < slam.state.n_kf)
            & ((bind[:, 0] == m_ref) | (bind[:, 1] == m_ref)))
    if inactive:
        mask &= bind[:, 0] != slam.active_id
    ba_args = slam._ba_args(packed, i)
    ref_args = slam._refine_args(m_ref, mask)
    targs, levers = slam._track_args(packed, i)

    def track(run):
        def call(ev):
            st = slam.state
            a = list(targs)
            a[6] = slam._generator("track", i)
            a[8] = dataclasses.replace(
                st, est_c2w=st.est_c2w.clone(),
                est_c2w_rel=st.est_c2w_rel.clone(),
                keyframe_ref=st.keyframe_ref.clone())
            res = timed(ev, run, *a, **levers)
            return ([getattr(res, k) for k in TRACK_FIELDS], a[8].est_c2w,
                    a[8].est_c2w_rel, a[8].keyframe_ref)
        return call

    chunk = slam.init_chunk
    if not 0 < chunk < slam.mcfg.first_iters:
        chunk = slam.mcfg.first_iters
    rays = packed.reshape(-1, 7)

    def fit(run, **kw):
        def call(ev):
            field, opt = _field_copy(slam, slam.active_id)
            loss = timed(ev, run, field, opt, rays, slam.fcfg, slam.consts,
                         slam.mcfg, slam.lw, chunk,
                         slam._round_rays(slam.mcfg.sample),
                         slam._generator("init", 10_000 + i), **kw)
            return loss, field.params(detach=True), _moments(field, opt)
        return call

    progs = slam.programs
    return {
        "ba": (ba(progs.local_ba, slam.active_id, ba_args, "ba", False,
                  optim_cur=slam.optim_cur),
               ba(mapper.local_ba, slam.active_id, ba_args, "ba", False,
                  optim_cur=slam.optim_cur)),
        "refine": (ba(progs.local_ba, m_ref, ref_args, "refine", True,
                      include_current=False),
                   ba(mapper.local_ba, m_ref, ref_args, "refine", True,
                      include_current=False)),
        "track": (track(progs.track_frame_update),
                  track(tracker.track_frame_update)),
        "fit": (fit(progs.init_submap_fit, chunk=chunk),
                fit(mapper.init_submap_fit))}


def _bits_equal(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_bits_equal(x, y)
                                        for x, y in zip(a, b))
    return a.dtype == b.dtype and bool(torch.equal(a, b))


def program_checks(slam, ds, label: str, reps: int = 3) -> dict:
    """Each programmed stage at the run's last frame: the program called
    once (a replay, or the key's capture where the run never reached it),
    then ``reps`` times against the stage function, each replay the
    function's bits; per stage the mean device ms between CUDA events
    and host ms (synchronised) of a call both ways. Returns them."""
    i = ds.num_frames - 1
    rows = {}
    for stage, (prog, eager) in stage_pairs(slam, ds, i).items():
        first = []
        prog(first)
        ev_p, ev_e = [], []
        same_bits = True
        for _ in range(reps):
            same_bits &= _bits_equal(prog(ev_p), eager(ev_e))
        row = {"same_bits": same_bits}
        for way, ev in (("program", ev_p), ("eager", ev_e)):
            row[f"{way}_ms"] = float(np.mean([a.elapsed_time(b)
                                              for a, b, _ in ev]))
            row[f"{way}_host_ms"] = float(np.mean([h for _, _, h in ev])
                                          * 1e3)
        rows[stage] = row
        print(f"programs {label} {stage}: replay == eager bit for bit "
              f"{same_bits}  program {row['program_ms']:.3f} ms (host "
              f"{row['program_host_ms']:.3f})  eager {row['eager_ms']:.3f} "
              f"ms (host {row['eager_host_ms']:.3f})")
        if not same_bits:
            _fail(f"programs {label}: the {stage} program's replay differs "
                  f"from the eager call")
    return rows


def template_copy_ms(slam, reps: int = 20) -> float:
    """Device ms of one BA call's parameter and moment copies (the active
    submap's into the program's template and back)."""
    import torch
    prog = next(p for p in slam.programs.programs.values()
                if p.stage == "ba")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        prog.template.load(slam.field, slam.map_opt)
        prog.template.store(slam.field, slam.map_opt)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _programs_runs():
    """Phase 5's orbit (45 frames, one submap) and phase 6's outback at
    seed 0 (200 frames, the manager), run here for --programs-only."""
    import torch
    from mipsfusion_tpu_torch.config import flagship_orbit, flagship_outback
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    dev = torch.device("cuda")
    for label, cfg, n, traj, span in (
            ("orbit", flagship_orbit(use_manager=False), 45, "orbit",
             45 / 200.0),
            ("outback", flagship_outback(use_manager=True, seed=0), 200,
             "outback", 1.0)):
        cfg["data"]["output"] = None
        ds = SyntheticDataset(cfg, n_frames=n, trajectory=traj, span=span,
                              device=dev)
        slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
        res, counts, wall = _run_path(slam)
        print(f"programs run {label}: ATE RMSE "
              f"{res['absolute_translational_error.rmse'] * 1000:.2f} mm  "
              f"tracked FPS {res['fps']:.2f}  wall {wall:.1f} s  submaps "
              f"{res['n_submaps']}  switches {slam.switch_events}  "
              f"launches {counts}")
        print(f"programs run {label} stage ms: " + json.dumps(
            {k: round(v, 3) for k, v in slam.stage_ms().items()}))
        SYSTEMS[label] = (slam, ds)


def phase_programs():
    """Phase 16: at each programmed stage's key on the flagship orbit and
    the outback (phase 5's and 6's systems, after their runs), the
    program's replay against the eager call on the same inputs and
    draws, bit for bit; the stage ms of both ways; the graphs, their
    capture seconds and memory, the run's peak memory; the cost of
    passing the parameters as arguments (the copies a BA call makes)
    against one graph per submap."""
    import torch
    if "orbit" not in SYSTEMS:
        _programs_runs()
    out = {}
    for label in ("orbit", "outback"):
        slam, ds = SYSTEMS[label]
        out[label] = program_checks(slam, ds, label)
        stats = slam.programs.stats()
        print(f"programs {label}: " + json.dumps(stats))
        graphs = sum(s["programs"] for s in stats.values())
        cap_s = sum(s["capture_s"] for s in stats.values())
        mib = sum(s["graph_bytes"] for s in stats.values()) / 2**20
        ba = stats["ba"]
        used = int(slam.state.localMLP_info[:, 0].sum().item())
        print(f"programs {label}: {graphs} graphs, capture {cap_s:.2f} s, "
              f"graph memory {mib:.1f} MiB, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"parameters as arguments: copies {template_copy_ms(slam):.4f}"
              f" ms a BA call; one BA graph per submap instead: {used} x "
              f"{ba['graph_bytes'] / 2**20:.1f} MiB and {used} x "
              f"{ba['capture_s'] / ba['programs']:.2f} s of capture")
    return out


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
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-4 only: build, every kernel against its "
                         "plain version with times, the autograd paths")
    ap.add_argument("--scale-only", action="store_true",
                    help="phases 1-2, then only phase 10 (the scale profile)")
    ap.add_argument("--scale-trace", action="store_true",
                    help="with --scale-only: print the manager's predicates "
                         "and pose errors at every keyframe")
    ap.add_argument("--stress-only", action="store_true",
                    help="phases 1-2, then only phase 11 (the stress runs "
                         "and the injected slips)")
    ap.add_argument("--hash-only", action="store_true",
                    help="phases 1-2, then only phase 12 (the HashGrid "
                         "orbit and its mesh)")
    ap.add_argument("--consistency-only", action="store_true",
                    help="phases 1-2, then only phase 13 (the consistency "
                         "outback at seed 0) and its kernel labels")
    ap.add_argument("--files-only", action="store_true",
                    help="phases 1-2, then only phase 15 (the decoders and "
                         "the FastCaMo-large run through the file reader)")
    ap.add_argument("--programs-only", action="store_true",
                    help="phases 1-2, then only phase 16 (each stage "
                         "program's replay against the eager call on the "
                         "orbit and the outback)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="phases 1-2, then only phase 14 (the orbit and the "
                         "outback on the sharded mesh, against their "
                         "unsharded runs)")
    args = ap.parse_args(argv)
    if args.outback_seeds is not None:
        outback_seeds([int(s) for s in args.outback_seeds.split(",")],
                      args.outback_spawn)
        return 0
    if (args.scale_only or args.stress_only or args.hash_only
            or args.consistency_only or args.sharded_only or args.files_only
            or args.programs_only):
        phase_device()
        phase_build(check_hmma=False)
        if args.programs_only:
            print(json.dumps({"programs": phase_programs()}))
        elif args.files_only:
            print(json.dumps({"launches_files": phase_files()}))
        elif args.sharded_only:
            counts, by_dev = phase_sharded()
            print(json.dumps({"launches_sharded": counts,
                              "launches_sharded_by_device": by_dev}))
        elif args.scale_only:
            print(json.dumps({"launches_scale": phase_scale(
                trace=args.scale_trace)}))
        elif args.stress_only:
            off, on = phase_stress()
            print(json.dumps({"launches_stress": on,
                              "launches_stress_off": off}))
        elif args.hash_only:
            print(json.dumps({"launches_hash": phase_hash()}))
        else:
            stage, run, sizes = phase_consistency(OUTBACK_SEEDS[0])
            rows = {}
            phase_consistency_kernels(rows, sizes)
            print(json.dumps({"launches_consistency": stage,
                              "launches_consistency_run": run,
                              "kernel_ms": {n: r["ms"]
                                            for n, r in rows.items()}}))
        return 0
    phase_device()
    phase_build()
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    fc.reset_launch_counts()
    rows = phase_kernels()
    phase_autograd()
    if args.kernels_only:
        print(json.dumps({"kernel_ms": {n: r["ms"] for n, r in rows.items()},
                          "kernel_ms_idle_launch": {
                              n: r["ms_idle_launch"]
                              for n, r in rows.items()},
                          "bound_ms": {n: r["bound_ms"]
                                       for n, r in rows.items()}}))
        return 0
    k0_launches = fc.launch_counts()["encode_forward"]
    orbit_counts = phase_slam()
    by_seed, counts, mesh_counts, closed_seeds = phase_outbacks()
    phase_cli()
    cp_counts, cp_mesh_counts = phase_cp_profile()
    scale_counts = phase_scale()
    stress_off, stress_counts = phase_stress()
    hash_counts = phase_hash()
    closing_seed = next(s_ for s_ in OUTBACK_SEEDS if closed_seeds[s_])
    cons_stage, cons_run, cons_sizes = phase_consistency(closing_seed)
    phase_consistency_kernels(rows, cons_sizes)
    sharded_counts, sharded_by_dev = phase_sharded()
    files_counts = phase_files()
    programs = phase_programs()
    # K0 has no SLAM caller (as triplane_encode_pallas has none in the JAX
    # package): no loop may launch it
    k0_loops = [orbit_counts["encode_forward"], cp_counts["encode_forward"],
                scale_counts["encode_forward"],
                stress_off["encode_forward"],
                stress_counts["encode_forward"],
                cons_run["encode_forward"],
                sharded_counts["encode_forward"],
                files_counts["encode_forward"]] + [
        c["encode_forward"] for c in by_seed.values()]
    if any(k0_loops):
        _fail(f"K0 launched by a SLAM loop (orbit, cp profile, scale, "
              f"stress off and on, consistency, sharded outback, files, "
              f"outbacks): {k0_loops}")
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
            # the mesher's launches on the main path's run
            "launches_mesh": mesh_counts[name],
            # the CP profile's run (kernels at the cp shape) and its mesh
            "launches_cp_profile": cp_counts[name],
            "launches_cp_profile_mesh": cp_mesh_counts[name],
            # the scale profile's run (snake_fast.yaml, 600 frames) and
            # the stress runs with every lever on and with none
            "launches_scale": scale_counts[name],
            "launches_stress": stress_counts[name],
            "launches_stress_off": stress_off[name],
            # the HashGrid orbit (plain torch: none of these kernels) and
            # the consistency stages of the consistency outback (K2's
            # launches there are all without weight gradients)
            "launches_hash": hash_counts[name],
            "launches_consistency": cons_stage[name],
            "launches_consistency_run": cons_run[name],
            # the sharded outback (phase 14), in all and per CUDA device
            "launches_sharded": sharded_counts[name],
            "launches_sharded_by_device": sharded_by_dev[name],
            # the FastCaMo-large run through the file reader (phase 15:
            # the kernels at the fcl shape)
            "launches_files": files_counts[name],
            "slam_caller": on_path,
            "max_abs_err": r["max_abs_err"],
            # "ms", "plain_ms" and the bound at the first shape measured
            # (the flagship's BA batch, 195,000 uniform points); every
            # label's numbers ride beside them, the cp and fcl shapes'
            # under "cp:" and "fcl:" labels, the flagship's at the scale
            # profile's and the stress screen's sizes under "snake:"
            "ms": next(iter(r["ms"].values())),
            "ms_idle_launch": next(iter(r["ms_idle_launch"].values())),
            "plain_ms": next(iter(r["plain_ms"].values())),
            "bound_ms": next(iter(r["bound_ms"].values())),
            "bound_by": next(iter(r["bound_by"].values())),
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            "ms_by_shape": r["ms"],
            "ms_idle_launch_by_shape": r["ms_idle_launch"],
            "plain_ms_by_shape": r["plain_ms"],
            "bound_ms_by_shape": r["bound_ms"],
            "bound_by_shape": r["bound_by"]})
    print(json.dumps({"programs": programs}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

"""Two checkouts of the PyTorch port on the same card: K0's, K1's and K4's
outputs on fixed flagship inputs, where their bits differ, and the
wrappers' host time a call.

    python3 tools/torch_tree_compare.py run <checkout> <out.npz>
    python3 tools/torch_tree_compare.py compare <a.npz> <b.npz>
    python3 tools/torch_tree_compare.py stages <checkout> [--scale]
        [--seeds 0,1] [--stress] [--eager] [--torch-adam]

``run`` imports ``<checkout>/mipsfusion_tpu_torch`` (its own kernels, built
at first use; it needs the card), makes the flagship field ([32, 64] x F4
+ CP 384 x 40, embed 48) and 195,000 points from numpy seeds, so no code
of either checkout shapes the inputs, and saves on the host: K0's encode
(as [E, N]), K1's full output and embed, K1's sdf-only output, and K4's d_x
for four cotangents (every embed row; the CP rows zeroed; scale 0's rows
only; the CP rows only). It also prints the wall time a call of K0's,
K1's and K4's wrappers takes at 64 points, 2,000 calls queued back to
back and synchronised once (median of 5 rounds): the kernels are tiny
there, so the time is the host's (shape lookup, argument checks,
allocations, the ctypes call, the launch); and the time of one K0 call
launched on an idle device at 55,536 and 195,000 points (median of 50).
``compare`` prints, per kernel output and row, how many values differ and
the largest difference in units in the last place.

``stages`` runs ``<checkout>``'s SLAM loop on the card and prints one
JSON line: the flagship outback at seed 0 (200 frames, the manager) as
``MIPSFusionTorch.run`` runs it (tracked FPS, the device-stream ms a call
of each stage, ``stage_ms()``, and their calls, ATE, switch frames,
K1-K4's launches); then a second run of it whose frames 120-159 (a
steady window: both submaps made, no switch) run under
``torch.profiler``: the window's wall time between two synchronisations,
the union of the device's kernel, copy and set intervals in it (busy),
and the idle share 1 - busy / wall; with ``--scale`` also
configs/synthetic/snake_fast.yaml as the smoke's phase 10 runs it (600
frames: FPS, stage ms, ATE, submaps); with ``--seeds`` the outback at
each further seed of the list as the first (``outback_<seed>``); with
``--stress`` the smoke's stress run (b), every robustness lever on
(chip_smoke.stress_config, 120 frames), whose stage ms split the gated
track's calls into those the gate fired on and the others
(``track_fired``, ``track_quiet``, on trees that record them). Run it
once per checkout, in turns (parent, change, change, parent), to compare
two trees on one card.
On a checkout with stage programs (``slam/programs.py``), ``--eager``
runs the stages by their functions instead (the programs' oracle) and
``--torch-adam`` gives the map ``torch.optim.Adam`` as the trees before
the programs had it (its bias correction in float64 on the host): the
two together attribute a change of the results to the programs or to
the optimizer's step.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

N = 195_000
E = 48
LAYERS_IN_OUT = {"trunk0": (51, 128), "trunk1": (128, 128),
                 "rgb": (64 + 51, 3), "sdf0": (64 + E, 128),
                 "sdf1": (128, 5)}
# d_embed rows kept in each K4 case (the embed is [s0 4 | s1 4 | cp 40])
K4_CASES = {"all": range(0, E), "scales": range(0, 8),
            "s0": range(0, 4), "cp": range(8, E)}


def _inputs():
    rng = np.random.default_rng(0)
    planes = {"s0": rng.normal(0, 0.5, (3, 32, 32, 4)),
              "s1": rng.normal(0, 0.5, (3, 64, 64, 4)),
              "cp": rng.normal(1.0, 0.3, (3, 384, 40))}
    dec = {}
    for name, (fi, fo) in LAYERS_IN_OUT.items():
        lim = 1.0 / np.sqrt(fi)
        dec[name] = {"w": rng.uniform(-lim, lim, (fi, fo)),
                     "b": rng.uniform(-lim, lim, (fo,))}
    x = rng.uniform(-0.15, 1.15, (3, N))
    k = N // 16
    x[:, :k] = 1.0                           # the clamp edges
    x[1, k:2 * k] = 0.0
    d_embed = rng.normal(0, 0.1, (E, N))
    return planes, dec, x, d_embed


def run(checkout: str, out: str):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    if os.path.dirname(fc.__file__) != os.path.join(
            os.path.abspath(checkout), "mipsfusion_tpu_torch", "ops"):
        raise SystemExit(f"imported {fc.__file__}, not {checkout}'s")
    dev = torch.device("cuda")

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev).contiguous()

    planes, dec, x, d_embed = _inputs()
    planes = {k: t(v) for k, v in planes.items()}
    dec = {k: {"w": t(v["w"]), "b": t(v["b"])} for k, v in dec.items()}
    x, d_embed = t(x), t(d_embed)
    # K0's [N, E] saved as [E, N], a row per embed row as K1's embed
    res = {"k0_encode": tc.encode_forward(x.T.contiguous(), planes, 2).T}
    o, emb = fc.field_forward(x, planes, dec, 2, 8, 5, return_embed=True)
    res["k1_out"], res["k1_embed"] = o, emb
    res["k1_sdf_only"] = fc.field_forward(x, planes, dec, 2, 8, 5,
                                          sdf_only=True)
    for case, rows in K4_CASES.items():
        g = torch.zeros_like(d_embed)
        g[list(rows)] = d_embed[list(rows)]
        res[f"k4_{case}"] = tc.x_backward(x, g, planes, 2)
    torch.cuda.synchronize()
    xs = x[:, :64].contiguous()
    xr = xs.T.contiguous()
    gs = d_embed[:, :64].contiguous()
    for name, fn in (("encode_forward", lambda: tc.encode_forward(
            xr, planes, 2)),
                     ("field_forward", lambda: fc.field_forward(
            xs, planes, dec, 2, 8, 5)),
                     ("x_backward", lambda: tc.x_backward(xs, gs, planes,
                                                          2))):
        times = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 2000 * 1e3)
        print(f"{checkout}: {name} host ms a call at 64 points "
              f"{float(np.median(times)):.4f} (rounds "
              + " ".join(f"{v:.4f}" for v in times) + ")")
    # K0 launched on an idle device, the wrapper's host time inside (as
    # chip_smoke's idle times): the scale profile's BA batch and the
    # flagship's, median of 50 calls
    for n in (55_536, N):
        xe = x[:, :n].T.contiguous()
        times = []
        for i in range(51):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            tc.encode_forward(xe, planes, 2)
            b.record()
            torch.cuda.synchronize()
            if i:
                times.append(a.elapsed_time(b))
        print(f"{checkout}: encode_forward idle launch ms at {n} points "
              f"{float(np.median(times)):.4f} (min {min(times):.4f}, max "
              f"{max(times):.4f})")
    np.savez(out, **{k: v.cpu().numpy() for k, v in res.items()})
    print(f"{checkout}: saved {sorted(res)} to {out}")


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of float32 (finite values)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return np.abs(ia - ib)


def compare(a_path: str, b_path: str):
    a, b = np.load(a_path), np.load(b_path)
    for key in a.files:
        x, y = a[key], b[key]
        diff = x.view(np.int32) != y.view(np.int32)    # -0.0 vs 0.0 too
        line = [f"{key}: {int(diff.sum())} of {x.size} values differ"]
        for r in range(x.shape[0]):
            if diff[r].any():
                line.append(f"row {r}: {int(diff[r].sum())} (max "
                            f"{int(_ulp(x[r], y[r]).max())} ulp, max abs "
                            f"{float(np.abs(x[r] - y[r]).max()):.3g})")
        print("; ".join(line))


class _EagerStages:
    """The stage programs' methods as the stage functions themselves."""

    def __init__(self):
        from mipsfusion_tpu_torch.slam import manager, mapper, system, tracker
        self.local_ba = mapper.local_ba
        self.track_frame_update = tracker.track_frame_update
        self._fit = mapper.init_submap_fit
        # the loop-closure stages, on trees that run them as programs
        self.global_pgo = system.global_pgo
        self.switch_ba_update = getattr(system, "switch_ba_update", None)
        self.predicates_fused = manager.predicates_fused
        self.overlap_verify_icp = system.overlap_verify_icp

    def init_submap_fit(self, *args, chunk=0):
        return self._fit(*args)


def _torch_adam(field, mcfg):
    import torch
    return torch.optim.Adam([
        {"params": list(field.decoder.parameters()), "lr": mcfg.lr_decoder,
         "weight_decay": 1e-6, "eps": 1e-8},
        {"params": field.embed_params(), "lr": mcfg.lr_embed,
         "eps": 1e-15},
    ], betas=(0.9, 0.99))


def _system(cfg, ds, eager: bool, dev=None):
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    if eager:
        slam.programs = _EagerStages()
    return slam


def _outback(eager: bool, seed: int = 0):
    import torch
    from mipsfusion_tpu_torch.config import flagship_outback
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    cfg = flagship_outback(use_manager=True, seed=seed)
    cfg["data"]["output"] = None
    dev = torch.device("cuda")
    ds = SyntheticDataset(cfg, n_frames=200, trajectory="outback", span=1.0,
                          device=dev)
    return _system(cfg, ds, eager, dev), ds


def _summary(slam, res) -> dict:
    """The run's numbers; a stage's ms a call is also split into its first
    call (a program's warm-up and capture) and the mean of the rest."""
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    stage_ms = slam.stage_ms()
    ms = {k: [a.elapsed_time(b) for a, b in v]
          for k, v in slam._events.items()}
    return {"fps": res["fps"],
            "ate_m": res["absolute_translational_error.rmse"],
            "n_submaps": res["n_submaps"],
            "switches": [list(e) for e in slam.switch_events],
            "stage_ms": stage_ms, "stage_calls": dict(slam.stage_calls),
            "stage_ms_first": {k: v[0] for k, v in ms.items()},
            "stage_ms_after_first": {k: float(np.mean(v[1:]))
                                     for k, v in ms.items() if len(v) > 1},
            "launches": fc.launch_counts()}


def _idle_window(eager: bool, w0: int = 120, w1: int = 160) -> dict:
    """Frames w0..w1-1 of the outback under torch.profiler (the frames
    before them run first, unprofiled): wall, busy and idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    slam, ds = _outback(eager)
    ds.prerender(range(w1))
    for i in range(w0):
        slam.process_frame(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(w0, w1):
            slam.process_frame(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e3
    return {"frames": [w0, w1], "wall_ms": wall, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "device_events": len(spans)}


def stages(checkout: str, scale: bool = False, eager: bool = False,
           torch_adam: bool = False, seeds=(0,), stress: bool = False):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from mipsfusion_tpu_torch.ops import field_cuda as fc
    from mipsfusion_tpu_torch.slam import mapper
    if os.path.dirname(fc.__file__) != os.path.join(
            os.path.abspath(checkout), "mipsfusion_tpu_torch", "ops"):
        raise SystemExit(f"imported {fc.__file__}, not {checkout}'s")
    if torch_adam:
        mapper.make_map_optimizer = _torch_adam
    out = {"checkout": checkout, "device": torch.cuda.get_device_name(0),
           "eager": eager, "torch_adam": torch_adam}
    fc.reset_launch_counts()
    slam, _ = _outback(eager)
    t0 = time.time()
    res = slam.run(verbose=False)
    out["outback"] = _summary(slam, res)
    out["outback"]["wall_s"] = time.time() - t0
    del slam
    for seed in seeds[1:]:
        fc.reset_launch_counts()
        slam, _ = _outback(eager, seed)
        out[f"outback_{seed}"] = _summary(slam, slam.run(verbose=False))
        del slam
    out["idle"] = _idle_window(eager)
    if stress:
        import chip_smoke
        from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
        cfg = chip_smoke.stress_config(True)
        fc.reset_launch_counts()
        slam = _system(cfg, SyntheticDataset(cfg), eager)
        out["stress"] = _summary(slam, slam.run(verbose=False))
        out["stress"]["track_counts"] = slam.track_counts()
        del slam
    if scale:
        from mipsfusion_tpu_torch.config import load_config
        from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
        cwd = os.getcwd()
        os.chdir(os.path.abspath(checkout))
        try:
            cfg = load_config("configs/synthetic/snake_fast.yaml")
        finally:
            os.chdir(cwd)
        cfg["data"]["output"] = None
        fc.reset_launch_counts()
        slam = _system(cfg, SyntheticDataset(cfg), eager)
        out["scale"] = _summary(slam, slam.run(verbose=False))
    print(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("checkout")
    r.add_argument("out")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    st = sub.add_parser("stages")
    st.add_argument("checkout")
    st.add_argument("--scale", action="store_true")
    st.add_argument("--eager", action="store_true")
    st.add_argument("--torch-adam", action="store_true")
    st.add_argument("--seeds", default="0",
                    help="comma-separated outback seeds, the first profiled")
    st.add_argument("--stress", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args.checkout, args.out)
    elif args.cmd == "stages":
        stages(args.checkout, args.scale, args.eager, args.torch_adam,
               tuple(int(x) for x in args.seeds.split(",")), args.stress)
    else:
        compare(args.a, args.b)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two checkouts of the PyTorch port on the same card: K0's, K1's and K4's
outputs on fixed flagship inputs, where their bits differ, and the
wrappers' host time a call.

    python3 tools/torch_tree_compare.py run <checkout> <out.npz>
    python3 tools/torch_tree_compare.py compare <a.npz> <b.npz>

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
"""

import argparse
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("checkout")
    r.add_argument("out")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args.checkout, args.out)
    else:
        compare(args.a, args.b)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K0's split of the SMs across its roles, timed on the card: the plan
(``FieldShape.encode_plan``, split by weighted tap reads) against the split
by the plain count of taps and against the plan with blocks moved to and
from the CP role.

    python3 tools/k0_plans.py [--out FILE.json]

At every shape of the kernels' table and at the sizes of ``chip_smoke.py``'s
K0 labels (the BA batch on uniform points, the BA's ray-ordered points,
786,432 uniform points), each plan's blocks go to the entry point with the
same inputs, its output is held to the wrapper's bits, and its device time
a call (``chip_smoke._time_ms``) is printed beside the bound. The plans are
timed in the order given, then again in reverse, so a drift of the card's
clock shows as a difference between a plan's two readings. Needs the card.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = {"flag": (195_000, (2600, 75)), "cp": (55_536, (1424, 39)),
         "fcl": (195_000, (2600, 75))}
MOVES = (8, -8)                  # blocks moved to (from) the CP role


def _moved(blocks, d: int) -> tuple:
    """The blocks with d moved to the CP role from the scale roles in turn
    (d < 0: from it to them)."""
    out = list(blocks)
    scales = [r for r in range(3) if out[r] > 0]
    for i in range(abs(d)):
        r, step = scales[i % len(scales)], (1 if d > 0 else -1)
        out[r] -= step
        out[3] += step
    return tuple(out)


def plans(shape, n_sm: int) -> dict:
    from mipsfusion_tpu_torch.ops import _build
    plan = shape.encode_plan(n_sm).blocks
    out = {"plan": plan, "taps": _build.split_blocks(n_sm, shape.encode_taps())}
    for d in MOVES:
        out[f"cp{d:+d}"] = _moved(plan, d)
    return out


def run(out_path=None):
    import torch
    import chip_smoke as cs
    from mipsfusion_tpu_torch.ops import _build
    from mipsfusion_tpu_torch.ops import triplane_cuda as tc
    if not torch.cuda.is_available():
        raise SystemExit("k0_plans: needs a CUDA device")
    dev = torch.device("cuda")
    n_sm = _build.sm_count(dev)
    rows = []
    for name, (n_ba, rays) in SIZES.items():
        planes = cs.field_params(name, 0, dev)["planes"]
        ns = sum(k.startswith("s") for k in planes)
        shape = _build.kernel_shape(planes, ns)
        variants = plans(shape, n_sm)
        fn = shape.fn("encode_forward")
        for label, xx in (("ba", cs.test_points(n_ba, 1, dev)),
                          ("rays", cs.ray_points(*rays, 8, dev)),
                          ("786k", cs.test_points(786_432, 14, dev))):
            xr = xx.T.contiguous()
            n = xr.shape[0]
            ref = tc.encode_forward(xr, planes, ns)
            ptrs = [xr.data_ptr()] + tc.plane_ptrs(planes, shape)
            out = torch.empty_like(ref)

            def call(blocks):
                _build.check(fn(*ptrs, n, out.data_ptr(), *blocks,
                                _build.stream(xr.device)), "encode_forward")

            ms = {v: [] for v in variants}
            for order in (list(variants), list(reversed(variants))):
                for v in order:
                    call(variants[v])
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise SystemExit(f"{name}:{label} plan {v}: bits "
                                         "differ from the wrapper's")
                    ms[v].append(cs._time_ms(lambda: call(variants[v])))
            b_ms, b_by = cs.bound("encode_forward", n, shape)
            for v, blocks in variants.items():
                rows.append({"shape": name, "label": label, "n": n,
                             "plan": v, "blocks": list(blocks), "ms": ms[v],
                             "bound_ms": b_ms, "bound_by": b_by})
                print(f"k0 {name}:{label} N={n} {v:5s} {list(blocks)} "
                      + " ".join(f"{t:.4f}" for t in ms[v])
                      + f" ms (bound {b_ms:.4f}, {b_by})", flush=True)
            del xx, xr, ref, out
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    run(ap.parse_args(argv).out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

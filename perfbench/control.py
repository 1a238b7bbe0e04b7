#!/usr/bin/env python3
"""The control of the benchmark's correctness check, and the readings its
limits are set from.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 8 [--out perfbench/out/control.jsonl]

For each seed: one session of the cell as ``run.py`` makes it (set-up,
warm lap, a short window with the same checked calls), then the checked
calls run by the plain reference twice: in float32 with TF32 off (the
reference) and with its products in TF32 (the control, the precision
below the configuration's float32). Printed per seed, one JSON line:
the program's numbers against the reference (the lower readings) and the
control's numbers against the reference (the upper readings), each with
the verdict at the cell's limits. The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [ROOT, HERE]
    import run
    from harness import check
    from mipsfusion_tpu_torch.ops import _build
    _build.build()
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = run.resolve(bench, args.workload)
    conf, traffic = cell["config"], cell["traffic"]
    cfg = conf["config"]
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        sess = run.open_session(cell, seed, dev)
        snaps = sess.snapshots
        sess.warm(int(traffic["warm_frames"]))
        win = sess.window(args.seconds)
        torch.cuda.synchronize(dev)
        run.release(sess)
        ref = check.reference_outputs(snaps, cfg, sess.stream)
        ctl = check.reference_outputs(snaps, cfg, sess.stream, tf32=True)
        line = {"workload": args.workload, "seed": seed,
                "frames": len(win["frames"]),
                "seconds": round(time.time() - t0, 1)}
        for side, outs in (("program", check.program_outputs(snaps)),
                           ("control", ctl)):
            res = check.compare(snaps, outs, ref)
            res["correct"], res["checks"] = check.verdict(
                res["numbers"], conf["limits"], conf["check"]["required"],
                res["calls"])
            line[side] = res
        print(json.dumps(line))
        sys.stdout.flush()
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del sess, snaps, ref, ctl
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

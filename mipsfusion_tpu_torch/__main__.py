"""Command line: run the port's SLAM system on a config.

    python3 -m mipsfusion_tpu_torch --config configs/synthetic/orbit.yaml \
        [--n_frames N] [--resume <output>/<exp>/ckpt_<frame>] \
        [--profile trace.json] [--device cuda|cpu]

The counterpart of the JAX package's ``main.py``. It runs on the card
unless ``--device cpu`` is given. Output goes to
``<data.output>/<data.exp_name>/``: ``ate_*.txt``, ``traj_*.txt`` (TUM),
``traj_*.png`` and ``render_*.png`` at ``mesh.vis``, ``ckpt_<frame>`` at
``mesh.ckpt_freq``, ``mesh_<frame>.ply`` at ``mesh.mesh_freq``, and at
the end ``ckpt_final`` and ``mesh_final.ply``. ``--profile`` writes a
``torch.profiler`` Chrome trace of the run. The line before the last
gives the wall seconds of the start (imports, config, dataset, system),
the frame loop and the final checkpoint and mesh; the last line printed is
``ATE RMSE: <m> m | <fps> FPS``.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python3 -m mipsfusion_tpu_torch",
        description="MIPSFusion port: neural RGB-D SLAM with PyTorch/CUDA")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to config yaml file")
    parser.add_argument("--n_frames", type=int, default=None,
                        help="Optionally cap the number of frames")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint dir to resume from")
    parser.add_argument("--profile", type=str, default=None,
                        help="Write a torch.profiler Chrome trace (json) "
                             "to this path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    t_start = time.time()

    from .config import load_config
    from .device import resolve_device
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    out = cfg.get("data", {}).get("output")
    if out:
        os.makedirs(os.path.join(out, cfg["data"].get("exp_name", "exp")),
                    exist_ok=True)

    import torch
    seed = cfg.get("seed", 0)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    from .slam.system import MIPSFusionTorch
    slam = MIPSFusionTorch(cfg, device=device)
    start = 0
    if args.resume:
        start = slam.resume_from(args.resume)
        print(f"resumed from {args.resume} at frame {start}")
    t_run = time.time()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if slam.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            results = slam.run(n_frames=args.n_frames, start=start)
        prof.export_chrome_trace(args.profile)
    else:
        results = slam.run(n_frames=args.n_frames, start=start)
    n_run = (args.n_frames or slam.dataset.num_frames) - start
    print("wall: start %.1f s | loop %.1f s (%d frames) | final checkpoint "
          "%.1f s | final mesh %.1f s | run %.1f s" % (
              t_run - t_start, n_run / results["fps"], n_run,
              results.get("final_checkpoint_s", 0.0),
              results.get("final_mesh_s", 0.0), time.time() - t_run))
    print("ATE RMSE: %.4f m | %.2f FPS" % (
        results["absolute_translational_error.rmse"], results["fps"]))


if __name__ == "__main__":
    main()

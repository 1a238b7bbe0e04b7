"""ATE of a TUM-format trajectory against a ground truth.

    python3 -m mipsfusion_tpu_torch.tools.eval_ate gt.txt est.txt \
        [--offset 0.0] [--max_difference 0.02] [--plot out.png]

The counterpart of the JAX package's ``tools/eval_ate.py`` (the
reference's ``tools/eval_ate.py``): reads TUM lines (``t tx ty tz qx qy
qz qw``; ``#`` comments, commas allowed), associates the timestamps
greedily by closest match within ``max_difference`` after adding
``offset`` to the estimate's, aligns the estimate by Horn's method and
prints the translational error statistics (``eval/ate.evaluate_ate``),
one ``key: value`` a line. ``--plot`` writes the top-down (x, z) plot of
both trajectories as a PNG (``slam/logger.plot_traj``: ground truth
black, estimate blue).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..eval.ate import evaluate_ate


def read_tum(path: str) -> Dict[float, List[float]]:
    """Timestamp -> [tx ty tz qx qy qz qw] of each TUM line."""
    data = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) >= 8:
                data[vals[0]] = vals[1:8]
    return data


def associate(first: Dict, second: Dict, offset: float = 0.0,
              max_difference: float = 0.02) -> List[Tuple[float, float]]:
    """Greedy closest-timestamp matching (ref eval_ate.py:35-65): the
    candidate pairs closer than max_difference, taken in order of their
    distance, each timestamp used once; sorted."""
    first_keys = set(first)
    second_keys = set(second)
    potential = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first_keys for b in second_keys
        if abs(a - (b + offset)) < max_difference)
    matches = []
    for _, a, b in potential:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def matched_translations(gt_file: str, est_file: str, offset: float = 0.0,
                         max_difference: float = 0.02):
    """(gt [M, 3], est [M, 3]) translations of the associated pairs."""
    gt = read_tum(gt_file)
    est = read_tum(est_file)
    matches = associate(gt, est, offset, max_difference)
    gt_t = np.array([gt[a][:3] for a, _ in matches]).reshape(-1, 3)
    est_t = np.array([est[b][:3] for _, b in matches]).reshape(-1, 3)
    return gt_t, est_t


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python3 -m mipsfusion_tpu_torch.tools.eval_ate",
        description="ATE of a TUM trajectory against a ground truth")
    parser.add_argument("gt_file")
    parser.add_argument("est_file")
    parser.add_argument("--offset", type=float, default=0.0)
    parser.add_argument("--max_difference", type=float, default=0.02)
    parser.add_argument("--plot", type=str, default=None)
    args = parser.parse_args(argv)

    gt_t, est_t = matched_translations(args.gt_file, args.est_file,
                                       args.offset, args.max_difference)
    if len(gt_t) < 2:
        sys.exit("not enough matched timestamps")
    results = evaluate_ate(gt_t, est_t)
    for k, v in results.items():
        print(f"{k}: {v}")
    if args.plot:
        from ..slam.logger import plot_traj

        def poses(t):
            p = np.tile(np.eye(4), (len(t), 1, 1))
            p[:, :3, 3] = t
            return p

        plot_traj(poses(gt_t), poses(est_t), args.plot)
        print(f"plot -> {args.plot}")
    return results


if __name__ == "__main__":
    main()

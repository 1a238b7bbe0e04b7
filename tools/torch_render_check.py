"""Hold the port's batched frame rendering to its one-frame-at-a-time
rendering on the card, bit for bit, and time both.

    python3 tools/torch_render_check.py

``SyntheticDataset.prerender`` sphere-traces 16 frames as one batch of
rays; ``packed`` of a frame not cached renders it alone. Every op after a
frame's rotation is per ray, so both must give the same bits. Checked on
200 frames of the flagship outback, 96 frames of the scale profile's
snake in the tiled room, and 48 sweep frames with sensor noise. Prints one
line a scene and exits non-zero if any frame differs. Run it from the
repository root on a machine with a CUDA device.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    from chip_smoke import STRESS_NOISE, _load_yaml
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    ok = True
    for yaml, n, noise in (("configs/synthetic/outback.yaml", 200, None),
                           ("configs/synthetic/snake_fast.yaml", 96, None),
                           ("configs/synthetic/outback.yaml", 48,
                            STRESS_NOISE)):
        cfg = _load_yaml(yaml)
        if noise:
            cfg["synthetic"].update(trajectory="sweep", noise=dict(noise))
        one = SyntheticDataset(cfg, n_frames=n)
        batched = SyntheticDataset(cfg, n_frames=n)
        torch.cuda.synchronize()
        t0 = time.time()
        frames = [one.packed(i) for i in range(n)]
        torch.cuda.synchronize()
        t1 = time.time()
        batched.prerender(range(n))
        torch.cuda.synchronize()
        t2 = time.time()
        same = all(torch.equal(f, batched.packed(i))
                   for i, f in enumerate(frames))
        ok &= same
        print(f"render bits {yaml} noise={bool(noise)} {n} frames: batched "
              f"== single {same}  single {t1 - t0:.2f} s  batched "
              f"{t2 - t1:.2f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

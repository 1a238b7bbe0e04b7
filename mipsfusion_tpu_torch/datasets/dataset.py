"""Dataset dispatch: the port of ``mipsfusion_tpu/datasets/dataset.py``'s
``get_dataset``.

The synthetic scene is the port's ``SyntheticDataset``. The file readers
(Replica, ScanNet, FastCaMo) decode PNG and JPG frames, and the card's
machine has no image decoder (no cv2, no PIL), so they are not ported yet
and raise.
"""

from __future__ import annotations

from typing import Dict


def get_dataset(config: Dict, device=None):
    """The dataset ``config["dataset"]`` names, on ``device`` (None: the
    card; ``"cpu"`` for a CPU run). The synthetic scene reads its whole
    ``synthetic:`` block (frames, trajectory, span, props, noise,
    ``noise_seed``), as the JAX package's does."""
    name = config["dataset"]
    if name == "synthetic":
        from .synthetic import SyntheticDataset
        return SyntheticDataset(config, device=device)
    if name in ("replica", "scannet", "fastcamo_synth", "fastcamo_large"):
        raise NotImplementedError(
            f"dataset {name!r}: the file readers decode PNG/JPG frames and "
            "need an image decoder (cv2), which the GPU machine lacks; the "
            "port runs the synthetic scene")
    raise ValueError(f"unknown dataset '{name}'")

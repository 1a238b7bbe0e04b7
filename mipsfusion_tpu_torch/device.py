"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card
    (``cuda``). Without CUDA, None raises: a CPU run asks for it with
    ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")

"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (``cuda``).
    Without CUDA, the card raises: a CPU run asks for it with
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device=\"cpu\" (--device cpu on the command line) to run on "
            "the CPU")
    return dev

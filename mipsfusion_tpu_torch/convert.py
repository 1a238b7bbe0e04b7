"""Field parameters between the JAX package's tree and the port's Field.

The JAX tree is ``{"planes": {"s0": [3, R0, R0, F], "s1": .., "cp": [3,
Rcp, C]}, "decoder": {layer: {"w": [in, out], "b": [out]}}}`` with one
``s<i>`` per plane scale (the flagship's [32, 64] x F4 + CP 384 x 40; a
third scale ``s2`` in the CP profile and the FastCaMo-large family),
numpy leaves; the HashGrid field's tree is ``{"hash": [L, T, F],
"decoder": ...}``. The port keeps the same layouts, so conversion copies
every leaf it finds and checks the structure.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.decoder import LAYERS
from .models.scene_rep import Field


def params_from_jax(tree: Dict, device=None) -> Field:
    """A Field holding copies of the JAX tree's (numpy) leaves."""
    if set(tree) not in ({"planes", "decoder"}, {"hash", "decoder"}):
        raise ValueError("expected planes + decoder or hash + decoder, got "
                         f"{sorted(tree)}")
    if set(tree["decoder"]) != set(LAYERS):
        raise ValueError(f"decoder layers {sorted(tree['decoder'])}")

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    enc = ({"hash": t(tree["hash"])} if "hash" in tree else
           {"planes": {k: t(v) for k, v in tree["planes"].items()}})
    return Field({**enc, "decoder": {n: {"w": t(d["w"]), "b": t(d["b"])}
                                     for n, d in tree["decoder"].items()}})


def params_to_numpy(field: Field) -> Dict:
    """The Field's parameters as a JAX-layout tree of numpy arrays."""
    p = field.params(detach=True)
    enc = ({"hash": p["hash"].cpu().numpy()} if "hash" in p else
           {"planes": {k: v.cpu().numpy() for k, v in p["planes"].items()}})
    return {**enc, "decoder": {n: {k: t.cpu().numpy() for k, t in d.items()}
                               for n, d in p["decoder"].items()}}

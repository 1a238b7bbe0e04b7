"""The work of the port's Triplane + CP encoding kernels, a share of each
field kernel kind of ``harness/work.py``: K0/K1's encode (the plane and CP
taps), K3 (``plane_backward``: the table gradient) and K4
(``x_backward_add``: the gradient to the points, with the PE gradient's
add). A frozen copy of the encoding's terms of the port's
``chip_smoke._flops_pt`` / ``_bytes``, written over the configuration's
widths.
"""

from __future__ import annotations

from typing import Dict, Tuple


def dims(cfg: Dict) -> Dict:
    """The encoding's widths: scales S of F features, C CP components,
    the embedding's width E, the plane and CP resolutions."""
    g = cfg["grid"]
    S = len(g["tri_resolutions"])
    F = int(g["tri_features"])
    C = int(g["cp_components"]) if g.get("cp_resolution") else 0
    return {"S": S, "F": F, "C": C, "E": S * F + C,
            "res": [int(r) for r in g["tri_resolutions"]],
            "cp_res": int(g.get("cp_resolution") or 0)}


def work(kind: str, d: Dict) -> Tuple[int, int, int]:
    """(FLOPs a point outside the tensor cores, bytes a point, bytes a
    launch) of the encoding's share of kernel kind ``kind``."""
    S, C = d["S"], d["C"]
    E4 = 4 * d["E"]
    table = 4 * (sum(3 * r * r * d["F"] for r in d["res"])
                 + 3 * d["cp_res"] * C)
    cp = 4 * 3 * d["cp_res"] * C
    encode = (96 * S + 11 * C, 0, table)
    return {"field_forward": encode,
            "field_forward_sdf": encode,
            "decoder_backward": (0, 0, 0),
            "decoder_backward_go": (0, 0, 0),
            "plane_backward": (60 * S + 21 * C, 12 + E4, table + cp),
            "x_backward_add": (120 * S + 20 * C + 3, 12 + E4 + 12 + 12,
                               table)}[kind]

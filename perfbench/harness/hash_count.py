"""The work of the multiresolution hash encoding (Instant-NGP, Mueller et
al. 2022, section 3), a share of each field kernel kind of
``harness/work.py``, written from the encoding's definition, so it reads
the same work whatever implements it: the encode maps to
``field_forward`` and ``field_forward_sdf``, the table gradient to
``plane_backward``, the point gradient to ``x_backward_add``.

It has the interface of a count (``dims``, ``work``), and ``least_s``,
the least seconds of a traced part's hash work by kinds, for the hash
kernels' roofline readers.

Per point and level: the corner coordinates and axis weights 12 FLOPs
(x s + 0.5, the fraction, 1 - f on 3 axes), the 8 corner weights 16; the
encode blends 8 corners x 2 features (32: 60 in all), the table gradient
forms and scales each corner's share (32: 60), the point gradient forms
g . feature at 8 corners (24), each axis's two sides of 4 weighted terms
(72) and the level's d_x (9): 117, and d_x_pe's add once a point. Bytes a
point: x in, the embed or its cotangent, d_x_pe and d_x for the point
gradient; bytes a launch: the encode and the point gradient read once
the rows a launch can address (res^3 on a dense level, all T on a hashed
one), the table gradient writes the whole table once. Float operations
only; the hash's integer arithmetic is not counted.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

from harness import work as wk
from reference.encodings import HashGrid as hg

LEVELS = hg.LEVELS
FEATURES = hg.FEATURES
KINDS_FORWARD = ("field_forward", "field_forward_sdf")
KINDS_BACKWARD = ("plane_backward", "x_backward_add")


def dims(cfg: Dict) -> Dict:
    """The encoding's widths: L levels of F features, T rows a level, the
    embedding's width E, and the rows of each level a point can address
    (``rows``: res^3 where the level is dense, T where it is hashed)."""
    T = 1 << int(cfg["grid"].get("hash_size", 19))
    res = [math.ceil(hg.level_scale(level)) + 1 for level in range(LEVELS)]
    return {"L": LEVELS, "F": FEATURES, "T": T, "E": LEVELS * FEATURES,
            "rows": [min(r ** 3, T) for r in res]}


def work(kind: str, d: Dict) -> Tuple[int, int, int]:
    """(FLOPs a point outside the tensor cores, bytes a point, bytes a
    launch) of the encoding's share of kernel kind ``kind``."""
    L, E4 = d["L"], 4 * d["E"]
    table = 4 * sum(d["rows"]) * d["F"]
    grad = 4 * d["L"] * d["T"] * d["F"]
    encode = (60 * L, 12 + E4, table)
    return {"field_forward": encode,
            "field_forward_sdf": encode,
            "decoder_backward": (0, 0, 0),
            "decoder_backward_go": (0, 0, 0),
            "plane_backward": (60 * L, 12 + E4, grad),
            "x_backward_add": (117 * L + 3, 12 + E4 + 12 + 12, table)}[kind]



def least_s(cfg: Dict, calls: Dict[str, int],
            kinds: Iterable[str]) -> Optional[float]:
    """The least seconds the hash encoding's share of ``kinds`` needs for
    the stage calls ``calls`` (stage -> calls; the budgets'
    ``harness/work.stage_launches``): per launch the larger of its FLOPs at the
    float32 peak and its bytes at the HBM peak. None where the field is
    not a hash grid or no such launch was made."""
    if cfg["grid"].get("enc", "HashGrid") != "HashGrid":
        return None
    d = dims(cfg)
    total = 0.0
    for stage, n_calls in calls.items():
        for kind, launches, pts in wk.stage_launches(cfg).get(stage, ()):
            if kind not in kinds:
                continue
            flops, per_pt, fixed = work(kind, d)
            total += n_calls * launches * max(
                flops * pts / wk.PEAK_OTHER,
                (per_pt * pts + fixed) / wk.PEAK_BYTES)
    return total if total > 0 else None

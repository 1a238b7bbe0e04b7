"""The field's work, counted by the benchmark: operations and bytes per
point of each kernel kind, the points each stage call gives each kind
(from the configuration's budgets), and the card's published peaks.

A kind's work is the decoder's share (its products and the bytes of the
points, embeddings, outputs and weights; here, for every field) plus the
encoding's (``counts/<enc>.py`` for the configuration's ``grid.enc``: its
widths, and its share of each kind as other FLOPs, bytes a point and
bytes a launch). A field whose encoding has no count is not counted.
Both shares are a frozen copy of the port's ``chip_smoke._flops_pt`` /
``_bytes`` (K0-K4 with the 8-band PE and the 5-class decoder), written
over the configuration's widths. The peaks are fixed data: NVIDIA's H100
SXM figures, dense. Products run at the TF32 tensor-core rate, which no
float32-accurate implementation on this card exceeds, so the least time
is a bound for any kernel that computes the same products.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, List, Optional, Tuple

from reference import encodings

# NVIDIA H100 SXM, dense (data sheet)
PEAK_PRODUCTS = 495e12     # FLOP/s, TF32 on the tensor cores
PEAK_OTHER = 67e12         # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # B/s, HBM3

KINDS = ("field_forward", "field_forward_sdf", "decoder_backward",
         "decoder_backward_go", "plane_backward", "x_backward_add")


COUNTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "counts")


def count_of(name: str):
    """The work count of encoding ``name`` (``counts/<name>.py``), or None
    where the benchmark has none."""
    if not os.path.exists(os.path.join(COUNTS, f"{name}.py")):
        return None
    return importlib.import_module(f"{__package__}.counts.{name}")


def field_dims(cfg: Dict) -> Dict:
    """The widths the counts need, from a system configuration: the
    decoder's, and the encoding's from its count (with ``enc``, its
    name)."""
    enc = encodings.name_of(cfg)
    dec = cfg["decoder"]
    pe = 3 + 3 * 2 * int(cfg["pos"]["n_bins"])
    hid = int(dec["hidden_dim"])
    geo = int(dec["geo_feat_dim"])
    rgb = int(dec["hidden_dim_color"])
    return {**count_of(enc).dims(cfg), "enc": enc, "pe": pe, "hid": hid,
            "geo": geo, "rgb": rgb, "branch": hid, "n_class": 5}


def _layers(d: Dict) -> Dict[str, Tuple[int, int]]:
    return {"trunk0": (d["pe"], d["hid"]),
            "trunk1": (d["hid"], d["geo"] + d["rgb"]),
            "rgb": (d["rgb"] + d["pe"], 3),
            "sdf0": (d["geo"] + d["E"], d["branch"]),
            "sdf1": (d["branch"], d["n_class"])}


def n_weights(d: Dict) -> int:
    """Decoder parameters (weights and biases)."""
    return sum((fi + 1) * fo for fi, fo in _layers(d).values())


def flops_per_point(kind: str, d: Dict) -> Tuple[int, int]:
    """(FLOPs in the decoder's matrix products, other FLOPs) a point."""
    L = _layers(d)
    macs = {k: fi * fo for k, (fi, fo) in L.items()}
    full = sum(macs.values())
    sdf_only = (macs["trunk0"] + d["hid"] * d["geo"] + macs["sdf0"]
                + macs["sdf1"])
    recompute = full - macs["rgb"]
    wgrad = n_weights(d)
    products = {"field_forward": 2 * full,
                "field_forward_sdf": 2 * sdf_only,
                "decoder_backward": 2 * (recompute + full + wgrad),
                "decoder_backward_go": 2 * (recompute + full),
                "plane_backward": 0, "x_backward_add": 0}[kind]
    return products, count_of(d["enc"]).work(kind, d)[0]


def bytes_per_point(kind: str, d: Dict) -> Tuple[int, int]:
    """(bytes a point, bytes a launch): each input read once, each output
    written once."""
    E4 = 4 * d["E"]
    weights = 4 * n_weights(d)
    out = 4 * (5 + d["n_class"])
    pt, launch = {"field_forward": (12 + out + E4, weights),
                  "field_forward_sdf": (12 + 4, weights),
                  "decoder_backward": (12 + out + E4 + 12 + E4, 2 * weights),
                  "decoder_backward_go": (12 + out + E4 + 12 + E4, weights),
                  "plane_backward": (0, 0),
                  "x_backward_add": (0, 0)}[kind]
    _, enc_pt, enc_launch = count_of(d["enc"]).work(kind, d)
    return pt + enc_pt, launch + enc_launch


def samples_per_ray(training: Dict) -> int:
    return int(training["n_samples_d"]) + int(training["n_range_d"])


def stage_launches(cfg: Dict) -> Dict[str, List[Tuple[str, int, int]]]:
    """Per stage, the field launches one call makes: (kind, launches,
    points a launch), from the configuration's budgets.

    - ``ba``: ``iters`` x (``sample`` + ``pixels_cur``) rays x samples a
      ray, forward, backward with weight gradients, planes and points;
    - ``refine``: the same on ``sample`` rays;
    - ``track``: ``iter_RO`` sdf-only queries of particles x RO pixels,
      then ``iter`` GO steps on ``tracking.sample`` rays (no weight
      gradients, no planes);
    - ``init_chunk``: ``first_iters_chunk`` fit steps on ``sample`` rays
      (no pose, so no point gradient);
    - ``switch_ba``: ``switch.map_num`` pose-only steps on ``sample``
      rays."""
    m, t, tr = cfg["mapping"], cfg["tracking"], cfg["training"]
    s_map = samples_per_ray(tr)
    s_track = int(t.get("n_samples_d", tr["n_samples_d"])) + int(
        t.get("n_range_d", tr["n_range_d"]))
    full = ("field_forward", "decoder_backward", "plane_backward",
            "x_backward_add")
    ba_pts = (int(m["sample"]) + int(m["pixels_cur"])) * s_map
    fit_pts = int(m["sample"]) * s_map
    ro_pts = (int(t["RO"]["particle_size"]) * int(t["RO"]["n_rows"])
              * int(t["RO"]["n_cols"]))
    go_pts = int(t["sample"]) * s_track
    it = int(m["iters"])
    go = int(t["iter"])
    return {
        "ba": [(k, it, ba_pts) for k in full],
        "refine": [(k, it, fit_pts) for k in full],
        "track": [("field_forward_sdf", int(t["iter_RO"]), ro_pts)]
        + [(k, go, go_pts) for k in ("field_forward", "decoder_backward_go",
                                     "x_backward_add")],
        "init_chunk": [(k, int(m["first_iters_chunk"]), fit_pts)
                       for k in full[:3]],
        "switch_ba": [(k, int(t["switch"]["map_num"]), fit_pts)
                      for k in ("field_forward", "decoder_backward_go",
                                "x_backward_add")],
    }


def least_times(cfg: Dict, calls: Dict[str, int]
                ) -> Optional[Dict[str, float]]:
    """The least seconds the field work of ``calls`` (stage -> calls)
    needs on the card: ``arith`` (operations at peak), ``bytes``, and
    ``bound``, the sum over launches of the larger of the two, with the
    operations and bytes counted; None where the field's encoding has no
    count."""
    if count_of(encodings.name_of(cfg)) is None:
        return None
    d = field_dims(cfg)
    table = stage_launches(cfg)
    arith = mem = bound = ops = nbytes = 0.0
    for stage, n_calls in calls.items():
        for kind, launches, pts in table.get(stage, ()):
            n = n_calls * launches
            mm, rest = flops_per_point(kind, d)
            per_pt, fixed = bytes_per_point(kind, d)
            a = (mm / PEAK_PRODUCTS + rest / PEAK_OTHER) * pts
            b = (per_pt * pts + fixed) / PEAK_BYTES
            arith += n * a
            mem += n * b
            bound += n * max(a, b)
            ops += n * (mm + rest) * pts
            nbytes += n * (per_pt * pts + fixed)
    return {"arith": arith, "bytes": mem, "bound": bound, "flops": ops,
            "bytes_moved": nbytes}

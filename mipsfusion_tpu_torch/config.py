"""Config: a YAML loader without PyYAML, and the flagship configurations.

``load_config``, ``update_recursive`` and ``apply_overrides`` are the port
of ``mipsfusion_tpu/config.py``. The card's machine has no PyYAML, so
``load_config`` parses the subset of YAML that ``configs/base.yaml`` and
``configs/synthetic/*.yaml`` use: nested block mappings (spaces only),
``#`` comments, plain and quoted scalars (ints, floats with a dot and an
optional signed exponent, ``True``/``False``, null) and one-line flow
lists, nested ones included. Scalars resolve as PyYAML's YAML 1.1 rules
resolve them. Anything outside the subset (block sequences, flow
mappings, anchors, tags, block scalars, multi-line values, duplicate keys,
a numeric-looking plain scalar those rules would read as a string, such as
``1e-5``) raises, so a config is never misread. ``inherit_from`` resolves
as the JAX loader resolves it.

``FLAGSHIP_ORBIT`` is ``configs/base.yaml`` merged with
``configs/synthetic/orbit.yaml`` and ``FLAGSHIP_OUTBACK`` the same base
merged with ``configs/synthetic/outback.yaml``, written out in Python.
``tests/test_torch_slice.py`` and ``tests/test_torch_multi.py`` hold them
equal to the merged yamls.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# PyYAML's implicit resolvers (YAML 1.1) for the scalar types the configs use
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)"
                    r"(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
# plain scalars that start like a number but that the rules above do not
# read as one (1e-5, 0x1f, 017, 1:30): PyYAML would return a string
_NUMERIC_LOOKING = re.compile(r"[-+]?\.?[0-9]")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+|$)(.*)$")


class YamlSubsetError(ValueError):
    """A config uses YAML outside the subset ``load_config`` reads."""


def _strip_comment(text: str, where: str) -> str:
    """``text`` without a trailing ``# comment`` (a ``#`` at the start or
    after whitespace, outside quotes)."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    if quote:
        raise YamlSubsetError(f"{where}: unterminated quote")
    return text.rstrip()


def _quoted(text: str, where: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise YamlSubsetError(f"{where}: bad quoted scalar {text!r}")
    body = text[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YamlSubsetError(f"{where}: bad quoted scalar {text!r}")
        return body.replace("''", "'")
    out, i = [], 0
    esc = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
    while i < len(body):
        c = body[i]
        if c == '"':
            raise YamlSubsetError(f"{where}: bad quoted scalar {text!r}")
        if c == "\\":
            if i + 1 >= len(body) or body[i + 1] not in esc:
                raise YamlSubsetError(f"{where}: escape outside the subset "
                                      f"in {text!r}")
            out.append(esc[body[i + 1]])
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text[:1] in "\"'":
        return _quoted(text, where)
    if not text or text in _NULL:
        return None
    if text[0] in "&*!|>%@`{}[],?-" and text not in _SPECIAL_FLOAT \
            and not _NUMERIC_LOOKING.match(text):
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML "
                              "subset (anchor, alias, tag, block scalar, "
                              "flow mapping or block sequence)")
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlSubsetError(f"{where}: plain scalar {text!r} holds ': ' "
                              "or ' #'")
    if text in _BOOL:
        return _BOOL[text]
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _NUMERIC_LOOKING.match(text):
        raise YamlSubsetError(f"{where}: {text!r} looks like a number but "
                              "YAML 1.1 would read it as a string; write it "
                              "with a dot and a signed exponent (1.0e-5) or "
                              "quote it")
    return text


def _flow_list(text: str, where: str) -> List[Any]:
    """A one-line flow list ``[a, "b", [c, d]]``."""
    pos = 0

    def parse_list() -> List[Any]:
        nonlocal pos
        assert text[pos] == "["
        pos += 1
        items: List[Any] = []
        expect_item = True
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise YamlSubsetError(f"{where}: unterminated flow list")
            c = text[pos]
            if c == "]":
                if expect_item and items:
                    raise YamlSubsetError(f"{where}: trailing comma in "
                                          f"{text!r}")
                pos += 1
                return items
            if not expect_item:
                if c != ",":
                    raise YamlSubsetError(f"{where}: bad flow list {text!r}")
                pos += 1
                expect_item = True
                continue
            if c == "[":
                items.append(parse_list())
            elif c in "\"'":
                end = pos + 1
                while True:
                    end = text.find(c, end)
                    if end < 0:
                        raise YamlSubsetError(f"{where}: unterminated quote")
                    if c == "'" and text[end + 1:end + 2] == "'":
                        end += 2
                        continue
                    if c == '"' and text[end - 1] == "\\":
                        end += 1
                        continue
                    break
                items.append(_quoted(text[pos:end + 1], where))
                pos = end + 1
            elif c in "{,":
                raise YamlSubsetError(f"{where}: flow mapping or empty item "
                                      f"in {text!r}")
            else:
                end = pos
                while end < len(text) and text[end] not in ",]":
                    end += 1
                items.append(_scalar(text[pos:end], where))
                pos = end
            expect_item = False

    out = parse_list()
    if text[pos:].strip():
        raise YamlSubsetError(f"{where}: text after the flow list in "
                              f"{text!r}")
    return out


def _value(text: str, where: str) -> Any:
    return _flow_list(text, where) if text.startswith("[") else \
        _scalar(text, where)


def parse_yaml_subset(text: str, name: str = "<yaml>") -> Dict[str, Any]:
    """Parse a YAML document of the subset described in the module
    docstring into a dict; raise ``YamlSubsetError`` outside it."""
    lines: List[Tuple[int, int, str]] = []      # (line no, indent, content)
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{no}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"{where}: tab indentation")
        body = _strip_comment(raw, where)
        if not body.strip():
            continue
        if body.strip() in ("---", "...") or body.startswith("%"):
            raise YamlSubsetError(f"{where}: document markers and "
                                  "directives are outside the subset")
        lines.append((no, len(body) - len(body.lstrip(" ")), body.strip()))

    pos = 0

    def block(indent: int) -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(lines):
            no, ind, content = lines[pos]
            where = f"{name}:{no}"
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"{where}: unexpected indentation")
            if content.startswith("- ") or content == "-":
                raise YamlSubsetError(f"{where}: block sequences are "
                                      "outside the subset; write a flow "
                                      "list [a, b]")
            m = _KEY.match(content)
            if m is None:
                raise YamlSubsetError(f"{where}: expected 'key: value', got "
                                      f"{content!r}")
            key, rest = m.group(1), m.group(2).strip()
            if key in out:
                raise YamlSubsetError(f"{where}: duplicate key {key!r}")
            pos += 1
            if rest:
                out[key] = _value(rest, where)
                if pos < len(lines) and lines[pos][1] > indent:
                    raise YamlSubsetError(
                        f"{name}:{lines[pos][0]}: a value continues over "
                        "several lines (outside the subset)")
            elif pos < len(lines) and lines[pos][1] > indent:
                out[key] = block(lines[pos][1])
            else:
                out[key] = None
        return out

    if lines and lines[0][1] != 0:
        raise YamlSubsetError(f"{name}:{lines[0][0]}: the document must "
                              "start at column 0")
    return block(0)


def _read_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return parse_yaml_subset(f.read(), path)


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Deep-merge ``src`` into ``dst`` in place (src wins on leaves)."""
    for k, v in src.items():
        if k not in dst:
            dst[k] = {}
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            update_recursive(dst[k], v)
        else:
            dst[k] = v


def load_config(path: str,
                default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a config yaml, resolving ``inherit_from`` chains: the parent
    path is tried relative to the working directory first, then to the
    child file's directory; the child's values win on a deep merge."""
    cfg_special = _read_yaml(path)
    inherit = cfg_special.get("inherit_from")
    if inherit is not None:
        if not os.path.exists(inherit):
            candidate = os.path.join(os.path.dirname(path), inherit)
            if os.path.exists(candidate):
                inherit = candidate
        cfg = load_config(inherit, default_path)
    elif default_path is not None:
        cfg = _read_yaml(default_path)
    else:
        cfg = {}
    update_recursive(cfg, cfg_special)
    cfg.pop("inherit_from", None)
    return cfg


# the multi-device switches and the JAX system's defaults; they act only
# when the system's mesh has more than one device
PARALLEL_DEFAULTS = {"sharded_refine": True, "dp_hot_path": True}


def parallel_config(cfg: Dict[str, Any]) -> Dict[str, bool]:
    """The config's ``parallel:`` block as a mapping of bools, defaults
    filled in: ``dp_hot_path`` (ray data-parallelism in tracking, local
    BA and the first fits) and ``sharded_refine`` (every inactive submap
    refined in one step). Raises on another key or a value that is not a
    bool."""
    block = cfg.get("parallel") or {}
    if not isinstance(block, dict):
        raise ValueError(f"parallel: expected a mapping, got {block!r}")
    out = dict(PARALLEL_DEFAULTS)
    for k, v in block.items():
        if k not in out or not isinstance(v, bool):
            raise ValueError(f"parallel.{k}: {v!r}; the block takes "
                             f"{sorted(out)} as booleans")
        out[k] = v
    return out


def apply_overrides(cfg: Dict[str, Any],
                    overrides: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``cfg`` with dotted-path overrides applied, e.g.
    ``apply_overrides(cfg, {"mapping.iters": 5})``."""
    out = copy.deepcopy(cfg)
    for dotted, value in overrides.items():
        node = out
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


FLAGSHIP_ORBIT: Dict[str, Any] = {
    "dataset": "synthetic",
    "seed": 0,
    "synthetic": {
        "trajectory": "orbit",
        "n_frames": 200,
        "room_half": [3.0, 2.2, 2.5],
    },
    "data": {
        "downsample": 1,
        "sc_factor": 1.0,
        "trainskip": 1,
        "starting_frame": 0,
        "output": "output",
        "exp_name": "synthetic_orbit",
    },
    "mapping": {
        "sample": 1800,
        "pixels_cur": 800,
        "iters": 15,
        "lr_embed": 0.01,
        "lr_decoder": 0.01,
        "lr_rot": 0.001,
        "lr_trans": 0.001,
        "keyframe_every": 15,
        "map_every": 3,
        "localMLP_num": 10,
        "localMLP_max_len": [3.5, 3.5, 3.5],
        "first_iters": 500,
        "first_iters_chunk": 64,
        "optim_cur": False,
        "min_pixels_cur": 20,
        "map_accum_step": 1,
        "pose_accum_step": 5,
        "map_wait_step": 0,
        "bound": [[-4.0, 4.0], [-3.2, 3.2], [-3.5, 3.5]],
        "marching_cubes_bound": [[-4.0, 4.0], [-3.2, 3.2], [-3.5, 3.5]],
        "min_containing_ratio": 0.7,
        "min_containing_ratio_mo": 0.6,
        "min_containing_ratio_back": 0.5,
        "overlapping": {"n_rays_h": 40, "n_rays_w": 40, "min_pts": 200},
    },
    "tracking": {
        "iter": 10,
        "iter_RO": 5,
        "sample": 1000,
        "lr_rot": 0.001,
        "lr_trans": 0.001,
        "ignore_edge_W": 20,
        "ignore_edge_H": 20,
        "const_speed": True,
        "best": True,
        "wait_iters": 100,
        "switch_interval": 30,
        "pose_gate": {"rel": 6.0, "abs": 0.0},
        "motion_prior_w": 0.0,
        "drift_gate": {"thresh": 0.0},
        "RO": {
            "particle_size": 2000,
            "initial_scaling_factor": 0.04,
            "rescaling_factor": 0.5,
            "n_rows": 16,
            "n_cols": 24,
        },
        "switch": {"iter_RO": 10, "iter": 20, "lr_rot": 0.001,
                   "lr_trans": 0.001},
    },
    "sampling": {"kf_n_rays_h": 150, "kf_n_rays_w": 200,
                 "n_rays_h": 16, "n_rays_w": 24},
    "grid": {
        "enc": "Triplane",
        "tri_resolutions": [32, 64],
        "tri_features": 4,
        "cp_resolution": 384,
        "cp_components": 40,
        "hash_size": 19,
        "voxel_sdf": 0.02,
        "tcnn_encoding": True,
        "use_bound_normalize": True,
    },
    "pos": {"enc": "Frequency", "n_bins": 8},
    "decoder": {
        "geo_feat_dim": 64,
        "hidden_dim": 128,
        "num_layers": 2,
        "num_layers_color": 2,
        "hidden_dim_color": 64,
        "tcnn_network": False,
    },
    "training": {
        "rgb_weight": 1.0,
        "depth_weight": 0.1,
        "sdf_weight": 1000.0,
        "fs_weight": 10.0,
        "eikonal_weight": 0,
        "smooth_weight": 0.0,
        "smooth_pts": 64,
        "smooth_vox": 0.1,
        "smooth_margin": 0.05,
        "n_samples_d": 54,
        "range_d": 0.25,
        "n_range_d": 21,
        "n_importance": 0,
        "perturb": 1,
        "white_bkgd": False,
        "trunc": 0.1,
        "rot_rep": "quat",
        "rgb_missing": 0.0,
        "norm_factor": 1.0,
    },
    "cam": {
        "H": 240,
        "W": 320,
        "fx": 160.0,
        "fy": 160.0,
        "cx": 159.5,
        "cy": 119.5,
        "png_depth_scale": 1000.0,
        "crop_edge": 0,
        "near": 0.0,
        "far": 8.0,
        "depth_trunc": 100.0,
    },
    "mesh": {
        "resolution": 256,
        "vis": 100,
        "voxel_eval": 0.05,
        "voxel_final": 0.03,
        "ckpt_freq": 500,
        "render_color": False,
    },
}


def _merged(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge (``over`` wins on leaves), as the yaml loader does."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


# outback.yaml against orbit.yaml: the same room, camera and bound; the
# out-and-back trajectory, small submaps and the loop-closure settings
FLAGSHIP_OUTBACK: Dict[str, Any] = _merged(FLAGSHIP_ORBIT, {
    "synthetic": {"trajectory": "outback"},
    "data": {"exp_name": "synthetic_outback"},
    "mapping": {
        "keyframe_every": 10,
        "localMLP_max_len": [2.0, 2.0, 2.0],
        "localMLP_max_len_back": [2.0, 2.0, 2.0],
        "min_cr_localMLP_len": [1.8, 1.8, 1.8],
        "min_containing_ratio": 0.75,
        "min_containing_ratio_mo": 0.6,
        "min_containing_ratio_back": 0.5,
        "global_BA": {"key_edge_weight": 0.1},
    },
    "tracking": {"switch": {
        "lr_rot": 0.001, "lr_trans": 0.001, "align_threshold": 0.08,
        "including_last": 0, "min_correspondence": 2000,
        "min_trans_dist": 0.5, "map_num": 15, "iter_RO": 10, "iter": 20,
    }},
})


def flagship_orbit(**top_level) -> Dict[str, Any]:
    """A deep copy of ``FLAGSHIP_ORBIT`` with top-level keys replaced."""
    cfg = copy.deepcopy(FLAGSHIP_ORBIT)
    cfg.update(top_level)
    return cfg


def flagship_outback(**top_level) -> Dict[str, Any]:
    """A deep copy of ``FLAGSHIP_OUTBACK`` with top-level keys replaced."""
    cfg = copy.deepcopy(FLAGSHIP_OUTBACK)
    cfg.update(top_level)
    return cfg

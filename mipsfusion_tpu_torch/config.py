"""The flagship configurations written out in Python.

``FLAGSHIP_ORBIT`` is ``configs/base.yaml`` merged with
``configs/synthetic/orbit.yaml`` and ``FLAGSHIP_OUTBACK`` the same base
merged with ``configs/synthetic/outback.yaml`` (what
``mipsfusion_tpu.config.load_config`` returns for each yaml), so the port
runs without PyYAML. ``tests/test_torch_slice.py`` and
``tests/test_torch_multi.py`` hold them equal to the merged yamls.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

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

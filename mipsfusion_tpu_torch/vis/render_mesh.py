"""Offline meshes from a saved checkpoint.

    python3 -m mipsfusion_tpu_torch.vis.render_mesh --config <yaml> \
        --seq_result <output>/<exp> [--ckpt final] [--voxel_size V] \
        [--no_joint] [--device cuda|cpu]

The counterpart of the JAX package's ``vis/render_mesh.py``: it reloads
``<seq_result>/ckpt_<ckpt>`` (written by either package) and writes each
submap's mesh as ``mesh_<i>_<ckpt>.ply`` and, with two or more submaps,
the joint entropy/distance-fused mesh as ``mesh_joint_<ckpt>.ply``, each
after the small-component and unseen-face filters. It runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python3 -m mipsfusion_tpu_torch.vis.render_mesh")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--seq_result", type=str, required=True,
                        help="output dir of the SLAM run")
    parser.add_argument("--ckpt", type=str, default="final")
    parser.add_argument("--voxel_size", type=float, default=None)
    parser.add_argument("--no_joint", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch
    from ..config import load_config
    from ..device import resolve_device
    from ..mesher.mesher import (MeshConfig, Mesher,
                                 apply_visibility_filters,
                                 keyframe_occupancies, save_mesh_ply)
    from ..models import scene_rep as sr
    from ..slam.checkpoint import load_ckpt

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    ckpt_dir = os.path.join(args.seq_result, f"ckpt_{args.ckpt}")
    state, fields, _ = load_ckpt(ckpt_dir, device=dev)

    fcfg = sr.FieldConfig.from_dict(cfg)
    m = cfg["mapping"]
    if fcfg.use_bound_normalize:
        consts = sr.FieldConsts.from_bound(torch.tensor(
            m["bound"], dtype=torch.float32, device=dev))
    else:
        consts = sr.FieldConsts.from_norm_factor(torch.tensor(
            m["localMLP_max_len"], dtype=torch.float32, device=dev))

    voxel = args.voxel_size or cfg.get("mesh", {}).get("voxel_final", 0.03)
    mesher = Mesher(fcfg, consts, MeshConfig(voxel_size=voxel))
    bound = np.asarray(m.get("marching_cubes_bound", m["bound"]))

    info = state.localMLP_info.cpu().numpy()
    used = int(info[:, 0].sum())
    first_kf = state.localMLP_first_kf.cpu().numpy()
    kf_c2w = state.kf_c2w.cpu().numpy()
    anchors = kf_c2w[first_kf[:used]]

    # keyframe world poses and per-keyframe max depth for the filters
    n_kf = state.n_kf
    kf_ref = state.keyframe_ref.cpu().numpy()[:n_kf]
    bind = state.keyframe_localMLP.cpu().numpy()[:n_kf]
    kf_frames = state.kf_frame_ids.cpu().numpy()[:n_kf]
    est = state.est_c2w.cpu().numpy()
    kf_world = np.empty((n_kf, 4, 4), np.float32)
    for k in range(n_kf):
        if kf_ref[k] == -1:
            kf_world[k] = kf_c2w[k]
        else:
            kf_world[k] = kf_c2w[first_kf[max(bind[k, 0], 0)]] \
                @ est[kf_frames[k]]
    kf_rays_np = state.kf_rays.cpu().numpy()[:n_kf]
    kf_max_d = kf_rays_np[:, :, 6].max(axis=1)
    cam = cfg["cam"]
    ds_f = cfg["data"].get("downsample", 1)
    H, W = cam["H"] // ds_f, cam["W"] // ds_f
    K_mat = np.asarray([[cam["fx"] / ds_f, 0, cam["cx"] / ds_f],
                        [0, cam["fy"] / ds_f, cam["cy"] / ds_f],
                        [0, 0, 1.0]])
    min_area = cfg.get("mesh", {}).get(
        "remove_small_geometry_threshold", 0.5)

    def cleanup(verts, faces, colors):
        return apply_visibility_filters(
            verts, faces, colors, kf_world, K_mat, H, W, kf_max_d,
            min_component_area=min_area)

    # observed-surface occupancy validity, global and per submap (the
    # scheme of MIPSFusionTorch.extract_mesh)
    mesh_cfg = cfg.get("mesh", {})
    observed_fn, submap_fns, grid_bounds = keyframe_occupancies(
        kf_world, kf_rays_np, bind, used, bound,
        cvox=mesh_cfg.get("occupancy_voxel", 0.2),
        dilate=mesh_cfg.get("occupancy_dilate", 1))

    params = [fields[i].params(detach=True) if fields[i] is not None
              else None for i in range(used)]
    for i in range(used):
        if params[i] is None:
            continue
        verts, faces, colors = mesher.extract_single_mesh(
            params[i], anchors[i], info[i, 1:4], info[i, 4:7],
            trunc=0.99, bound_world=bound, observed_fn=submap_fns[i],
            grid_bounds=grid_bounds)
        verts, faces, colors = cleanup(verts, faces, colors)
        out = os.path.join(args.seq_result, f"mesh_{i}_{args.ckpt}.ply")
        save_mesh_ply(out, verts, faces, colors)
        print(f"submap {i}: {len(verts)} verts {len(faces)} faces -> {out}")

    if not args.no_joint and used > 1:
        verts, faces, colors = mesher.extract_mesh_jointly(
            params, anchors, info[:used, 1:4], info[:used, 4:7],
            trunc=0.99, bound_world=bound, observed_fn=observed_fn,
            submap_observed_fns=submap_fns, grid_bounds=grid_bounds)
        verts, faces, colors = cleanup(verts, faces, colors)
        out = os.path.join(args.seq_result, f"mesh_joint_{args.ckpt}.ply")
        save_mesh_ply(out, verts, faces, colors)
        print(f"joint: {len(verts)} verts {len(faces)} faces -> {out}")


if __name__ == "__main__":
    main()

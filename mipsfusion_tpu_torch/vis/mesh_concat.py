"""Concatenate per-submap mesh clips into one whole-scene PLY.

    python3 -m mipsfusion_tpu_torch.vis.mesh_concat OUT_DIR
    python3 -m mipsfusion_tpu_torch.vis.mesh_concat a.ply b.ply -o whole.ply

The counterpart of the JAX package's ``vis/mesh_concat.py``, over the
port's own PLY reader and writer (``mesher/mesher.py``). With one
directory it takes ``OUT_DIR/clip_*.ply`` (else every ``*.ply`` there)
and writes ``OUT_DIR/color_whole_mesh.ply``; it prints the counts and the
vertices' bounding box.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..mesher.mesher import concat_meshes, load_mesh_ply, save_mesh_ply


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m mipsfusion_tpu_torch.vis.mesh_concat",
        description="Concatenate PLY meshes into one")
    ap.add_argument("inputs", nargs="+",
                    help="PLY files, or one directory containing clip_*.ply")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (default: <dir>/color_whole_mesh.ply)")
    args = ap.parse_args(argv)

    if len(args.inputs) == 1 and os.path.isdir(args.inputs[0]):
        mesh_dir = args.inputs[0]
        paths = sorted(glob.glob(os.path.join(mesh_dir, "clip_*.ply"))) or \
            sorted(glob.glob(os.path.join(mesh_dir, "*.ply")))
        out = args.output or os.path.join(mesh_dir, "color_whole_mesh.ply")
    else:
        paths = args.inputs
        out = args.output or "color_whole_mesh.ply"
    if not paths:
        sys.exit("no input meshes found")

    verts, faces, colors = concat_meshes([load_mesh_ply(p) for p in paths])
    save_mesh_ply(out, verts, faces, colors)
    print(f"wrote {out}: {len(verts)} verts, {len(faces)} faces "
          f"from {len(paths)} clips")
    if len(verts):
        print("xyz_min:", np.min(verts, axis=0).tolist())
        print("xyz_max:", np.max(verts, axis=0).tolist())


if __name__ == "__main__":
    main()

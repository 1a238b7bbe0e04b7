"""Print the axis-aligned bounding box of a mesh's vertices.

    python3 -m mipsfusion_tpu_torch.vis.get_min_max mesh.ply

The counterpart of the JAX package's ``vis/get_min_max.py``, over the
port's own PLY reader.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..mesher.mesher import load_mesh_ply


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m mipsfusion_tpu_torch.vis.get_min_max",
        description="Bounding box of a PLY mesh's vertices")
    ap.add_argument("mesh", help="PLY mesh path")
    args = ap.parse_args(argv)
    verts, faces, _ = load_mesh_ply(args.mesh)
    if not len(verts):
        sys.exit("mesh has no vertices")
    print(f"{len(verts)} verts, {len(faces)} faces")
    print("xyz_min:", np.min(verts, axis=0).tolist())
    print("xyz_max:", np.max(verts, axis=0).tolist())


if __name__ == "__main__":
    main()

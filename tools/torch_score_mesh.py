"""Score meshes of a synthetic scene against its analytic SDF and say
where the error sits, with the PyTorch port on the CPU.

    python3 tools/torch_score_mesh.py --config <yaml> A.ply [B.ply ...]

For each PLY (written by either package: the port's CLI writes
``mesh_final.ply``, ``vis/render_mesh.py`` of the JAX package
``mesh_joint_<ckpt>.ply`` from a checkpoint of either) it prints one JSON
line: the vertex count, the accuracy (mean |SDF| of the vertices) and
``eval/recon.mesh_error_split``'s shares (vertices outside the room, the
accuracy of those inside, vertices farther than 5 cm). The room is the
config's ``synthetic.room_half``. Run it from the repository root.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("meshes", nargs="+")
    args = ap.parse_args(argv)
    import torch
    from mipsfusion_tpu_torch.config import load_config
    from mipsfusion_tpu_torch.datasets.synthetic import (SyntheticDataset,
                                                         props_on, scene_sdf)
    from mipsfusion_tpu_torch.eval.recon import (mesh_accuracy_vs_sdf,
                                                 mesh_error_split)
    from mipsfusion_tpu_torch.mesher.mesher import load_mesh_ply
    cfg = load_config(args.config)
    half = SyntheticDataset(cfg, n_frames=1, device="cpu").room_half

    def sdf_fn(p):
        return scene_sdf(torch.as_tensor(p, dtype=torch.float32), half,
                         props_on("cpu")).numpy()

    for path in args.meshes:
        verts, faces, _ = load_mesh_ply(path)
        print(json.dumps({"mesh": path, "vertices": len(verts),
                          "faces": len(faces),
                          "accuracy_m": mesh_accuracy_vs_sdf(verts, sdf_fn),
                          **mesh_error_split(verts, half)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

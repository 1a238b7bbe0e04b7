"""The port's SLAM loop through its file readers, on the CPU.

A short synthetic orbit (the port's ``SyntheticDataset`` at the tiny CPU
runs' size) is written with cv2 as a FastCaMo tree (PNG colour, 16-bit
depth at 1 mm, ``pose/<i>.txt``) and as a Replica tree (JPEG colour,
``traj.txt``), and the multi-submap corridor of ``test_torch_multi.py``
as a ScanNet tree (JPEG colour, the manager on: a second submap).
``MIPSFusionTorch(cfg, device="cpu")`` builds the reader through
``get_dataset`` and must give, bit for bit, the poses of the same system
run on an in-memory dataset that hands it the same decoded frames: the
file path adds decoding and nothing else. Then the command line on the
FastCaMo tree, through a yaml that inherits
``configs/FastCaMo-synth/fastcamo_synth.yaml``."""

import os
import re
import subprocess
import sys

import cv2
import numpy as np
import torch

from mipsfusion_tpu_torch.datasets.dataset import get_dataset
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
from test_smoke_e2e import smoke_config
from test_torch_slice import _triplane

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


def _frames(cfg, n=N, trajectory="orbit", span=N / 400.0):
    ds = SyntheticDataset(cfg, n_frames=n, trajectory=trajectory,
                          span=span, device="cpu")
    for i in range(n):
        p = ds.packed(i).numpy()
        rgb = np.round(np.clip(p[..., 3:6], 0, 1) * 255).astype(np.uint8)
        depth = np.round(p[..., 6] * 1000.0).astype(np.uint16)
        # the stored pose is pre-OpenGL: the readers negate columns 1, 2
        T = ds.gt_pose(i).astype(np.float64).copy()
        T[:3, 1:3] *= -1
        yield i, rgb, depth, T


def write_posedir(root, cfg, n=N, ext="png", **traj):
    """A FastCaMo (PNG colour) or ScanNet (JPEG colour) tree."""
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, rgb, depth, T in _frames(cfg, n, **traj):
        cv2.imwrite(os.path.join(root, "color", f"{i}.{ext}"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 98] if ext == "jpg" else [])
        cv2.imwrite(os.path.join(root, "depth", f"{i}.png"), depth)
        np.savetxt(os.path.join(root, "pose", f"{i}.txt"), T)


def write_replica(root, cfg, n=N):
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    lines = []
    for i, rgb, depth, T in _frames(cfg, n):
        cv2.imwrite(os.path.join(root, "results", f"frame{i:06d}.jpg"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 98])
        cv2.imwrite(os.path.join(root, "results", f"depth{i:06d}.png"),
                    depth)
        lines.append(" ".join(repr(float(v)) for v in T.ravel()))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


class InMemory:
    """Frames handed over as they are: the decoded frames of a reader."""

    def __init__(self, reader):
        self.H, self.W = reader.H, reader.W
        self.fx, self.fy, self.cx, self.cy = (reader.fx, reader.fy,
                                              reader.cx, reader.cy)
        self.num_frames = reader.num_frames
        self.frames = [reader.host_packed(i)
                       for i in range(reader.num_frames)]
        self.poses = list(reader.poses)

    def packed(self, i):
        return self.frames[i]

    def gt_pose(self, i):
        return self.poses[i]

    def prerender(self, indices):
        pass


def _file_cfg(dataset, datadir, cfg=None):
    cfg = cfg or _triplane(smoke_config(N))
    cfg["dataset"] = dataset
    cfg["data"].update({"datadir": datadir, "trainskip": 1, "downsample": 1,
                        "sc_factor": 1.0, "starting_frame": 0,
                        "output": None})
    cfg["cam"]["png_depth_scale"] = 1000.0
    return cfg


def _check_file_path_adds_nothing(cfg, ate_max=0.10):
    torch.manual_seed(0)
    slam = MIPSFusionTorch(cfg, device="cpu")
    assert type(slam.dataset).__name__ != "SyntheticDataset"
    res = slam.run(verbose=False)
    slam.dataset.close()
    mem = InMemory(get_dataset(cfg, device="cpu"))
    torch.manual_seed(0)
    ref = MIPSFusionTorch(cfg, dataset=mem, device="cpu")
    ref_res = ref.run(verbose=False)
    assert torch.equal(slam.state.est_c2w, ref.state.est_c2w)
    assert torch.equal(slam.state.est_c2w_rel, ref.state.est_c2w_rel)
    assert res["absolute_translational_error.rmse"] == \
        ref_res["absolute_translational_error.rmse"] < ate_max
    assert slam.dataset.decode_s["frames"] == slam.dataset.num_frames
    assert slam.switch_events == ref.switch_events
    return res, slam


def test_fastcamo_tree_runs_as_in_memory(tmp_path):
    cfg = _file_cfg("fastcamo_synth", str(tmp_path))
    write_posedir(str(tmp_path), cfg)
    ds = get_dataset(cfg, device="cpu")
    syn = SyntheticDataset(cfg, n_frames=N, trajectory="orbit",
                           span=N / 400.0, device="cpu")
    # the frames read back are the rendered ones quantised: colour to
    # 1/255, depth to 1 mm; the poses as rendered
    for i in (0, N - 1):
        got, want = ds.packed(i), syn.packed(i)
        assert torch.equal(got[..., :3], want[..., :3])
        assert torch.equal(got[..., 3:6], torch.round(
            want[..., 3:6] * 255) / 255)
        assert torch.equal(got[..., 6], (torch.round(
            want[..., 6] * 1000).to(torch.int32).float() / 1000.0))
        np.testing.assert_allclose(ds.gt_pose(i), syn.gt_pose(i),
                                   atol=1e-7)
    _check_file_path_adds_nothing(cfg)


def test_replica_tree_runs_as_in_memory(tmp_path):
    cfg = _file_cfg("replica", str(tmp_path))
    write_replica(str(tmp_path), cfg)
    _check_file_path_adds_nothing(cfg)


def test_scannet_corridor_spawns_a_submap_as_in_memory(tmp_path):
    """The manager through the ScanNet reader: the corridor leaves submap
    0, a second submap is made and refinement runs, with the in-memory
    run's poses and switch frames."""
    from test_torch_multi import corridor_config
    n = 20
    cfg = _file_cfg("scannet", str(tmp_path), corridor_config(n))
    write_posedir(str(tmp_path), cfg, n, ext="jpg", trajectory="corridor",
                  span=0.55)
    # (the corridor at this size tracks loosely: its test in
    # test_torch_multi.py holds no ATE either)
    res, slam = _check_file_path_adds_nothing(cfg, ate_max=float("inf"))
    assert type(slam.dataset).__name__ == "ScannetDataset"
    assert res["n_submaps"] >= 2, res
    assert any(flag == 3 for _, flag in slam.switch_events)
    assert slam.stage_calls["refine"] >= 1


def test_cli_on_a_fastcamo_tree(tmp_path):
    """python3 -m mipsfusion_tpu_torch --config <yaml inheriting
    fastcamo_synth.yaml> --device cpu exits 0 on the tree, prints its ATE
    line last and writes the render panels and ATE of frames 0 and 4
    (render_debug_images and evaluate on a reader) and the mesh."""
    data = tmp_path / "tree"
    cfg = _file_cfg("fastcamo_synth", str(data))
    write_posedir(str(data), cfg)
    yaml = tmp_path / "tiny_fastcamo.yaml"
    yaml.write_text(f"""inherit_from: "{ROOT}/configs/FastCaMo-synth/fastcamo_synth.yaml"
data:
  datadir: "{data}"
  output: "{tmp_path / 'out'}"
  exp_name: "tiny"
cam:
  H: 40
  W: 56
  fx: 28.0
  fy: 28.0
  cx: 27.5
  cy: 19.5
  far: 8.0
grid:
  tri_resolutions: [8, 16]
  cp_resolution: 32
  cp_components: 8
decoder:
  hidden_dim: 32
  geo_feat_dim: 16
  hidden_dim_color: 16
mapping:
  bound: [[-4.0, 4.0], [-3.2, 3.2], [-3.5, 3.5]]
  marching_cubes_bound: [[-4.0, 4.0], [-3.2, 3.2], [-3.5, 3.5]]
  sample: 128
  pixels_cur: 64
  iters: 3
  first_iters: 60
  first_iters_chunk: 0
  keyframe_every: 2
  map_every: 2
tracking:
  iter: 3
  iter_RO: 2
  sample: 96
  ignore_edge_W: 4
  ignore_edge_H: 4
  RO:
    particle_size: 128
    n_rows: 8
    n_cols: 12
sampling:
  kf_n_rays_h: 20
  kf_n_rays_w: 28
  n_rays_h: 8
  n_rays_w: 12
training:
  n_samples_d: 8
  n_range_d: 7
mesh:
  vis: 4
  ckpt_freq: 0
  voxel_final: 0.15
""")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "mipsfusion_tpu_torch",
                          "--config", str(yaml), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    last = res.stdout.strip().splitlines()[-1]
    m = re.match(r"ATE RMSE: ([0-9.]+) m \| ([0-9.]+) FPS", last)
    assert m and float(m.group(1)) < 0.2, last
    exp = tmp_path / "out" / "tiny"
    assert (exp / "mesh_final.ply").exists()
    assert (exp / "ate_4.txt").exists()
    assert len(list(exp.glob("render_*.png"))) == 2, sorted(os.listdir(exp))

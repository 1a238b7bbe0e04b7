"""The port's command line (``python -m mipsfusion_tpu_torch``) and offline
mesher (``python -m mipsfusion_tpu_torch.vis.render_mesh``) on the CPU, in
subprocesses: a 7-frame run of a yaml inheriting
configs/synthetic/orbit.yaml with tiny budgets and a checkpoint every 3
frames writes its output tree and prints the ATE line; the run resumes
from its frame-3 checkpoint; the offline mesher meshes its final
checkpoint."""

import json
import os
import re
import subprocess
import sys

import numpy as np

from mipsfusion_tpu_torch.mesher.mesher import load_mesh_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = """inherit_from: "{root}/configs/synthetic/orbit.yaml"
synthetic:
  n_frames: 7
  span: 0.035
data:
  output: "{out}"
  exp_name: "tiny"
cam:
  H: 40
  W: 56
  fx: 28.0
  fy: 28.0
  cx: 27.5
  cy: 19.5
grid:
  tri_resolutions: [8, 16]
  cp_resolution: 32
  cp_components: 8
decoder:
  hidden_dim: 32
  geo_feat_dim: 16
  hidden_dim_color: 16
mapping:
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
  vis: 3
  ckpt_freq: 3
  voxel_final: 0.15
"""


def _run(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return res.stdout


def _ate(stdout):
    m = re.search(r"^ATE RMSE: ([0-9.]+) m \| ([0-9.]+) FPS$", stdout, re.M)
    assert m is not None, stdout[-2000:]
    assert stdout.strip().splitlines()[-1] == m.group(0)
    return float(m.group(1))


def test_cli_run_resume_and_offline_mesh(tmp_path):
    out = tmp_path / "out"
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(TINY.format(root=ROOT, out=out))
    exp = out / "tiny"
    stdout = _run("mipsfusion_tpu_torch", "--device", "cpu", "--config",
                  str(yaml), "--n_frames", "7")
    assert _ate(stdout) < 0.10
    for name in ("ckpt_3", "ckpt_6", "ckpt_final", "traj_3.txt",
                 "traj_6.txt", "traj_3.png", "mesh_final.ply",
                 "render_00000.png", "render_00003.png", "ate_final.txt"):
        assert (exp / name).exists(), name
    for name in ("ckpt.npz", "model_0.npz", "opt_state.npz"):
        assert (exp / "ckpt_final" / name).exists(), name
    traj = np.loadtxt(exp / "traj_6.txt")
    assert traj.shape == (7, 8) and np.isfinite(traj).all()
    verts, faces, colors = load_mesh_ply(str(exp / "mesh_final.ply"))
    assert len(verts) > 100 and len(faces) > 100 and colors is not None

    (exp / "mesh_final.ply").unlink()
    stdout = _run("mipsfusion_tpu_torch", "--device", "cpu", "--config",
                  str(yaml), "--n_frames", "7", "--resume",
                  str(exp / "ckpt_3"))
    assert f"resumed from {exp / 'ckpt_3'} at frame 3" in stdout
    assert _ate(stdout) < 0.10
    assert (exp / "mesh_final.ply").exists()

    stdout = _run("mipsfusion_tpu_torch.vis.render_mesh", "--device", "cpu",
                  "--config", str(yaml), "--seq_result", str(exp),
                  "--ckpt", "final")
    assert "submap 0:" in stdout
    v0, f0, _ = load_mesh_ply(str(exp / "mesh_0_final.ply"))
    assert len(v0) > 100 and len(f0) > 100


def test_cli_profile_holds_the_spans(tmp_path):
    """``--profile`` writes a Chrome trace that holds the system's host
    spans (the frames, the stages and their program phases) and prints
    the idle-by-span line (no device operations on the CPU)."""
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(TINY.format(root=ROOT, out=tmp_path / "out"))
    trace = tmp_path / "trace.json"
    stdout = _run("mipsfusion_tpu_torch", "--device", "cpu", "--config",
                  str(yaml), "--n_frames", "4", "--profile", str(trace))
    _ate(stdout)
    assert "idle by span: no device operations in the trace" in stdout
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"mf/frame", "mf/track", "mf/track/launch", "mf/ba/draws",
            "mf/read/manager"} <= names

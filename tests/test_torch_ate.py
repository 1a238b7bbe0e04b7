"""The port's own ATE against the JAX package's, the port's imports, and
the card as the entry points' default device."""

import ast
import os

import numpy as np
import pytest
import torch

from mipsfusion_tpu.eval import ate as jate
from mipsfusion_tpu_torch.eval import ate as tate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trajectory(rng, n):
    """[n, 4, 4] poses: a random walk of positions with random rotations."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses[i, :3, :3] = q * np.sign(np.linalg.det(q))
    return poses


def _rigid(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = np.eye(4)
    T[:3, :3] = q * np.sign(np.linalg.det(q))
    T[:3, 3] = rng.normal(0, 1.0, 3)
    return T


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pose_evaluation_matches_jax_package(seed, offset):
    """Seeded trajectories, the estimate a noisy copy of GT (and with
    ``offset`` moved by a rigid transform, which the Horn alignment
    removes); one GT pose is NaN and must be masked on both sides."""
    rng = np.random.default_rng(seed)
    gt = _trajectory(rng, 40)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (40, 3))
    if offset:
        est = _rigid(rng)[None] @ est
    gt[7, 0, 3] = np.nan
    ref = jate.pose_evaluation(gt, est)
    out = tate.pose_evaluation(gt, est)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-12, err_msg=k)
    assert out["compared_pose_pairs"] == 39


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_save_traj_tum_matches_jax_package(tmp_path, seed, dtype):
    """The TUM writer: byte-identical files for the same poses (random
    rotations reach every branch of the quaternion construction)."""
    poses = _trajectory(np.random.default_rng(seed), 60).astype(dtype)
    poses[5, :3, :3] = np.diag([1.0, -1.0, -1.0])       # a 180-degree turn
    jate.save_traj_tum(poses, str(tmp_path / "jax.txt"))
    tate.save_traj_tum(poses, str(tmp_path / "port.txt"))
    ref = (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "port.txt").read_bytes() == ref
    assert len(ref.splitlines()) == 60


def _port_files():
    pkg = os.path.join(ROOT, "mipsfusion_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every .py of the port and chip_smoke.py, module level and inside
    functions: no import of jax or of mipsfusion_tpu."""
    files = _port_files()
    assert len(files) > 20
    rel = {os.path.relpath(p, ROOT) for p in files}
    for must in ("mipsfusion_tpu_torch/__main__.py",
                 "mipsfusion_tpu_torch/mesher/mesher.py",
                 "mipsfusion_tpu_torch/mesher/marching.py",
                 "mipsfusion_tpu_torch/vis/render_mesh.py",
                 "mipsfusion_tpu_torch/slam/checkpoint.py",
                 "mipsfusion_tpu_torch/slam/logger.py",
                 "mipsfusion_tpu_torch/eval/recon.py",
                 "mipsfusion_tpu_torch/datasets/dataset.py",
                 "mipsfusion_tpu_torch/datasets/image.py",
                 "mipsfusion_tpu_torch/parallel/sharding.py",
                 "mipsfusion_tpu_torch/parallel/__init__.py"):
        assert must in rel, must
    bad = [f"{os.path.relpath(p, ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in ("jax", "jaxlib", "mipsfusion_tpu")]
    assert not bad, bad


def test_entry_points_default_to_the_card(monkeypatch):
    """With no CUDA device, MIPSFusionTorch and SyntheticDataset given no
    device raise and name device="cpu"; they do not carry on on the CPU."""
    from mipsfusion_tpu_torch.config import flagship_orbit
    from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = flagship_orbit(use_manager=False)
    cfg["cam"].update(H=24, W=32, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SyntheticDataset(cfg, n_frames=3, trajectory="orbit", span=0.01)
    ds = SyntheticDataset(cfg, n_frames=3, trajectory="orbit", span=0.01,
                          device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MIPSFusionTorch(cfg, ds)
    assert MIPSFusionTorch(cfg, ds, device="cpu").device.type == "cpu"
    # the CLI and the offline mesher default to the card too
    from mipsfusion_tpu_torch.__main__ import main as cli
    from mipsfusion_tpu_torch.vis.render_mesh import main as render_mesh
    path = os.path.join(ROOT, "configs", "synthetic", "orbit.yaml")
    monkeypatch.chdir(ROOT)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli(["--config", path, "--n_frames", "2"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        render_mesh(["--config", path, "--seq_result", "nowhere"])

"""The port's output tools against the JAX package's on the same files:
``vis.mesh_concat`` (the concatenated PLY's arrays), ``vis.get_min_max``
(the printed box), ``tools.eval_ate`` (the association and the printed
ATE statistics) and ``tools.vis_cameras`` (the frusta's geometry; its PNG
decodes and holds every frustum). The new modules are inside the import
scan of tests/test_torch_ate.py."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from mipsfusion_tpu_torch.mesher.mesher import load_mesh_ply, save_mesh_ply
from mipsfusion_tpu_torch.tools import eval_ate, vis_cameras
from mipsfusion_tpu_torch.vis import get_min_max, mesh_concat

from test_torch_ate import _port_files
from test_torch_logger import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(rel):
    """A script of the JAX package's vis/ or tools/ as a module."""
    path = os.path.join(ROOT, rel)
    name = "jax_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tool"] + list(argv))
    mod.main()


def _meshes(tmp_path, n=3, colors=(True, False, True)):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        v = rng.uniform(-2, 2, (20 + 5 * i, 3)).astype(np.float32)
        f = rng.integers(0, len(v), (11 + i, 3)).astype(np.int32)
        c = rng.uniform(0, 1, (len(v), 3)) if colors[i] else None
        p = str(tmp_path / f"clip_{i}.ply")
        save_mesh_ply(p, v, f, c)
        paths.append(p)
    return paths


def test_new_tools_are_in_the_import_scan():
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for must in ("mipsfusion_tpu_torch/vis/mesh_concat.py",
                 "mipsfusion_tpu_torch/vis/get_min_max.py",
                 "mipsfusion_tpu_torch/tools/eval_ate.py",
                 "mipsfusion_tpu_torch/tools/vis_cameras.py",
                 "mipsfusion_tpu_torch/ops/encoding.py",
                 "mipsfusion_tpu_torch/slam/system.py"):
        assert must in rel, must


@pytest.mark.parametrize("form", ["dir", "files"])
def test_mesh_concat_matches_jax(tmp_path, monkeypatch, capsys, form):
    """Three clips (one without colours): the same vertices, faces and
    colours in both outputs, bit for bit, and the same printed lines."""
    paths = _meshes(tmp_path)
    jax_out, port_out = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    args = [str(tmp_path)] if form == "dir" else paths
    _run_jax_main(_jax_tool("vis/mesh_concat.py"), args + ["-o", jax_out],
                  monkeypatch)
    jax_print = capsys.readouterr().out.replace(jax_out, "OUT")
    mesh_concat.main(args + ["-o", port_out])
    port_print = capsys.readouterr().out.replace(port_out, "OUT")
    assert port_print == jax_print
    ref, out = load_mesh_ply(jax_out), load_mesh_ply(port_out)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert len(out[0]) == 20 + 25 + 30 and len(out[1]) == 11 + 12 + 13


def test_mesh_concat_default_output(tmp_path):
    _meshes(tmp_path)
    mesh_concat.main([str(tmp_path)])
    verts, faces, colors = load_mesh_ply(
        str(tmp_path / "color_whole_mesh.ply"))
    assert verts.shape == (75, 3) and colors.shape == (75, 3)


def test_get_min_max_matches_jax(tmp_path, monkeypatch, capsys):
    path = _meshes(tmp_path, 1)[0]
    _run_jax_main(_jax_tool("vis/get_min_max.py"), [path], monkeypatch)
    ref = capsys.readouterr().out
    get_min_max.main([path])
    assert capsys.readouterr().out == ref
    assert "xyz_min:" in ref


def _tum(path, t, xyz, quat):
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ti, p, q in zip(t, xyz, quat):
            f.write(f"{ti:.6f} {p[0]} {p[1]} {p[2]} {q[0]} {q[1]} {q[2]} "
                    f"{q[3]}\n")


@pytest.fixture()
def tum_pair(tmp_path):
    """A ground truth at 30 Hz and an estimate with jittered timestamps,
    frames missing on both sides, a rigid offset and noise."""
    rng = np.random.default_rng(4)
    n = 80
    t = np.arange(n) / 30.0
    xyz = np.cumsum(rng.normal(scale=0.05, size=(n, 3)), 0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    keep_gt = np.ones(n, bool)
    keep_gt[[5, 6, 40]] = False
    keep_est = np.ones(n, bool)
    keep_est[[10, 41, 79]] = False
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = xyz @ R.T + [0.4, -0.2, 1.0] + rng.normal(scale=0.01, size=(n, 3))
    t_est = t + rng.uniform(-0.005, 0.005, n)
    gt_path, est_path = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    _tum(gt_path, t[keep_gt], xyz[keep_gt], q[keep_gt])
    _tum(est_path, t_est[keep_est], est[keep_est], q[keep_est])
    return gt_path, est_path


def test_eval_ate_matches_jax(tum_pair, monkeypatch, capsys):
    """The association (greedy, within 0.02 s) and every printed
    statistic equal the JAX tool's, line for line."""
    gt_path, est_path = tum_pair
    jmod = _jax_tool("tools/eval_ate.py")
    _run_jax_main(jmod, [gt_path, est_path], monkeypatch)
    ref = capsys.readouterr().out
    res = eval_ate.main([gt_path, est_path])
    assert capsys.readouterr().out == ref
    assert res["compared_pose_pairs"] == 80 - 6
    assert eval_ate.associate(eval_ate.read_tum(gt_path),
                              eval_ate.read_tum(est_path)) == \
        jmod.associate(jmod.read_tum(gt_path), jmod.read_tum(est_path))
    assert 0.005 < res["absolute_translational_error.rmse"] < 0.03


def test_eval_ate_offset_and_plot(tum_pair, tmp_path, monkeypatch, capsys):
    """With a time offset the matches shift as in JAX; the plot is a PNG
    of ``plot_traj``'s size with both trajectories drawn."""
    gt_path, est_path = tum_pair
    jmod = _jax_tool("tools/eval_ate.py")
    for off in (1 / 30.0, -2 / 30.0):
        assert eval_ate.associate(
            eval_ate.read_tum(gt_path), eval_ate.read_tum(est_path), off) \
            == jmod.associate(jmod.read_tum(gt_path),
                              jmod.read_tum(est_path), off)
    png = str(tmp_path / "ate.png")
    eval_ate.main([gt_path, est_path, "--plot", png])
    img = read_png(png)
    assert img.shape == (512, 512, 3)
    black = (img == 0).all(-1)
    blue = (img[..., 0] == 0) & (img[..., 1] == 0) & (img[..., 2] == 255)
    assert black.sum() > 100 and blue.sum() > 100


def test_vis_cameras_frusta_match_jax_and_png_holds_them(tmp_path):
    """The frusta's edges equal the JAX tool's; the PNG decodes, and the
    apex and far corners of every drawn frustum are frustum-coloured."""
    jmod = _jax_tool("tools/vis_cameras.py")
    rng = np.random.default_rng(2)
    poses = np.tile(np.eye(4), (12, 1, 1))
    for i in range(12):
        a = rng.normal(size=3) * 0.3
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        poses[i, :3, :3] = np.linalg.qr(np.eye(3) + K)[0]
        poses[i, :3, 3] = [np.cos(i / 3), 0.1 * i, np.sin(i / 3)]
    for p in poses:
        for (a0, a1), (b0, b1) in zip(vis_cameras.frustum_lines(p),
                                      jmod.frustum_lines(p)):
            np.testing.assert_allclose(a0, b0, atol=1e-12)
            np.testing.assert_allclose(a1, b1, atol=1e-12)
    out = str(tmp_path / "cams.png")
    bound = np.array([[-1.5, 1.5], [-0.5, 1.6], [-1.5, 1.5]])
    drawn = vis_cameras.draw_cameras(poses, bound=bound, out_path=out,
                                     every=3)
    img = read_png(out)
    assert img.shape == (640, 640, 3)
    fp = drawn["frusta_px"]
    assert fp.shape == (4, 5, 2)
    col = np.rint(np.asarray(vis_cameras.FRUSTUM_RGB) * 255).astype(int)
    for f in fp:
        for c, r in f:
            assert (img[r, c] == col).all(), (r, c, img[r, c])
    red = np.rint(np.asarray(vis_cameras.PATH_RGB) * 255).astype(int)
    assert (img == red).all(-1).sum() > 50
    assert (img == 0).all(-1).sum() > 100               # the bound


def test_vis_cameras_reads_tum(tmp_path, capsys):
    """poses_from_tum inverts save_traj_tum's quaternions; the CLI writes
    the PNG."""
    from mipsfusion_tpu_torch.eval.ate import save_traj_tum
    rng = np.random.default_rng(7)
    poses = np.tile(np.eye(4), (9, 1, 1))
    for i in range(9):
        poses[i, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(poses[i, :3, :3]) < 0:
            poses[i, :3, 0] *= -1
        poses[i, :3, 3] = rng.normal(size=3)
    path = str(tmp_path / "traj.txt")
    save_traj_tum(poses.astype(np.float32), path)
    back = vis_cameras.poses_from_tum(path)
    np.testing.assert_allclose(back, poses, atol=1e-5)
    out = str(tmp_path / "c.png")
    vis_cameras.main(["--traj", path, "--out", out, "--every", "2"])
    assert read_png(out).shape == (640, 640, 3)
    assert "9 poses" in capsys.readouterr().out

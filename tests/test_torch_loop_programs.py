"""The loop-closure chain and the drift-gated track as stage programs
(``mipsfusion_tpu_torch/slam/programs.py``) on the CPU: PGO, switch BA,
the manager's predicates, overlap verification + ICP, and the gated
track's three programs (its read, its rescue, its commit).

On the CPU a program runs its body eagerly on its static buffers. Here
the programs run under a stand-in for the CUDA graphs (``_LintGraphs``)
whose capture and every replay run the body under a lint that fails on
what ends a CUDA graph's capture: a read of the device from the host
(``.item()``, ``bool()``, a 0-d tensor as an index, a mask), a copy from
host memory, a library call that checks its result on the host
(``torch.linalg.solve``), a draw. ``torch.linalg.eigh`` passes: on the
card the normals make its cuSOLVER call without the check
(``ops/cusolver.py``). Each program gives the bits of
a direct eager call on the same inputs and identically seeded generators,
serves two calls with different ids at one key, and matches its JAX
counterpart (``_global_pgo``, ``_switch_ba_fused``,
``manager._predicates_fused``, ``_overlap_verify_icp``, the gated
``tracker.track_frame``) on the same numpy inputs and draws, with the
tolerance each test states. The card's replays against the eager calls:
``tests/test_torch_programs_cuda.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.slam import manager as jmgr
from mipsfusion_tpu.slam import state as jstate
from mipsfusion_tpu.slam import system as jsys
from mipsfusion_tpu.slam import tracker as jtracker
from mipsfusion_tpu_torch.convert import params_from_jax
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.ops import cusolver
from mipsfusion_tpu_torch.slam import icp as ticp
from mipsfusion_tpu_torch.slam import manager as tmgr
from mipsfusion_tpu_torch.slam import mapper as tmapper
from mipsfusion_tpu_torch.slam import programs
from mipsfusion_tpu_torch.slam import state as tstate
from mipsfusion_tpu_torch.slam import system as tsys
from mipsfusion_tpu_torch.slam import tracker as ttracker

from test_manager import flat_scene, init_state_two_submaps
from test_torch_field import small_fcfg, small_params
from test_torch_levers import SLIPS, gate_frames  # noqa: F401
from test_torch_loop import KF_EVERY, _rel, _verify_args, scene  # noqa
from test_torch_losses import port_fcfg
from test_torch_manager import MGR_CFG, port_state
from test_torch_multi import LW, _jax_draws, ba_field  # noqa: F401

torch.set_num_threads(1)


# ------------------------------------------------------------ the lint

class HostRead(AssertionError):
    pass


_T = torch.Tensor
_FORBIDDEN = {
    _T.item: "item", _T.tolist: "tolist", _T.__bool__: "bool()",
    _T.__int__: "int()", _T.__float__: "float()", _T.__index__: "index",
    _T.cpu: "cpu", _T.numpy: "numpy", torch.linalg.solve: "linalg.solve",
    torch.linalg.svd: "linalg.svd",
    torch.linalg.inv: "linalg.inv", torch.linalg.det: "linalg.det",
    torch.nonzero: "nonzero", _T.nonzero: "nonzero",
    torch.masked_select: "masked_select", torch.unique: "unique",
    torch.repeat_interleave: "repeat_interleave",
    _T.repeat_interleave: "repeat_interleave",
    torch.multinomial: "a draw", torch.rand: "a draw", torch.randn: "a draw",
    torch.randint: "a draw"}


def _bad_index(idx) -> bool:
    """A 0-d integer tensor (read on the host) or a bool mask (its
    nonzero count is)."""
    for i in (idx if isinstance(idx, tuple) else (idx,)):
        if isinstance(i, torch.Tensor) and (
                i.dtype == torch.bool or (i.dim() == 0
                                          and not i.is_floating_point())):
            return True
    return False


class CaptureLint(TorchFunctionMode):
    """Fails on what ends a CUDA graph's capture (see the module
    docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FORBIDDEN:
            raise HostRead(_FORBIDDEN[func])
        if func in (_T.__getitem__, _T.__setitem__) and _bad_index(args[1]):
            raise HostRead(f"{func.__name__} by a device scalar or a mask")
        if func is _T.__setitem__ and not isinstance(args[2], torch.Tensor):
            raise HostRead("__setitem__ of a host value")
        if func in (torch.tensor, torch.as_tensor) and not isinstance(
                args[0] if args else kwargs.get("data"), torch.Tensor):
            raise HostRead(f"{func.__name__} of host data")
        return func(*args, **kwargs)


class _LintGraphs:
    """``programs.CudaGraphs`` on the CPU: the capture and every replay
    run the body under ``CaptureLint``, the replay's results copied into
    the captured outputs, as a graph's replay writes them."""

    def __init__(self):
        self.replays = 0

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        with CaptureLint():
            out = fn()

        def replay():
            self.replays += 1
            with CaptureLint():
                new = fn()
            with torch.no_grad():
                for k, v in new.items():
                    out[k].copy_(v)
        return replay, out, 0


def lint_programs() -> programs.StagePrograms:
    return programs.StagePrograms("cpu", graphs=_LintGraphs())


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for j, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{j}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


def _one_program(progs, stage):
    p = [p for p in progs.programs.values() if p.stage == stage]
    assert len(p) == 1, [q.key[:1] for q in progs.programs.values()]
    return p[0]


@pytest.mark.parametrize("bad", ["item", "index", "bool", "setitem",
                                 "solve", "mask", "as_tensor"])
def test_the_lint_catches_host_reads(bad):
    """Each of these ends a capture on the card; the lint fails on it, and
    a program under the lint stand-in raises with the stage and the key."""
    x = torch.arange(6.0)
    i = torch.tensor(2)
    A = torch.eye(3) * 2.0
    body = {"item": lambda s: {"y": s["x"] * s["x"].sum().item()},
            "index": lambda s: {"y": s["x"][i]},
            "bool": lambda s: {"y": s["x"] if s["x"].sum() > 0 else s["x"]},
            "setitem": lambda s: {"y": _set(s["x"])},
            "solve": lambda s: {"y": torch.linalg.solve(A, s["x"][:3])},
            "mask": lambda s: {"y": s["x"][s["x"] > 2.0]},
            "as_tensor": lambda s: {"y": s["x"] + torch.as_tensor([1.0])}}[bad]
    prog = programs.Program("probe", ("probe", bad), body, _LintGraphs())
    with pytest.raises(RuntimeError, match=r"capturing stage 'probe'"):
        prog({"x": x})


def _set(x):
    y = x.clone()
    y[1] = 1.0
    return y


# ------------------------------------------------------- the pieces

def test_solve_is_linalg_solve():
    """``icp.solve`` (solve_ex, no host check) gives torch.linalg.solve's
    bits on damped normal equations of the ICP's and PGO's sizes."""
    g = torch.Generator().manual_seed(0)
    for n in (6, 120):
        J = torch.randn(3 * n, n, generator=g)
        H = J.T @ J + 1e-3 * torch.eye(n)
        b = torch.randn(n, generator=g)
        assert torch.equal(ticp.solve(H, b), torch.linalg.solve(H, b))


def test_normals_are_eighs_on_the_cpu():
    """On the CPU the normals are eigh's smallest eigenvectors, bit for
    bit (the card's cuSOLVER call is held to eigh in
    tests/test_torch_programs_cuda.py); the card's call takes only CUDA
    float32 batches."""
    pts = torch.randn(300, 3, generator=torch.Generator().manual_seed(1))
    pts[:, 2] *= 0.05
    idx = torch.topk(((pts[:, None] - pts[None]) ** 2).sum(-1), 10, dim=-1,
                     largest=False).indices
    nb = pts[idx] - pts[idx].mean(1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", nb, nb)
    assert torch.equal(ticp.estimate_normals(pts, k=10),
                       torch.linalg.eigh(cov).eigenvectors[:, :, 0])
    with pytest.raises(ValueError, match="CUDA float32"):
        cusolver.syev_batched(cov)


# ------------------------------------------------------------------ PGO

def _pgo_states(scene):
    """The scripted two-submap state after the switch back to submap 0 on
    frame 28 (tests/test_torch_loop.py), with a third used submap (first
    keyframe 5, adjacent to 1): (JAX state, its pre-rectification pose,
    the rectified one)."""
    _, st, _, cur, _ = scene
    rng = np.random.default_rng(7)
    rect = (np.asarray(st.est_c2w[cur]) @ _rel(rng, 0.02)).astype(np.float32)
    jst, temp = jsys._switch_state_update(st, jnp.asarray(cur),
                                          jnp.asarray(rect), jnp.asarray(0))
    info = np.asarray(jst.localMLP_info).copy()
    info[2] = [1, 1.0, 0.5, -1.0, 2.0, 2.0, 2.0]
    adj = np.asarray(jst.localMLP_adjacent).copy()
    adj[1, 2] = adj[2, 1] = 1.0
    jst = jst._replace(localMLP_info=jnp.asarray(info),
                       localMLP_adjacent=jnp.asarray(adj),
                       localMLP_first_kf=jst.localMLP_first_kf.at[2].set(5))
    return jst, np.asarray(temp), rect


def test_pgo_program_matches_jax_and_the_function(scene):
    """One PGO program serves (aft 0, prev 1, used 2) and (aft 2, prev 0,
    used 3): each replay gives the function's bits, and the anchors equal
    JAX's ``_global_pgo`` to 1e-5 (tests/test_torch_loop.py's bound)."""
    jst, temp, rect = _pgo_states(scene)
    progs = lint_programs()
    for aft, prev, used in ((0, 1, 2), (2, 0, 3)):
        ref = jsys._global_pgo(jst, jnp.asarray(temp), jnp.asarray(rect),
                               jnp.asarray(aft), jnp.asarray(prev),
                               jnp.asarray(used), jnp.asarray(0.1, jnp.float32))
        a, b = port_state(jst), port_state(jst)
        progs.global_pgo(a, torch.tensor(temp), torch.tensor(rect), aft,
                         prev, used, 0.1)
        tsys.global_pgo(b, torch.tensor(temp), torch.tensor(rect), aft, prev,
                        used, 0.1)
        _same(a.kf_c2w, b.kf_c2w, "kf_c2w")
        moved = np.abs(np.asarray(ref.kf_c2w) - np.asarray(jst.kf_c2w)).max()
        assert moved > 1e-4
        np.testing.assert_allclose(a.kf_c2w.numpy(), np.asarray(ref.kf_c2w),
                                   atol=1e-5)
    prog = _one_program(progs, "pgo")
    assert prog.calls == 2 and prog.replays == 1


# ------------------------------------------------------------ switch BA

def _switch_inputs(scene, i):
    ds, st, kf_frames, _, _ = scene
    packed = np.asarray(ds.packed(i))
    return st, packed.reshape(-1, 7), kf_frames


def test_switch_ba_program_matches_jax(scene, monkeypatch):
    """Switch BA of frame 28 against submap 1 (the active one) over
    keyframes 3-5, on JAX's draws: frame 28's pose after the program
    equals JAX's ``_switch_ba_fused`` to 1e-5 (tests/test_torch_multi.py's
    bound for switch BA), every other pose exactly."""
    jf = dataclasses.replace(small_fcfg(), n_range_d=5, n_samples_d=6,
                             range_d=0.25, near=0.0, far=2.5, perturb=False)
    p = small_params(jf)
    st, rays, kf_frames = _switch_inputs(scene, 28)
    mask = np.zeros(16, bool)
    mask[[3, 4, 5]] = True
    n_iters, n_total, i = 6, 48, 28
    key = jax.random.PRNGKey(4)
    jc = jsr.FieldConsts(jnp.full(3, -10.0), jnp.full(3, 0.047))
    ref = jsys._switch_ba_fused(
        st, jax.tree.map(jnp.asarray, p), key, jnp.asarray(mask),
        jnp.asarray(rays), jnp.asarray(i), jnp.asarray(kf_frames), jf, jc,
        jsr.LossWeights(*LW), 0.001, 0.001, n_iters, n_total, 3)
    w = tmapper.switch_ba_weights(torch.tensor(mask), n_total).numpy()
    draws = _jax_draws(key, jnp.log(jnp.asarray(w) + 1e-12), n_iters,
                       n_total, st.kf_rays.shape[1], rays.shape[0])
    monkeypatch.setattr(tmapper, "ba_draws",
                        lambda *a: (draws, [None] * n_iters))
    pst = port_state(st)
    lint_programs().switch_ba_update(
        pst, params_from_jax(p).params(detach=True), torch.tensor(mask),
        torch.tensor(rays), i, torch.tensor(kf_frames), port_fcfg(jf),
        tsr.FieldConsts(torch.full((3,), -10.0), torch.full((3,), 0.047)),
        tsr.LossWeights(*LW), 0.001, 0.001, n_iters, n_total, 3)
    out, want = pst.est_c2w.numpy(), np.asarray(ref.est_c2w)
    assert np.abs(want[i] - np.asarray(st.est_c2w[i])).max() > 5e-4
    np.testing.assert_allclose(out[i], want[i], atol=1e-5)
    others = np.arange(len(out)) != i
    np.testing.assert_array_equal(out[others], np.asarray(st.est_c2w)[others])


def test_switch_ba_program_equals_the_function(scene, ba_field):
    """Frames 28 and 24 through one switch-BA program (the frame index an
    input), perturbation on: est_c2w and the loss are the bits of
    ``system.switch_ba_update`` from an identically seeded generator."""
    jf, tf, p = ba_field
    tf = dataclasses.replace(tf, perturb=True)
    consts = tsr.FieldConsts(torch.full((3,), -10.0),
                             torch.full((3,), 0.047))
    params = params_from_jax(p).params(detach=True)
    progs = lint_programs()
    for i, top in ((28, [3, 4, 5]), (24, [4, 5])):
        st, rays, kf_frames = _switch_inputs(scene, i)
        mask = np.zeros(16, bool)
        mask[top] = True
        out = []
        for run in (progs.switch_ba_update, tsys.switch_ba_update):
            pst = port_state(st)
            loss = run(pst, params, torch.tensor(mask), torch.tensor(rays),
                       i, torch.tensor(kf_frames), tf, consts,
                       tsr.LossWeights(*LW), 0.001, 0.001, 4, 48, 2,
                       torch.Generator().manual_seed(i))
            out.append((pst.est_c2w, loss))
        _same(out[0], out[1], f"switch BA at {i}")
    assert _one_program(progs, "switch_ba").calls == 2


# ------------------------------------------------- manager predicates

def _predicate_case(active, wait):
    """tests/test_torch_manager.py's three-submap predicate state with
    the active submap ``active``."""
    depth, dirs = flat_scene()
    jst = init_state_two_submaps([0.0, 0.0, -2.0], [3.0, 3.0, 3.0],
                                 [0.4, 0.1, -1.5], [1.0, 1.0, 1.0])
    info_row = jnp.concatenate([jnp.ones(1),
                                jnp.asarray([0.2, 0.0, -2.1]),
                                jnp.asarray([2.0, 2.0, 2.0])])
    jst = jst._replace(
        localMLP_info=jst.localMLP_info.at[2].set(info_row),
        localMLP_first_kf=jst.localMLP_first_kf.at[2].set(0),
        active_submap_id=jnp.asarray(active, jnp.int32))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.05, -0.02, 0.1]
    return jst, np.asarray(depth), np.asarray(dirs), pose


def test_predicates_program_matches_jax_and_the_function():
    """One manager program at (active 1, wait 2) and (active 0, wait 1):
    the replay gives ``manager.predicates_fused``'s bits, and the dict
    equals JAX's ``_predicates_fused`` to 1e-6 (tests/test_torch_manager.py's
    bound), the most-overlapping id exactly."""
    cfg = jmgr.ManagerConfig(**MGR_CFG)
    jm = jmgr.Manager(cfg, 12, 16, keyframe_every=5)
    tm = tmgr.Manager(tmgr.ManagerConfig(**MGR_CFG), 12, 16, 5)
    progs = lint_programs()
    for active, wait in ((1, 2), (0, 1)):
        jst, depth, dirs, pose = _predicate_case(active, wait)
        ref = jmgr._predicates_fused(
            jst, jnp.asarray(pose), jnp.asarray(depth), jnp.asarray(dirs),
            jnp.asarray(wait),
            jnp.asarray(cfg.min_cr_localMLP_len, jnp.float32), cfg.near,
            cfg.far, jm.cr_rows, jm.cr_cols)
        args = (torch.tensor(pose), torch.tensor(depth), torch.tensor(dirs),
                wait, tm.min_cr_len, 0.0, 10.0, tm.cr_rows, tm.cr_cols)
        pst = port_state(jst)
        assert pst.active_submap_id == active
        out = progs.predicates_fused(pst, *args)
        _same(out, tmgr.predicates_fused(pst, *args), "predicates")
        host = tmgr.host_dict(out)
        for k, v in host.items():
            np.testing.assert_allclose(v, np.asarray(ref[k]), atol=1e-6,
                                       err_msg=k)
        assert int(host["mo_id"]) == int(ref["mo_id"])
    assert _one_program(progs, "manager").calls == 2


def test_manager_runs_its_keyframes_through_the_program():
    """A Manager with the program installed decides as the function's:
    the predicates of one keyframe, through ``_predicates``."""
    jst, depth, dirs, pose = _predicate_case(1, 2)
    tm = tmgr.Manager(tmgr.ManagerConfig(**MGR_CFG), 12, 16, 5)
    ref = tm._predicates(port_state(jst), torch.tensor(depth),
                         torch.tensor(dirs), torch.tensor(pose), 2)
    progs = lint_programs()
    tm.predicates_fn = progs.predicates_fused
    out = tm._predicates(port_state(jst), torch.tensor(depth),
                         torch.tensor(dirs), torch.tensor(pose), 2)
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert _one_program(progs, "manager").calls == 1


# ------------------------------------------- verification + ICP

def _verify_call(run, pst, scene, mo, active, cur, min_trans=0.5):
    ds, _, kf_frames, _, _ = scene
    packed, rows, cols, K_mat, pose_world = _verify_args(scene)
    kr, kc = jstate.kf_downsample_indices(30, 40, 12, 16)
    sub = np.linspace(0, 191, 64).astype(np.int64)
    t = torch.tensor
    return run(pst, t(packed[..., 6]), t(packed[..., :3]), t(pose_world),
               mo, active, t(rows), t(cols), t(K_mat), t(kf_frames), cur,
               t(np.asarray(kr)[sub]).long(), t(np.asarray(kc)[sub]).long(),
               t(sub), 0.08, min_trans, 5, 4, 2, 30, 40, 48, 1, KF_EVERY,
               192)


def test_verify_program_matches_jax_and_the_function(scene):
    """One verification program for (mo 0, active 1, frame 28) and (mo 1,
    active 0, frame 24): each replay gives the function's bits; the first
    equals JAX's ``_overlap_verify_icp`` as tests/test_torch_loop.py holds
    the function (ids and counts exactly, inliers within 1, the rectified
    pose to 1e-4)."""
    _, st, kf_frames, cur, _ = scene
    packed, rows, cols, K_mat, pose_world = _verify_args(scene)
    kr, kc = jstate.kf_downsample_indices(30, 40, 12, 16)
    sub = np.linspace(0, 191, 64).astype(np.int32)
    ref = jsys._overlap_verify_icp(
        st, jnp.asarray(packed[..., 6]), jnp.asarray(packed[..., :3]),
        jnp.asarray(pose_world), 0, 1, jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(K_mat), jnp.asarray(kf_frames), jnp.asarray(cur),
        jnp.asarray(np.asarray(kr)[sub]), jnp.asarray(np.asarray(kc)[sub]),
        jnp.asarray(sub), 0.08, 0.5, jnp.asarray(5), k=4, edge=2, H=30, W=40,
        n_per=48, n_incl=1, keyframe_every=KF_EVERY, R=192)
    progs = lint_programs()
    for mo, active, frame in ((0, 1, cur), (1, 0, 24)):
        pst = port_state(st)
        out = _verify_call(progs.overlap_verify_icp, pst, scene, mo, active,
                           frame)
        _same(out, _verify_call(tsys.overlap_verify_icp, pst, scene, mo,
                                active, frame), f"verify {mo} {active}")
        if mo == 0:
            for k in ("top_kf_ids", "top_valid", "counts", "vis",
                      "mask_final", "n_related", "n_valid"):
                np.testing.assert_array_equal(out[k].numpy(),
                                              np.asarray(ref[k]), err_msg=k)
            assert abs(int(out["n_inliers"]) - int(ref["n_inliers"])) <= 1
            np.testing.assert_allclose(out["pose_final"].numpy(),
                                       np.asarray(ref["pose_final"]),
                                       atol=1e-4)
            assert int(out["n_inliers"]) > 20
    prog = _one_program(progs, "verify")
    assert prog.calls == 2 and prog.replays == 1


# ------------------------------------------------------ gated track

def _gate_setup(gate_frames, case, kf_frame=0, n_go=3, n_rays=24,
                perturb=False, keyframe_every=5):
    """tests/test_torch_levers.py's slip setup with the state the loop
    keeps: an anchor from frame 0, frame 5 at its ground truth times the
    slip (its prediction est_c2w[4] too), RO off, GO and the polish GO
    ``n_go`` iterations on ``n_rays`` rays."""
    frames, gt = gate_frames
    slipped = (gt[5] @ SLIPS[case]).astype(np.float32)
    jf = dataclasses.replace(small_fcfg(), n_range_d=5, n_samples_d=6,
                             perturb=perturb)
    p = small_params(jf, scale=False)
    est = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    est[0], est[4], est[5] = gt[0], slipped, slipped
    if kf_frame > 0:
        est[kf_frame] = gt[0]
    st = tstate.init_state(16, 4, 2, 8, [2.0, 2.0, 2.0], "cpu")
    st.est_c2w.copy_(torch.tensor(est))
    tp, tn, tv = ttracker.gate_anchor(torch.tensor(frames[0]), 24, 43)
    args = (params_from_jax(p).params(detach=True), port_fcfg(jf),
            tsr.FieldConsts.from_norm_factor(torch.tensor([3.0, 3.0, 3.0])),
            ttracker.ROConfig(particle_size=8, n_rows=4, n_cols=6, n_iters=0),
            ttracker.GOConfig(n_iters=n_go, n_rays=n_rays),
            torch.zeros((8, 6)), None, torch.tensor(frames[5]), st, 5, False,
            tsr.LossWeights(), 0, n_go, keyframe_every, torch.tensor(-1.0))
    # a healthy reading sits near the 9.5 mm sampling floor: the refresh
    # takes readings under the threshold (anchor_health 1)
    levers = dict(dgcfg=ttracker.DriftGateConfig(thresh=0.02,
                                                 polish=n_go > 0,
                                                 anchor_health=1.0),
                  gate=ttracker.GateAnchor(tp, tn, tv,
                                           torch.tensor(kf_frame)),
                  prev_rescued=torch.tensor(False))
    return jf, p, est, slipped, args, levers


def _with_generators(args, levers, seed):
    a = list(args)
    a[6] = torch.Generator().manual_seed(seed)
    st = a[8]
    a[8] = dataclasses.replace(st, est_c2w=st.est_c2w.clone(),
                               est_c2w_rel=st.est_c2w_rel.clone(),
                               keyframe_ref=st.keyframe_ref.clone())
    return a, dict(levers, polish_generator=torch.Generator().manual_seed(
        seed + 1))


@pytest.mark.parametrize("case", ["healthy", "translation"])
def test_gated_track_programs_match_jax(gate_frames, case):
    """An unfired frame (at its ground truth) and a fired one (a 60 mm
    slip) through the gated track's programs, GO and the polish GO at 3
    iterations: the rescue as JAX's gated ``track_frame``'s, the reading to
    5e-4 m and the pose to 1e-4 (tests/test_torch_levers.py's bounds on
    the same frames); the read ran on both, the rescue only on the fired
    frame, the commit on both (the anchor due at age 5, or the rescue)."""
    frames, gt = gate_frames
    jf, p, est, slipped, args, levers = _gate_setup(gate_frames, case)
    pts, nrm, valid = jtracker.gate_anchor(jnp.asarray(frames[0]), 24, 43)
    cur = frames[5]
    ref = jtracker.track_frame(
        jax.tree.map(jnp.asarray, p), jf,
        jsr.FieldConsts.from_norm_factor(jnp.asarray([3.0, 3.0, 3.0])),
        jtracker.ROConfig(particle_size=8, n_rows=4, n_cols=6, n_iters=0),
        jtracker.GOConfig(n_iters=3, n_rays=24),
        jtracker.make_pst(jax.random.PRNGKey(1),
                          jtracker.ROConfig(particle_size=8)),
        jax.random.PRNGKey(2), jnp.asarray(cur[..., 3:6]),
        jnp.asarray(cur[..., 6]), jnp.asarray(cur[..., :3]),
        jnp.asarray(est), jnp.asarray(5), jnp.asarray(False),
        jsr.LossWeights(), 0, 3,
        dgcfg=jtracker.DriftGateConfig(thresh=0.02, polish=True),
        gate_pts=pts, gate_normals=nrm, gate_valid=valid,
        gate_kf_frame=jnp.asarray(0, jnp.int32))
    progs = lint_programs()
    out = progs.track_frame_update(*args, **levers)
    assert bool(out.fired) == (case == "translation")
    assert bool(out.rescued) == bool(ref.rescued) == bool(out.fired)
    np.testing.assert_allclose(float(out.drift_res), float(ref.drift_res),
                               atol=5e-4)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-4)
    np.testing.assert_array_equal(args[8].est_c2w[5].numpy(),
                                  out.pose.numpy())
    stages = progs.stats()
    assert stages["track_gate"]["calls"] == 1
    assert stages["track_commit"]["calls"] == 1
    assert ("track_rescue" in stages) == (case == "translation")


@pytest.mark.parametrize("case,kf_frame,keyframe_every", [
    ("translation", 0, 5), ("translation", 0, 4), ("healthy", 0, 4),
    ("healthy", 3, 5)])
def test_gated_track_programs_equal_the_function(gate_frames, case,
                                                 kf_frame, keyframe_every):
    """Fired (a keyframe and not), due, and quiet (the anchor 2 frames
    old: only the read), with perturbation on and random GO pixels (the
    draws made before the replays, the polish's from its own
    generator): the result, the committed pose store and the anchor are
    ``tracker.track_frame_update``'s bits; a second call at the same
    key replays the programs."""
    *_, args, levers = _gate_setup(gate_frames, case, kf_frame=kf_frame,
                                   n_rays=40, perturb=True,
                                   keyframe_every=keyframe_every)
    progs = lint_programs()
    for rep in range(2):
        outs = []
        for run in (progs.track_frame_update, ttracker.track_frame_update):
            a, lv = _with_generators(args, levers, 11 + rep)
            res = run(*a, **lv)
            st = a[8]
            outs.append((res._replace(gate=None, refresh=None), res.gate,
                         res.refresh, st.est_c2w, st.est_c2w_rel,
                         st.keyframe_ref))
        _same(outs[0], outs[1], f"{case} call {rep}")
    fired = bool(outs[0][0].fired)
    assert fired == (case == "translation")
    due = outs[0][2] is True
    assert due == (case == "healthy" and kf_frame == 0)
    stats = progs.stats()
    assert stats["track_gate"] == dict(stats["track_gate"], programs=1,
                                       calls=2, replays=1)
    assert ("track_rescue" in stats) == fired
    assert ("track_commit" in stats) == (fired or due)

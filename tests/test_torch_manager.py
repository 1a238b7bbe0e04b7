"""Parity of the port's submap manager with the JAX package's: the expand
rule, the containing ratio and the per-keyframe predicates on the same
numpy inputs, and the scripted decision scenarios of tests/test_manager.py
driven through both Managers in lockstep with the same stubbed overlap
verification. After every keyframe the flags, every state table and the
manager's own registers must be equal (tables to float32 rounding,
1e-6; ids, counters and bindings exactly): on scripted states no ratio
lies near a threshold, so no decision can flip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.slam import manager as jmgr
from mipsfusion_tpu.slam import state as jstate
from mipsfusion_tpu_torch.slam import manager as tmgr
from mipsfusion_tpu_torch.slam import state as tstate
from mipsfusion_tpu_torch.slam.state import SlamState

from test_manager import (OverlapSpy, flat_scene, init_state_two_submaps,
                          init_state_with_submap0)

torch.set_num_threads(1)

MGR_CFG = dict(min_containing_ratio=0.7, min_containing_ratio_mo=0.6,
               min_containing_ratio_back=0.5,
               min_cr_localMLP_len=(0.1, 0.1, 0.1),
               localMLP_max_len=(4.0, 4.0, 4.0),
               localMLP_max_len_back=(4.0, 4.0, 4.0), near=0.0, far=10.0)
TABLES = ("kf_rays", "kf_frame_ids", "kf_c2w", "est_c2w", "est_c2w_rel",
          "keyframe_ref", "localMLP_info", "localMLP_max_len",
          "localMLP_adjacent", "keyframe_localMLP", "localMLP_first_kf",
          "active_first_kf")
REGISTERS = ("n_kf", "active_submap_id", "prev_active_submap_id",
             "last_switch_frame")


def port_state(jst: jstate.SlamState) -> SlamState:
    """The port's state holding the JAX state's values."""
    t = {k: torch.tensor(np.asarray(getattr(jst, k))) for k in TABLES}
    for k in ("kf_frame_ids", "keyframe_ref", "keyframe_localMLP",
              "localMLP_first_kf", "active_first_kf"):
        t[k] = t[k].long()
    return SlamState(**t, **{k: int(getattr(jst, k)) for k in REGISTERS})


def assert_states_equal(pst: SlamState, jst: jstate.SlamState):
    for k in TABLES:
        a, b = getattr(pst, k).numpy(), np.asarray(getattr(jst, k))
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=k)
    for k in REGISTERS:
        assert getattr(pst, k) == int(getattr(jst, k)), k


def test_init_state_matches_jax():
    """Every table and register of a fresh state, the multi-submap fields
    (max lengths, adjacency, active and previous submap, last switch
    frame) included."""
    cap = jstate.StateCapacity(n_frames=24, n_keyframes=6, n_submaps=4,
                               rays_per_kf=12, kf_rays_h=3, kf_rays_w=4)
    jst = jstate.init_state(cap, [2.0, 1.5, 3.0])
    assert_states_equal(tstate.init_state(24, 6, 4, 12, [2.0, 1.5, 3.0]),
                        jst)


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("seed", range(10))
def test_expand_rule_matches_jax(seed):
    """The host rule (numpy on both sides: equal) and the device rule
    (float32: 1e-6) on random boxes, contained or not, clamped or not."""
    rng = np.random.default_rng(seed)
    args = (rng.uniform(-3, 3, 3), rng.uniform(0.5, 6.0, 3),
            rng.uniform(-3, 3, 3), rng.uniform(0.5, 5.0, 3),
            rng.uniform(4.0, 8.0, 3))
    if seed == 0:                 # keyframe box inside: no change
        args = (np.zeros(3), np.full(3, 4.0), np.full(3, 0.5),
                np.ones(3), np.full(3, 7.0))
    for a, b in zip(tmgr.expand_rule(*args), jmgr.expand_rule(*args)):
        np.testing.assert_array_equal(a, b)
    a32 = [np.asarray(a, np.float32) for a in args]
    out = tmgr.expand_rule_t(*[torch.tensor(a) for a in a32])
    ref = jmgr.expand_rule_jnp(*[jnp.asarray(a) for a in a32])
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_containing_ratio_matches_jax():
    depth, dirs = flat_scene(H=12, W=16)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, 0.3]
    args = (np.asarray(depth), np.asarray(dirs), pose,
            np.array([0.0, 0.0, -1.7], np.float32),
            np.array([0.5, 0.4, 0.9], np.float32),
            np.array([0.3, 0.3, 0.3], np.float32))
    rows, cols = tmgr.uniform_grid(12, 16, 6, 8)
    jr, jc = jmgr.uniform_grid(12, 16, 6, 8)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))
    out = tmgr.containing_ratio(*[torch.tensor(a) for a in args], rows, cols)
    ref = jmgr.containing_ratio(*[jnp.asarray(a) for a in args], jr, jc)
    assert 0.0 < float(ref) < 1.0
    assert float(out) == pytest.approx(float(ref), abs=1e-7)


@pytest.mark.parametrize("case", ["one_submap", "three_submaps"])
def test_predicates_match_jax(case):
    """The predicate dict of one keyframe (frustum box, ratios, expanded
    box, most-overlapping submap, wait-loop ratio, world pose)."""
    depth, dirs = flat_scene()
    if case == "one_submap":
        jst = init_state_with_submap0([0.0, 0.0, -0.8], [1.2, 1.2, 1.6])
        wait = 0
    else:
        jst = init_state_two_submaps([0.0, 0.0, -2.0], [3.0, 3.0, 3.0],
                                     [0.4, 0.1, -1.5], [1.0, 1.0, 1.0])
        row = jnp.concatenate([jnp.ones(1), jnp.asarray([0.2, 0.0, -2.1]),
                               jnp.asarray([2.0, 2.0, 2.0])])
        jst = jst._replace(
            localMLP_info=jst.localMLP_info.at[2].set(row),
            localMLP_first_kf=jst.localMLP_first_kf.at[2].set(0))
        wait = 2
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.05, -0.02, 0.1]
    cfg = jmgr.ManagerConfig(**MGR_CFG)
    jm = jmgr.Manager(cfg, 12, 16, keyframe_every=5)
    ref = jmgr._predicates_fused(
        jst, jnp.asarray(pose), depth, dirs, jnp.asarray(wait),
        jnp.asarray(cfg.min_cr_localMLP_len, jnp.float32), cfg.near, cfg.far,
        jm.cr_rows, jm.cr_cols)
    tm = tmgr.Manager(tmgr.ManagerConfig(**MGR_CFG), 12, 16, 5)
    out = tmgr.predicates_fused(
        port_state(jst), torch.tensor(pose), torch.tensor(np.asarray(depth)),
        torch.tensor(np.asarray(dirs)), wait, tm.min_cr_len, 0.0, 10.0,
        tm.cr_rows, tm.cr_cols)
    host = tmgr.host_dict(out)
    for k, v in host.items():
        np.testing.assert_allclose(v, np.asarray(ref[k]), atol=1e-6,
                                   err_msg=k)
    assert int(host["mo_id"]) == int(ref["mo_id"])


def test_host_dict_one_copy_keeps_kinds():
    d = {"f": torch.tensor([[1.5, -2.25]]), "i": torch.tensor([3, -1]),
         "b": torch.tensor([True, False]), "s": torch.tensor(7)}
    h = tmgr.host_dict(d)
    assert h["f"].dtype == np.float32 and h["f"].shape == (1, 2)
    assert h["i"].dtype == np.int64 and h["b"].dtype == bool
    assert h["s"].shape == () and int(h["s"]) == 7
    np.testing.assert_array_equal(h["i"], [3, -1])


# --------------------------------------------------- scripted scenarios

def _moved(x=0.0, y=0.0):
    p = np.eye(4, dtype=np.float32)
    p[0, 3], p[1, 3] = x, y
    return p


def _db_state():
    return init_state_two_submaps([0.0, 0.0, -2.0], [3.0, 3.0, 3.0],
                                  [0.1, 0.0, -2.0], [3.2, 3.2, 3.2])


def _case5_state():
    return init_state_two_submaps([0.0, 0.0, -2.0], [3.0, 3.0, 3.0],
                                  [10.0, 10.0, 10.0], [4.0, 4.0, 4.0])


def _pair_change(m):
    m.db_active_id = 99


# name: (initial JAX state, overlap results, steps of (pose, frame, kf,
# hook applied to both managers first), expected flags)
SCENARIOS = {
    "contained_msg2": (
        lambda: init_state_with_submap0([0.0, 0.0, -2.0], [3.0, 3.0, 3.0]),
        [], [(_moved(), 5, 1, None)], [2]),
    "new_submap_msg3": (
        lambda: init_state_with_submap0([10.0, 10.0, 10.0], [1.0, 1.0, 1.0]),
        [], [(_moved(), 5, 1, None)], [3]),
    "expand_msg2": (
        lambda: init_state_with_submap0([0.0, 0.0, -0.8], [1.2, 1.2, 1.6]),
        [], [(_moved(), 5, 1, None)], [2]),
    "wait_loop_matures": (
        _case5_state, [False, True],
        [(_moved(), 10, 2, None), (_moved(), 15, 3, None)], [3, 1]),
    "wait_loop_holds": (
        _case5_state, [False, True],
        [(_moved(), 10, 2, None), (_moved(x=8.0), 15, 3, None),
         (_moved(), 20, 4, None)], None),
    "wait_loop_cleared": (
        _case5_state, [False] * 4,
        [(_moved(), 10, 2, None), (_moved(30.0, 30.0), 15, 3, None)],
        [3, 3]),
    "double_binding_switch": (
        _db_state, [True],
        [(_moved(), 5 * k, k, None) for k in range(2, 7)], [2, 2, 2, 2, 1]),
    "double_binding_failed_verify": (
        _db_state, [False, False],
        [(_moved(), 5 * k, k, None) for k in range(2, 13)], [2] * 11),
    "double_binding_pair_change": (
        _db_state, [True],
        [(_moved(), 5 * k, k, None) for k in range(2, 5)]
        + [(_moved(), 25, 5, _pair_change)], [2, 2, 2, 2]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scripted_scenario_matches_jax(name):
    make_state, results, steps, expected = SCENARIOS[name]
    depth, dirs = flat_scene()
    jm = jmgr.Manager(jmgr.ManagerConfig(**MGR_CFG), 12, 16,
                      keyframe_every=5)
    tm = tmgr.Manager(tmgr.ManagerConfig(**MGR_CFG), 12, 16, 5)
    jspy, tspy = OverlapSpy(results), OverlapSpy(results)
    jm.find_overlap_fn, tm.find_overlap_fn = jspy, tspy
    jst = make_state()
    tst = port_state(jst)
    tdepth = torch.tensor(np.asarray(depth))
    tdirs = torch.tensor(np.asarray(dirs))
    flags = []
    for pose, frame, kf, hook in steps:
        if hook is not None:
            hook(jm)
            hook(tm)
        jst, jflag = jm.process_keyframe(jst, depth, dirs, jnp.asarray(pose),
                                         frame_id=frame, kf_id=kf)
        tst, tflag = tm.process_keyframe(tst, tdepth, tdirs,
                                         torch.tensor(pose), frame, kf)
        assert tflag == jflag
        flags.append(tflag)
        assert_states_equal(tst, jst)
        for reg in ("double_binding_counter", "db_active_id", "db_mo_id",
                    "wait_loop", "localMLP_Id_wait", "localMLP_Id_actual",
                    "last_binding"):
            assert getattr(tm, reg) == getattr(jm, reg), reg
        assert (tm.ovlp_data is None) == (jm.ovlp_data is None)
        if tflag == 1:
            break
    assert tspy.calls == jspy.calls
    if expected is not None:
        assert flags == expected

"""Sharded background refinement: every inactive submap in one step, slot
s on mesh device s % n. Its slots and masks against what the JAX system's
``_make_sharded_refine_step`` computes on one state, a tiny corridor run
at 2 virtual CPU shards with both ``parallel`` switches on against both
off, and (``slow``) the whole loop-closing outback sharded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.slam import state as jstate
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.parallel.sharding import make_mesh
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch, refine_slots

from test_torch_multi import corridor_config

torch.set_num_threads(1)


def _bindings(rng, K, n_kf, M):
    """Keyframe bindings (first, second submap; -1 none) of a run with M
    submaps: every valid keyframe first-bound, some bound to two."""
    bind = np.full((K, 2), -1, np.int64)
    bind[:n_kf, 0] = rng.integers(0, M, n_kf)
    two = rng.uniform(size=n_kf) < 0.4
    bind[:n_kf, 1] = np.where(two, (bind[:n_kf, 0] + rng.integers(
        1, M, n_kf)) % M, -1)
    return bind


def _jax_slots(bind, n_kf, active, inactive, nd):
    """The JAX system's _inactive_refine_sharded and its step's masks:
    ids cycle-padded to the mesh, kf_mask = submap_kf_mask & not
    first-bound to the active submap, write-back first-bound only, slots
    past the real submaps masked."""
    K = bind.shape[0]
    cap = jstate.StateCapacity(n_frames=4 * K, n_keyframes=K, n_submaps=8,
                               rays_per_kf=4)
    st = jstate.init_state(cap, [2.0, 2.0, 2.0])._replace(
        keyframe_localMLP=jnp.asarray(bind, jnp.int32),
        n_kf=jnp.asarray(n_kf, jnp.int32),
        active_submap_id=jnp.asarray(active, jnp.int32))
    mi = ((len(inactive) + nd - 1) // nd) * nd
    ms = (inactive * mi)[:mi]
    kf, wb = [], []
    for s, m in enumerate(ms):
        mask = jstate.submap_kf_mask(st, m) & (
            st.keyframe_localMLP[:, 0] != st.active_submap_id)
        kf.append(np.asarray(mask))
        wb.append(np.asarray(mask & (st.keyframe_localMLP[:, 0] == m))
                  & (s < len(inactive)))
    return ms, np.stack(kf), np.stack(wb)


@pytest.mark.parametrize("nd", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_refine_slots_match_jax(seed, nd):
    """Slots, refine masks and write-back masks on one state (the host
    mirror of the bindings in the port, the device table in JAX), for
    one to seven inactive submaps; the write-back masks never overlap."""
    rng = np.random.default_rng(seed)
    K, n_kf, M = 24, 19, 6
    bind = _bindings(rng, K, n_kf, M)
    for n_inactive in range(1, M):
        active = int(rng.integers(0, M))
        inactive = [m for m in rng.permutation(M)[:n_inactive + 1].tolist()
                    if m != active][:n_inactive]
        ms, kf, wb = refine_slots(inactive, nd, bind, n_kf, active)
        ref = _jax_slots(bind, n_kf, active, inactive, nd)
        assert ms == ref[0] and len(ms) % nd == 0
        np.testing.assert_array_equal(kf, ref[1])
        np.testing.assert_array_equal(wb, ref[2])
        assert wb.sum(0).max() <= 1


def corridor_refine_config(n):
    """The tiny corridor of tests/test_torch_multi.py with more tracking
    and mapping iterations, so that it tracks (ATE ~0.11 m over 0.3 of
    the corridor); three submaps, refinement from frame 12."""
    cfg = corridor_config(n)
    cfg["tracking"].update(iter=10, iter_RO=5)
    cfg["mapping"].update(iters=10, first_iters=100)
    return cfg


def _corridor(flags: bool, n=30):
    cfg = corridor_refine_config(n)
    cfg["parallel"] = {"sharded_refine": flags, "dp_hot_path": flags}
    ds = SyntheticDataset(cfg, n_frames=n, trajectory="corridor", span=0.3,
                          device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu",
                           mesh=make_mesh(devices=["cpu"] * 2))
    return slam, slam.run(verbose=False)


def test_sharded_refine_corridor_matches_unsharded():
    """Both switches on at 2 virtual CPU shards against both off: at least
    one sharded refine (every inactive submap, cycle-padded to 2 slots),
    budgets rounded, the keyframe bindings mirrored, and the ATEs within
    JAX's own bounds (tests/test_sharded_refine.py:81-83: each < 0.16 m,
    apart by < 0.02 m)."""
    slam_s, res_s = _corridor(True)
    assert slam_s.use_sharded_refine and slam_s.use_dp_hot
    log = slam_s.sharded_refine_log
    assert log and all(len(ms) % 2 == 0 for _, ms in log)
    assert any(len(set(ms)) == 2 for _, ms in log)
    assert res_s["n_submaps"] >= 2 and slam_s._inactive_rr == 0
    for m in range(res_s["n_submaps"]):
        assert all(torch.isfinite(t).all()
                   for t in slam_s.fields[m].parameters())
    slam_q, res_q = _corridor(False)
    assert not slam_q.sharded_refine_log and slam_q._inactive_rr >= 1
    ate_s = res_s["absolute_translational_error.rmse"]
    ate_q = res_q["absolute_translational_error.rmse"]
    print(f"ATE sharded {ate_s * 1000:.1f} mm, unsharded {ate_q * 1000:.1f} "
          "mm")
    assert ate_s < 0.16 and ate_q < 0.16
    assert abs(ate_s - ate_q) < 0.02


@pytest.mark.slow
def test_port_outback_loop_closure_sharded():
    """The whole system sharded: tests/test_torch_multi.py's 220-frame
    loop-closing outback with both switches on at 2 virtual CPU shards: a
    switch back with switch BA and PGO, at least one sharded refine, and
    the ATE within 0.02 m of the unsharded run's
    (tests/test_sharded_whole_system.py:110)."""
    from test_loop_closure_e2e import loop_config
    from test_torch_slice import _triplane
    out = {}
    for flags in (True, False):
        cfg = _triplane(loop_config(220))
        cfg["use_manager"] = True
        cfg["parallel"] = {"sharded_refine": flags, "dp_hot_path": flags}
        ds = SyntheticDataset(cfg, n_frames=220, trajectory="outback",
                              span=1.0, device="cpu")
        slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu",
                               mesh=make_mesh(devices=["cpu"] * 2))
        out[flags] = (slam, slam.run(verbose=False))
    slam, res = out[True]
    assert any(flag == 1 for _, flag in slam.switch_events)
    assert slam.stage_calls["switch_ba"] >= 1 and slam.stage_calls["pgo"] >= 1
    assert slam.sharded_refine_log
    ate_s = res["absolute_translational_error.rmse"]
    ate_q = out[False][1]["absolute_translational_error.rmse"]
    assert ate_s < 0.05 and abs(ate_s - ate_q) < 0.02, (ate_s, ate_q)


def test_smoke_containment_band_recomputes_the_manager():
    """The chip smoke's account of a sharded run that takes another
    branch rests on chip_smoke.containment_band: on a tiny corridor run,
    its ratio with the faces unmoved equals the manager's own decision
    quantity (the larger of cr_active and cr_active_new) at every
    keyframe, and moving the faces in or out only lowers or raises it."""
    import chip_smoke
    cfg = corridor_config(12)
    ds = SyntheticDataset(cfg, n_frames=12, trajectory="corridor", span=0.55,
                          device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    recs = chip_smoke.record_decisions(slam)
    slam.run(verbose=False)
    assert [r["frame"] for r in recs] == [3, 6, 9]
    assert any(r["flag"] == 3 for r in recs)
    for r in recs:
        lo0, hi0 = chip_smoke.containment_band(r, 0.0)
        # the manager's ratio is a float32 division of the same counts
        assert lo0 == hi0
        assert np.float32(lo0) == max(r["cr_active"], r["cr_active_new"])
        lo, hi = chip_smoke.containment_band(r, 0.05)
        assert lo <= lo0 <= hi

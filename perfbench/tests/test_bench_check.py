"""The correctness check end to end on the CPU, at a test's size: a sound
run of the port is correct, and a run with the timed path broken
underneath is not, once for each fault a cell can have. (The exchange
between chips does not exist in a one-chip cell.)

Each run skips run.py's look for a card and drives the rest of a run
(``execute``) on the CPU, where the port runs its plain functions."""

import time

import pytest
import torch

from conftest import (HASH_CELL, LOOP_KINDS, add_hash_cell, copy_bench,
                      load_bench, run_copied_cell, tiny_cell)

SEED = 2_147_483_917
FRAMES = 16


def _run(run_module):
    torch.manual_seed(0)
    return run_module.execute(tiny_cell(), SEED, 1e9, False,
                              torch.device("cpu"), time.time(),
                              max_frames=FRAMES)


def test_sound_run_is_correct(run_module):
    res = _run(run_module)
    assert res["correct"], res["checks"]
    assert res["attempted"] == FRAMES and res["failed"] == 0
    assert res["checks"]["track_calls_checked"]["value"] >= 3
    assert res["checks"]["ba_calls_checked"]["value"] >= 2
    assert res["checks"]["ba_change_gap"]["value"] < 1e-4
    assert res["checks"]["ba_pose_median_mm"]["value"] < 1e-3
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"tracked_fps", "frame_ms_p95",
                                   "setup_s"}


def _unchanged_ba(monkeypatch):
    """Local BA returns its state unchanged: the map and poses as given."""
    from mipsfusion_tpu_torch.ops.geometry import matrix_to_quaternion
    from mipsfusion_tpu_torch.slam import mapper, programs

    def local_ba(self, field, opt, kf_rays, kf_mask, first_kf, last_kf,
                 kf_poses, cur_rays, cur_pose, *a, **k):
        return mapper.BAResult(
            kf_quat=matrix_to_quaternion(kf_poses[:, :3, :3]),
            kf_trans=kf_poses[:, :3, 3],
            cur_quat=matrix_to_quaternion(cur_pose[:3, :3]),
            cur_trans=cur_pose[:3, 3], loss=torch.zeros(()))
    monkeypatch.setattr(programs.StagePrograms, "local_ba", local_ba)
    return "ba_change_gap"


def _half_batch(monkeypatch):
    """Every rendering loss (GO, BA, refine) takes the mean over the first
    half of its rays and leaves the rest out (Adam's normalized steps hide
    it from the BA's change norms; the tracked pose shows it)."""
    from mipsfusion_tpu_torch.models import scene_rep
    orig = scene_rep.forward_losses_T

    def half(params, rays_oT, rays_dT, target_rgbT, target_d, cfg, consts,
             emd_w=0.01, generator=None, u=None):
        h = target_d.shape[0] // 2
        return orig(params, rays_oT[:, :h], rays_dT[:, :h],
                    target_rgbT[:, :h], target_d[:h], cfg, consts, emd_w,
                    generator, None if u is None else u[:h])
    monkeypatch.setattr(scene_rep, "forward_losses_T", half)
    return "track_pose_mm"


def _altered_pose(monkeypatch):
    """The tracker's answer altered where it is produced: each tracked
    pose moved by 5 mm along x."""
    from mipsfusion_tpu_torch.slam import tracker
    orig = tracker.track_pose

    def moved(*a, **k):
        res, rays = orig(*a, **k)
        shift = torch.zeros((4, 4))
        shift[0, 3] = 0.005
        return res._replace(pose=res.pose + shift.to(res.pose)), rays
    monkeypatch.setattr(tracker, "track_pose", moved)
    return "track_pose_mm"


@pytest.mark.parametrize("fault", [_unchanged_ba, _half_batch,
                                   _altered_pose],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_fault_is_not_correct(run_module, monkeypatch, fault):
    """The fault fails some compared number (``number`` among them)."""
    number = fault(monkeypatch)
    res = _run(run_module)
    rows = res["checks"]
    over = {k for k, r in rows.items()
            if r["value"] is not None and r["value"] > r["limit"]}
    assert not res["correct"]
    assert number in over, rows


def test_hash_cell_fault_is_not_correct(tmp_path):
    """The HashGrid cell that only new files add to a copy of the
    benchmark (``conftest.add_hash_cell``), with its local BA returning
    its state unchanged: not correct, by the map's change."""
    copy_bench(tmp_path)
    add_hash_cell(tmp_path, load_bench())
    res = run_copied_cell(tmp_path, HASH_CELL, "_unchanged_ba")
    rows = res["checks"]
    assert not res["correct"]
    assert rows["ba_change_gap"]["value"] > rows["ba_change_gap"]["limit"]


def _shifted(T, i=None):
    """T moved 5 mm along x (row i of a pose table, or the pose)."""
    shift = torch.zeros_like(T)
    if i is None:
        shift[0, 3] = 0.005
    else:
        shift[i, 0, 3] = 0.005
    return T + shift


def _icp_altered(monkeypatch):
    """The verification's answer altered where it is produced: the
    ICP-rectified pose moved by 5 mm."""
    from mipsfusion_tpu_torch.slam import system
    orig = system.overlap_verify_icp

    def moved(*a, **k):
        out = orig(*a, **k)
        return dict(out, pose_final=_shifted(out["pose_final"]))
    monkeypatch.setattr(system, "overlap_verify_icp", moved)
    return "icp_pose_mm"


def _switch_ba_altered(monkeypatch):
    """The switch BA's answer altered where it is produced: the loop
    keyframe's refined pose moved by 5 mm."""
    from mipsfusion_tpu_torch.slam import system
    orig = system.switch_ba_at

    def moved(st, params, kf_mask, frame_rays, i, *a, **k):
        est, loss = orig(st, params, kf_mask, frame_rays, i, *a, **k)
        return _shifted(est, int(i)), loss
    monkeypatch.setattr(system, "switch_ba_at", moved)
    return "switch_ba_pose_mm"


@pytest.mark.parametrize("fault", [None, _icp_altered, _switch_ba_altered],
                         ids=["sound", "icp_answer_altered",
                              "switch_ba_answer_altered"])
def test_loop_closure_check(run_module, monkeypatch, fault):
    """The loop-closure chain's checked calls (verification + ICP, switch
    BA, PGO), made directly on a tiny session's state once it has a
    second submap: the reference agrees with a sound program within the
    cell's limits, and an altered answer fails its number."""
    from harness import check
    number = fault(monkeypatch) if fault else None
    cell = tiny_cell()
    limits = run_module.resolve(load_bench(), cell["workload"]["name"])[
        "config"]["limits"]
    sess = run_module.open_session(cell, SEED, torch.device("cpu"))
    sess.warm(cell["traffic"]["warm_frames"] + 21)
    system, snaps = sess.system, sess.snapshots
    i = sess.next_frame - 1
    assert system.active_id != 0 and i % 10 == 0
    st = system.state
    packed = sess.stream.packed(i)
    snaps.active, snaps.frame = True, i
    pose_world = (st.kf_c2w[st.localMLP_first_kf[system.active_id]]
                  @ st.est_c2w[i])
    system._find_overlapping_region(0, system.active_id, st, packed[..., 6],
                                    packed[..., :3], pose_world)
    ver = snaps.verify[-1]["out"]
    system._switch_ba(packed, ver["top_kf_ids"][ver["top_valid"]].numpy(),
                      i)
    system.programs.global_pgo(st, st.est_c2w[i].clone(),
                               st.est_c2w[i - 1].clone(), 1, 0, 2, 0.1)
    snaps.active = False
    run_module.release(sess)
    res = check.compare(snaps, check.program_outputs(snaps),
                        check.reference_outputs(snaps, cell["config"][
                            "config"], sess.stream))
    assert res["calls"] == {"track": 0, "ba": 0, "pgo": 1, "verify": 1,
                            "switch_ba": 1}
    nums = {n: res["numbers"][n] for n in LOOP_KINDS.values()}
    if fault is None:
        assert all(v <= limits[n] for n, v in nums.items()), (nums, res)
        assert res["verify"][0]["same_keyframes"]
    else:
        assert nums[number] > limits[number], nums
    ok, _ = check.verdict(res["numbers"], {n: limits[n] for n in nums},
                          {k: 1 for k in LOOP_KINDS}, res["calls"])
    assert ok == (fault is None)


def test_ba_pose_number_is_the_median_over_calls():
    """One ill-conditioned call does not decide ``ba_pose_median_mm``;
    half the calls off do; no call gives no number."""
    from harness import check
    limits = tiny_cell()["config"]["limits"]
    lim = limits["ba_pose_median_mm"]

    def rows(*v):
        return [{"pose_median_mm": x} for x in v]
    sound = [1e-4 * lim] * 7
    assert check._median(rows(*sound, 3.0 * lim), "pose_median_mm") <= lim
    assert check._median(rows(*sound[:4], *[3.0 * lim] * 4),
                         "pose_median_mm") > lim
    assert check._median([], "pose_median_mm") is None


def test_missing_number_is_not_correct():
    """A number with a limit that no call gave fails the run."""
    from harness import check
    ok, rows = check.verdict({"pgo_anchor_mm": None}, {"pgo_anchor_mm": 1.0},
                             {}, {})
    assert not ok and rows["pgo_anchor_mm"]["value"] is None


@pytest.mark.cuda
def test_control_fails_on_the_card(cuda_device, run_module):
    """The control (the reference with its products in TF32) against the
    reference, at a small size on the card: some number over its limit."""
    import sys
    from harness import check
    cell = tiny_cell()
    conf, traffic = cell["config"], cell["traffic"]
    cfg = conf["config"]
    sess = run_module.open_session(cell, 3, cuda_device)
    snaps = sess.snapshots
    sess.warm(traffic["warm_frames"])
    sess.window(1e9, max_frames=FRAMES)
    ref = check.reference_outputs(snaps, cfg, sess.stream)
    ctl = check.reference_outputs(snaps, cfg, sess.stream, tf32=True)
    numbers = check.compare(snaps, ctl, ref)["numbers"]
    print(numbers, file=sys.stderr)
    assert any(v is not None and v > conf["limits"][k]
               for k, v in numbers.items() if k in conf["limits"])

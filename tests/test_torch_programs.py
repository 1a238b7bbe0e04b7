"""The stage programs (``mipsfusion_tpu_torch/slam/programs.py``) on the
CPU, where each program runs its body eagerly on its static buffers: for
local BA, background refinement, tracking and the first fits, the program
gives the bits of a direct call of the stage function on the same inputs
and an identically seeded generator (the draws made before the call, the
inputs copied into static buffers, parameters and moments copied in and
out), also after a submap switch, on a second submap, with the program of
the same key; one program a key; BA and refine through the program
against JAX's ``local_ba`` on the same draws; the launch counters a
capture records, added once a replay (a stand-in for the CUDA graph,
since the CPU has none); a failed capture raising with the stage and the
key. The card's replays against the eager calls:
``tests/test_torch_programs_cuda.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.ops.geometry import qt_to_matrix as jqt
from mipsfusion_tpu.slam import mapper as jmapper
from mipsfusion_tpu_torch.convert import params_from_jax, params_to_numpy
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.ops import _build
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops.geometry import qt_to_matrix as tqt
from mipsfusion_tpu_torch.slam import checkpoint as tck
from mipsfusion_tpu_torch.slam import mapper as tmapper
from mipsfusion_tpu_torch.slam import programs
from mipsfusion_tpu_torch.slam import tracker
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

from test_torch_multi import (LW, _ba_inputs, _jax_draws, ba_field,  # noqa
                              corridor_config)

torch.set_num_threads(1)
N_FRAMES = 20


def _same(a, b, what=""):
    """a and b (tensors, or nested tuples, lists and dicts of them) equal
    bit for bit."""
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


def _copy(slam, m):
    """A copy of submap m's field and of its map optimizer (the active
    submap's moments; a fresh optimizer for another submap)."""
    field = tsr.Field(slam.fields[m].params(detach=True))
    opt = tmapper.make_map_optimizer(field, slam.mcfg)
    if m == slam.active_id:
        assert tck.adam_from_leaves(opt, field, tck.adam_to_leaves(
            slam.map_opt, slam.field))
    return field, opt


def _field_and_moments(field, opt):
    return (field.params(detach=True),
            [torch.as_tensor(a) for a in tck.adam_to_leaves(opt, field)])


@pytest.fixture(scope="module")
def corridor():
    """20 corridor frames with the manager on the CPU (a second submap,
    its chunked first fit, refinement of submap 0): the system and its
    dataset."""
    cfg = corridor_config(N_FRAMES)
    ds = SyntheticDataset(cfg, n_frames=N_FRAMES, trajectory="corridor",
                          span=0.55, device="cpu")
    slam = MIPSFusionTorch(cfg, dataset=ds, device="cpu")
    slam.run(verbose=False)
    assert any(flag == 3 for _, flag in slam.switch_events)
    assert slam.active_id == 1
    return slam, ds


def _program(slam, stage):
    progs = [p for p in slam.programs.programs.values() if p.stage == stage]
    assert len(progs) == 1, [p.key[:1] for p in progs]
    return progs[0]


def test_ba_program_equals_the_function_after_a_switch(corridor):
    """Local BA on the second submap after the switch, through the
    program that ran every BA of the run (submap 0's before the switch
    too): the function's result, field and moments bit for bit."""
    slam, ds = corridor
    i = N_FRAMES - 1
    switch = max(f for f, flag in slam.switch_events if flag == 3)
    prog = _program(slam, "ba")
    after = sum(1 for f in range(switch + 1, N_FRAMES)
                if f % slam.map_every == 0)
    assert prog.calls > after          # it served submap 0 as well
    args = slam._ba_args(ds.packed(i), i)
    (fa, oa), (fb, ob) = _copy(slam, 1), _copy(slam, 1)
    ra = slam.programs.local_ba(fa, oa, *args, slam._generator("ba", i),
                                optim_cur=slam.optim_cur)
    rb = tmapper.local_ba(fb, ob, *args, slam._generator("ba", i),
                          optim_cur=slam.optim_cur)
    _same(tuple(ra), tuple(rb), "BAResult")
    _same(_field_and_moments(fa, oa), _field_and_moments(fb, ob), "field")
    assert len([p for p in slam.programs.programs.values()
                if p.stage == "ba"]) == 1


def test_refine_program_equals_the_function(corridor):
    """A refine round on the inactive submap 0 (fresh optimizer, no
    current frame): the function's bits."""
    slam, _ = corridor
    i = N_FRAMES - 1
    bind = slam._host_kf_bind
    mask = ((np.arange(bind.shape[0]) < slam.state.n_kf)
            & ((bind[:, 0] == 0) | (bind[:, 1] == 0)) & (bind[:, 0] != 1))
    assert mask.any()
    args = slam._refine_args(0, mask)
    _program(slam, "refine")
    (fa, oa), (fb, ob) = _copy(slam, 0), _copy(slam, 0)
    ra = slam.programs.local_ba(fa, oa, *args, slam._generator("refine", i),
                                include_current=False)
    rb = tmapper.local_ba(fb, ob, *args, slam._generator("refine", i),
                          include_current=False)
    _same(tuple(ra), tuple(rb), "BAResult")
    _same(_field_and_moments(fa, oa), _field_and_moments(fb, ob), "field")


@pytest.mark.parametrize("i", [N_FRAMES - 1, N_FRAMES - 2])
def test_track_program_equals_the_function(corridor, i):
    """Tracking frame i (a keyframe and not) with the drift gate off: the
    result and the committed pose store, bit for bit."""
    slam, ds = corridor
    args, levers = slam._track_args(ds.packed(i), i)
    assert not levers
    st = slam.state
    out = []
    for run in (slam.programs.track_frame_update,
                tracker.track_frame_update):
        a = list(args)
        a[6] = slam._generator("track", i)
        a[8] = dataclasses.replace(st, est_c2w=st.est_c2w.clone(),
                                   est_c2w_rel=st.est_c2w_rel.clone(),
                                   keyframe_ref=st.keyframe_ref.clone())
        res = run(*a)
        out.append(([getattr(res, k) for k in (
            "pose", "loss", "loss_ewma", "accepted", "drift_res", "armed",
            "fired", "rescued", "ss_scale")],
            (a[8].est_c2w, a[8].est_c2w_rel, a[8].keyframe_ref)))
    _same(out[0], out[1], "track")
    assert slam.programs.programs                       # the run's


def test_fit_program_chunks_equal_the_function(corridor):
    """The first fit of 40 iterations as programs of 16, 16 and 8 on the
    active optimizer: the function's 40 iterations, bit for bit."""
    slam, ds = corridor
    rays = ds.packed(0).reshape(-1, 7)
    n_rays = slam._round_rays(slam.mcfg.sample)
    (fa, oa), (fb, ob) = _copy(slam, 1), _copy(slam, 1)
    la = slam.programs.init_submap_fit(
        fa, oa, rays, slam.fcfg, slam.consts, slam.mcfg, slam.lw, 40,
        n_rays, slam._generator("init", 99), chunk=16)
    lb = tmapper.init_submap_fit(
        fb, ob, rays, slam.fcfg, slam.consts, slam.mcfg, slam.lw, 40,
        n_rays, slam._generator("init", 99))
    _same(la, lb, "loss")
    _same(_field_and_moments(fa, oa), _field_and_moments(fb, ob), "field")
    fits = sorted(p.key[5] for p in slam.programs.programs.values()
                  if p.stage == "fit")
    assert fits == [8, 16]               # the run's chunk, the remainder


# ------------------------------------------------- keys; JAX's local_ba

def _small_ba(ba_field, seed=1):
    jf, tf, p = ba_field
    rays, _, poses, _ = _ba_inputs(seed=seed)
    mask = np.array([True, True, False, True])
    consts = tsr.FieldConsts(torch.full((3,), -10.0),
                             torch.full((3,), 0.047))
    return jf, tf, p, rays, poses, mask, consts


def test_one_program_a_key(ba_field):
    """The same shapes and flags reuse the program; another ray budget,
    optim_cur or include_current makes another."""
    jf, tf, p, rays, poses, mask, consts = _small_ba(ba_field)
    progs = programs.StagePrograms("cpu")
    tm = tmapper.MapConfig(sample=48, pixels_cur=16, iters=2,
                           pose_accum_step=2)
    field = params_from_jax(p)
    opt = tmapper.make_map_optimizer(field, tm)

    def call(n_total, optim_cur=False, include_current=True):
        g = torch.Generator().manual_seed(0)
        progs.local_ba(field, opt, torch.tensor(rays), torch.tensor(mask),
                       0, torch.tensor(3), torch.tensor(poses),
                       torch.tensor(rays[0]), torch.eye(4), tf, consts, tm,
                       tsr.LossWeights(*LW), n_total, g,
                       include_current=include_current, optim_cur=optim_cur)

    call(48)
    call(48)
    assert len(progs.programs) == 1
    assert next(iter(progs.programs.values())).calls == 2
    call(48, optim_cur=True)
    call(64)
    call(48, include_current=False)
    assert len(progs.programs) == 4
    assert sorted(s["programs"] for s in progs.stats().values()) == [1, 3]


@pytest.mark.parametrize("include_current", [False, True])
def test_ba_program_matches_jax(ba_field, monkeypatch, include_current):
    """Refine (a fresh optimizer, no current frame) and BA (the current
    frame's quota) through the program on JAX's draws, against JAX's
    local_ba: keyframe poses, every field parameter and the last loss to
    1e-5 (tests/test_torch_multi.py's bound for the function)."""
    jf, tf, p, rays, poses, mask, consts = _small_ba(ba_field)
    first_kf, last_kf, n_total = 0, 3, 48
    cur = rays[0] if include_current else np.zeros((8, 7), np.float32)
    jm = jmapper.MapConfig(sample=n_total, pixels_cur=16, iters=4,
                           pose_accum_step=2)
    key = jax.random.PRNGKey(5)
    jp = jax.tree.map(jnp.asarray, p)
    jc = jsr.FieldConsts(jnp.full(3, -10.0), jnp.full(3, 0.047))
    ref = jmapper.local_ba(
        jp, jmapper.make_map_optimizer(jm).init(jp), key,
        jnp.asarray(rays), jnp.asarray(mask), first_kf, last_kf,
        jnp.asarray(poses), jnp.asarray(cur), jnp.eye(4), jf, jc, jm,
        jsr.LossWeights(*LW), n_total, include_current=include_current)
    w, _ = jmapper._kf_sampling_weights(jnp.asarray(mask), first_kf,
                                        last_kf, n_total,
                                        16 if include_current else 0)
    draws = _jax_draws(key, jnp.log(w + 1e-12), jm.iters, n_total,
                       rays.shape[1], cur.shape[0])
    monkeypatch.setattr(tmapper, "ba_draws",
                        lambda *a: (draws, [None] * len(draws)))
    field = params_from_jax(p)
    tm = tmapper.MapConfig(sample=n_total, pixels_cur=16, iters=4,
                           pose_accum_step=2)
    res = programs.StagePrograms("cpu").local_ba(
        field, tmapper.make_map_optimizer(field, tm), torch.tensor(rays),
        torch.tensor(mask), first_kf, torch.tensor(last_kf),
        torch.tensor(poses), torch.tensor(cur), torch.eye(4), tf, consts,
        tm, tsr.LossWeights(*LW), n_total, include_current=include_current)
    ref_poses = np.asarray(jqt(ref.kf_quat, ref.kf_trans))
    assert np.abs(ref_poses[1] - poses[1]).max() > 1e-4        # it moved
    np.testing.assert_allclose(
        tqt(res.kf_quat, res.kf_trans).numpy(), ref_poses, atol=1e-5)
    assert float(res.loss) == pytest.approx(float(ref.loss), rel=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-5), params_to_numpy(field),
        ref.field_params)


# ------------------------------------- capture: counters and failures

class _RecordingGraphs:
    """A stand-in for ``programs.CudaGraphs`` on the CPU: the warm-up runs
    the body, the capture runs it as recording (its launches counted,
    then taken back by the program) and hands back a replay that runs no
    Python, as a CUDA graph's does not."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.replayed = 0

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        out = fn()

        def replay():
            self.replayed += 1
        return replay, out, 0


def test_replays_add_the_captured_launch_counts():
    """A body that launches K1 twice and K2 once: after the first call
    (warm-up and capture) the counters read one call's launches, after
    each replay one call's more."""
    dev = torch.device("cpu")

    def body(s):
        _build.count_launch(fc.field_forward, dev)
        _build.count_launch(fc.field_forward, dev)
        _build.count_launch(fc.decoder_backward, dev)
        fc.decoder_backward.dw_launches += 1
        return {"y": s["x"] * 2.0}

    graphs = _RecordingGraphs()
    prog = programs.Program("test", ("test",), body, graphs)
    fc.reset_launch_counts()
    x = torch.arange(4.0)
    for n in (1, 2, 3):
        out = prog({"x": x + n})
        assert fc.launch_counts()["field_forward"] == 2 * n
        assert fc.launch_counts()["decoder_backward"] == n
        assert fc.decoder_backward.dw_launches == n
        assert fc.launch_counts(by_device=True)["field_forward"] == {
            None: 2 * n}
    assert graphs.replayed == 2 and prog.replays == 2 and prog.calls == 3
    # the stand-in's replay recomputes nothing: the captured output
    assert torch.equal(out["y"], 2.0 * (torch.arange(4.0) + 1))
    fc.reset_launch_counts()


def test_a_failed_capture_raises_with_stage_and_key():
    prog = programs.Program("track", ("track", 7), lambda s: {"y": s["x"]},
                            _RecordingGraphs(fail=True))
    with pytest.raises(RuntimeError, match=r"stage 'track' at key "
                                           r"\('track', 7\)"):
        prog({"x": torch.zeros(2)})


def test_inputs_must_fit_the_key():
    prog = programs.Program("ba", ("ba",), lambda s: {"y": s["x"] + 1})
    assert torch.equal(prog({"x": torch.zeros(2)})["y"], torch.ones(2))
    with pytest.raises(ValueError, match="do not fit"):
        prog({"x": torch.zeros(3)})

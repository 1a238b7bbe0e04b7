"""The stage programs on the card: each program's replay gives the bits of
the stage function called eagerly on copies of the same inputs from an
identically seeded generator (local BA, refine, track, a chunk of the
first fit; PGO, switch BA, the manager's predicates, a verification +
ICP; the drift-gated track quiet, with its refresh due and fired, after
a short run of the flagship field on small frames), a replay adds the
launches the eager call makes to the kernels' counters, and a capture
that meets a host read raises, naming the stage and the key.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_programs_cuda.py -m cuda
"""

import pytest
import torch

import chip_smoke
from mipsfusion_tpu_torch.config import flagship_outback
from mipsfusion_tpu_torch.datasets.synthetic import SyntheticDataset
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.slam import programs
from mipsfusion_tpu_torch.slam.system import MIPSFusionTorch

pytestmark = pytest.mark.cuda
STAGES = ("ba", "refine", "track", "fit")
LOOP_STAGES = ("pgo", "switch_ba", "manager", "verify")
GATE_STAGES = ("track_gate", "track_due", "track_fired")
# the stages that launch kernels (PGO, the predicates and verification
# launch none)
LAUNCHING = STAGES + ("switch_ba",) + GATE_STAGES


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def run():
    """30 outback frames at 60 x 80 with the flagship field (the kernels'
    "flag" shape) and small budgets: the system after its run, and its
    dataset."""
    dev = _device()
    cfg = flagship_outback(use_manager=True)
    cfg["data"]["output"] = None
    cfg["cam"].update(H=60, W=80, fx=40.0, fy=40.0, cx=39.5, cy=29.5)
    cfg["tracking"].update(iter_RO=2, iter=4, sample=256)
    cfg["tracking"]["RO"].update(particle_size=128, n_rows=8, n_cols=12)
    cfg["mapping"].update(sample=384, pixels_cur=128, iters=4,
                          first_iters=24, first_iters_chunk=8)
    cfg["sampling"].update(kf_n_rays_h=12, kf_n_rays_w=16)
    ds = SyntheticDataset(cfg, n_frames=30, trajectory="outback", span=0.3,
                          device=dev)
    slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    slam.run(verbose=False)
    return slam, ds


def _pair(slam, ds, stage):
    if stage in STAGES:
        return chip_smoke.stage_pairs(slam, ds, ds.num_frames - 1)[stage]
    if stage in LOOP_STAGES:
        return chip_smoke.loop_pairs(slam, ds)[stage]
    return chip_smoke.gate_pairs(slam, ds)[stage]


@pytest.mark.parametrize("stage", STAGES + LOOP_STAGES + GATE_STAGES)
def test_replay_equals_the_eager_call(run, stage):
    slam, ds = run
    prog, eager = _pair(slam, ds, stage)
    prog([])                                  # captured, if it was not
    for _ in range(2):
        out = prog([])
        assert chip_smoke._bits_equal(out, eager([]))
    if stage in GATE_STAGES:
        fired = bool(out[0][chip_smoke.TRACK_FIELDS.index("fired")])
        assert fired == (stage == "track_fired")
        assert bool(out[2][0]) == (stage == "track_due")


@pytest.mark.parametrize("stage", LAUNCHING)
def test_replay_counts_the_eager_launches(run, stage):
    """The counters after a replay moved exactly as after the eager call
    (totals, per device, K2 with weight gradients, K1's sdf-only sizes);
    the gated track's launches split over its read and its rescue."""
    slam, ds = run
    prog, eager = _pair(slam, ds, stage)
    prog([])
    fc.reset_launch_counts()
    eager([])
    want = fc.launch_counters()
    fc.reset_launch_counts()
    prog([])
    assert fc.launch_counters() == want
    assert want[("field_forward", "launches")] > 0
    fc.reset_launch_counts()


def test_syev_batched_is_eighs_bits_and_captures():
    """The normals' cuSOLVER call gives torch.linalg.eigh's eigenvalues
    and eigenvectors bit for bit (flat, elongated and zero covariances),
    and a program of it replays them."""
    from mipsfusion_tpu_torch.ops import cusolver
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, 10, 3, device=dev, generator=g) * torch.tensor(
        [1.0, 0.5, 0.01], device=dev)
    x = x - x.mean(1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", x, x)
    cov[:8] = 0.0
    ref = torch.linalg.eigh(cov)
    values, vectors = cusolver.syev_batched(cov)
    assert torch.equal(values, ref.eigenvalues)
    assert torch.equal(vectors, ref.eigenvectors)
    prog = programs.Program(
        "normals", ("normals",),
        lambda s: {"v": cusolver.syev_batched(s["c"])[1]},
        programs.CudaGraphs(dev))
    prog({"c": cov})
    assert torch.equal(prog({"c": cov})["v"], ref.eigenvectors)


def test_zz_a_host_read_fails_the_capture():
    """A body that reads the device from the host cannot be captured: the
    program raises, naming the stage and the key (it runs last: the
    failed capture is the file's final use of the card)."""
    dev = _device()
    prog = programs.Program(
        "probe", ("probe", 1),
        lambda s: {"y": s["x"] * float(s["x"].sum().item())},
        programs.CudaGraphs(dev))
    with pytest.raises(RuntimeError,
                       match=r"capturing stage 'probe' at key \('probe', 1\)"):
        prog({"x": torch.ones(4, device=dev)})


@pytest.fixture(scope="module")
def hash_run():
    """The ``run`` fixture's 30 outback frames with the HashGrid field (16
    levels x 2, 2^19 rows: H1-H3 and K1 / K2 at the hash shape)."""
    dev = _device()
    cfg = flagship_outback(use_manager=True)
    cfg["data"]["output"] = None
    cfg["grid"].update(enc="HashGrid", hash_size=19)
    cfg["cam"].update(H=60, W=80, fx=40.0, fy=40.0, cx=39.5, cy=29.5)
    cfg["tracking"].update(iter_RO=2, iter=4, sample=256)
    cfg["tracking"]["RO"].update(particle_size=128, n_rows=8, n_cols=12)
    cfg["mapping"].update(sample=384, pixels_cur=128, iters=4,
                          first_iters=24, first_iters_chunk=8)
    cfg["sampling"].update(kf_n_rays_h=12, kf_n_rays_w=16)
    ds = SyntheticDataset(cfg, n_frames=30, trajectory="outback", span=0.3,
                          device=dev)
    slam = MIPSFusionTorch(cfg, dataset=ds, device=dev)
    slam.run(verbose=False)
    assert slam.field.hash is not None
    return slam, ds


@pytest.mark.parametrize("stage", STAGES)
def test_hash_replay_equals_the_eager_call(hash_run, stage):
    """On the HashGrid field each stage program's replay gives the eager
    call's bits (H2's int64 table gradient included), and moves the
    launch counters (the hash kernels' launches too) as the eager call
    does."""
    slam, ds = hash_run
    prog, eager = _pair(slam, ds, stage)
    prog([])
    for _ in range(2):
        assert chip_smoke._bits_equal(prog([]), eager([]))
    fc.reset_launch_counts()
    eager([])
    want = fc.launch_counters()
    fc.reset_launch_counts()
    prog([])
    assert fc.launch_counters() == want
    assert want[("hash_forward", "launches")] > 0
    # GO differentiates the pose alone, a first fit the field alone
    assert (want[("hash_x_backward", "launches")] > 0) == (stage != "fit")
    assert (want[("hash_table_backward", "launches")] > 0) == (
        stage != "track")
    fc.reset_launch_counts()

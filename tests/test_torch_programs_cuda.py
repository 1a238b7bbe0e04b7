"""The stage programs on the card: each program's replay gives the bits of
the stage function called eagerly on copies of the same inputs from an
identically seeded generator (local BA, refine, track, a chunk of the
first fit, after a short run of the flagship field on small frames), a
replay adds the launches the eager call makes to the kernels' counters,
and a capture that meets a host read raises, naming the stage and the
key.

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


@pytest.mark.parametrize("stage", STAGES)
def test_replay_equals_the_eager_call(run, stage):
    slam, ds = run
    prog, eager = chip_smoke.stage_pairs(slam, ds, ds.num_frames - 1)[stage]
    prog([])                                  # captured, if it was not
    for _ in range(2):
        assert chip_smoke._bits_equal(prog([]), eager([]))


@pytest.mark.parametrize("stage", STAGES)
def test_replay_counts_the_eager_launches(run, stage):
    """The counters after a replay moved exactly as after the eager call
    (totals, per device, K2 with weight gradients, K1's sdf-only sizes)."""
    slam, ds = run
    prog, eager = chip_smoke.stage_pairs(slam, ds, ds.num_frames - 1)[stage]
    prog([])
    fc.reset_launch_counts()
    eager([])
    want = fc.launch_counters()
    fc.reset_launch_counts()
    prog([])
    assert fc.launch_counters() == want
    assert want[("field_forward", "launches")] > 0
    fc.reset_launch_counts()


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

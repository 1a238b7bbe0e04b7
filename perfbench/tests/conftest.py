"""Paths and the tiny CPU cell of the benchmark's own tests.

Run from the repository's root: ``python -m pytest perfbench/tests -q``
(CPU; the card-only tests carry the ``cuda`` marker and skip without a
card)."""

import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
for p in (PB, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def load_run():
    spec = importlib.util.spec_from_file_location(
        "perfbench_run", os.path.join(PB, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(name: str = "flag-full.outback-laps") -> dict:
    """A cell of BENCHMARK.json cut to a CPU test's size: 48 x 64 frames,
    a 30-frame lap, every budget small; the field's widths as run."""
    run = load_run()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = copy.deepcopy(run.resolve(json.load(f), name))
    c = cell["config"]["config"]
    c["cam"].update(H=48, W=64, fx=32.0, fy=32.0, cx=31.5, cy=23.5)
    c["sampling"].update(kf_n_rays_h=12, kf_n_rays_w=16)
    c["tracking"].update(iter=3, iter_RO=2, sample=64, ignore_edge_W=4,
                         ignore_edge_H=4)
    c["tracking"]["RO"].update(particle_size=32, n_rows=4, n_cols=6)
    c["mapping"].update(sample=96, pixels_cur=32, iters=3, first_iters=10,
                        first_iters_chunk=4)
    c["mapping"]["overlapping"].update(n_rays_h=8, n_rays_w=8)
    c["training"].update(n_samples_d=8, n_range_d=5)
    cell["traffic"].update(lap_frames=30, session_frames=200,
                           warm_frames=30, trace_frames=0, check_span=12)
    # at this size the track never closes a loop: the loop-closure
    # kinds are checked by direct calls (test_bench_check.py)
    chk, limits = cell["config"]["check"], cell["config"]["limits"]
    for kind, number in LOOP_KINDS.items():
        chk["required"].pop(kind, None)
        limits.pop(number, None)
    return cell


# each loop-closure kind of checked call and the number it gives
LOOP_KINDS = {"pgo": "pgo_anchor_mm", "verify": "icp_pose_mm",
              "switch_ba": "switch_ba_pose_mm"}


# a cell that only new files add to a copy of the benchmark: a HashGrid
# field on flag-full's budgets, its table at 2^14 rows a level (3 dense
# levels, 13 hashed)
HASH_CELL = "hash-test.hash-mix"


def copy_bench(dst) -> dict:
    """Copy perfbench/ (no outputs) and BENCHMARK.json into ``dst``;
    returns the copied benchmark and the bytes of every copied file."""
    shutil.copytree(PB, dst / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}


def add_hash_cell(dst, bench: dict, enc: str = "HashGrid") -> str:
    """Add ``HASH_CELL`` to the copy in ``dst`` as new files: its
    configuration (flag-full.json with ``grid.enc`` ``enc``), its mix (a
    copy of outback-laps.json) and its entries in ``bench``, written to
    ``dst/BENCHMARK.json``."""
    conf_name, mix = HASH_CELL.split(".")
    pb = dst / "perfbench"
    conf = json.loads((pb / "configs" / "flag-full.json").read_text())
    conf["name"] = conf_name
    conf["config"]["grid"].update(enc=enc, hash_size=14)
    (pb / "configs" / f"{conf_name}.json").write_text(json.dumps(conf))
    shutil.copy(pb / "traffic" / "outback-laps.json",
                pb / "traffic" / f"{mix}.json")
    bench["configs"].append({"name": conf_name, "source": "x",
                             "file": f"perfbench/configs/{conf_name}.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": HASH_CELL, "config": conf_name,
                               "traffic": mix, "chips": 1, "why": "x"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return HASH_CELL


def run_copied_cell(dst, cell: str, fault: str = "") -> dict:
    """The result line of ``cell`` of the copy in ``dst``, run on the CPU
    at ``tiny_cell``'s sizes by the copy's own files (``cell_on_cpu.py``),
    with the fault of test_bench_check.py named ``fault`` applied."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, str(dst / "perfbench" / "tests" / "cell_on_cpu.py"),
         cell, fault], capture_output=True, text=True, timeout=600,
        cwd=dst, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def run_module():
    return load_run()


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda", 0)

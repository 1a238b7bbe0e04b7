"""The hash-full cell's own files: its configuration run on the CPU at a
test's size through the real harness (``correct``, and not ``correct``
when local BA leaves its state unchanged), the hash encoding's work count
(``harness/hash_count.py``) against a count by hand, and the two hash
kernels' roofline readers, which read nothing where no hash kernel ran."""

import importlib.util
import os
import time

import pytest
import torch

import test_bench_check
from conftest import PB, load_bench, load_run, tiny_cell
from harness import hash_count, work

CELL = "hash-full.outback-laps"


def _run(run_module):
    torch.manual_seed(0)
    return run_module.execute(tiny_cell(CELL), test_bench_check.SEED, 1e9,
                              False, torch.device("cpu"), time.time(),
                              max_frames=test_bench_check.FRAMES)


def test_hash_full_is_a_hash_grid_on_flag_full():
    """The configuration differs from flag-full's only in ``grid.enc``,
    and the cell runs flag-full's traffic."""
    run = load_run()
    bench = load_bench()
    hash_cell = run.resolve(bench, CELL)
    flag = run.resolve(bench, "flag-full.outback-laps")
    a, b = hash_cell["config"]["config"], flag["config"]["config"]
    assert hash_cell["encoding"] == "HashGrid"
    assert a["grid"]["hash_size"] == 19
    assert {**a, "grid": None} == {**b, "grid": None}
    assert {k: v for k, v in a["grid"].items() if k != "enc"} == {
        k: v for k, v in b["grid"].items() if k != "enc"}
    assert hash_cell["traffic"] == flag["traffic"]


def test_hash_full_runs_correct_on_the_cpu(run_module):
    res = _run(run_module)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["ba_calls_checked"]["value"] >= 2


def test_hash_full_unchanged_ba_is_not_correct(run_module, monkeypatch):
    test_bench_check._unchanged_ba(monkeypatch)
    res = _run(run_module)
    rows = res["checks"]
    assert not res["correct"]
    assert rows["ba_change_gap"]["value"] > rows["ba_change_gap"]["limit"]


def test_hash_count_by_hand():
    """At 2^14 rows a level: 16 levels x 2 features, E = 32; levels 0-2
    (resolutions 16, 20, 24) are dense and address 16^3, 20^3 and 24^3
    rows, the other 13 all 2^14. The encode: 60 FLOPs a level (12 for the
    coordinates and axis weights, 16 for 8 corner weights, 32 to blend 8
    corners x 2 features), 12 + 128 bytes a point (x in, the embed out),
    the addressable rows (2 floats each) read once a launch; the table
    gradient the same FLOPs and bytes a point, and the whole table
    (16 x 2^14 x 2 floats) written once; the point gradient 117 FLOPs a
    level and d_x_pe's add, 12 + 128 + 12 + 12 bytes a point, the
    addressable rows read once; the decoder's kinds nothing."""
    cfg = {"grid": {"enc": "HashGrid", "hash_size": 14}}
    d = hash_count.dims(cfg)
    T = 1 << 14
    assert d == {"L": 16, "F": 2, "T": T, "E": 32,
                 "rows": [4096, 8000, 13824] + [T] * 13}
    read = 4 * 2 * (4096 + 8000 + 13824 + 13 * T)
    grad = 4 * 16 * T * 2
    assert hash_count.work("field_forward", d) == (960, 140, read)
    assert hash_count.work("field_forward_sdf", d) == (960, 140, read)
    assert hash_count.work("plane_backward", d) == (960, 140, grad)
    assert hash_count.work("x_backward_add", d) == (1875, 164, read)
    for kind in ("decoder_backward", "decoder_backward_go"):
        assert hash_count.work(kind, d) == (0, 0, 0)


def test_hash_least_time_by_hand():
    """One BA call of the hash-full configuration: 15 iterations of one
    encode, one table gradient and one point gradient on 2600 x 75 =
    195,000 points; each launch bound by its bytes (FLOPs at 67 TFLOP/s
    take less). At 2^19 rows, levels 0-8 are dense (resolutions 16, 20,
    24, 28, 34, 41, 49, 59, 71) and levels 9-15 hashed."""
    cfg = load_run().resolve(load_bench(), CELL)["config"]["config"]
    T = 1 << 19
    res = (16, 20, 24, 28, 34, 41, 49, 59, 71)
    read = 4 * 2 * (sum(r ** 3 for r in res) + 7 * T)
    grad = 4 * 16 * T * 2
    pts = 2600 * 75
    fwd = 15 * (140 * pts + read) / work.PEAK_BYTES
    bwd = 15 * ((140 * pts + grad) + (164 * pts + read)) / work.PEAK_BYTES
    assert 960 * pts / work.PEAK_OTHER < (140 * pts + read) / work.PEAK_BYTES
    got_f = hash_count.least_s(cfg, {"ba": 1}, hash_count.KINDS_FORWARD)
    got_b = hash_count.least_s(cfg, {"ba": 1}, hash_count.KINDS_BACKWARD)
    assert got_f == pytest.approx(fwd, rel=1e-12)
    assert got_b == pytest.approx(bwd, rel=1e-12)
    flag = load_run().resolve(load_bench(), "flag-full.outback-laps")
    assert hash_count.least_s(flag["config"]["config"], {"ba": 1},
                              hash_count.KINDS_FORWARD) is None


@pytest.mark.parametrize("reader", ["hash_fwd_roofline", "hash_bwd_roofline"])
def test_hash_readers_read_nothing_without_hash_kernels(reader):
    """On a trace of the Triplane kernels alone (as a port without the hash
    kernels gives) and on a run with no trace, the readers return None;
    on a trace with the hash kernels, a share of their device time."""
    spec = importlib.util.spec_from_file_location(
        reader, os.path.join(PB, "metrics", f"{reader}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = load_run().resolve(load_bench(), CELL)["config"]["config"]
    calls = {"ba": 10, "track": 30, "refine": 10}
    triplane = {"void mf::(anonymous namespace)::field_forward_kernel<x>()":
                0.2, "void mf::(anonymous namespace)::decoder_bwd_kernel<x>()":
                0.5, "void mf::(anonymous namespace)::x_bwd_kernel<x>()": 0.1}
    ctx = {"cfg": cfg, "calls": calls,
           "trace": {"kernel_s": triplane, "busy_s": 1.0, "window_s": 2.0}}
    assert mod.read(ctx) is None
    assert mod.read({"cfg": cfg}) is None
    kernels = dict(triplane)
    kernels.update({
        "void mf::(anonymous namespace)::hash_fwd_kernel<mf::HashShape<16>>()":
            0.4,
        "void mf::(anonymous namespace)::hash_table_bwd_kernel<x>()": 0.6,
        "void mf::(anonymous namespace)::hash_table_bwd_finish_kernel()":
            0.1,
        "void mf::(anonymous namespace)::hash_x_bwd_kernel<x>()": 0.3})
    ctx["trace"]["kernel_s"] = kernels
    kinds = (hash_count.KINDS_FORWARD if reader == "hash_fwd_roofline"
             else hash_count.KINDS_BACKWARD)
    busy = 0.4 if reader == "hash_fwd_roofline" else 1.0
    want = 100.0 * hash_count.least_s(cfg, calls, kinds) / busy
    assert mod.read(ctx) == pytest.approx(want, rel=1e-12)
    assert 0 < mod.read(ctx) < 100

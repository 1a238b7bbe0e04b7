"""BENCHMARK.json and the files it names: every cell resolves by name, the
names and units keep to the benchmark's characters, a new configuration,
mix and metric need only new files, and nothing the benchmark runs
imports JAX or the JAX package."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import (HASH_CELL, PB, ROOT, add_hash_cell, copy_bench,
                      run_copied_cell)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves(run_module):
    b = bench()
    for wl in b["workloads"]:
        cell = run_module.resolve(b, wl["name"])
        assert cell["config"]["name"] == wl["config"]
        assert cell["traffic"]["lap_frames"] > 0
        assert {m["name"] for m in cell["per_layer"]} <= set(cell["readers"])
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


def test_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for w in b["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in b["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_new_cell_needs_only_new_files(tmp_path, run_module):
    """A dummy configuration, mix and metric added as new files to a copy
    of perfbench/ and a cell that uses them resolve with no edit to a file
    that is there; and a cell of a field of the other encoding (HashGrid),
    added the same way, runs on the CPU to ``correct``."""
    before = copy_bench(tmp_path)
    del before[tmp_path / "BENCHMARK.json"]
    dst = tmp_path / "perfbench"
    b = bench()
    with open(dst / "configs" / "flag-full.json") as f:
        conf = json.load(f)
    conf["name"] = "dummy-conf"
    (dst / "configs" / "dummy-conf.json").write_text(json.dumps(conf))
    with open(dst / "traffic" / "outback-laps.json") as f:
        mix = json.load(f)
    mix["lap_frames"] = 123
    (dst / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (dst / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    b["configs"].append({"name": "dummy-conf", "source": "x",
                         "file": "perfbench/configs/dummy-conf.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "dummy-conf.dummy-mix",
                           "config": "dummy-conf", "traffic": "dummy-mix",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "dummy_metric", "unit": "s",
                           "better": "lower", "source": "program_counter",
                           "layer": "x", "moves": "tracked_fps",
                           "workloads": ["dummy-conf.dummy-mix"]})
    # a cell's own form of a metric is read by the metric's one reader
    b["per_layer"].append({"name": "ate_rmse_mm.dummy-conf.dummy-mix",
                           "unit": "mm", "better": "lower",
                           "source": "program_counter", "layer": "x",
                           "moves": "tracked_fps",
                           "workloads": ["dummy-conf.dummy-mix"]})
    add_hash_cell(tmp_path, b)
    code = ("import sys, json, importlib.util; "
            f"sys.path.insert(0, {str(dst)!r}); "
            f"spec = importlib.util.spec_from_file_location('r', "
            f"{str(dst / 'run.py')!r}); m = importlib.util.module_from_spec"
            "(spec); spec.loader.exec_module(m); "
            f"c = m.resolve(json.load(open({str(tmp_path / 'BENCHMARK.json')!r})), "
            "'dummy-conf.dummy-mix'); "
            "print(c['traffic']['lap_frames'], c['config']['name'], "
            "c['readers']['dummy_metric']({}), "
            "c['readers']['ate_rmse_mm.dummy-conf.dummy-mix']("
            "{'ate_rmse_mm': 7.5}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["123", "dummy-conf", "42.0", "7.5"]
    res = run_copied_cell(tmp_path, HASH_CELL)
    assert res["correct"], res["checks"]
    assert res["checks"]["ba_calls_checked"]["value"] >= 2
    assert all(p.read_bytes() == v for p, v in before.items())


def test_missing_encoding_is_refused_before_setup(tmp_path):
    """A configuration whose grid.enc has no reference module: run.py
    exits 2 while it resolves the cell, naming the file it looked for,
    and prints no result."""
    copy_bench(tmp_path)
    add_hash_cell(tmp_path, bench(), enc="NoSuchEncoding")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", HASH_CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 2, out.stderr
    assert "missing file of the benchmark: " \
        "perfbench/reference/encodings/NoSuchEncoding.py" in out.stderr
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("sub", ["harness", "harness/counts", "reference",
                                 "reference/encodings", "metrics", "."])
def test_no_jax_and_a_reference_of_its_own(sub):
    """No module under perfbench/ imports jax or the JAX package (top-level
    names compared whole: the port's name begins with the JAX package's),
    and the reference imports nothing of the port."""
    base = os.path.join(PB, sub)
    files = [os.path.join(base, f) for f in os.listdir(base)
             if f.endswith(".py")]
    assert files
    for f in files:
        tops = set(_imports(f))
        assert not tops & {"jax", "jaxlib", "flax", "mipsfusion_tpu"}, f
        if sub.startswith("reference"):
            assert "mipsfusion_tpu_torch" not in tops, f
            assert not tops & {"harness"}, f


def test_refuses_without_a_card():
    """No CPU fallback: without a CUDA device run.py exits non-zero and
    prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload",
         "flag-full.outback-laps", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 3, out.stderr
    assert out.stdout.strip() == ""


def test_refuses_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ gives no
    result."""
    copy_bench(tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "flag-full.outback-laps", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

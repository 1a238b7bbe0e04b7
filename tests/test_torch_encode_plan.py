"""K0's launch plan (ops/_build.py EncodePlan, FieldShape.encode_plan) at
every shape of the kernels' table, on the CPU.

K0 (csrc/triplane.cuh encode_fwd_kernel) cuts the encode into roles: one
per plane scale (a lane a point) and one for the CP lines (a lane a
point's group of 4 channels). A block takes one role, stages the role's
table in shared memory where it fits, and walks the role's tiles of
K0_THREADS items. Which roles stage is a fact of the shape; the split of
the SMs across the roles is worked out in Python, once per shape and
card: these tests hold it to the card's shared-memory
limit, to the kernel's constants, and hold a host model of the kernel's
indexing (tiles strided over a role's blocks, items to output slots) to
cover every value of the [N, E] output exactly once.
"""

import os
import re
import subprocess

import numpy as np
import pytest

from mipsfusion_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mipsfusion_tpu_torch", "csrc")
SHAPES = {s.name: s for s in _build.SHAPES.values()}
H100_SMS = 132


def _constant(name: str) -> int:
    with open(os.path.join(CSRC, "triplane.cuh")) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    return int(m.group(1))


def test_plan_constants_are_the_kernels():
    """The plan's lanes a tile, shared-memory limit and barrier bytes are
    the kernel's, and its roles are the kernel's four."""
    assert _build.K0_THREADS == _constant("K0_THREADS")
    assert _build.SMEM_MAX == _constant("K0_SMEM_MAX") == 232_448
    assert _build.K0_BARRIER == _constant("K0_BARRIER")
    assert len(_build.ENCODE_ROLES) == _constant("K0_ROLES")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tables_and_shared_memory(name):
    """Each role's table is its planes' (or the CP lines') bytes; the
    dynamic shared memory is the largest table that fits plus the barrier,
    within a block's 232,448 bytes; every role stages its table where it
    fits: the flagship all three tables, cp and fcl all but the
    786,432-byte third scale."""
    shape = SHAPES[name]
    tables = shape.encode_tables
    assert sum(tables) == 4 * shape.table_size
    assert tables[3] == 4 * int(np.prod(shape.cp_shape))
    for s, shp in enumerate(shape.plane_shapes):
        assert tables[s] == 4 * int(np.prod(shp))
    plan = shape.encode_plan(H100_SMS)
    assert plan.smem <= _build.SMEM_MAX
    assert plan.smem == shape.encode_smem == 196_608 + _build.K0_BARRIER
    for b, staged in zip(tables, shape.encode_staged):
        assert staged == (0 < b <= plan.smem - _build.K0_BARRIER)
    assert shape.encode_staged == (True, True, False, True)
    if shape.n_scales == 3:
        assert tables[2] == 786_432 > _build.SMEM_MAX


@pytest.mark.parametrize("n_sm", [H100_SMS, 114, 4])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_blocks_split_across_roles(name, n_sm):
    """The plan takes one block an SM, every role with work gets at least
    one, a scale the shape lacks none; the CP role, with the most taps,
    the most blocks."""
    shape = SHAPES[name]
    plan = shape.encode_plan(n_sm)
    assert sum(plan.blocks) == n_sm
    for r, items in enumerate(shape.encode_items(1)):
        assert (plan.blocks[r] >= 1) == (items > 0)
    assert plan.blocks[3] == max(plan.blocks)
    assert shape.encode_plan(n_sm) is plan            # worked out once


@pytest.mark.parametrize("name,blocks", [("flag", (25, 25, 0, 82)),
                                         ("cp", (20, 20, 39, 53)),
                                         ("fcl", (18, 18, 36, 60))])
def test_split_on_the_card_is_the_timed_one(name, blocks):
    """At the H100's 132 SMs the tap-read weights (K0_TAP_COST) give the
    split that was timed against moved blocks and the plain count of taps
    (PERF.md section 6); a card with fewer SMs than roles is refused."""
    assert SHAPES[name].encode_plan(H100_SMS).blocks == blocks
    with pytest.raises(ValueError, match="needs"):
        SHAPES[name].encode_plan(len([b for b in blocks if b]) - 1)


@pytest.mark.parametrize("n", [1, 63, 512, 55_536, 195_000, 195_001])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_grid_covers_every_output_value_once(name, n):
    """A host model of the kernel's indexing: role r's launched blocks
    (no more than its tiles) take tiles b, b + blocks, .. of K0_THREADS
    items, a lane an item; a scale lane's
    item is a point, its 4 values slots 4 s .. 4 s + 3 of the point's row;
    a CP lane's item i is point i // G, group g = i % G, its values slots
    4 (S + g) .. Together they write each of the N x E values exactly
    once."""
    shape = SHAPES[name]
    plan = shape.encode_plan(H100_SMS)
    grid = plan.grid(shape, n)
    T = _build.K0_THREADS
    G = shape.cp_components // 4
    S, E = shape.n_scales, shape.embed_dim
    hits = np.zeros(n * E, np.int64)
    for r, (g, items) in enumerate(zip(grid, shape.encode_items(n))):
        tiles = -(-items // T)
        assert g == min(plan.blocks[r], tiles)
        if items == 0:
            continue
        # block b's tiles b, b + g, .., lane l of a tile its item l
        i = np.concatenate([t * T + np.arange(T) for b in range(g)
                            for t in range(b, tiles, g)])
        i = i[i < items]
        assert np.array_equal(np.sort(i), np.arange(items))
        if r < 3:
            base = i * E + 4 * r
        else:
            base = (i // G) * E + 4 * (S + i % G)
        for k in range(4):
            np.add.at(hits, base + k, 1)
    assert (hits == 1).all()


def test_entry_points_take_the_signatures_arguments(tmp_path):
    """Every C entry point of shape.cu, preprocessed at each shape, takes
    as many parameters as the loader's ctypes signature passes (K0's plan
    arguments included)."""
    (tmp_path / "cuda_runtime.h").write_text("")
    for s in _build.SHAPES.values():
        out = subprocess.run(
            ["c++", "-E", "-P", "-I", str(tmp_path)] + s.defines
            + ["-x", "c++", _build.UNIT], capture_output=True, text=True,
            check=True).stdout
        for name, argtypes in _build._SIGNATURES.items():
            m = re.search(rf"int {name}_{s.name}\(([^)]*)\)", out)
            params = [p for p in m.group(1).split(",") if p.strip()]
            assert len(params) == len(argtypes), (s.name, name)

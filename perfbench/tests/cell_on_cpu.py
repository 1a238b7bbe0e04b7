"""Run a cell of the BENCHMARK.json beside this perfbench/ on the CPU at a
test's size (``tiny_cell``) and print its result line, by this copy's own
files:

    python perfbench/tests/cell_on_cpu.py <cell> [<fault>]

``<fault>`` names a fault of ``test_bench_check.py`` (``_unchanged_ba``)
applied first. The port is imported from ``PYTHONPATH``."""

import json
import sys
import time

import pytest
import torch

import test_bench_check
from conftest import load_run, tiny_cell


def main(argv) -> int:
    cell = tiny_cell(argv[0])
    run = load_run()
    with pytest.MonkeyPatch.context() as mp:
        if len(argv) > 1 and argv[1]:
            getattr(test_bench_check, argv[1])(mp)
        torch.manual_seed(0)
        res = run.execute(cell, test_bench_check.SEED, 1e9, False,
                          torch.device("cpu"), time.time(),
                          max_frames=test_bench_check.FRAMES)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Shared pieces of the benchmark's CPU tests: tiny versions of the cells
(the real workload files with small sizes), and a driver call that skips
the harness's look for a card."""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

INFER = dict(sizes=[[60, 100], [58, 98]], pool_pairs=4, iters=2, batch=2, check={"pairs": 2})
TINY = {
    "engine": INFER,
}


@pytest.fixture(autouse=True)
def _small_and_private(monkeypatch, tmp_path):
    """Few threads, and a TMPDIR of the test's own."""
    torch.set_num_threads(2)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def tiny_run(workload: str, seconds: float = 1.5, seed: int = 2 ** 31 + 5,
             trace: bool = False, **over) -> harness.Run:
    """The cell's Run on the CPU with the tiny sizes of its entry."""
    _, cell, _, config = harness.cell_files(harness.manifest(), workload)
    cell = {**cell, **TINY[cell["entry"]], **over}
    return harness.Run(cell=cell, config=config, seconds=seconds, seed=seed, trace=trace,
                       device=torch.device("cpu"))


def drive(run: harness.Run) -> harness.Run:
    """The rest of a run after the look for a card: the cell's driver."""
    driver = harness.load_file_module(
        harness.BENCH_DIR / "drivers" / f"{run.cell['entry']}.py", "portbench_test_driver")
    driver.run(run, harness.SetupClock(time.perf_counter()))
    return run


@pytest.fixture
def tiny():
    return tiny_run


@pytest.fixture
def run_driver():
    return drive

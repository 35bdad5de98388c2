"""The reader of ``pin_ms_per_pair.batch`` on synthetic runs: the engine's
pinned-copy seconds over the pairs it served, and nothing where the engine
has no such counter (an engine older than the counter) or served nothing."""

from __future__ import annotations

import types

import pytest

from portbench import harness

READER = harness.load_file_module(harness.BENCH_DIR / "metrics" / "pin_ms_per_pair.batch.py",
                                  "portbench_test_pin_reader")


def run_with(stats):
    return types.SimpleNamespace(sources={} if stats is None else {"engine_stats": stats})


def test_ms_per_served_pair():
    stats = types.SimpleNamespace(pin_s=0.6, images=24)
    assert READER.read(run_with(stats)) == pytest.approx(25.0)


@pytest.mark.parametrize("stats", [
    None,                                           # no engine
    types.SimpleNamespace(images=24),               # an engine without the counter
    types.SimpleNamespace(pin_s=0.0, images=0),     # nothing served
], ids=["no_engine", "no_counter", "nothing_served"])
def test_nothing_to_read(stats):
    assert READER.read(run_with(stats)) is None


def test_reads_the_engines_stats():
    from raft_stereo_tpu_torch.runtime.infer import InferStats

    stats = InferStats(images=8, pin_s=0.2)
    assert READER.read(run_with(stats)) == pytest.approx(25.0)

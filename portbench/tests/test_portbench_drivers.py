"""A tiny CPU rehearsal of each driver through the rest of a run (the look
for a card skipped), and the comparison seeing ``correct`` come out false
with the timed path broken underneath: an answer altered where it is
produced."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.run import metrics_for

MAN = harness.manifest()


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_rehearsal(workload, tiny, run_driver):
    run = run_driver(tiny(workload))
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    e2e = metrics_for(MAN, run, workload)
    assert "setup_s" in e2e and len(e2e) >= 3
    assert all(v["value"] > 0 for k, v in e2e.items() if k != "peak_mem_gib")


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_traced_rehearsal_reads_layer_metrics(workload, tiny, run_driver):
    run = run_driver(tiny(workload, trace=True))
    assert run.trace_summary is not None and run.trace_summary["window_s"] > 0
    layer = metrics_for(MAN, run, workload)
    wanted = {m["name"] for m in MAN["per_layer"] if workload in m["workloads"]}
    # K1's launches and the engine's CUDA events exist on the card alone
    assert set(layer) == {m for m in wanted
                          if not m.startswith(("k1_roofline", "device_ms_per_pair"))}
    assert run.correct


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_an_altered_answer_is_not_correct(workload, tiny, run_driver, monkeypatch):
    """The first item of every batch comes out of the forward 5 px off."""
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

    real = RAFTStereo._outputs

    def altered(self, flow_x, up_mask):
        lowres, disp = real(self, flow_x, up_mask)
        disp = disp.clone()
        disp[0] += 5.0
        return lowres, disp

    monkeypatch.setattr(RAFTStereo, "_outputs", altered)
    run = run_driver(tiny(workload))
    assert not run.correct
    assert run.checks["disp_gap_ratio"][0] > run.checks["disp_gap_ratio"][1]

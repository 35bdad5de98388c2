"""The control: the plain reference put in the program's place one step
below the precision the configurations state (fp8 convolutions; the
correlation, the flow state and the upsampling in bf16), has to come out
not correct against each cell's limit. Here at sizes a CPU test holds;
``test_control_on_the_card`` runs it at a cell's own size."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, serving, traffic

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def eval_control_gap(workload, size, seed, device="cpu"):
    _, cell, _, config = harness.cell_files(harness.manifest(), workload)
    cell = dict(cell, sizes=[size], pool_pairs=1)
    run = harness.Run(cell=cell, config=config, seconds=0, seed=seed, trace=False,
                      device=torch.device(device))
    pool = traffic.image_pool(cell, seed, device)
    control = serving.reference_outputs(run, pool, [0], "fp8", "bf16")
    gaps, scales = serving.gap_ratios(run, pool, list(control.items()))
    return gaps[0] / scales[0], cell["limits"]["disp_gap_ratio"]


@pytest.mark.parametrize("seed", [2 ** 31 + 9, 7])
def test_inference_control_is_not_correct(seed):
    gap, limit = eval_control_gap("raftstereo.middlebury-f", [128, 256], seed=seed)
    assert gap > limit


def test_the_reference_in_its_own_precision_is_the_reference():
    """The precision switch leaves the float32 reference as it was, and the
    configured precision's own gap is no gap of the reference's."""
    _, cell, _, config = harness.cell_files(harness.manifest(), CELLS[-1])
    cell = dict(cell, sizes=[[64, 128]], pool_pairs=1)
    run = harness.Run(cell=cell, config=config, seconds=0, seed=5, trace=False,
                      device=torch.device("cpu"))
    pool = traffic.image_pool(cell, 5, "cpu")
    same = serving.reference_outputs(run, pool, [0])
    gaps, scales = serving.gap_ratios(run, pool, list(same.items()))
    assert gaps == [0.0] and scales[0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload):
    """At the cell's largest size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at a cell's own size runs on the card")
    _, cell, _, _ = harness.cell_files(harness.manifest(), workload)
    gap, limit = eval_control_gap(workload, cell["sizes"][0], seed=2 ** 31 + 9, device="cuda")
    assert gap > limit

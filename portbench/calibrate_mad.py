"""Readings that the MADNet2Fusion cell's comparison limit is set from.

    python3 -m portbench.calibrate_mad --workload <cell> --seeds 1,2,... \\
        [--program-control-seeds 1,2] [--seconds 2] [--out FILE]

In one process. For each of ``--seeds``: a run of the cell's timed path
(``drivers/mad_engine.py``) at its timed sizes, whose gaps to the float32
reference, over the configured precision's own (TF32 in the convolutions
the program's probe found TF32), are the program's readings (the lower
readings); then, on the same seed's pool and sample, the controls
computed by the reference in the program's place and read as the
program's answers are (the upper readings): ``bf16`` (convolutions,
correlation and attention one step below the configured precision) and
``no_attention`` (each level's cross-attention passes its window
through); and ``tf32_products``, the configured precision with the
correlation's and the attention's matrix products in TF32. Each reading
is given for every statistic of ``mad_serving.gap_stats``. For each of
``--program-control-seeds``: a run of the timed path with the program's
own cross-attention replaced by its input. The benchmark's own runs never
read a control. Prints one JSON line a reading and a summary: for each
statistic, the largest program reading and the smallest of each control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import guided, harness, mad_serving, serving


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def program_run(cell, config, seed: int, seconds: float, device) -> harness.Run:
    run = harness.Run(cell=cell, config=config, seconds=seconds, seed=seed, trace=False,
                      device=device)
    driver = harness.load_file_module(harness.BENCH_DIR / "drivers" / f"{cell['entry']}.py",
                                      "portbench_driver")
    driver.run(run, harness.SetupClock(time.perf_counter()))
    return run


def _ratios(gaps, scales) -> dict:
    """The widest ratio over the sampled pairs, for each statistic."""
    return {k: max(g[k] / s[k] for g, s in zip(gaps, scales)) for k in scales[0]}


def control_readings(run: harness.Run) -> dict:
    """Each control's ratios on the run's seed: the pairs its sample drew,
    computed by the reference in the control's precision."""
    pool = guided.guided_pool(run.cell, run.seed, run.device)
    picks = sorted(serving.Sampler(run.cell["check"]["pairs"], len(pool), run.seed).chosen)
    want = mad_serving.reference_outputs(run, pool, picks)
    configured = mad_serving.configured(run)
    own = mad_serving.reference_outputs(run, pool, picks, **configured)
    scales = [mad_serving.gap_stats(own[i], want[i]) for i in picks]
    out = {}
    controls = dict(mad_serving.CONTROLS,
                    tf32_products=dict(configured, **mad_serving.TF32_PRODUCTS))
    for name, precision in controls.items():
        got = mad_serving.reference_outputs(run, pool, picks, **precision)
        gaps = [mad_serving.gap_stats(got[i], want[i]) for i in picks]
        out[name] = {"ratios": _ratios(gaps, scales), "gaps_px": gaps}
    return out


def bypassed_attention():
    """Patch the program's cross-attention layer to return its input; the
    returned callable undoes it."""
    from raft_stereo_tpu_torch.models.attention import TransformerCrossAttnLayer

    real = TransformerCrossAttnLayer.forward

    def through(self, feat_left, feat_right, pos=None, last_layer=False):
        return feat_left, None

    TransformerCrossAttnLayer.forward = through

    def undo():
        TransformerCrossAttnLayer.forward = real

    return undo


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--program-control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    _, cell, _, config = harness.cell_files(harness.manifest(), args.workload)
    device = harness.require_cuda(1)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        run = program_run(cell, config, seed, args.seconds, device)
        ref_notes = run.notes["reference"]
        row = {"seed": seed, "kind": "program", "correct": run.correct, "failed": run.failed,
               "checks": run.checks, "end_to_end": run.end_to_end, "setup_s": run.setup_s,
               "notes": run.notes,
               "ratios": _ratios(ref_notes["gaps_px"], ref_notes["configured_gaps_px"])}
        row.update(control_readings(run))
        row["seconds"] = time.perf_counter() - t0
        del run
        emit(row)
    for seed in seeds(args.program_control_seeds):
        t0 = time.perf_counter()
        undo = bypassed_attention()
        try:
            run = program_run(cell, config, seed, args.seconds, device)
        finally:
            undo()
        ref_notes = run.notes["reference"]
        emit({"seed": seed, "kind": "program_no_attention", "correct": run.correct,
              "ratios": _ratios(ref_notes["gaps_px"], ref_notes["configured_gaps_px"]),
              "seconds": time.perf_counter() - t0})
        del run
    programs = [r for r in rows if r["kind"] == "program"]
    stats = list(programs[0]["ratios"]) if programs else []
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
               "tf32_convs": programs[0]["notes"]["tf32_convs"] if programs else None}
    for k in stats:
        lower = max(r["ratios"][k] for r in programs)
        entry = {"program": {"lower": lower, "readings": [r["ratios"][k] for r in programs]}}
        for name in ("bf16", "no_attention", "tf32_products"):
            readings = [r[name]["ratios"][k] for r in programs]
            entry[name] = {"upper": min(readings), "over_lower": min(readings) / lower,
                           "readings": readings}
        bypass = [r["ratios"][k] for r in rows if r["kind"] == "program_no_attention"]
        entry["program_no_attention"] = {"upper": min(bypass) if bypass else None,
                                         "readings": bypass}
        summary[k] = entry
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())

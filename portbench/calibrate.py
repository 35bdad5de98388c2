"""Readings that the comparison's limits are set from, for one cell.

    python3 -m portbench.calibrate --workload <cell> [--seeds 1,2,...] \\
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

In one process (set-up is long). For each of ``--seeds``, a run of the
cell's timed path at its timed sizes: the comparison's number, the program
against the reference (the lower readings). For each of
``--control-seeds``, the pairs such a run would compare (the seed's pool
and sample), computed by the reference in lower precision in the
program's place, and compared as the program's answers are (the upper
readings): the control (fp8 convolutions; correlation, flow state and
upsampling in bf16), and its second step alone (the configured bf16
convolutions, the rest in bf16). The benchmark's own runs never read a
control. Prints one JSON line a seed and a summary: the largest program
reading and the smallest of each control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import harness, serving, traffic

# name -> (convolutions, correlation / flow state / upsampling)
CONTROLS = {"control": ("fp8", "bf16"), "bf16_state": ("bf16", "bf16")}


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def control_row(cell, config, seed: int, device) -> dict:
    run = harness.Run(cell=cell, config=config, seconds=0, seed=seed, trace=False, device=device)
    pool = traffic.image_pool(cell, seed, device)
    picks = sorted(serving.Sampler(cell["check"]["pairs"], len(pool), seed).chosen)
    want = serving.reference_outputs(run, pool, picks)
    own = serving.reference_outputs(run, pool, picks, "bf16", "fp32")
    scales = [serving.mean_gap(own[i], want[i]) for i in picks]
    row = {"seed": seed, "kind": "control", "bf16_gaps_px": scales}
    for name, (convs, state) in CONTROLS.items():
        got = serving.reference_outputs(run, pool, picks, convs, state)
        gaps = [serving.mean_gap(got[i], want[i]) for i in picks]
        row[name] = {"disp_gap_ratio": max(g / sc for g, sc in zip(gaps, scales)),
                     "gaps_px": gaps}
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    _, cell, _, config = harness.cell_files(harness.manifest(), args.workload)
    device = harness.require_cuda(1)
    driver = harness.load_file_module(harness.BENCH_DIR / "drivers" / f"{cell['entry']}.py",
                                      "portbench_driver")
    rows = []
    for seed in seeds(args.seeds):
        run = harness.Run(cell=cell, config=config, seconds=args.seconds, seed=seed,
                          trace=False, device=device)
        t0 = time.perf_counter()
        driver.run(run, harness.SetupClock(t0))
        rows.append({"seed": seed, "kind": "program", "correct": run.correct,
                     "failed": run.failed, "disp_gap_ratio": run.checks["disp_gap_ratio"][0],
                     "end_to_end": run.end_to_end, "setup_s": run.setup_s,
                     "seconds": time.perf_counter() - t0, "notes": run.notes})
        print(json.dumps(rows[-1], default=str), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        rows.append(dict(control_row(cell, config, seed, device),
                         seconds=time.perf_counter() - t0))
        print(json.dumps(rows[-1]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    program = [r["disp_gap_ratio"] for r in rows if r["kind"] == "program"]
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
               "lower": max(program) if program else None, "program": program}
    for name in CONTROLS:
        readings = [r[name]["disp_gap_ratio"] for r in rows if r["kind"] == "control"]
        summary[name] = {"upper": min(readings) if readings else None, "readings": readings}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())

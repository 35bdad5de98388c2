"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic; ``portbench/workloads/<cell>.json`` holds
the traffic's parameters and names the driver (``drivers/<entry>.py``)
that builds the program, warms up the cell's shapes, measures for
``--seconds`` and compares what the timed path produced with the plain
reference. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics (each read by ``metrics/<name>.py``) from a run
whose window ran under ``torch.profiler``.

The last line of standard output is the result (JSON). A run that cannot
measure (no card, too few cards, a module of the JAX package loaded)
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def _cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    port builds its own kernels into ``build/raft_stereo_tpu_torch`` there;
    these are PyTorch's)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(harness.ROOT / "build" / "portbench" / sub)


def applicable(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(man: dict, run: harness.Run, cell: str) -> dict:
    out = {}
    if not run.trace:
        for m in man["end_to_end"]:
            if not applicable(m, cell):
                continue
            value = run.setup_s if m["name"] == "setup_s" else run.end_to_end.get(m["name"])
            if value is None or not math.isfinite(value):
                raise harness.NoResult(f"end-to-end metric {m['name']} was not measured")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in man["per_layer"]:
        if not applicable(m, cell):
            continue
        reader = harness.load_file_module(harness.BENCH_DIR / "metrics" / f"{m['name']}.py",
                                          f"portbench_metric_{len(out)}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    try:
        man = harness.manifest()
        entry, cell, _, config = harness.cell_files(man, args.workload)
        device = harness.require_cuda(int(entry["chips"]))
        run = harness.Run(cell=cell, config=config, seconds=args.seconds, seed=args.seed,
                          trace=bool(args.trace), device=device)
        driver = harness.load_file_module(
            harness.BENCH_DIR / "drivers" / f"{cell['entry']}.py", "portbench_driver")
        clock = harness.SetupClock(T_START)
        clock.mark("imports")
        driver.run(run, clock)
        metrics = metrics_for(man, run, args.workload)
        loaded = harness.forbidden_loaded()
        if loaded:
            raise harness.NoResult(f"modules of the JAX package or its runtime are loaded: "
                                   f"{loaded}")
    except harness.NoResult as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 3
    result = {
        "correct": run.correct, "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics, "device": harness.device_info(run, int(entry["chips"])),
    }
    if run.trace_summary is not None:
        result["breakdown"] = run.trace_summary["breakdown"]
        run.notes["host_calls"] = run.trace_summary["host_calls"]
    run.notes["setup_phases_s"] = clock.phases
    for k, v in run.notes.items():
        print(json.dumps({k: v}))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

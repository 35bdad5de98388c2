"""One run of a benchmark cell with the port's telemetry sink installed from
the process's start, and what the sink's spans and marks then measure.

    python3 tools/trace_cell.py --workload raftstereo.middlebury-f --seed <n> \
        --seconds 30 --trace 1 --sink build/portbench/telemetry/<n>

The run is ``python3 -m portbench.run``'s (the same driver, set-up, window
and comparison), and its result line comes first. Then one line
``{"tracing": {...}}``:

  * always: ``pairs_per_s``, ``device_ms_per_pair`` (the engine's CUDA
    events around each full batch) and ``pin_ms_per_pair``
    (``InferStats.pin_s``);
  * with ``--trace 1``: ``layout_convert_ms_per_pair`` (cuDNN's
    ``nchwToNhwc`` and ``nhwcToNchw`` transposes around a conv on NCHW
    memory) and ``strided_elementwise_ms_per_pair`` (PyTorch's
    non-vectorised ``elementwise_kernel<128, 4>``, which element-wise ops
    with strided or mixed-format operands fall back to): device time a
    pair over the traced window, by kernel name;
  * with ``--sink``: ``encode_ms_per_pair`` and ``refine_ms_per_iter``
    (the captured forward's stage marks, ``InferStats.stage_ms``),
    ``stage_sum_pct`` (encode + (iters-1) x refine + final over the batch's
    device ms), and ``graph_warmup_s`` and ``graph_capture_s`` (the set-up's
    ``graph.warmup`` and ``graph.capture`` spans);
  * with ``--sink`` and ``--trace 1``: ``idle_by_span``, every idle second
    of the traced window by the innermost span open on the consumer thread
    (the one that called ``stream``) and on the stager thread
    (``telemetry.idle_by_span`` over the profiler's device intervals),
    ``stager_idle_pct`` (the window's share idle while the consumer was in
    ``decode_wait``), ``idle_s`` against the window's, the share a named
    consumer span covers, and the window's first idle gap with its spans;
    each for the harness's window (from the first profiler event, as long
    as the host's window) and for the tracer's own start to stop.

Without ``--sink`` no sink is installed and the run is the benchmark's, so
two runs on one seed, with and without, give what the sink and the marks
cost. Needs a CUDA card; prints no result without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from raft_stereo_tpu_torch.runtime import telemetry  # noqa: E402

CONSUMER, STAGER = "MainThread", "infer-stager"

# kernel-name patterns of the traced window's device time a pair
KERNEL_FAMILIES = {
    "layout_convert_ms_per_pair": re.compile(r"nchwToNhwc|nhwcToNchw"),
    "strided_elementwise_ms_per_pair": re.compile(r"(?<![A-Za-z_])elementwise_kernel<128, 4\b"),
}


def keep_device_intervals(harness, store: dict) -> None:
    """Wrap the harness's trace reduction so that the window and the device
    intervals it reduces are kept (on the profiler's clock), and the tracer's
    own start and stop on that clock."""
    from torch.autograd import DeviceType

    reduce = harness.reduce_trace
    start, stop = harness.Tracer.start, harness.Tracer.stop

    def starting(tracer):
        start(tracer)
        store["started"] = time.time_ns()

    def stopping(tracer):
        store["stopped"] = time.time_ns()
        stop(tracer)

    harness.Tracer.start, harness.Tracer.stop = starting, stopping

    def keeping(prof, window_s):
        events = list(prof.profiler.kineto_results.events())
        w0 = min((e.start_ns() for e in events), default=0)
        store["window"] = (w0, w0 + int(window_s * 1e9))
        store["busy"] = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                         if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        return reduce(prof, window_s)

    harness.reduce_trace = keeping


def lane(spans, thread: str, window):
    return [(s["start_ns"], s["end_ns"], s["name"]) for s in spans
            if s["thread"] == thread and s["end_ns"] > window[0] and s["start_ns"] < window[1]]


def first_gap(busy, window):
    """The window's first idle interval (ns), or None."""
    cursor = window[0]
    for s, e in sorted(busy):
        if s > cursor:
            return cursor, min(s, window[1])
        cursor = max(cursor, e)
    return (cursor, window[1]) if cursor < window[1] else None


def idle_report(spans, kept: dict) -> dict:
    window, busy = kept["window"], kept["busy"]
    lanes = [lane(spans, CONSUMER, window), lane(spans, STAGER, window)]
    joined = telemetry.idle_by_span(busy, window, lanes)
    idle_ns = sum(joined.values())
    window_ns = window[1] - window[0]
    named = sum(v for (c, _), v in joined.items() if c != telemetry.OUTSIDE)
    waiting = sum(v for (c, _), v in joined.items() if c == "decode_wait")
    gap = first_gap(busy, window)
    out = {
        "idle_by_span": [[c, s, v / 1e9] for (c, s), v in
                         sorted(joined.items(), key=lambda kv: -kv[1])],
        "idle_s": idle_ns / 1e9, "window_s": window_ns / 1e9,
        "named_consumer_pct": 100.0 * named / idle_ns if idle_ns else None,
        "stager_idle_pct": 100.0 * waiting / window_ns,
    }
    if gap is not None:
        out["first_gap"] = {"at_s": (gap[0] - window[0]) / 1e9, "spans": [
            [c, s, v / 1e9] for (c, s), v in telemetry.idle_by_span([], gap, lanes).items()]}
    return out


def window_report(spans, kept: dict) -> dict:
    """``idle_report`` over the harness's window ([its first event, + the
    host's window seconds]) and over the tracer's own [start, stop], with
    the first event's lag behind the start."""
    out = {"harness_window": idle_report(spans, kept)}
    if "started" in kept and "stopped" in kept:
        out["first_event_lag_s"] = (kept["window"][0] - kept["started"]) / 1e9
        out["tracer_window"] = idle_report(
            spans, dict(kept, window=(kept["started"], kept["stopped"])))
    return out


def kernel_family_ms(ops: dict, pairs: int) -> dict:
    """Device ms a pair of each ``KERNEL_FAMILIES`` pattern, summed over the
    traced operations (``{name: {"count", "seconds"}}``) it matches."""
    return {key: 1e3 * sum(v["seconds"] for n, v in ops.items() if pat.search(n)) / pairs
            for key, pat in KERNEL_FAMILIES.items()}


def tracing_line(run, tel, kept: dict) -> dict:
    stats = run.sources.get("engine_stats")
    out = {"pairs_per_s": run.end_to_end.get("pairs_per_s")}
    pairs = sum(stats.batch_valid) if stats is not None else 0
    if pairs:
        out["device_ms_per_pair"] = sum(stats.batch_ms) / pairs
        if run.trace_summary is not None:
            out.update(kernel_family_ms(run.trace_summary["ops"], pairs))
    if stats is not None and stats.images:
        out["pin_ms_per_pair"] = stats.pin_s / stats.images * 1e3
    if tel is None:
        return out
    marked = [(st, ms, n) for st, ms, n in zip(stats.stage_ms, stats.batch_ms,
                                                stats.batch_valid) if st]
    iters = int(run.cell["iters"])
    if marked:
        n = sum(v for _, _, v in marked)
        out["encode_ms_per_pair"] = sum(st["encode"] for st, _, _ in marked) / n
        out["refine_ms_per_iter"] = sum(st["refine"] for st, _, _ in marked) / (n * (iters - 1))
        out["final_ms_per_pair"] = sum(st["final"] for st, _, _ in marked) / n
        out["stage_sum_pct"] = 100.0 * (sum(sum(st.values()) for st, _, _ in marked)
                                        / sum(ms for _, ms, _ in marked))
    spans = tel.spans()
    out["graph_warmup_s"] = sum((s["end_ns"] - s["start_ns"]) / 1e9 for s in spans
                                if s["name"] == "graph.warmup")
    out["graph_capture_s"] = sum((s["end_ns"] - s["start_ns"]) / 1e9 for s in spans
                                 if s["name"] == "graph.capture")
    if "window" in kept:
        out.update(window_report(spans, kept))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sink", default=None, metavar="DIR",
                   help="install the port's telemetry sink in DIR from the start")
    args = p.parse_args(argv)
    tel = telemetry.install(telemetry.Telemetry(args.sink)) if args.sink else None

    from portbench import harness
    from portbench import run as bench

    bench._cache_dirs()
    kept: dict = {}
    keep_device_intervals(harness, kept)
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
        metrics = bench.metrics_for(man, run, args.workload)
    except harness.NoResult as e:
        print(f"trace_cell: no result: {e}", file=sys.stderr)
        return 3
    finally:
        if tel is not None:
            telemetry.uninstall(tel)
    print(json.dumps({"correct": run.correct, "metrics": metrics, "setup_s": run.setup_s,
                      "device": harness.device_info(run, int(entry["chips"])),
                      "checks": run.checks}))
    print(json.dumps({"tracing": tracing_line(run, tel, kept)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

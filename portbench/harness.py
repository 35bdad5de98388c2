"""What every run shares: the manifest and the cell's files, the card
check, the set-up clock, the traced window and its reduction, and the
result line.

A driver (``drivers/<entry>.py``) fills a :class:`Run`; per-layer readers
(``metrics/<metric>.py``) read it. Nothing here knows a cell by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent

TRACE_SECONDS = 15.0

# The reference package and its runtime: none of these may be loaded in a
# process that prints a result (compared by whole top-level name: the port's
# name begins with the reference package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "raft_stereo_tpu")


class NoResult(RuntimeError):
    """The run cannot give a result: exit non-zero, print no result line."""


@dataclasses.dataclass
class Run:
    """What a driver measured: the end-to-end values, the sources per-layer
    readers take their numbers from, and the comparison's readings."""

    cell: dict
    config: dict
    seconds: float
    seed: int
    trace: bool
    device: Any = None
    setup_s: Optional[float] = None
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    # name -> (value, limit): each number the comparison read
    checks: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    # what per-layer readers read: the engine's accounting, the batch, the
    # rate
    sources: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace_summary: Optional[dict] = None
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def window_seconds(self) -> float:
        """The measured window: ``--seconds``, or at most ``TRACE_SECONDS``
        in a traced run (the trace of a minute of kernels would take longer
        to reduce than a run is allowed)."""
        return min(self.seconds, TRACE_SECONDS) if self.trace else self.seconds

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(math.isfinite(v) and v <= lim for v, lim in self.checks.values()))


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise NoResult(f"{path} not found")
    return load_json(path)


def cell_files(man: dict, workload: str, root: Path = ROOT):
    """(manifest entry of the cell, its traffic parameters, its
    configuration entry, the configuration's file)."""
    entry = next((w for w in man["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    cell = load_json(BENCH_DIR / "workloads" / f"{workload}.json")
    config = load_json(root / cfg_entry["file"])
    return entry, cell, cfg_entry, config


def load_file_module(path: Path, name: str):
    """Import ``path`` as module ``name`` (driver and reader files are found
    by the names in the manifest; their names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise NoResult(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def require_cuda(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoResult("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell needs {chips} card(s), {torch.cuda.device_count()} visible")
    return torch.device("cuda:0")


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def device_info(run: Run, chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace_summary is not None:
        info["busy_s"] = run.trace_summary["busy_s"]
        info["window_s"] = run.trace_summary["window_s"]
    return info


def read_peak(device) -> int:
    import torch

    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


# ------------------------------------------------------------------ traced window

class Tracer:
    """The measured window under ``torch.profiler`` when the run traces,
    else nothing: ``start`` at the window's start, ``stop`` at its end,
    which reduces the trace into ``run.trace_summary``. Device activity
    only (kernels, copies, sets, and the CUDA runtime calls that launch
    them): recording every host operator slowed the realtime model's
    closed loop by a fifth and would misstate the device's idle share."""

    def __init__(self, run: Run):
        self.run = run
        self.prof = None
        self.t0 = 0.0

    def start(self) -> None:
        if not self.run.trace or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        # a CPU rehearsal has no device activity to record
        cuda = torch.device(self.run.device).type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        if torch.device(self.run.device).type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.run.trace_summary = reduce_trace(self.prof, window_s)
        self.prof = None


@contextlib.contextmanager
def traced(run: Run):
    """``Tracer`` around a block that is the whole window."""
    tracer = Tracer(run)
    tracer.start()
    try:
        yield
    finally:
        tracer.stop()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof, window_s: float) -> dict:
    """From the profiler's events over a window of ``window_s`` (host
    clock): the time some device operation ran (the union of kernel, copy
    and set intervals), the device time and count by operation name, and
    the longest idle gaps, each named by the innermost CUDA runtime call
    the host was in at the gap's middle."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if d > 0:
                device.append((s, s + d, e.name()))
        else:
            host.append((s, s + d, e.name()))
    starts = [s for s, _, _ in host + device]
    w0 = min(starts) if starts else 0
    w1 = w0 + int(window_s * 1e9)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    by_name: Dict[str, List[float]] = {}
    for s, e, n in inside:
        acc = by_name.setdefault(n, [0, 0.0])
        acc[0] += 1
        acc[1] += (e - s) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        cover = [(e - s, n) for s, e, n in host if s < mid < e]
        labelled.append([min(cover)[1] if cover else "host outside the CUDA runtime",
                         (b - a) / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    calls: Dict[str, int] = {}
    for _, _, n in host:
        calls[n] = calls.get(n, 0) + 1
    return {
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "ops": {n: {"count": c, "seconds": t} for n, (c, t) in by_name.items()},
        "host_calls": dict(sorted(calls.items(), key=lambda kv: -kv[1])[:10]),
        "breakdown": {"device_ops": [[n[:200], t] for n, (_, t) in top],
                      "idle_gaps": [[n[:200], t] for n, t in labelled]},
    }


def device_seconds(run: Run, needle: str):
    """(launches, device seconds) of the traced operations whose name holds
    ``needle``; None when the run was not traced or none ran."""
    if run.trace_summary is None:
        return None
    hits = [v for n, v in run.trace_summary["ops"].items() if needle in n]
    if not hits:
        return None
    return sum(v["count"] for v in hits), sum(v["seconds"] for v in hits)


class SetupClock:
    """Set-up runs from the process's start to the window's. ``mark`` ends
    a named phase of it; ``phases`` holds each phase's seconds."""

    def __init__(self, t0: float):
        self.t0 = self.t_mark = t0
        self.phases: Dict[str, float] = {}

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] = now - self.t_mark
        self.t_mark = now

    def stop(self) -> float:
        self.mark("rest")
        return self.t_mark - self.t0

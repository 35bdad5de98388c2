"""Training metric logging: running means flushed every SUM_FREQ steps into
``<run_dir>/metrics.jsonl`` (the port's own copy of
``raft_stereo_tpu/utils/metrics.py:25-177``, without the TensorBoard
writer). Each flushed row carries the installed telemetry sink's event
counters as ``event/<name>`` (monotonic totals), so skips, quarantines, IO
retries and checkpoint commits line up against the loss curve.

A flushed non-finite running mean raises ``NonFiniteMetricError`` after its
row is written: the reference's fail-fast on a NaN loss, at no per-step
cost. A logger without a ``run_dir`` (a data-parallel rank other than 0,
whose metrics are the global ones rank 0 writes) writes nothing but still
fails fast at the same step as rank 0.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Callable, Dict, Optional

from raft_stereo_tpu_torch.runtime import telemetry

logger = logging.getLogger(__name__)

SUM_FREQ = 100


class NonFiniteMetricError(RuntimeError):
    """Raised when a flushed running mean is NaN/Inf (see MetricLogger)."""


class MetricLogger:
    """Accumulates per-step metrics; flushes running means every SUM_FREQ."""

    def __init__(self, run_dir: Optional[str], schedule: Optional[Callable] = None,
                 fail_on_nonfinite: bool = True):
        self.run_dir = run_dir
        self.schedule = schedule
        self.fail_on_nonfinite = fail_on_nonfinite
        self.jsonl = None
        self.running: Dict[str, float] = {}
        self.count = 0
        self.last_step = 0
        self._closed = False
        if run_dir is None:
            return
        os.makedirs(run_dir, exist_ok=True)
        self.jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        # Restart marker: the file is appended to, so a resumed run's rows
        # are told from the interrupted run's by the marker between them.
        self.jsonl.write(json.dumps({"marker": "logger_start", "wall_time": time.time()}) + "\n")
        self.jsonl.flush()

    def push(self, step: int, metrics: Dict[str, float],
             timing: Optional[Dict[str, float]] = None) -> None:
        """Add one step's metrics (tensors are read only at the flush);
        ``timing`` (the loop's data_wait / h2d_stage / device_step /
        ckpt_stall seconds) is folded in under ``time/<key>``."""
        if timing:
            metrics = dict(metrics, **{f"time/{k}": float(v) for k, v in timing.items()})
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + v
        self.count += 1
        self.last_step = step
        if self.count >= SUM_FREQ:
            self._flush_running(step)

    def _flush_running(self, step: int) -> None:
        means = {k: float(v) / self.count for k, v in self.running.items()}
        bad = sorted(k for k, v in means.items() if not math.isfinite(v))
        if bad and self.fail_on_nonfinite:
            # the evidence lands on disk before the abort, and the window is
            # reset so that close() still works
            self._write(step, means)
            self.running = {}
            self.count = 0
            raise NonFiniteMetricError(f"non-finite running mean(s) {bad} flushed at step {step}")
        lr = float(self.schedule(step)) if self.schedule else None
        status = ", ".join(f"{k} {v:10.4f}" for k, v in sorted(means.items()))
        logger.info("Training Metrics (%d): lr=%s %s", step, lr, status)
        tel = telemetry.get()
        counters = ({f"event/{k}": float(v) for k, v in tel.counters_snapshot().items()}
                    if tel is not None else {})
        self._write(step, dict(means, **({"lr": lr} if lr is not None else {}), **counters))
        self.running = {}
        self.count = 0

    def flush(self) -> None:
        """Flush the partial window now (the preemption path)."""
        if self.count:
            self._flush_running(self.last_step)

    def write_dict(self, step: int, results: Dict[str, float]) -> None:
        self._write(step, results)

    def _write(self, step: int, values: Dict[str, float]) -> None:
        if self.jsonl is None:
            return
        # NaN/Inf as strings: the row stays strict JSON
        safe = {k: (v if isinstance(v, str) or math.isfinite(v) else repr(float(v)))
                for k, v in values.items()}
        self.jsonl.write(json.dumps({"step": step, "wall_time": time.time(), **safe}) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        """Flush the partial window and release the file (idempotent; the
        file is closed even if that flush raises)."""
        if self._closed:
            return
        self._closed = True
        try:
            if self.count:
                self._flush_running(self.last_step)
        finally:
            if self.jsonl is not None:
                self.jsonl.close()

"""Runtime telemetry: structured events, host spans, run health and
latency metrics (the port's own copy of ``raft_stereo_tpu/runtime/telemetry.py``).

  * **Events** (``<run_dir>/events.jsonl``): one typed JSON record a runtime
    event (``event``, wall and monotonic time, host, optional step, a flat
    payload), named in ``EVENT_SCHEMA``; per-event counters are folded into
    ``MetricLogger`` rows as ``event/<name>``.
  * **Host spans** (``span("name")``): a ``perf_counter_ns`` pair and an
    append, with the span's number and its parent's (the innermost span
    open on its thread); flushed as a Chrome trace
    (``<run_dir>/trace_host.json``) with named thread lanes, on
    ``torch.profiler``'s clock: the sink's ``anchor`` (a monotonic and a
    Unix-epoch reading of one instant, taken at ``install``) converts
    each span, so the file lines up with a profiler trace of the same run
    (``spans()``, ``idle_by_span``).
  * **Stage marks** (``stage_marks``/``mark``): the boundaries a forward
    marks on the device stream (events: under a CUDA graph capture, the
    graph's event-record nodes), collected only while a sink is installed;
    ``stage_ms`` reads the times between them.
  * **Run health** (``<run_dir>/heartbeat.json``): replaced atomically (tmp,
    fsync, rename) with the step, rate, checkpoint, counters, latency
    percentiles and, on the card, ``torch.cuda.memory_stats()`` under the JAX
    keys (``device_memory_stats``).
  * **Latency metrics**: ``LogHistogram`` (log buckets, bounded relative
    error, mergeable) and ``MetricsRegistry`` (counters, gauges,
    histograms), exported as Prometheus text (``<run_dir>/metrics.prom``)
    with each heartbeat and at close; ``SLOTracker`` for a latency target.
  * **Trace ids** (``new_trace_id``): a serving request's id rides every
    event and span on its path (``trace_id``/``trace_ids`` are reserved
    framing keys).
  * ``RecompileDetector`` emits ``recompile`` when a ``GraphCache`` captures
    one key a second time; ``ProfileWindow`` (``--profile_steps A:B``) runs
    ``torch.profiler`` over steps [A, B] of a training run and writes a
    Chrome trace under ``<run_dir>/profile``.

The hooks are module-level (``install``/``get``/``emit``/``span``/``observe``/
``inc_metric``/``set_gauge``) and are free no-ops with no sink installed. The
module imports only the standard library; torch is read from ``sys.modules``
(the memory probe) or imported inside the profile window. Telemetry never
kills a run: write errors are logged once and counted. The heartbeat keeps
the ``heartbeat_write`` crash point between its tmp write and its rename.
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import logging
import math
import os
import random
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

from raft_stereo_tpu_torch.runtime import faultinject

logger = logging.getLogger(__name__)

HEARTBEAT_NAME = "heartbeat.json"
EVENTS_NAME = "events.jsonl"
TRACE_NAME = "trace_host.json"
METRICS_PROM_NAME = "metrics.prom"

# Payload keys reserved by the record framing itself: event/t_wall/
# t_mono/host/step ride every record, and trace_id/trace_ids may ride any
# event on a request's causal path.
RESERVED_KEYS = frozenset(
    {"event", "t_wall", "t_mono", "host", "step", "trace_id", "trace_ids"}
)

# The declared event registry: every ``emit()`` in this package uses one
# of these names, with payload keys drawn from the declared tuple (the
# ``RESERVED_KEYS`` framing keys ride every record). This is the
# emitter/consumer contract: ``tools/run_report.py`` may only key on
# declared names. The registry is the JAX package's, entry for entry, so
# one consumer reads a run of either package; events of modules the port
# has not ported yet are declared and never emitted. Adding an event =
# adding it here first; payload keys are append-only once a consumer reads
# them.
EVENT_SCHEMA = {
    # --- run lifecycle (runtime.loop / serve_adaptive) ---
    "run_start": ("name", "num_steps", "resumed", "prefetch_depth",
                  "async_ckpt", "host_id", "num_hosts", "stream_pos",
                  "mode", "adapt", "adapt_mode", "policy", "num_requests"),
    "run_end": ("outcome", "total_steps", "wall_s", "ckpt_commits",
                # serve_adaptive's summary fields
                "served", "failed", "adapt_steps", "adapt_skips",
                "regressions", "rollbacks", "snapshots", "holds", "frozen",
                "proxy_first", "proxy_last", "proxy_mean_first_half",
                "proxy_mean_second_half"),
    "resume": ("path", "stream_pos"),
    "geometry_change": ("manifest", "run"),
    "preempt": ("emergency_ckpt", "stream_pos"),
    "preempt_signal": ("signal",),
    # --- hot-loop health ---
    "stager_underrun": ("wait_ms",),
    "recompile": ("cache_size",),
    "profile_start": ("out_dir",),
    "profile_stop": ("out_dir",),
    # --- checkpoints ---
    "checkpoint_commit": ("tag", "path", "bytes", "commit_ms"),
    "checkpoint_rotate": ("removed", "kept"),
    "checkpoint_enqueue": ("tag", "async_queue_depth"),
    # --- guard / data layer ---
    "nan_skip": ("consecutive", "total"),
    "guard_abort": ("consecutive", "threshold"),
    "quarantine": ("index", "reason", "total"),
    "quarantine_systemic": ("quarantined", "domain", "threshold"),
    "io_retry": ("path", "attempt", "error"),
    # --- the JAX package's fused-step fallback; the port has no fallback
    # and never emits it ---
    "fused_update_fallback": ("reason", "backend", "shape"),
    # --- serving engine (runtime.infer) ---
    # trace_id / trace_ids are reserved framing keys (like step): any event
    # on a request's path may carry the single id or the batch's id list
    "bucket_compile": ("bucket", "batch", "compile_ms", "cache_size"),
    "infer_batch_commit": ("bucket", "valid", "padded", "wait_ms", "h2d_ms",
                           "device_ms"),
    "request_failed": ("stage", "bucket", "error"),
    "infer_retry": ("kind", "attempt", "bucket", "error"),
    "bucket_circuit_open": ("bucket", "reason", "error"),
    # pixels / bucket_hw: a reason=circuit degradation at a huge
    # bucket is megapixel overflow (route it to the spatial tier), at an
    # ordinary bucket a genuine compile failure — postmortems need the
    # pixel context to tell them apart
    "infer_degraded": ("bucket", "micro_batch", "reason", "error",
                       "pixels", "bucket_hw"),
    "watchdog_trip": ("where", "deadline_s", "stager_alive", "batches_done",
                      "bucket", "error"),
    "stream_summary": ("completed", "failed", "degraded", "watchdog_trips"),
    # --- continuous-batching scheduler (runtime.scheduler) ---
    "sched_admit": ("bucket", "depth", "priority", "deadline_ms"),
    "sched_flush": ("bucket", "valid", "reason", "wait_ms"),
    # --- serving lifecycle: drain + load shedding ---
    # a request rejected by the admission-time overload layer (reason
    # queue_full / deadline) or resolved as a typed casualty of a drain
    # that hit its --drain_timeout (reason drained) — the caller receives
    # a typed error InferResult either way, never a silent drop
    "sched_shed": ("reason", "bucket", "depth", "deadline_ms", "est_ms"),
    # --- megapixel serving: the spatial-sharded tier ---
    # one per request the pixel-aware admission layer hands to the
    # spatial tier: the decoded bucket, its H·W, and the bar it exceeded
    # (a raised bar under overload sheds the band below it instead —
    # those ride sched_shed reason=spatial)
    "sched_spatial_route": ("bucket", "pixels", "threshold", "tier"),
    # first SIGTERM/SIGINT (or a programmatic stop): admission stops,
    # pending work flushes, in-flight batches complete, then drain_complete
    # records how the bounded drain resolved every admitted request
    "drain_begin": ("signal", "timeout_s", "label"),
    "drain_complete": ("duration_ms", "resolved", "drained", "label"),
    # --- persistent executable store (runtime.aot_store) ---
    "aot_store_hit": ("path", "bytes", "load_ms", "bucket", "batch"),
    "aot_store_miss": ("path", "bucket", "batch"),
    "aot_store_reject": ("path", "reason", "error", "bucket", "batch"),
    "aot_store_commit": ("path", "bytes", "export_ms", "bucket", "batch"),
    # --- online adaptation (runtime.adapt) ---
    "adapt_eval": ("proxy", "frozen"),
    "adapt_hold": ("proxy", "ema_fast", "best_fast"),
    "adapt_step": ("block", "loss", "proxy", "ema_fast", "ema_slow"),
    "adapt_skip": ("consecutive", "block"),
    "adapt_regress": ("proxy", "ema_fast", "ema_slow", "factor"),
    "adapt_rollback": ("reason", "restored", "snapshot_step", "path"),
    "adapt_snapshot": ("path", "adapt_steps"),
    "adapt_frozen": ("reason",),
    "adapt_error": ("error",),
    # serving paused while an adaptation opportunity ran (eval/steps/
    # snapshot IO): the latency cost online adaptation charges requests
    "adapt_pause": ("pause_ms", "took"),
    # --- latency-tiered multi-model serving (runtime.tiers) ---
    # one per routed request: which tier the policy picked and why
    # (explicit / deadline / priority / default)
    "tier_dispatch": ("tier", "reason", "priority", "deadline_ms"),
    # cascade gate decisions: a fast-tier result accepted on confidence,
    # or an escalated pair resolved by the quality tier — outcome is
    # "replaced" (quality result served) or "fallback" (quality failed,
    # e.g. drained mid-cascade; the retained fast result served instead)
    "cascade_accept": ("confidence", "threshold"),
    "cascade_escalate": ("confidence", "threshold", "outcome"),
    # --- adaptive compute: early exit + video warm starting ---
    # one per request whose refinement loop exited before its tier's full
    # iteration budget (--converge_eps): how many iterations ran vs were
    # compiled, and how many the convergence exit saved
    "refine_early_exit": ("bucket", "iters", "iters_done", "saved"),
    # one per session-tagged video frame at admission: whether the frame
    # warm-started from the previous frame's disparity (reason names why
    # a frame went cold: first, reset after an error/drain, shape change)
    "session_warm_start": ("session", "frame", "warm", "reason"),
    # a session frame resolved by the session layer itself as a typed
    # error (still parked behind its predecessor when the inner stream
    # ended at a drain bound / stream death) — never a silent drop
    "session_shed": ("session", "reason"),
    # --- self-tuning overload control (runtime.controller) ---
    # one per controller interval: the decision (degrade one rung /
    # promote one rung / hold), the ladder position it moved between,
    # the sensor values that drove it (windowed SLO budget burn and the
    # deepest bucket's queue depth), and — on actuation — which knob
    # moved and to what value, with the declared bound it stayed inside
    "ctrl_degrade": ("rung", "from_rung", "knob", "value", "lo", "hi",
                     "burn", "depth", "reason"),
    "ctrl_promote": ("rung", "from_rung", "knob", "value", "lo", "hi",
                     "burn", "depth", "dwell_s"),
    "ctrl_hold": ("rung", "burn", "depth", "reason"),
    # --- crash forensics (runtime.blackbox) ---
    # one atomically-committed blackbox.json was written: trigger is
    # watchdog_trip / stream_death / adapt_frozen / drain / signal,
    # threads/ring_events are the dump's coverage counts, providers the
    # snapshot hooks that answered
    "blackbox_dump": ("trigger", "reason", "path", "threads", "ring_events",
                      "providers"),
    # --- quality observatory (runtime.quality) ---
    # a tier's drift-sentinel alarm transitioned (state raise / clear):
    # the worst sensor's PSI/KS (histogram sensors) or window-vs-reference
    # value (rate sensors) ride along, plus how many comparison windows
    # the sentinel has scored and the window size that scored this one
    "quality_drift": ("tier", "sensor", "state", "psi", "ks", "value",
                      "reference", "windows", "window_n"),
    # one golden canary checked against its committed golden: outcome is
    # pass / fail / captured (first sight of this (tier, key) bootstraps
    # the golden), mode is exact (frozen f32 path) or epe (toleranced
    # mean-abs-diff proxy), consecutive is the tier's failure streak
    "canary_result": ("tier", "seq", "key", "outcome", "epe", "tol",
                      "mode", "consecutive"),
    # the consecutive-failure latch fired: adaptation freezes via the
    # registered rails, the blackbox snapshots, and the controller's
    # fifth guard blocks quality-spending promotions until restart
    "canary_latch": ("tier", "consecutive", "reason", "action"),
    # --- fleet serving (runtime.fleet) ---
    # one request placed on a replica: reason is affinity / session /
    # migrate / least_loaded / failover, depth the fleet-wide in-flight
    # table, est_ms the host's EWMA-clocked queue estimate at placement
    "fleet_route": ("host", "reason", "session", "depth", "est_ms"),
    # a replica declared down (exit / conn_lost / send_error / health /
    # drain_exit): inflight is how many of its requests enter failover
    "fleet_host_down": ("host", "reason", "inflight", "pid"),
    # one in-flight request's failover decision: outcome redispatch
    # (re-sent to `host` at generation+1 — the fence) or typed_error
    # (budget spent / no healthy replica / drain cut it short)
    "fleet_failover": ("host", "from_host", "attempt", "outcome"),
    # a per-host circuit-breaker transition: state closed / open /
    # half_open, reason health_fail / probe / probe_ok / probe_fail
    "fleet_circuit_open": ("host", "state", "failures", "reason"),
    # a drain bracket: host is the drained replica (None for the
    # fleet-wide drain), phase begin / complete
    "fleet_drain": ("host", "phase", "pending", "duration_ms"),
}


def declared_events():
    """The registered event names (a frozen view of ``EVENT_SCHEMA``)."""
    return frozenset(EVENT_SCHEMA)


# Trace ids come from a generator seeded by the OS at import and again in
# every forked child: an id then costs no system call (``uuid4`` reads the
# OS's random source each time, which on some hosts costs more than the
# request's own bookkeeping).
_trace_rng = random.Random(os.urandom(16))


def _reseed_trace_ids() -> None:
    _trace_rng.seed(os.urandom(16))


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed_trace_ids)


def new_trace_id() -> str:
    """A fresh 16-hex-char request trace id (collision-safe at serving
    volumes: 64 random bits)."""
    return f"{_trace_rng.getrandbits(64):016x}"


# ----------------------------------------------------- streaming histograms

# Default bucket growth factor: bucket i covers (min*g^(i-1), min*g^i], the
# estimate is the geometric midpoint, so the worst-case relative error of
# any reported quantile is sqrt(g) - 1 ≈ 4.9% at g=1.1 — tight enough that
# "p99 is 6x p50" is a real signal, coarse enough that a histogram spanning
# 1 µs .. 1 h is ~230 occupied buckets at most.
HIST_GROWTH = 1.1
HIST_MIN = 1e-6  # seconds; anything faster than 1 µs is clamped


class LogHistogram:
    """Log-bucketed streaming histogram: bounded relative error, mergeable.

    Values land in geometric buckets ``(min*g^(i-1), min*g^i]``; quantiles
    are answered from the bucket counts with relative error bounded by
    ``rel_error()`` (= sqrt(growth) - 1). Two histograms with identical
    parameters merge exactly (bucket counts add) — per-thread or per-host
    histograms fold into one without losing the bound. Thread-safe; the
    exact count/sum/min/max ride alongside the buckets, and quantile
    estimates are clamped into [min, max] so p0/p100 are exact.

    No dependencies: it stays importable from frame_io workers without a
    numpy or torch import.
    """

    __slots__ = ("growth", "min_value", "_log_g", "_lock", "_buckets",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, growth: float = HIST_GROWTH,
                 min_value: float = HIST_MIN):
        if growth <= 1.0:
            raise ValueError("LogHistogram growth must be > 1")
        if min_value <= 0.0:
            raise ValueError("LogHistogram min_value must be > 0")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_g = math.log(self.growth)
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def rel_error(self) -> float:
        """Worst-case relative error of any quantile estimate."""
        return math.sqrt(self.growth) - 1.0

    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        # ceil of log_g(value/min): the smallest i with min*g^i >= value
        i = math.ceil(math.log(value / self.min_value) / self._log_g)
        # guard the float edge: log/ceil may land one bucket high exactly
        # at a boundary, which would break the error bound's low side
        if self.min_value * self.growth ** (i - 1) >= value:
            i -= 1
        return max(i, 0)

    def _estimate(self, index: int) -> float:
        if index == 0:
            return self.min_value
        # geometric midpoint of the bucket: the error-minimizing point
        return self.min_value * self.growth ** (index - 0.5)

    def record(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            return  # a NaN latency is a bug upstream, not a sample
        i = self._index(value)
        with self._lock:
            self._buckets[i] = self._buckets.get(i, 0) + 1
            self._count += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    def merge(self, other: "LogHistogram") -> None:
        """Fold ``other`` in exactly (same growth/min_value required)."""
        if (other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError(
                "LogHistogram.merge requires identical bucket parameters"
            )
        with other._lock:
            buckets = dict(other._buckets)
            count, total = other._count, other._sum
            mn, mx = other._min, other._max
        with self._lock:
            for i, n in buckets.items():
                self._buckets[i] = self._buckets.get(i, 0) + n
            self._count += count
            self._sum += total
            if mn is not None and (self._min is None or mn < self._min):
                self._min = mn
            if mx is not None and (self._max is None or mx > self._max):
                self._max = mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (0 <= q <= 1); None when empty."""
        qs = self.quantiles((q,))
        return qs[0] if qs else None

    def _quantiles_from(self, items, count, mn, mx, qs
                        ) -> List[Optional[float]]:
        """Quantile walk over an already-consistent bucket view."""
        out: List[Optional[float]] = []
        for q in qs:
            if q <= 0.0:
                out.append(mn)  # exact extremes ride alongside the buckets
                continue
            if q >= 1.0:
                out.append(mx)
                continue
            # the rank-th smallest sample (1-indexed, nearest-rank)
            rank = min(max(int(math.ceil(q * count)), 1), count)
            acc = 0
            est = self._estimate(items[-1][0])
            for i, n in items:
                acc += n
                if acc >= rank:
                    est = self._estimate(i)
                    break
            out.append(min(max(est, mn), mx))  # never outside [min, max]
        return out

    def quantiles(self, qs) -> List[Optional[float]]:
        """Estimate several quantiles in ONE consistent pass (one lock
        acquisition, one bucket walk) — exported percentile sets must not
        mix two snapshots of a live histogram."""
        with self._lock:
            if self._count == 0:
                return [None for _ in qs]
            items = sorted(self._buckets.items())
            count, mn, mx = self._count, self._min, self._max
        return self._quantiles_from(items, count, mn, mx, qs)

    def snapshot(self) -> Dict[str, Any]:
        """The export view: count/sum/min/max + p50/p95/p99.

        ATOMIC: one lock acquisition covers the stats and the quantile
        inputs — a record() landing mid-snapshot can never produce the
        torn ``{count: 1, p50: None}`` view that would crash an exporter
        formatting the quantile as a number.
        """
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            items = sorted(self._buckets.items()) if count else []
        if count == 0:
            p50 = p95 = p99 = None
        else:
            p50, p95, p99 = self._quantiles_from(
                items, count, mn, mx, (0.5, 0.95, 0.99))
        return {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "p50": p50,
            "p95": p95,
            "p99": p99,
        }

    def bucket_counts(self) -> Dict[int, int]:
        """A copy of the raw bucket counts (merge/equality testing)."""
        with self._lock:
            return dict(self._buckets)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _prom_labels(label_items, extra: str = "") -> str:
    body = ",".join(f'{k}="{v}"' for k, v in label_items)
    if extra:
        body = f"{body},{extra}" if body else extra
    return "{" + body + "}" if body else ""


class MetricsRegistry:
    """Process-local registry of counters, gauges, and latency histograms.

    Keyed by (name, sorted label items) — e.g.
    ``observe("infer_e2e_seconds", 0.12, bucket="448x736")``. Thread-safe:
    serving records from the consumer thread, the stager thread captures
    decode costs, and the heartbeat/Prometheus exporters read from
    whichever thread flushes. ``to_prometheus()`` renders the standard
    text exposition format (histograms as summaries with precomputed
    p50/p95/p99 quantiles plus ``_sum``/``_count``/``_max``), and
    ``latency_snapshot()`` is the nested dict the heartbeat embeds.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._hists: Dict[Tuple[str, tuple], LogHistogram] = {}

    def inc(self, name: str, n: float = 1, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def histogram(self, name: str, **labels) -> LogHistogram:
        """Get-or-create the (name, labels) histogram."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = LogHistogram()
            return h

    def observe(self, name: str, value: float, **labels) -> None:
        self.histogram(name, **labels).record(value)

    def _snapshot(self):
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    dict(self._hists))

    def latency_snapshot(self) -> Dict[str, Any]:
        """{name: {label_str|"": {count,sum,min,max,p50,p95,p99}}} — the
        heartbeat's ``latency`` section."""
        _counters, _gauges, hists = self._snapshot()
        out: Dict[str, Any] = {}
        for (name, labels), h in sorted(hists.items()):
            label_str = ",".join(f"{k}={v}" for k, v in labels)
            out.setdefault(name, {})[label_str] = h.snapshot()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the whole registry."""
        counters, gauges, hists = self._snapshot()
        lines: List[str] = []
        seen_types = set()

        def header(name: str, kind: str) -> None:
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} {kind}")

        def num(v: float) -> str:
            # integral values print exactly (a monotonic counter must not
            # plateau into 1.23457e+06 at scale); others get 9 sig figs
            return str(int(v)) if float(v).is_integer() else f"{v:.9g}"

        for (name, labels), v in sorted(counters.items()):
            header(name, "counter")
            lines.append(f"{name}{_prom_labels(labels)} {num(v)}")
        for (name, labels), v in sorted(gauges.items()):
            header(name, "gauge")
            lines.append(f"{name}{_prom_labels(labels)} {num(v)}")
        for (name, labels), h in sorted(hists.items()):
            snap = h.snapshot()
            if not snap["count"]:
                continue
            header(name, "summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                qlabel = 'quantile="%s"' % q
                lines.append(
                    f"{name}{_prom_labels(labels, qlabel)} {snap[key]:.9g}"
                )
            lines.append(f"{name}_sum{_prom_labels(labels)} {snap['sum']:.9g}")
            lines.append(f"{name}_count{_prom_labels(labels)} {snap['count']}")
            header(f"{name}_max", "gauge")
            lines.append(f"{name}_max{_prom_labels(labels)} {snap['max']:.9g}")
        return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------------- SLO accounting


class SLOTracker:
    """Per-tier deadline-hit-rate and error-budget burn.

    ``observe(tier, seconds, ok)`` classifies one resolved request: a hit
    is a completed request whose end-to-end latency met the configured
    ``p95_ms`` target; a failed/shed/drained request (``ok=False``) or a
    late one is a miss. ``snapshot()`` derives the per-tier hit rate and
    the error-budget burn rate — the miss fraction over the allowed miss
    budget, so burn 1.0 means the tier is spending its budget exactly as
    fast as allowed and burn 4.0 means it will exhaust a month's budget
    in a week. Thread-safe (requests resolve on the serving consumer
    thread, the blackbox dumper and the heartbeat read from theirs);
    dependency-free like the histograms above.
    """

    def __init__(self, p95_ms: float, budget: float):
        if p95_ms <= 0:
            raise ValueError("SLOTracker p95_ms must be > 0")
        if not 0.0 < budget <= 1.0:
            raise ValueError("SLOTracker budget must be in (0, 1]")
        self.p95_ms = float(p95_ms)
        self.budget = float(budget)
        self._lock = threading.Lock()
        self._totals: Dict[str, int] = {}
        self._misses: Dict[str, int] = {}

    def observe(self, tier: str, seconds: Optional[float],
                ok: bool = True) -> None:
        tier = str(tier)
        miss = (not ok) or seconds is None \
            or float(seconds) * 1e3 > self.p95_ms
        with self._lock:
            self._totals[tier] = self._totals.get(tier, 0) + 1
            if miss:
                self._misses[tier] = self._misses.get(tier, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        """{tier: {target_p95_ms, budget, total, misses, hit_rate,
        budget_burn}} — empty dict before the first observation."""
        with self._lock:
            totals = dict(self._totals)
            misses = dict(self._misses)
        out: Dict[str, Any] = {}
        for tier in sorted(totals):
            total = totals[tier]
            miss = misses.get(tier, 0)
            frac = miss / total if total else 0.0
            out[tier] = {
                "target_p95_ms": self.p95_ms,
                "budget": self.budget,
                "total": total,
                "misses": miss,
                "hit_rate": round(1.0 - frac, 6),
                "budget_burn": round(frac / self.budget, 4),
            }
        return out

    def to_prometheus(self) -> str:
        """Prometheus text lines for the SLO posture (appended to the
        registry's exposition by ``write_metrics_prom``)."""
        snap = self.snapshot()
        if not snap:
            return ""
        lines = ["# TYPE slo_requests_total counter"]
        for tier, row in snap.items():
            hits = row["total"] - row["misses"]
            lines.append(f'slo_requests_total{{tier="{tier}",outcome="hit"}} '
                         f"{hits}")
            lines.append(
                f'slo_requests_total{{tier="{tier}",outcome="miss"}} '
                f"{row['misses']}")
        lines.append("# TYPE slo_hit_rate gauge")
        for tier, row in snap.items():
            lines.append(f'slo_hit_rate{{tier="{tier}"}} {row["hit_rate"]:g}')
        lines.append("# TYPE slo_budget_burn gauge")
        for tier, row in snap.items():
            lines.append(
                f'slo_budget_burn{{tier="{tier}"}} {row["budget_burn"]:g}')
        lines.append("# TYPE slo_target_p95_ms gauge")
        lines.append(f"slo_target_p95_ms {self.p95_ms:g}")
        return "\n".join(lines) + "\n"


# Span buffer cap: ~80 bytes/span in memory, ~120 bytes serialized — 200k
# spans is ~25 MB of trace, about what Perfetto still opens comfortably.
# Past the cap, spans are counted (``spans_dropped``) instead of recorded,
# and the drop is announced in the flushed trace metadata — a truncated
# trace must not read as "the run stopped doing work here".
MAX_SPANS = 200_000

# Trace ids a span keeps of its batch's list (spans stay in memory until
# flushed; events carry the full list).
SPAN_TRACE_IDS = 8

# Flight-recorder depth: the last N event records, full payloads,
# kept in memory independent of file flushing — what a blackbox dump can
# still produce when events.jsonl was never flushed (or never configured).
# 512 records is minutes of serving history at typical event rates for
# well under a megabyte.
RING_CAPACITY = 512


def clock_anchor(tries: int = 5) -> Tuple[int, int]:
    """(``perf_counter_ns``, ``time_ns``) of one instant. Spans stamp the
    first (CLOCK_MONOTONIC); ``torch.profiler`` stamps its host and device
    events in Unix-epoch nanoseconds (CLOCK_REALTIME), the second. The
    tightest of ``tries`` bracketed reads: the monotonic reading is the
    middle of the two around the epoch one."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


class Span(NamedTuple):
    """One recorded span: ``t0`` (``perf_counter_ns``) and ``dur`` in ns;
    ``sid`` its number in the sink (from 1) and ``parent`` the number of
    the innermost span open on its thread when it began (0: none)."""

    name: str
    tid: int
    thread: str
    t0: int
    dur: int
    args: Optional[dict]
    sid: int
    parent: int


class Telemetry:
    """One run's telemetry sink: event log + span buffer + heartbeat.

    Thread-safe (events and spans arrive from the training thread, the
    stager thread, the checkpoint committer thread, and loader workers) and
    reentrant (``RLock``): the preemption signal handler may emit an event
    while the interrupted main-thread frame holds the lock.
    """

    def __init__(self, run_dir: str, host: int = 0, max_spans: int = MAX_SPANS,
                 ring_capacity: int = RING_CAPACITY):
        self.run_dir = str(run_dir)
        self.host = int(host)
        os.makedirs(self.run_dir, exist_ok=True)
        self._lock = threading.RLock()
        self._events_path = os.path.join(self.run_dir, EVENTS_NAME)
        self._events_f = open(self._events_path, "a")
        self._counters: Counter = Counter()
        self._spans: List[Span] = []
        self._max_spans = max_spans
        self._spans_dropped = 0
        self._span_ids = itertools.count(1)
        self._open = threading.local()  # per thread: the numbers of its open spans
        # (monotonic ns, profiler-clock ns) of one instant; ``install`` takes
        # it again
        self.anchor = clock_anchor()
        self._write_errors = 0
        self._closed = False
        # flight recorder: a bounded ring of the last N full event
        # records, appended O(1) under the (reentrant) lock on the same
        # path that counts the event — survives the file write failing,
        # and is what blackbox dumps and /debug/requests read
        self._ring_cap = max(int(ring_capacity), 0)
        self._ring: List[Dict[str, Any]] = []
        self._ring_total = 0
        self._ring_dropped = 0
        # the run's metrics registry (counters/gauges/latency histograms):
        # fed through the module-level observe()/inc_metric() hooks,
        # exported by the heartbeat's latency section and metrics.prom
        self.metrics = MetricsRegistry()
        # per-tier SLO accounting, armed by configure_slo (CLI
        # --slo_p95_ms); None = no SLO configured, observe_slo no-ops
        self.slo: Optional[SLOTracker] = None

    def configure_slo(self, p95_ms: float, budget: float = 0.01
                      ) -> SLOTracker:
        """Arm per-tier SLO accounting (call once, before serving — the
        install-once pattern the telemetry sink itself uses)."""
        self.slo = SLOTracker(p95_ms, budget)
        return self.slo

    # ------------------------------------------------------------- events

    def event(self, name: str, /, step: Optional[int] = None, **payload) -> None:
        """Append one typed record to events.jsonl and bump its counter.

        Reserved keys (``event``, ``t_wall``, ``t_mono``, ``host``,
        ``step``) frame the record; payload keys are merged flat so the log
        stays one-line-greppable (``jq 'select(.event=="quarantine")'``).
        """
        rec: Dict[str, Any] = {
            "event": name,
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "host": self.host,
        }
        if step is not None:
            rec["step"] = int(step)
        if payload:
            rec.update(payload)
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._closed:
                return
            self._counters[name] += 1
            # flight recorder: O(1) slot write (list append until full,
            # then overwrite-oldest by modular index) — BEFORE the file
            # write, so a dying disk still leaves the ring dumpable
            if self._ring_cap:
                if len(self._ring) < self._ring_cap:
                    self._ring.append(rec)
                else:
                    self._ring[self._ring_total % self._ring_cap] = rec
                    self._ring_dropped += 1
                self._ring_total += 1
            try:
                self._events_f.write(line + "\n")
                self._events_f.flush()
            except Exception as e:  # noqa: BLE001 — telemetry must not kill runs
                self._note_write_error("event", e)

    def counters_snapshot(self) -> Dict[str, int]:
        """Monotonic per-event-type counts (folded into MetricLogger rows)."""
        with self._lock:
            return dict(self._counters)

    def ring_snapshot(self) -> Dict[str, Any]:
        """A consistent copy of the flight recorder: the retained event
        records oldest-first, plus the overwrite (drop) count. One lock
        acquisition — an ``event()`` landing mid-snapshot can never
        produce a torn or reordered view."""
        with self._lock:
            if self._ring_total <= self._ring_cap or not self._ring_cap:
                events = list(self._ring)
            else:
                head = self._ring_total % self._ring_cap
                events = self._ring[head:] + self._ring[:head]
            return {
                "capacity": self._ring_cap,
                "total": self._ring_total,
                "dropped": self._ring_dropped,
                "events": events,
            }

    def _note_write_error(self, what: str, e: Exception) -> None:
        # called from event() (under the RLock) but also from flush_trace /
        # write_heartbeat error paths on arbitrary threads — take the
        # (reentrant) lock so the error count can't lose increments
        with self._lock:
            self._write_errors += 1
            first = self._write_errors == 1
        if first:
            logger.warning(
                "telemetry: %s write failed (%s: %s) — telemetry degrades, "
                "the run continues; further write errors are counted silently",
                what, type(e).__name__, e,
            )

    # -------------------------------------------------------------- spans

    @contextlib.contextmanager
    def span(self, name: str, /, **args) -> Iterator[None]:
        """Time a host-side region into the Chrome trace (near-zero cost).
        A ``trace_ids`` list is kept to its first ``SPAN_TRACE_IDS``."""
        sid = next(self._span_ids)
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        parent = stack[-1] if stack else 0
        stack.append(sid)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dur = time.perf_counter_ns() - t0
            stack.pop()
            ids = args.get("trace_ids")
            if ids and len(ids) > SPAN_TRACE_IDS:
                args["trace_ids"] = (list(ids[:SPAN_TRACE_IDS])
                                     + [f"+{len(ids) - SPAN_TRACE_IDS} more"])
            thread = threading.current_thread()
            with self._lock:
                if len(self._spans) >= self._max_spans:
                    self._spans_dropped += 1
                else:
                    self._spans.append(Span(name, thread.ident or 0, thread.name, t0, dur,
                                            args or None, sid, parent))

    def profiler_ns(self, mono_ns: int) -> int:
        """A ``perf_counter_ns`` reading on ``torch.profiler``'s clock."""
        return mono_ns - self.anchor[0] + self.anchor[1]

    def spans(self) -> List[Dict[str, Any]]:
        """The recorded spans on the profiler's clock: ``name``, ``thread``
        (its name), ``start_ns``, ``end_ns``, ``id``, ``parent`` and
        ``args``."""
        with self._lock:
            spans = list(self._spans)
        return [{"name": sp.name, "thread": sp.thread, "start_ns": self.profiler_ns(sp.t0),
                 "end_ns": self.profiler_ns(sp.t0 + sp.dur), "id": sp.sid, "parent": sp.parent,
                 "args": sp.args} for sp in spans]

    def flush_trace(self) -> None:
        """Atomically (re)write ``trace_host.json`` in Chrome trace format.

        The file is a complete JSON object (``json.loads`` / Perfetto both
        accept it) replaced wholesale on each flush — a reader never sees a
        torn trace, and a crash between flushes costs only the spans since
        the last one.
        """
        with self._lock:
            spans = list(self._spans)
            dropped = self._spans_dropped
        events: List[dict] = []
        seen_tids = {}
        for sp in spans:
            if sp.tid not in seen_tids:
                seen_tids[sp.tid] = sp.thread
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": self.profiler_ns(sp.t0) / 1e3,  # the profiler's clock, µs
                "dur": sp.dur / 1e3,
                "pid": self.host,
                "tid": sp.tid,
                "args": {**(sp.args or {}), "span_id": sp.sid, "parent_id": sp.parent},
            })
        meta = [
            {"name": "process_name", "ph": "M", "pid": self.host, "tid": 0,
             "args": {"name": f"host {self.host}"}},
        ] + [
            {"name": "thread_name", "ph": "M", "pid": self.host, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in seen_tids.items()
        ]
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"spans": len(events), "spans_dropped": dropped,
                          # ts = perf_counter_ns - anchor[0] + anchor[1], in µs:
                          # Unix-epoch time, torch.profiler's time base
                          "clock": "unix_epoch", "anchor_ns": list(self.anchor)},
        }
        path = os.path.join(self.run_dir, TRACE_NAME)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001
            self._note_write_error("trace", e)

    # ---------------------------------------------------------- heartbeat

    def write_heartbeat(self, **fields) -> None:
        """Atomically replace ``heartbeat.json`` with the current run health.

        tmp + fsync + ``os.replace`` — a poller (or a crash mid-write, see
        the ``heartbeat_write`` fault-injection point) always sees either
        the previous complete heartbeat or the new one, never a torn file.
        """
        hb: Dict[str, Any] = {
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "host": self.host,
        }
        hb.update(fields)
        hb["events"] = self.counters_snapshot()
        latency = self.metrics.latency_snapshot()
        if latency:
            hb["latency"] = latency
        if self.slo is not None:
            slo = self.slo.snapshot()
            if slo:
                hb["slo"] = slo
        mem = device_memory_stats()
        if mem is not None:
            hb["device_memory"] = mem
        path = os.path.join(self.run_dir, HEARTBEAT_NAME)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(hb, f, indent=1, sort_keys=True, default=str)
                f.flush()
                os.fsync(f.fileno())
            faultinject.crash_point("heartbeat_write")
            os.replace(tmp, path)
        except faultinject.InjectedCrash:
            raise
        except Exception as e:  # noqa: BLE001
            self._note_write_error("heartbeat", e)
        self.write_metrics_prom()

    def write_metrics_prom(self) -> None:
        """Atomically (re)write the Prometheus text snapshot of the metrics
        registry (``metrics.prom``) — nothing when no metric was recorded,
        so training/eval runs that never observe latency stay prom-free."""
        path = os.path.join(self.run_dir, METRICS_PROM_NAME)
        tmp = path + ".tmp"
        try:
            text = self.metrics.to_prometheus()
            if self.slo is not None:
                text += self.slo.to_prometheus()
            if not text:
                return
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 — telemetry must not kill runs
            self._note_write_error("metrics.prom", e)

    # -------------------------------------------------------------- close

    def close(self) -> None:
        """Flush the trace and metrics, release the event log (idempotent).

        The closed flag is latched under the lock but the flushes run
        OUTSIDE it (each snapshots state under its own short lock
        section) — holding ``_lock`` across file I/O would convoy every
        thread still emitting events.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.flush_trace()
        self.write_metrics_prom()
        with self._lock:
            try:
                self._events_f.close()
            except Exception:  # noqa: BLE001 — best-effort release
                pass


def device_memory_stats() -> Optional[dict]:
    """The caching allocator's figures for the current card under the JAX
    package's keys (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``: the card's memory), plus ``bytes_reserved``; None
    without a card, or in a process that has not imported torch (this probe
    never imports it). It reads counters only, no CUDA call that a graph
    capture on another thread would trip over."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        stats = torch.cuda.memory_stats()
        total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    except Exception:  # noqa: BLE001 — health reporting is best-effort
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
    }


# -------------------------------------------------------- module-level hooks

_current: Optional[Telemetry] = None


def install(tel: Optional[Telemetry]) -> Optional[Telemetry]:
    """Make ``tel`` the process-wide telemetry sink (None to clear), and take
    its clock anchor."""
    global _current
    if tel is not None:
        tel.anchor = clock_anchor()
    _current = tel
    return tel


def uninstall(tel: Optional[Telemetry]) -> None:
    """Close ``tel`` and clear it if it is the installed sink (idempotent)."""
    global _current
    if tel is None:
        return
    if _current is tel:
        _current = None
    tel.close()


def get() -> Optional[Telemetry]:
    return _current


def emit(name: str, /, step: Optional[int] = None, **payload) -> None:
    """Record an event on the installed sink; no-op when none is installed.

    ``name`` is positional-only, so a payload may itself carry a ``name``
    key (e.g. ``run_start``'s run name) without colliding."""
    tel = _current
    if tel is not None:
        tel.event(name, step=step, **payload)


_NO_SPAN = contextlib.nullcontext()


def span(name: str, /, **args):
    """Span on the installed sink; a shared nullcontext when none installed.
    Pass args that cost nothing to build (the sink bounds ``trace_ids``)."""
    tel = _current
    if tel is not None:
        return tel.span(name, **args)
    return _NO_SPAN


def metrics_registry() -> Optional[MetricsRegistry]:
    """The installed sink's metrics registry, or None."""
    tel = _current
    return tel.metrics if tel is not None else None


def observe(name: str, value: float, **labels) -> None:
    """Record one latency/size observation into the installed registry's
    ``name`` histogram; no-op (one attribute read) when none installed."""
    tel = _current
    if tel is not None:
        tel.metrics.observe(name, value, **labels)


def inc_metric(name: str, n: float = 1, **labels) -> None:
    """Bump a counter on the installed registry; no-op when none."""
    tel = _current
    if tel is not None:
        tel.metrics.inc(name, n, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    """Set a gauge on the installed registry; no-op when none."""
    tel = _current
    if tel is not None:
        tel.metrics.set_gauge(name, value, **labels)


def observe_slo(tier: str, seconds: Optional[float], ok: bool = True) -> None:
    """Classify one resolved request against the configured SLO (no-op
    when no sink is installed or no SLO was configured): ``seconds`` is
    the request's end-to-end latency, ``ok=False`` (failed/shed/drained)
    is a miss regardless of latency."""
    tel = _current
    if tel is not None and tel.slo is not None:
        tel.slo.observe(tier, seconds, ok=ok)


# ------------------------------------------------------------ stage marks

# per thread: (event factory, the marks collected) of the open
# ``stage_marks`` block
_marks = threading.local()


class HostMark:
    """A stage mark on the host clock, for a forward that runs on the host
    (the CPU): a device event's ``record`` and ``elapsed_time`` (ms)."""

    __slots__ = ("ns",)

    def __init__(self):
        self.ns = 0

    def record(self) -> None:
        self.ns = time.perf_counter_ns()

    def elapsed_time(self, end: "HostMark") -> float:
        return (end.ns - self.ns) / 1e6


@contextlib.contextmanager
def stage_marks(factory: Callable[[], Any]) -> Iterator[Optional[List[Tuple[str, Any]]]]:
    """Collect the stage marks (``mark``) that a forward records on this
    thread inside the block: yields the list of (stage, event) pairs, or
    None when no sink is installed, and then the forward records nothing.
    ``factory`` makes one event (``record()``, ``elapsed_time(end)`` in
    ms): ``torch.cuda.Event(enable_timing=True, external=True)`` under a
    CUDA graph capture, where each record becomes an event-record node of
    the graph; a timing event for an eager forward on the card;
    ``HostMark`` on the host."""
    if _current is None:
        yield None
        return
    prev = getattr(_marks, "active", None)
    active = _marks.active = (factory, [])
    try:
        yield active[1]
    finally:
        _marks.active = prev


def mark(stage: str) -> None:
    """Record the end of ``stage`` on the current stream into this thread's
    open ``stage_marks`` block; a no-op outside one."""
    active = getattr(_marks, "active", None)
    if active is not None:
        ev = active[0]()
        ev.record()
        active[1].append((stage, ev))


def stage_ms(marks: Sequence[Tuple[str, Any]]) -> Dict[str, float]:
    """The ms between consecutive marks, each named by the later one (its
    stage); {} for fewer than two. Every event must have completed."""
    return {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])}


# -------------------------------------------- idle device time by span

OUTSIDE = "outside the program"


def _innermost(spans) -> List[Tuple[int, int, str]]:
    """One thread's spans [(start, end, name)], nested, as disjoint
    segments [(start, end, name)] of the innermost span open."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, name), innermost last
    cursor = 0
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            segs.append((cursor, end, name))
            cursor = end
        if stack:
            segs.append((cursor, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, n))
        cursor = s
    while stack:
        end, name = stack.pop()
        segs.append((cursor, end, name))
        cursor = end
    return [x for x in segs if x[1] > x[0]]


def idle_by_span(busy: Sequence[Tuple[int, int]], window: Tuple[int, int],
                 lanes: Sequence[Sequence[Tuple[int, int, str]]]
                 ) -> Dict[Tuple[str, ...], int]:
    """Every idle nanosecond of ``window`` (the gaps between the ``busy``
    intervals, e.g. a profiler trace's kernels and copies) attributed once,
    to the innermost span of each lane (one thread's spans, [(start, end,
    name)]) open at that instant, ``OUTSIDE`` where none is: {(lane 0's
    name, lane 1's, ...): ns}. All times on one clock (``spans()`` gives
    the profiler's); the values sum to the window's idle time."""
    w0, w1 = window
    idle, cursor = [], w0
    for s, e in sorted(busy):
        s, e = min(max(s, w0), w1), min(e, w1)
        if e <= cursor:
            continue
        if s > cursor:
            idle.append((cursor, s))
        cursor = e
    if cursor < w1:
        idle.append((cursor, w1))
    segs = [_innermost(lane) for lane in lanes]
    starts = [[x[0] for x in sg] for sg in segs]
    bounds = sorted({t for sg in segs for x in sg for t in x[:2]})
    out: Dict[Tuple[str, ...], int] = {}
    for a, b in idle:
        cuts = [a] + bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)] + [b]
        for p, q in zip(cuts, cuts[1:]):
            key = []
            for sg, st in zip(segs, starts):
                i = bisect.bisect_right(st, p) - 1
                key.append(sg[i][2] if i >= 0 and sg[i][1] > p else OUTSIDE)
            key = tuple(key)
            out[key] = out.get(key, 0) + (q - p)
    return out


# ------------------------------------------------------- recompile detector


class RecompileDetector:
    """Emit a ``recompile`` event when a ``GraphCache`` captures a key it
    had captured before (an eviction brought it back: the capture's seconds
    are paid again).

    ``check()`` reads the cache's ``captures_by_key``; an object without
    it (an eager step function: nothing is captured) makes the detector
    inert. It fires once for each capture past a key's first."""

    def __init__(self, cache):
        self._cache = cache if hasattr(cache, "captures_by_key") else None
        self._seen = 0

    def check(self, step: Optional[int] = None) -> bool:
        """Returns True iff a recompile was recorded now."""
        if self._cache is None:
            return False
        repeats = sum(n - 1 for n in self._cache.captures_by_key.values() if n > 1)
        if repeats <= self._seen:
            return False
        self._seen = repeats
        logger.warning("a graph key was captured again (%d repeat capture(s) at step %s): "
                       "the cache evicted a key that is still in use", repeats, step)
        emit("recompile", step=step, cache_size=len(self._cache))
        return True


# ---------------------------------------------------------- profile window


def parse_profile_steps(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse ``--profile_steps A:B`` into an inclusive (start, stop) step
    window; None/empty disables. Raises ValueError on malformed specs so a
    typo fails at argparse time, not 40k steps into the run."""
    if not spec:
        return None
    try:
        a_s, b_s = spec.split(":")
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(
            f"--profile_steps expects A:B (1-indexed inclusive step window), "
            f"got {spec!r}"
        ) from None
    if a < 1 or b < a:
        raise ValueError(f"--profile_steps window must satisfy 1 <= A <= B, got {spec!r}")
    return a, b


class ProfileWindow:
    """Run ``torch.profiler`` (CPU and, on the card, CUDA activity) over
    steps [start, stop] of a training run.

    Driven by the loop: ``on_step_start(step)`` before ``step``,
    ``on_step_end(step)`` after it, ``close()`` at the loop's exit (so a
    preemption inside the window still writes the trace). The Chrome trace
    lands in ``out_dir`` as ``steps_<A>_<B>.pt.trace.json``.
    """

    def __init__(self, start_step: int, stop_step: int, out_dir: str):
        self.start_step = int(start_step)
        self.stop_step = int(stop_step)
        self.out_dir = str(out_dir)
        self._prof = None
        self._first: Optional[int] = None
        self._done = False

    def on_step_start(self, step: int) -> None:
        # armed over the whole window, so a run resumed inside it still
        # captures the rest; one resumed past it warns instead
        if self._prof is not None or self._done:
            return
        if step > self.stop_step:
            self._done = True
            logger.warning("profile window %d..%d is entirely before this run's first step %d "
                           "(resumed past it?); no trace will be taken",
                           self.start_step, self.stop_step, step)
            return
        if step < self.start_step:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.out_dir, exist_ok=True)
        try:
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            logger.warning("profile window: the profiler did not start: %s", e)
            self._prof = None
            self._done = True
            return
        self._first = step
        emit("profile_start", step=step, out_dir=self.out_dir)
        logger.info("profiling steps %d..%d into %s", self.start_step, self.stop_step,
                    self.out_dir)

    def on_step_end(self, step: int) -> None:
        if self._prof is not None and step >= self.stop_step:
            self._stop(step)

    def close(self) -> None:
        if self._prof is not None:
            self._stop(None)

    @property
    def trace_path(self) -> str:
        return os.path.join(self.out_dir, f"steps_{self._first}_{self.stop_step}.pt.trace.json")

    def _stop(self, step: Optional[int]) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(self.trace_path)
        except Exception as e:  # noqa: BLE001
            logger.warning("profile window: the trace was not written: %s", e)
        emit("profile_stop", step=step, out_dir=self.out_dir)


__all__ = [
    "EVENTS_NAME",
    "EVENT_SCHEMA",
    "HEARTBEAT_NAME",
    "HIST_GROWTH",
    "HIST_MIN",
    "HostMark",
    "LogHistogram",
    "MAX_SPANS",
    "METRICS_PROM_NAME",
    "MetricsRegistry",
    "OUTSIDE",
    "RING_CAPACITY",
    "SLOTracker",
    "SPAN_TRACE_IDS",
    "Span",
    "TRACE_NAME",
    "ProfileWindow",
    "RecompileDetector",
    "Telemetry",
    "clock_anchor",
    "declared_events",
    "device_memory_stats",
    "emit",
    "get",
    "idle_by_span",
    "inc_metric",
    "install",
    "mark",
    "metrics_registry",
    "new_trace_id",
    "observe",
    "observe_slo",
    "parse_profile_steps",
    "set_gauge",
    "span",
    "stage_marks",
    "stage_ms",
    "uninstall",
]

"""Continuous-batching scheduler and video sessions over the engine (the
port's own copy of ``raft_stereo_tpu/runtime/scheduler.py``).

The engine serves one stream in arrival order: its stager stages a
bucket's micro-batch the moment that bucket holds ``batch`` items, and a
partial bucket flushes only at the end of the stream. The scheduler adds
an admission layer in front of it:

  * **Per-bucket pending queues.** An admission thread (``sched-admit``)
    pulls the caller's requests, runs each one's decode (the lazy
    ``inputs``, so decode overlaps the engine's staging and its device
    work), buckets the shapes and queues each request with its priority
    and optional deadline, under a bounded ``admit_depth``.
  * **Full-batch-first dispatch.** The engine is fed whichever bucket can
    form a full micro-batch now; among full buckets the earliest deadline,
    then the highest priority, then the oldest head goes first, and within
    a bucket the ``batch`` most urgent requests board. With no deadlines
    or priorities that is FIFO: a FIFO stream packs the engine's batches
    and gives its outputs bitwise.
  * **Anti-starvation flush** (``--sched_max_wait``): a bucket whose oldest
    request has waited past the bound is dispatched as a partial (masked)
    batch ahead of full buckets, through an in-band ``FlushRequest``; so
    is every partial at the end of the stream (reason ``drain``).
  * **Downstream is the engine, unchanged**: retries, circuit breaker,
    degraded path, trace ids (assigned at admission, so ``sched_admit``
    and the engine's events share one). A decode that fails at admission
    is forwarded as a decode that raises, and the engine types it.

**Serving lifecycle.** ``max_pending`` replaces the blocking backpressure
with shedding: a request arriving while ``max_pending`` are queued is
rejected before its decode (``ShedError``, reason ``queue_full``), and
one whose deadline the bucket's EWMA batch-service time already misses is
rejected at admission (reason ``deadline``). ``request_drain(timeout_s)``
(signal-handler safe) flushes every pending bucket, lets in-flight batches
complete, and resolves whatever is still queued when the bound expires as
``DrainedError``; a drained scheduler stays drained. Every request the
source yields resolves exactly once.

**Pixel-aware routing** (the spatial tier, off until ``configure_spatial``
wires a sink): a decoded request whose padded bucket H·W exceeds the live
bar is handed to the sink, the spatial tier's feed, instead of boarding
this scheduler's queues (``sched_spatial_route``); the overload
controller may raise the bar above its base with
``set_spatial_threshold``, and the band (base, live] is then shed with
the typed reason ``spatial``. With routing off, admission is the same
code path it was without the tier.

**Video sessions.** ``SessionServer`` serialises the frames of each
session (frame t is admitted only after frame t-1 resolved) and
warm-starts each from its predecessor's disparity through
``forward_interpolate`` (a third input slot, zeros when cold); an error,
shed or drained frame resets its session, and frames still parked when
the inner stream ends resolve as ``SessionShedError``.

Telemetry: ``sched_admit``, ``sched_flush``, ``sched_shed``,
``session_warm_start`` and ``session_shed`` events; ``sched_queue_depth``
gauges and the ``sched_wait_seconds`` histogram. The admission and router
threads run host code only (numpy decode, bucketing, the warm fill), so
no CUDA call of theirs can overlap a graph capture on the dispatch
thread.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union,
)

import numpy as np

from raft_stereo_tpu_torch.ops.pad import bucket_shape
from raft_stereo_tpu_torch.runtime import blackbox, faultinject, quality, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    FlushRequest,
    InferenceEngine,
    InferRequest,
    InferResult,
)

logger = logging.getLogger(__name__)

_INF = float("inf")

# EWMA step for the per-bucket batch-service-time estimate that backs
# deadline shedding: heavy enough to track a load shift within a few
# batches, light enough that one outlier batch cannot flap the estimate.
_SERVICE_ALPHA = 0.3


class ShedError(RuntimeError):
    """Typed admission-layer rejection: the request was resolved by the
    overload/lifecycle layer (never dispatched), with ``reason`` one of
    ``queue_full`` (hard ``max_pending`` depth exceeded), ``deadline``
    (provably unmeetable under the bucket's EWMA service time),
    ``drained`` (still queued when a graceful drain hit its bound) or
    ``spatial`` (the megapixel band, under a spatial bar the overload
    controller raised above its base)."""

    def __init__(self, message: str, reason: str = "shed"):
        super().__init__(message)
        self.reason = reason


class DrainedError(ShedError):
    """The request was admitted but could not complete inside the drain
    bound — the typed ``reason="drained"`` resolution the drain contract
    guarantees instead of a silent drop."""

    def __init__(self, message: str):
        super().__init__(message, reason="drained")


@dataclass
class SchedRequest:
    """An ``InferRequest`` plus its scheduling context.

    ``deadline_s`` is a *relative* latency budget from admission (EDF
    ordering key; it is an ordering preference, not an enforcement — the
    engine's ``--infer_timeout`` watchdog owns hard deadlines). Higher
    ``priority`` dispatches first among equal deadlines. Plain
    ``InferRequest``s may be mixed into the same stream (priority 0, no
    deadline).

    ``tier`` pins the request to a named model tier when the stream is
    served by the latency-tiered dispatcher (``runtime.tiers.TieredServer``);
    left None, the ``TierPolicy`` derives the tier from the same deadline
    and priority fields that order dispatch within a tier. ``iters`` pins
    the request to a refinement-iteration count when the stream is served
    through iteration tiers (``--adaptive_iters --iter_tiers``): the
    ``IterTierPolicy`` snaps it up to the nearest allowed tier. ``session``
    tags the request as one frame of a video stream: the ``SessionServer``
    serializes frames per session and warm-starts each frame's disparity
    from its predecessor's. Servers that do not implement a field ignore
    it."""

    request: InferRequest
    priority: int = 0
    deadline_s: Optional[float] = None
    tier: Optional[str] = None
    iters: Optional[int] = None
    session: Optional[str] = None


@dataclass
class _Admitted:
    """One decoded request waiting in a bucket's pending queue."""

    request: InferRequest
    bucket: Optional[Tuple[int, int]]  # None: decode failed at admission
    priority: int
    deadline: float   # absolute monotonic (inf when none)
    t_admit: float    # monotonic admission time (wait / starvation clock)
    seq: int = 0      # admission order (stable FIFO tie-break)
    # the original decode error of a failed admission: normally typed by
    # the engine via the raising-decode forward, but a drain that expires
    # before the failed lane dispatches must still resolve the request
    # with ITS error, not a generic drained one
    error: Optional[BaseException] = None
    # quality observatory: a golden canary rides the real queues
    # but is invisible to the user capacity gate and the starvation
    # clocks — it can fill a padded batch slot, never displace a user
    canary: bool = False

    def urgency(self) -> Tuple[float, int, int]:
        return (self.deadline, -self.priority, self.seq)


@dataclass
class SchedStats:
    """Dispatch accounting for one scheduler (mutated under the lock)."""

    admitted: int = 0
    failed_admits: int = 0  # decode failed at admission (typed downstream)
    batches: int = 0        # dispatched groups (full + partial)
    full_batches: int = 0
    flushes: int = 0        # partial dispatches
    flush_reasons: Dict[str, int] = field(default_factory=dict)
    # requests resolved by the admission layer as typed errors instead of
    # being dispatched
    shed: int = 0
    shed_reasons: Dict[str, int] = field(default_factory=dict)
    # requests handed to the spatial tier's sink
    spatial_routed: int = 0


class ContinuousBatchingScheduler:
    """Admission + dispatch-ordering layer over one ``InferenceEngine``.

    ``serve(requests)`` yields ``InferResult``s exactly like
    ``engine.stream`` (micro-batch completion order, typed error results
    for isolated failures). One active ``serve`` at a time per instance;
    the instance is reusable across serves, and all engine state (graphs,
    circuit and cap memory, stats) persists as it does across
    ``engine.stream`` calls.
    """

    def __init__(self, engine: InferenceEngine, *,
                 max_wait_s: float = 2.0,
                 admit_depth: Optional[int] = None,
                 max_pending: Optional[int] = None):
        if max_wait_s <= 0:
            raise ValueError("scheduler max_wait_s must be > 0")
        if admit_depth is None:
            # default lookahead: a few micro-batches of decode-ahead,
            # never below one full batch whatever --infer_batch is
            admit_depth = max(64, 2 * engine.batch)
        if admit_depth < engine.batch:
            raise ValueError(
                f"scheduler admit_depth ({admit_depth}) must hold at least "
                f"one full micro-batch ({engine.batch})"
            )
        if max_pending is not None and max_pending < 1:
            raise ValueError("scheduler max_pending must be >= 1 or None")
        self.engine = engine
        self.max_wait_s = float(max_wait_s)
        self.admit_depth = int(admit_depth)
        # overload protection: a hard queue-depth cap that REPLACES the
        # blocking admit_depth backpressure with typed rejection; None
        # keeps the blocking behavior
        self.max_pending = None if max_pending is None else int(max_pending)
        self.stats = SchedStats()
        # admission thread <-> dispatch loop shared state, all mutated
        # under _cond. The lock is
        # an RLock: request_drain() is called from the SIGTERM handler,
        # which Python runs on the main thread — the same thread that may
        # already hold the lock inside serve(); a plain Lock would
        # self-deadlock the shutdown path it exists to serve.
        self._cond = threading.Condition(threading.RLock())
        self._pending: Dict[Tuple[int, int], List[_Admitted]] = {}
        self._failed: List[_Admitted] = []
        self._depth = 0
        # queued canaries (subset of _depth): the user queue_full gate
        # compares USER depth (_depth - _canary_depth) so a queued canary
        # can never consume a user admission slot
        self._canary_depth = 0
        self._seq = 0
        self._closed = True    # admission finished (source exhausted/died)
        self._serving = False  # a serve() generator is active
        self._stopped = False
        self._gen = 0          # serve generation: orphans stale admission
        self._source_error: Optional[BaseException] = None
        # serving lifecycle: drain state + the shed lane (typed
        # rejections the consumer yields interleaved with engine results)
        # + the per-bucket EWMA service clock behind deadline shedding
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._shed: List[InferResult] = []
        self._service_ewma: Dict[Tuple[int, int], float] = {}
        self._inflight: Dict[str, Tuple[Tuple[int, int], float]] = {}
        # dispatch timestamp of the batch last folded into each bucket's
        # EWMA: a batch of B results must step the EWMA ONCE, not B times
        # (B same-dt folds would compound alpha to 1-(1-a)^B and let one
        # outlier batch own the estimate)
        self._ewma_folded: Dict[Tuple[int, int], float] = {}
        # pixel-aware routing, off until configure_spatial(): the live bar
        # (padded H·W above it routes to the sink) and the base the
        # overload controller's bounded setter raises it from
        self.spatial_threshold: Optional[int] = None
        self._spatial_base: Optional[int] = None
        self._spatial_sink: Optional[Callable[[Any], None]] = None
        self._spatial_tier = "spatial"
        # crash forensics: self-register the introspection hook
        # with the installed blackbox dumper (free no-op when none)
        blackbox.register_provider(
            f"scheduler:{engine.tier_label}", self.snapshot)

    def snapshot(self) -> Dict[str, Any]:
        """Introspection view for blackbox dumps / ``/debug/queues``:
        per-bucket pending depths + head-of-line waits, the EWMA service
        clocks behind deadline shedding, drain/shed state, and the
        dispatch ledger. One ``_cond`` acquisition, no blocking work
        under it — safe to call from the dump worker while
        every serving thread is live."""
        with self._cond:
            now = time.monotonic()
            buckets: Dict[str, Any] = {}
            for b, q in self._pending.items():
                label = f"{b[0]}x{b[1]}"
                buckets[label] = {
                    "pending": len(q),
                    "oldest_wait_s": (
                        round(now - min(r.t_admit for r in q), 3)
                        if q else 0.0),
                    "service_ewma_ms": (
                        None if b not in self._service_ewma
                        else round(self._service_ewma[b] * 1e3, 1)),
                }
            for b, ewma in self._service_ewma.items():
                label = f"{b[0]}x{b[1]}"
                buckets.setdefault(label, {"pending": 0})[
                    "service_ewma_ms"] = round(ewma * 1e3, 1)
            drain_remaining = None
            if self._draining and self._drain_deadline is not None:
                drain_remaining = round(
                    max(self._drain_deadline - now, 0.0), 3)
            return {
                "tier": self.engine.tier_label,
                "depth": self._depth,
                "canary_depth": self._canary_depth,
                "buckets": buckets,
                "failed_lane": len(self._failed),
                "shed_lane": len(self._shed),
                "inflight_batches": len(self._inflight),
                "serving": self._serving,
                "closed": self._closed,
                "draining": self._draining,
                "drain_remaining_s": drain_remaining,
                "max_pending": self.max_pending,
                "max_wait_s": self.max_wait_s,
                "spatial_threshold": self.spatial_threshold,
                "spatial_base": self._spatial_base,
                "stats": {
                    "admitted": self.stats.admitted,
                    "failed_admits": self.stats.failed_admits,
                    "batches": self.stats.batches,
                    "full_batches": self.stats.full_batches,
                    "flushes": self.stats.flushes,
                    "flush_reasons": dict(self.stats.flush_reasons),
                    "shed": self.stats.shed,
                    "shed_reasons": dict(self.stats.shed_reasons),
                    "spatial_routed": self.stats.spatial_routed,
                },
            }

    # ---------------------------------------------------------- actuator

    def set_max_pending(self, max_pending: Optional[int]) -> None:
        """The overload controller's actuator: resize the admission cap.
        ``None`` restores the blocking backpressure; an int must be >= 1.
        Each admission decision reads the knob once, so a swap mid-serve
        cannot tear a decision; blocked admissions wake to re-evaluate."""
        if max_pending is not None:
            max_pending = int(max_pending)
            if max_pending < 1:
                raise ValueError("scheduler max_pending must be >= 1 or None")
        with self._cond:
            self.max_pending = max_pending
            self._cond.notify_all()

    def configure_spatial(self, threshold: int, sink, *,
                          tier_name: str = "spatial") -> None:
        """Wire pixel-aware routing: an admitted request whose padded
        bucket H·W exceeds ``threshold`` is handed, decoded, to ``sink``
        (the spatial tier's feed, called with a ``SchedRequest``) instead of
        boarding this scheduler's queues. ``threshold`` becomes the base
        bar, which ``set_spatial_threshold`` may raise. Never called,
        routing stays off."""
        threshold = int(threshold)
        if threshold < 1:
            raise ValueError("spatial threshold must be >= 1 pixel")
        if not callable(sink):
            raise TypeError("spatial sink must be callable")
        with self._cond:
            self._spatial_base = threshold
            self.spatial_threshold = threshold
            self._spatial_sink = sink
            self._spatial_tier = str(tier_name)
            self._cond.notify_all()

    def set_spatial_threshold(self, threshold: int) -> None:
        """The overload controller's bounded actuator: raise the live
        spatial bar, so the band (base, threshold] is shed with the typed
        reason ``spatial`` (the most expensive work goes first). It never
        goes below the base (restoring is setting it back to the base).
        Each admission decision reads the knob once."""
        if self._spatial_base is None:
            raise RuntimeError("set_spatial_threshold: configure_spatial() was never "
                               "called on this scheduler")
        threshold = int(threshold)
        if threshold < self._spatial_base:
            raise ValueError(f"spatial threshold {threshold} below the configured base "
                             f"{self._spatial_base} (the actuator only raises the bar)")
        with self._cond:
            self.spatial_threshold = threshold
            self._cond.notify_all()

    # ---------------------------------------------------------- admission

    def _admit_run(
        self, requests: Iterable[Union[InferRequest, SchedRequest]],
        gen: int,
    ) -> None:
        try:
            for item in requests:
                if self._admit_one(item, gen) is False:
                    return  # consumer abandoned the stream
        except BaseException as e:  # noqa: BLE001 — stream-level failure
            with self._cond:
                if gen == self._gen:
                    self._source_error = e
                self._cond.notify_all()
        finally:
            with self._cond:
                if gen == self._gen:
                    self._closed = True
                self._cond.notify_all()

    # ``gen`` defaults to the live generation ONLY for direct unit-test
    # admission; serve() always threads its own generation through
    def _admit_one(self, item, gen: Optional[int] = None) -> Optional[bool]:
        if isinstance(item, SchedRequest):
            req, priority, rel_deadline = (
                item.request, item.priority, item.deadline_s)
        else:
            req, priority, rel_deadline = item, 0, None
        # assign the trace id HERE so sched_admit and every engine
        # event/span downstream share it (the engine reuses a present id)
        tid = getattr(req, "trace_id", None) or telemetry.new_trace_id()
        # ONE knob read per admission decision: every gate below sees the
        # same value
        max_pending = self.max_pending
        is_canary = quality.is_canary(req.payload)
        # hard overload rejection runs BEFORE the decode and never blocks:
        # under saturation the caller gets a typed O(1) rejection, not a
        # decode it paid for or an unbounded backpressure wait. The gate
        # compares USER depth on both sides: queued canaries never consume
        # a user's admission slot, and a canary arriving at a saturated
        # user queue is itself shed (a canary adds no load under overload)
        if max_pending is not None:
            with self._cond:
                if gen is None:
                    gen = self._gen
                if self._stopped or gen != self._gen:
                    return self._abandoned(req, tid, gen)
                over = (self._depth - self._canary_depth) >= max_pending
                depth = self._depth
            if over:
                return self._shed_one(
                    req, tid, "queue_full", depth=depth,
                    deadline_ms=rel_deadline,
                    detail=f"queue depth {depth} >= max_pending "
                           f"{max_pending}",
                    gen=gen,
                )
        t_admit = time.monotonic()
        deadline = _INF if rel_deadline is None else t_admit + rel_deadline
        bucket: Optional[Tuple[int, int]] = None
        decode_error: Optional[BaseException] = None
        try:
            with telemetry.span("sched_decode", trace_id=tid):
                # InferRequest.resolve: the engine's own decode +
                # validation contract, run here on the admission thread
                arrays = req.resolve()
            # the engine stager's own bucketing (with a spatial engine's
            # H divisor): the queues agree with it
            bucket = bucket_shape(*arrays[0].shape[:2],
                                  divis_by=self.engine.divis_by,
                                  divis_h=self.engine.divis_h)
            admitted = InferRequest(
                payload=req.payload, inputs=arrays, trace_id=tid)
        except Exception as e:  # noqa: BLE001 — isolated to this request
            # forward a deterministically-raising decode: the engine's
            # isolation turns it into the typed error result + the
            # request_failed event, exactly as a stager-side decode failure
            def raise_it(e=e):
                raise e

            decode_error = e
            admitted = InferRequest(
                payload=req.payload, inputs=raise_it, trace_id=tid)
        # pixel-aware routing: one knob read per decision. A decoded bucket
        # above the live bar goes to the spatial sink; one between the base
        # and a raised live bar is shed. Off (no sink), nothing here runs.
        sink = self._spatial_sink
        spatial_threshold = self.spatial_threshold
        if sink is not None and spatial_threshold is not None and bucket is not None:
            pixels = bucket[0] * bucket[1]
            if pixels > spatial_threshold:
                with self._cond:
                    if gen is None:
                        gen = self._gen
                    stale = self._stopped or gen != self._gen
                    if not stale:
                        self.stats.spatial_routed += 1
                if stale:
                    return self._abandoned(req, tid, gen)
                telemetry.emit("sched_spatial_route", bucket=list(bucket), pixels=pixels,
                               threshold=spatial_threshold, tier=self._spatial_tier,
                               trace_id=tid)
                telemetry.inc_metric("sched_spatial_routed_total")
                sink(SchedRequest(request=admitted, priority=int(priority),
                                  deadline_s=rel_deadline))
                return None
            if pixels > self._spatial_base:
                return self._shed_one(
                    req, tid, "spatial", bucket=bucket, deadline_ms=rel_deadline,
                    detail=f"megapixel band shed: {pixels} px in ({self._spatial_base}, "
                           f"{spatial_threshold}] under the raised spatial bar",
                    gen=gen)
        rec = _Admitted(admitted, bucket, int(priority), deadline, t_admit,
                        error=decode_error, canary=is_canary)
        shed_est: Optional[float] = None
        with self._cond:
            if gen is None:
                gen = self._gen
            while max_pending is None \
                    and self._depth >= self.admit_depth \
                    and not self._stopped and gen == self._gen:
                self._cond.wait(0.1)
            if self._stopped or gen != self._gen:
                # this serve ended (or a NEWER one started while we were
                # wedged in a slow decode): a stale admission thread must
                # never pollute a later serve's queues
                return self._abandoned(req, tid, gen)
            if (self._draining and self._drain_deadline is not None
                    and time.monotonic() >= self._drain_deadline):
                # the drain bound has already expired: queueing now would
                # be a guaranteed casualty — resolve it as drained here
                shed_drained, depth = True, self._depth
            else:
                shed_drained = False
                if (max_pending is not None and bucket is not None
                        and rel_deadline is not None):
                    # deadline shedding: with the bucket's EWMA batch
                    # service time, the batches queued ahead (plus the one
                    # this request boards) already cost more wall time
                    # than the whole latency budget — a provable miss is
                    # rejected at admission, not carried to it
                    ewma = self._service_ewma.get(bucket)
                    if ewma is not None:
                        # queued canaries board BEHIND every user request
                        # (priority floor), so they add no service time
                        # ahead of this one — counting them could shed a
                        # user request a canary never actually delays
                        ahead = (sum(1 for r in
                                     self._pending.get(bucket, ())
                                     if not r.canary)
                                 // self.engine.batch) + 1
                        est = ewma * ahead
                        if est > rel_deadline:
                            shed_est, depth = est, self._depth
            if shed_drained or shed_est is not None:
                pass  # resolved below, outside the lock
            else:
                rec.seq = self._seq
                self._seq += 1
                self._depth += 1
                if rec.canary:
                    self._canary_depth += 1
                self.stats.admitted += 1
                if bucket is None:
                    self.stats.failed_admits += 1
                    self._failed.append(rec)
                    bucket_depth = None
                else:
                    self._pending.setdefault(bucket, []).append(rec)
                    bucket_depth = len(self._pending[bucket])
                depth = self._depth
            self._cond.notify_all()
        if shed_drained:
            return self._shed_one(
                req, tid, "drained", bucket=bucket, depth=depth,
                deadline_ms=rel_deadline,
                detail="admitted after the drain timeout expired",
                error=decode_error, gen=gen,
            )
        if shed_est is not None:
            return self._shed_one(
                req, tid, "deadline", bucket=bucket, depth=depth,
                deadline_ms=rel_deadline, est_s=shed_est,
                detail=f"estimated completion {shed_est * 1e3:.0f} ms > "
                       f"deadline {rel_deadline * 1e3:.0f} ms",
                gen=gen,
            )
        telemetry.emit(
            "sched_admit",
            bucket=list(bucket) if bucket else None,
            depth=depth,
            priority=priority,
            deadline_ms=(None if rel_deadline is None
                         else round(rel_deadline * 1e3, 1)),
            trace_id=tid,
        )
        telemetry.set_gauge("sched_queue_depth", depth)
        if bucket is not None:
            telemetry.set_gauge(
                "sched_queue_depth", bucket_depth,
                bucket=f"{bucket[0]}x{bucket[1]}",
            )
        return None

    # ------------------------------------------------- shedding + draining

    def _abandoned(self, req, tid: str, gen: Optional[int]) -> bool:
        """The serve ended under this admission's feet (returns False, the
        admission loop's stop value). A pulled request abandoned while a
        DRAIN was in progress can no longer be delivered a result — the
        consumer is gone — but the drop must be observable, never silent:
        it gets the ``sched_shed`` drained event. A plain consumer abandon
        (``it.close()``) or a genuinely stale generation stays quiet, as
        it always has."""
        with self._cond:
            drained_drop = (self._draining and gen is not None
                            and gen == self._gen)
        if drained_drop:
            logger.warning(
                "request %r was still in admission when the drained serve "
                "ended — recording the drop (no consumer left to deliver "
                "a typed result to)", req.payload,
            )
            telemetry.emit(
                "sched_shed", reason="drained", bucket=None, depth=None,
                deadline_ms=None, est_ms=None, trace_id=tid,
            )
            telemetry.inc_metric("sched_shed_total", reason="drained")
            # a drained drop is a resolved-by-the-lifecycle request: the
            # SLO counts it as a miss like every other shed — unless it
            # is a canary, which never counts against user traffic
            if not quality.is_canary(req.payload):
                telemetry.observe_slo(self.engine.tier_label, None,
                                      ok=False)
        return False

    def _shed_one(self, req, tid: str, reason: str, *,
                  bucket: Optional[Tuple[int, int]] = None,
                  depth: Optional[int] = None,
                  deadline_ms: Optional[float] = None,
                  est_s: Optional[float] = None,
                  detail: str = "",
                  error: Optional[BaseException] = None,
                  gen: Optional[int] = None) -> None:
        """Resolve one request as a typed admission-layer rejection: the
        result enters the shed lane (``serve`` yields it interleaved with
        engine results), the ``sched_shed`` event + counter record it.
        ``gen`` (admission-thread callers): a shed from a stale serve is
        dropped, exactly like a stale admission — it must never surface
        as a later serve's result."""
        if error is None:
            cls = DrainedError if reason == "drained" else ShedError
            msg = (f"request {req.payload!r} shed at admission "
                   f"({reason}{': ' + detail if detail else ''})")
            error = cls(msg) if cls is DrainedError else cls(msg, reason)
        res = InferResult(payload=req.payload, bucket=bucket, error=error,
                          trace_id=tid)
        with self._cond:
            stale = gen is not None and (self._stopped or gen != self._gen)
            if not stale:
                self._shed.append(res)
                self.stats.shed += 1
                self.stats.shed_reasons[reason] = (
                    self.stats.shed_reasons.get(reason, 0) + 1)
                self._cond.notify_all()
        if stale:
            # the serve ended under us: same observability contract as an
            # abandoned admission — a drained drop is recorded (telemetry
            # IO outside the lock), a plain consumer abandon stays quiet
            self._abandoned(req, tid, gen)
            return None
        telemetry.emit(
            "sched_shed", reason=reason,
            bucket=list(bucket) if bucket else None, depth=depth,
            deadline_ms=(None if deadline_ms is None
                         else round(deadline_ms * 1e3, 1)),
            est_ms=None if est_s is None else round(est_s * 1e3, 1),
            trace_id=tid,
        )
        telemetry.inc_metric("sched_shed_total", reason=reason)
        # a shed request never reached the engine's e2e clock, but it IS
        # a resolved request the SLO must count — as a miss. A canary is
        # the exception: its resolution never touches user SLO accounting
        if not quality.is_canary(req.payload):
            telemetry.observe_slo(self.engine.tier_label, None, ok=False)
        return None

    def request_drain(self, timeout_s: float) -> None:
        """Begin a bounded graceful drain (idempotent, signal-handler
        safe — the condition's RLock tolerates the handler interrupting a
        lock-holding section on the same thread). From this point: pending
        buckets dispatch as partial flushes (reason ``drain``), in-flight
        batches complete, and anything still queued when ``timeout_s``
        expires resolves as a typed ``DrainedError`` result. The drain
        latches for the instance's remaining lifetime."""
        with self._cond:
            if self._draining:
                return
            self._draining = True
            self._drain_deadline = time.monotonic() + max(float(timeout_s),
                                                          0.0)
            self._cond.notify_all()
        logger.warning(
            "scheduler drain requested: flushing pending work, bound %.1fs",
            max(float(timeout_s), 0.0),
        )

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def _drain_expired_locked(self, now: float) -> bool:
        return (self._draining and self._drain_deadline is not None
                and now >= self._drain_deadline)

    # the _locked suffix is the contract (same as _take_locked): the
    # caller's `with self._cond` block already holds the lock across this
    # call boundary, which lexical analysis cannot see
    def _take_expired_locked(self, now: float) -> List[_Admitted]:
        """Pop every queued record once the drain bound has expired (their
        typed resolution happens outside the lock). Caller holds the lock."""
        if not self._drain_expired_locked(now):
            return []
        recs: List[_Admitted] = []
        for q in self._pending.values():
            recs.extend(q)
        self._pending.clear()
        recs.extend(self._failed)
        self._failed = []
        if recs:
            self._depth -= len(recs)
            self._canary_depth -= sum(1 for r in recs if r.canary)
            self._cond.notify_all()
        return recs

    def _resolve_drained(self, recs: List[_Admitted]) -> None:
        """Typed ``drained`` resolution for records the drain bound cut
        off — a failed admission keeps its original decode error."""
        for rec in recs:
            err = rec.error or DrainedError(
                f"request {rec.request.payload!r} was still queued when "
                f"the drain timeout expired"
            )
            self._shed_one(
                rec.request, rec.request.trace_id, "drained",
                bucket=rec.bucket, error=err,
            )

    def _take_shed(self) -> List[InferResult]:
        with self._cond:
            if not self._shed:
                return []
            out, self._shed = self._shed, []
        return out

    def _observe_result(self, res: InferResult) -> None:
        """Fold one completed result into the bucket's EWMA batch-service
        clock (dispatch -> result wall time): the estimate that makes
        deadline shedding 'provable' instead of guessed. The EWMA steps
        once per BATCH (the batch's first consumed result — dt is the
        same for every member), so ``_SERVICE_ALPHA`` means what it says
        whatever the micro-batch size."""
        if res.trace_id is None:
            return
        now = time.monotonic()
        with self._cond:
            ent = self._inflight.pop(res.trace_id, None)
            if ent is None or not res.ok:
                return
            bucket, t_dispatch = ent
            if self._ewma_folded.get(bucket) == t_dispatch:
                return  # a sibling from the same batch already folded it
            self._ewma_folded[bucket] = t_dispatch
            dt = max(now - t_dispatch, 0.0)
            prev = self._service_ewma.get(bucket)
            self._service_ewma[bucket] = (
                dt if prev is None else prev + _SERVICE_ALPHA * (dt - prev))

    # ----------------------------------------------------------- dispatch

    def _pick_locked(self, now: float) -> Optional[Tuple[int, int]]:
        """The bucket to dispatch next, or None (wait for admissions).

        A bucket whose head has starved past ``max_wait_s`` goes first —
        ahead of full buckets, so a saturated popular shape can never
        starve a rare one indefinitely (it costs the popular bucket at
        most one dispatch slot per ``max_wait_s`` window). Then whichever
        bucket can form a full micro-batch (earliest deadline / highest
        priority / oldest request as the tie-break); at end of stream,
        any pending bucket (drain). Caller holds the lock."""

        def key(b):
            return min(r.urgency() for r in self._pending[b])

        # canaries are invisible to the starvation clock: a parked canary
        # must never trigger a partial flush (wasted batch slots ARE user
        # delay under load) — it dispatches with user traffic or at drain
        expired = [
            b for b, q in self._pending.items()
            if any(now - r.t_admit >= self.max_wait_s
                   for r in q if not r.canary)
        ]
        if expired:
            return min(expired, key=key)
        # a canary-only bucket never dispatches mid-serve (it would spend
        # a device slot user traffic could be waiting for elsewhere): a
        # dispatch needs at least one user request aboard; parked canaries
        # resolve at drain/close through the nonempty branch below
        full = [b for b, q in self._pending.items()
                if len(q) >= self.engine.batch
                and any(not r.canary for r in q)]
        if full:
            return min(full, key=key)
        if self._closed or self._source_error is not None or self._draining:
            nonempty = [b for b, q in self._pending.items() if q]
            return min(nonempty, key=key) if nonempty else None
        return None

    # the _locked suffix is the contract: the caller (_next_group's `with
    # self._cond` block) already holds the lock — lexical analysis can't
    # see a lock held across a call boundary
    def _take_locked(self, bucket: Tuple[int, int], now: float):
        """Pop the bucket's <= ``batch`` most urgent requests (stable:
        exact FIFO when no deadlines/priorities). Requests whose wait has
        exceeded ``max_wait_s`` board FIRST regardless of urgency — the
        latency bound must hold for a no-deadline request even when a
        sustained stream of finite-deadline arrivals would otherwise sort
        it behind every batch forever. Caller holds the lock."""

        def board_key(r: _Admitted):
            # the anti-starvation boost never applies to a canary: the
            # priority floor is absolute — a canary boards only into
            # slots no user request is contending for
            starved = (not r.canary
                       and now - r.t_admit >= self.max_wait_s)
            return (not starved,) + r.urgency()

        q = sorted(self._pending[bucket], key=board_key)
        taken, rest = q[:self.engine.batch], q[self.engine.batch:]
        if rest:
            self._pending[bucket] = rest
        else:
            self._pending.pop(bucket)
        self._depth -= len(taken)
        self._canary_depth -= sum(1 for r in taken if r.canary)
        self.stats.batches += 1
        if len(taken) == self.engine.batch:
            self.stats.full_batches += 1
        else:
            self.stats.flushes += 1
        self._cond.notify_all()  # backpressured admission may resume
        return taken, len(rest)

    def _next_wait_locked(self, now: float) -> Optional[float]:
        """Seconds until the oldest pending head starves — or the drain
        bound expires, whichever is sooner (None: no bound, wake on
        admission/close). Caller holds the lock."""
        bound: Optional[float] = None
        # canaries are exempt from the starvation clock (see _pick_locked)
        # — a canary-only head must not arm a wake bound that the picker
        # will never act on (the dispatch loop would spin on a 0s wait)
        heads = [min(r.t_admit for r in user)
                 for q in self._pending.values()
                 if (user := [r for r in q if not r.canary])]
        if heads:
            bound = max(self.max_wait_s - (now - min(heads)), 0.0)
        if self._draining and self._drain_deadline is not None:
            remaining = max(self._drain_deadline - now, 0.0)
            bound = remaining if bound is None else min(bound, remaining)
        return bound

    def _next_group(self) -> Optional[List[Any]]:
        """Block until the next dispatchable group: the requests to feed
        the engine (plus a ``FlushRequest`` for a partial batch), None at
        end of stream. Raises the source error once admitted work drains.
        Runs on the engine's stager thread (it consumes the feed).

        Telemetry I/O (the flush event's file write, histogram/gauge
        updates) happens OUTSIDE the lock: the dispatch decision must
        never serialize the admission thread on slow telemetry storage.
        The predicate is re-evaluated under the lock on every loop
        iteration, so releasing between poll and wait loses no wakeups."""
        faultinject.sched_stall_point(self.engine.tier_label)
        while True:
            with self._cond:
                if self._stopped:
                    return None
                now = time.monotonic()
                expired = self._take_expired_locked(now)
            if expired:
                # the drain bound cut these off: resolve them as typed
                # drained results (emits happen outside the lock)
                self._resolve_drained(expired)
                continue
            with self._cond:
                if self._stopped:
                    return None
                if self._failed:
                    recs, self._failed = self._failed, []
                    self._depth -= len(recs)
                    self._canary_depth -= sum(
                        1 for r in recs if r.canary)
                    self._cond.notify_all()
                    return [r.request for r in recs]
                now = time.monotonic()
                bucket = self._pick_locked(now)
                if bucket is not None:
                    taken, left = self._take_locked(bucket, now)
                    depth = self._depth
                    draining = bool(self._closed or self._source_error
                                    or self._draining)
                else:
                    if not any(self._pending.values()):
                        if self._source_error is not None:
                            raise self._source_error
                        if self._closed:
                            return None
                        if self._drain_expired_locked(now):
                            # the bound has passed and nothing is queued:
                            # end the feed NOW — a source that ignores the
                            # stop flag must not keep the process alive
                            return None
                    self._cond.wait(self._next_wait_locked(now))
                    continue
            return self._emit_group(bucket, taken, left, depth, draining,
                                    now)

    def _emit_group(self, bucket, taken: List[_Admitted], left: int,
                    depth: int, draining: bool, now: float) -> List[Any]:
        """Group bookkeeping: wait histograms, gauges, flush events.
        Called AFTER the lock is released, on a consistent snapshot —
        only ``stats.flush_reasons`` is written here, and only the
        dispatch loop writes it."""
        label = f"{bucket[0]}x{bucket[1]}"
        if self.max_pending is not None:
            # start each boarded request's service clock (the consumer
            # stops it at result time, feeding the bucket's EWMA) — only
            # the deadline-shed branch ever reads it, so a scheduler with
            # shedding off pays nothing here
            t_dispatch = time.monotonic()
            with self._cond:
                for r in taken:
                    self._inflight[r.request.trace_id] = (bucket, t_dispatch)
        oldest = 0.0
        for r in taken:
            wait = max(now - r.t_admit, 0.0)
            oldest = max(oldest, wait)
            telemetry.observe("sched_wait_seconds", wait, bucket=label)
        telemetry.set_gauge("sched_queue_depth", depth)
        telemetry.set_gauge("sched_queue_depth", left, bucket=label)
        group: List[Any] = [r.request for r in taken]
        if len(taken) < self.engine.batch:
            reason = "drain" if draining else "max_wait"
            self.stats.flush_reasons[reason] = (
                self.stats.flush_reasons.get(reason, 0) + 1)
            telemetry.emit(
                "sched_flush", bucket=list(bucket), valid=len(taken),
                reason=reason, wait_ms=round(oldest * 1e3, 1),
                trace_ids=[r.request.trace_id for r in taken],
            )
            # the in-band control token: the engine stages the partial
            # accumulation NOW (padded + masked) instead of at stream end
            group.append(FlushRequest(bucket=bucket))
        return group

    def _feed(self) -> Iterator[Any]:
        """The reordered request stream the engine consumes."""
        while True:
            group = self._next_group()
            if group is None:
                return
            for item in group:
                yield item
            if not isinstance(group[-1], FlushRequest):
                # a full group one of whose requests fails its decode in the
                # engine leaves the others short of a batch, with no flush
                # to follow: a request whose successor waits on its result
                # (a session frame) would strand. The token stages them now
                # and is a no-op when the group staged whole
                yield FlushRequest()

    # -------------------------------------------------------------- serve

    def serve(
        self, requests: Iterable[Union[InferRequest, SchedRequest]]
    ) -> Iterator[InferResult]:
        """Admit ``requests`` and stream scheduler-ordered results —
        engine results interleaved with any typed shed/drained rejections
        the admission layer resolved (every request the source yielded
        resolves exactly once, one way or the other)."""
        with self._cond:
            if self._serving:
                raise RuntimeError(
                    "ContinuousBatchingScheduler.serve: a serve is already "
                    "active on this instance"
                )
            self._serving = True
            self._closed = False
            self._stopped = False
            self._source_error = None
            # drain state deliberately NOT reset: a drained scheduler
            # stays draining for its remaining lifetime (the process is
            # exiting; a later serve must not un-drain it)
            self._shed = []
            self._inflight.clear()
            self._gen += 1
            gen = self._gen
        thread = threading.Thread(
            target=self._admit_run, args=(requests, gen),
            name="sched-admit", daemon=True,
        )
        thread.start()
        stream = self.engine.stream(self._feed())
        try:
            for res in stream:
                # unlocked emptiness peek: reading a list reference is
                # safe, and a shed that lands a hair late is yielded on
                # the next result or the final sweep
                if self._shed:
                    for shed in self._take_shed():
                        yield shed
                if self.max_pending is not None:
                    self._observe_result(res)
                yield res
            # admission exits promptly once the feed ended (source
            # exhausted, stopped by the drain wrapper, or shedding): the
            # bounded join lets its last shed land, then _stopped closes
            # the lane — a shed CANNOT land after the final sweep (it
            # would be silently lost), it can only become an _abandoned
            # drop (observable under a drain). During a drain the join
            # stretches to cover a realistic decode tail: a request whose
            # decode finishes inside it still gets its typed drained
            # result; one that outlives even that is the contractually
            # unbounded case (the process must exit) and degrades to the
            # observable sched_shed drop, never silence.
            thread.join(timeout=5.0 if self.draining else 1.0)
            with self._cond:
                self._stopped = True
                self._cond.notify_all()
            for shed in self._take_shed():
                yield shed
        finally:
            with self._cond:
                # consumer gone (normal end: everything below is a no-op):
                # release the dispatch loop and any backpressured admission
                self._stopped = True
                self._pending.clear()
                self._failed.clear()
                self._shed = []
                self._inflight.clear()
                self._depth = 0
                self._canary_depth = 0
                self._cond.notify_all()
            stream.close()  # engine joins its stager against the freed feed
            thread.join(timeout=5.0)
            with self._cond:
                self._closed = True
                self._stopped = False
                self._serving = False
                # invalidate THIS serve's generation now, not at the next
                # serve's start: an admission thread that outlived the join
                # (wedged in a >5s decode) must find gen already stale when
                # it finally wakes, or it would admit into the cleared
                # queues between serves
                self._gen += 1


# --------------------------------------------------- video stream sessions


class SessionShedError(RuntimeError):
    """Typed resolution for a session frame the session layer itself had
    to resolve: still parked behind its predecessor when the inner stream
    ended (drain bound, stream death, consumer abandon) — the
    exactly-once analog of the scheduler's ``DrainedError``, one layer
    up. Never a silent drop."""


@dataclass
class StreamSession:
    """Per-session serving state of one video stream (``SessionServer``).

    ``last_disp`` is the previous completed frame's full-resolution
    x-flow field ([H, W] fp32 — channel 0 of the served output), the
    warm-start source for the next frame; None means the next frame COLD
    starts (session start, or a typed reset after an error/drain result
    — stale state is never silently reused). Mutated only under the
    owning server's ``_lock``."""

    session_id: str
    frames: int = 0       # frames admitted to the inner stream
    warm_hits: int = 0    # frames that warm-started from a predecessor
    resets: int = 0       # cold restarts forced by an error/drain result
    last_disp: Optional[np.ndarray] = None
    inflight: bool = False
    parked: "deque" = field(default_factory=deque)


def default_warm_fn(disp: np.ndarray) -> np.ndarray:
    """Previous frame's full-res x-flow [H, W] -> the next frame's
    warm-start slot [H, W, 2]: the reference's ``forward_interpolate``
    (utils/warm_start.py) forward-warps the field and fills holes by
    nearest neighbor, exactly the video trick the reference applies to
    ``flow_init``. Pure host math — runs on the decode thread, behind
    device compute."""
    from raft_stereo_tpu_torch.utils.warm_start import forward_interpolate

    flow = np.stack(
        [np.asarray(disp, np.float32), np.zeros_like(disp, np.float32)],
        axis=-1,
    )
    return forward_interpolate(flow)


class SessionServer:
    """Session-sticky video serving over any request-stream callable.

    The adaptive-compute video layer: requests tagged with ``SchedRequest.session`` are frames
    of a stereo video stream. The server

      * **serializes frames per session** — frame t is admitted to the
        inner stream only after frame t-1 resolved (whatever reordering
        the scheduler applies to OTHER traffic, a session's own
        frames stay ordered), parking any frame that arrives early;
      * **warm-starts each admitted frame** — the wrapped lazy decode
        appends a third input slot: the previous frame's full-res
        disparity pushed through ``forward_interpolate`` (zeros when the
        session is cold), which the warm-capable serving forward feeds
        into the model's ``flow_init``. This in-process session map IS
        the sticky-routing primitive: frame t's decode reads exactly the
        state frame t-1's result wrote;
      * **never silently reuses stale state** — an error / shed /
        drained result RESETS the session (``resets`` counted, the next
        frame's ``session_warm_start`` event says ``warm=false
        reason=reset``), and frames still parked when the inner stream
        ends resolve as typed ``SessionShedError`` results
        (``session_shed`` events), exactly once.

    Sessionless requests pass through with a zero warm slot (the warm
    forward is one graph either way). Telemetry:
    ``session_warm_start`` per admitted frame (emitted at decode time,
    where warm-vs-cold is ground truth), ``session_warm_total{status=}``
    counters, ``session_shed`` + counter for layer-resolved frames.
    """

    def __init__(self, stream_fn: Callable, *,
                 warm_start: bool = True,
                 warm_fn: Optional[Callable] = None,
                 forward_sched: bool = False,
                 flush_buckets: Optional[bool] = None):
        self._stream_fn = stream_fn
        self.warm_start = bool(warm_start)
        self._warm_fn = warm_fn or default_warm_fn
        # whether the inner stream understands SchedRequest wrappers (a
        # scheduler serve keeps the priority/deadline context); a plain
        # engine stream gets the bare InferRequest
        self._forward_sched = bool(forward_sched)
        # whether a FlushRequest must chase every session admission: a
        # gated frame must not sit in a PLAIN engine's bucket accumulator
        # waiting for batchmates its own gate forbids. True whenever the
        # terminal engine is a plain stream, False when a scheduler's anti-starvation bound owns flushing.
        # Default: tied to forward_sched (plain single engine).
        self._flush_buckets = (not self._forward_sched
                               if flush_buckets is None
                               else bool(flush_buckets))
        self._lock = threading.Lock()
        self._sessions: Dict[str, StreamSession] = {}
        # tid -> (session_id | None, payload) for EVERY admitted request:
        # popped at resolution; whatever remains when the inner stream
        # ends gets a typed sweep resolution (exactly-once even against
        # an inner stream death)
        self._tid_session: Dict[str, Tuple[Optional[str], Any]] = {}
        self._stop = threading.Event()
        self._closed = False     # router exhausted the source
        self._done_sent = False  # the feed's end sentinel went out
        self._serving = False
        self._source_error: Optional[BaseException] = None
        self._dropped: List[Any] = []  # puts the stop flag abandoned
        # lifetime totals (summary survives the per-serve state reset)
        self._totals = {"sessions": 0, "frames": 0, "warm_hits": 0,
                        "resets": 0}
        # crash forensics: self-register the session-map hook
        blackbox.register_provider("sessions", self.snapshot)
        if self.warm_start and warm_fn is None:
            # the default fill's first call would otherwise import scipy
            # on the decode thread (seconds) while the source runs ahead
            from raft_stereo_tpu_torch.utils.warm_start import preload

            preload()

    def snapshot(self) -> Dict[str, Any]:
        """Introspection view for blackbox dumps / ``/debug/queues``:
        the session map's stickiness state — who is in flight, who is
        parked behind whom, and the warm-start hit ledger. One ``_lock``
        acquisition, nothing blocking under it."""
        with self._lock:
            sessions = {
                s.session_id: {
                    "frames": s.frames,
                    "warm_hits": s.warm_hits,
                    "resets": s.resets,
                    "inflight": s.inflight,
                    "parked": len(s.parked),
                    "has_state": s.last_disp is not None,
                }
                for s in self._sessions.values()
            }
            return {
                "warm_start": self.warm_start,
                "serving": self._serving,
                "closed": self._closed,
                "inflight_total": len(self._tid_session),
                "sessions": sessions,
            }

    # ------------------------------------------------------------ wrapping

    def _tier_label(self) -> str:
        """The downstream engine's tier label for quality sensors — the
        warm-rate samples must land in the SAME tier sketch the engine's
        results drive, or the sensor's window never closes. Resolved
        through the bound stream_fn (scheduler -> engine, or the engine
        itself); "serving" (the engine default) when the topology hides
        it."""
        owner = getattr(self._stream_fn, "__self__", None)
        engine = getattr(owner, "engine", owner)
        return str(getattr(engine, "tier_label", "serving"))

    def _warm_slot(self, disp: Optional[np.ndarray],
                   shape: Tuple[int, int], session: Optional[str]):
        """The warm-start input slot for one decode: forward-interpolated
        previous disparity, or zeros (cold / sessionless / shape
        change). Runs on the inner stream's decode thread."""
        if disp is not None and disp.shape != shape:
            logger.warning(
                "session %s: frame shape %s != previous frame %s — "
                "cold-starting (warm state never crosses a shape change)",
                session, shape, disp.shape,
            )
            disp = None
        if disp is None:
            return np.zeros(shape + (2,), np.float32), False
        # host math on host state: ``disp`` is a stored np array and the
        # warm fn is numpy/scipy — nothing here touches a device value
        return np.asarray(self._warm_fn(disp), np.float32), True

    def _wrap(self, inner: InferRequest, tid: str,
              session: Optional[str], frame: int,
              disp: Optional[np.ndarray], reason: str) -> InferRequest:
        """Wrap one request's lazy decode to append the warm slot; the
        engine's own validation contract runs FIRST (a malformed request
        stays a typed error, never a poisoned warm capture). The
        ``session_warm_start`` event is emitted HERE, at decode time,
        where warm-vs-cold (including a shape-change fallback) is ground
        truth. Consumed on the inner stream's stager/admission thread."""
        raw, payload = inner.inputs, inner.payload

        def resolve(raw=raw, payload=payload):
            arrays = InferRequest(payload=payload, inputs=raw).resolve()
            slot, warm = self._warm_slot(
                disp, arrays[0].shape[:2], session)
            if warm:
                # fault plant (RAFT_FI_WARM_POISON): a corrupted warm
                # slot models stale warm-start reuse — the degradation
                # the quality observatory's disparity sentinel must catch
                slot = faultinject.warm_poison_point(slot)
            if session is not None:
                telemetry.emit(
                    "session_warm_start", session=session, frame=frame,
                    warm=warm, reason="warm" if warm else reason,
                    trace_id=tid,
                )
                telemetry.inc_metric(
                    "session_warm_total",
                    status="warm" if warm else "cold",
                )
                # drift sentinel: the warm-start reuse RATE is a quality
                # sensor (a session layer that quietly stops warming — or
                # warms everything off stale state — shifts it)
                quality.observe_warm(self._tier_label(), warm,
                                     payload=payload)
            return arrays + (slot,)

        return InferRequest(payload=payload, inputs=resolve, trace_id=tid)

    def _admit(self, item, q: "queue.Queue") -> None:
        """Stamp, wrap, and hand one item to the inner feed. For session
        frames the warm source is captured NOW — the session has no
        other frame in flight, so ``last_disp`` is final until this
        frame resolves."""
        inner = getattr(item, "request", item)
        tid = getattr(inner, "trace_id", None) or telemetry.new_trace_id()
        inner.trace_id = tid
        session = getattr(item, "session", None)
        disp: Optional[np.ndarray] = None
        frame = 0
        reason = "sessionless"
        with self._lock:
            if session is not None:
                sess = self._sessions.get(session)
                if sess is None:
                    sess = self._sessions[session] = StreamSession(session)
                sess.inflight = True
                frame = sess.frames
                sess.frames += 1
                if self.warm_start and sess.last_disp is not None:
                    disp = sess.last_disp
                    sess.warm_hits += 1
                    reason = "warm"
                else:
                    reason = ("first" if sess.frames == 1
                              else ("reset" if sess.resets else "cold"))
            # EVERY admitted request is tracked until its result comes
            # back: an inner stream that ends without resolving it (a
            # stream death mid-drain) still gets a typed resolution from
            # the post-stream sweep — exactly once, never a silent loss
            self._tid_session[tid] = (session, inner.payload)
        wrapped = self._wrap(inner, tid, session, frame, disp, reason)
        if inner is not item and self._forward_sched:
            item.request = wrapped
            self._q_put(q, item)
        else:
            self._q_put(q, wrapped)
        if session is not None and self._flush_buckets:
            # plain-engine terminals: a gated session frame must not sit
            # in a bucket accumulator waiting for batchmates that cannot
            # arrive until ITS result lands — flush now (the engine pads
            # with the validity mask, same graph). A scheduler-backed
            # inner flushes via its own anti-starvation bound instead.
            self._q_put(q, FlushRequest())

    def _q_put(self, q: "queue.Queue", item) -> None:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue
        # the serve ended under this put: a real request must not be
        # silently lost — stash it for the post-stream typed sweep
        if item is not _SESSIONS_DONE and not isinstance(item, FlushRequest):
            with self._lock:
                self._dropped.append(item)

    def _route(self, requests: Iterable[Any], q: "queue.Queue") -> None:
        """Router thread: pull the source, gate session frames behind
        their predecessors, admit everything else straight through."""
        try:
            for item in requests:
                if self._stop.is_set():
                    # the serve ended while next() was pulling this item:
                    # never a silent drop — stash it for the typed sweep
                    # (or, past the sweep, the finally's observable shed)
                    with self._lock:
                        self._dropped.append(item)
                    return
                session = getattr(item, "session", None)
                if session is not None:
                    with self._lock:
                        sess = self._sessions.get(session)
                        if sess is None:
                            sess = self._sessions[session] = StreamSession(
                                session)
                        busy = sess.inflight
                        if busy:
                            sess.parked.append(item)
                    if busy:
                        continue
                self._admit(item, q)
        except BaseException as e:  # noqa: BLE001 — source failure: end the
            # feed; the inner stream re-raises its own source errors, ours
            # surfaces after in-flight work drains (engine semantics)
            with self._lock:
                self._source_error = e
        finally:
            with self._lock:
                self._closed = True
                done = self._maybe_finish_locked()
            if done:
                self._q_put(q, _SESSIONS_DONE)

    def _maybe_finish_locked(self) -> bool:
        """True exactly once, when the feed should end: source exhausted
        and no SESSION frame is in flight or parked (sessionless traffic
        must not gate the sentinel — with a plain-engine inner, a partial
        sessionless bucket only flushes at end-of-stream, which this
        sentinel IS). Caller holds the lock."""
        if self._done_sent or not self._closed:
            return False
        if any(s is not None for s, _p in self._tid_session.values()):
            return False
        if any(s.parked or s.inflight for s in self._sessions.values()):
            return False
        self._done_sent = True
        return True

    def _on_result(self, res: InferResult, q: "queue.Queue") -> None:
        """Consumer-side bookkeeping of one inner result: record (or
        reset) the session's warm state, release the next parked frame,
        close the feed when everything resolved."""
        ent = None
        if res.trace_id is not None:
            with self._lock:
                ent = self._tid_session.pop(res.trace_id, None)
        sid = ent[0] if ent is not None else None
        if sid is None:
            with self._lock:
                done = self._maybe_finish_locked()
            if done:
                self._q_put(q, _SESSIONS_DONE)
            return
        release = None
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                if res.ok and res.output is not None:
                    # channel 0 is the disparity whatever aux channels the
                    # adaptive forward appended; copy of a HOST result (the
                    # engine already materialized it) — the consumer owns
                    # the result buffer after the yield
                    sess.last_disp = np.array(
                        res.output[..., 0], np.float32, copy=True)
                else:
                    # typed cold restart: stale state is never reused
                    # across a failed/shed/drained frame
                    sess.last_disp = None
                    sess.resets += 1
                if sess.parked:
                    # the session stays BUSY across the pop->_admit
                    # hand-off (inflight is NOT cleared): the router must
                    # never slip a newer frame ahead of the released one,
                    # and the finish check must never see an idle gap and
                    # end the feed under a frame that is about to admit
                    release = sess.parked.popleft()
                else:
                    sess.inflight = False
            done = release is None and self._maybe_finish_locked()
        if release is not None:
            self._admit(release, q)
            return
        if done:
            self._q_put(q, _SESSIONS_DONE)

    def _feed(self, q: "queue.Queue") -> Iterator[Any]:
        """The inner stream's request feed (consumed on its
        stager/admission thread — config ``thread_role_seeds`` hint)."""
        while True:
            item = q.get()
            if item is _SESSIONS_DONE:
                return
            yield item

    def _typed_shed(self, sid: Optional[str], payload, tid: Optional[str],
                    reason: str) -> InferResult:
        telemetry.emit("session_shed", session=sid, reason=reason,
                       trace_id=tid)
        telemetry.inc_metric("session_shed_total")
        where = f"session {sid!r} frame" if sid is not None else "request"
        return InferResult(
            payload=payload,
            error=SessionShedError(
                f"{where} {payload!r} was {reason} when the stream ended"),
            trace_id=tid,
        )

    def _shed_leftovers(self, q: "queue.Queue") -> List[InferResult]:
        """Typed resolution for everything the inner stream never
        resolved once it ended: frames still PARKED behind a
        predecessor, feed items never CONSUMED (including puts the stop
        flag abandoned), and admitted requests whose results never came
        back (an inner stream death). Exactly-once holds against every
        ending the inner stream can have — never a silent drop. Runs
        after the router joined (no concurrent admissions)."""
        out: List[InferResult] = []
        with self._lock:
            items: List[Tuple[str, Any]] = []
            for sess in self._sessions.values():
                while sess.parked:
                    items.append(("parked", sess.parked.popleft()))
            items.extend(("undelivered", it) for it in self._dropped)
            self._dropped = []
        while True:  # feed items the inner stream never consumed
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is _SESSIONS_DONE or isinstance(item, FlushRequest):
                continue
            items.append(("undelivered", item))
        for reason, item in items:
            inner = getattr(item, "request", item)
            tid = getattr(inner, "trace_id", None)
            with self._lock:
                ent = (self._tid_session.pop(tid, None)
                       if tid is not None else None)
            sid = (ent[0] if ent is not None
                   else getattr(item, "session", None))
            out.append(self._typed_shed(sid, inner.payload, tid, reason))
        with self._lock:
            unresolved = list(self._tid_session.items())
            self._tid_session.clear()
        for tid, (sid, payload) in unresolved:
            out.append(self._typed_shed(sid, payload, tid, "unresolved"))
        return out

    # --------------------------------------------------------------- serve

    def serve(self, requests: Iterable[Any]) -> Iterator[InferResult]:
        """Serve ``requests`` (session-tagged and plain, mixed) through
        the inner stream; yield every result exactly once — inner
        results pass through, frames the session layer had to resolve
        itself surface as typed ``SessionShedError`` results."""
        with self._lock:
            if self._serving:
                raise RuntimeError(
                    "SessionServer.serve: a serve is already active on "
                    "this instance"
                )
            self._serving = True
            self._closed = False
            self._done_sent = False
            self._sessions.clear()
            self._tid_session.clear()
            self._dropped = []
            self._source_error = None
        self._stop.clear()
        q: "queue.Queue" = queue.Queue(maxsize=64)
        router = threading.Thread(
            target=self._route, args=(requests, q),
            name="session-router", daemon=True,
        )
        router.start()
        stream = self._stream_fn(self._feed(q))
        try:
            for res in stream:
                self._on_result(res, q)
                yield res
            # the inner stream ended (source exhausted, or a drain cut it
            # short): stop and join the router FIRST (no concurrent
            # admissions), then resolve everything it never resolved —
            # parked, undelivered, unresolved — typed, exactly once; a
            # source failure surfaces with engine semantics afterwards
            self._stop.set()
            router.join(timeout=5.0)
            for res in self._shed_leftovers(q):
                yield res
            with self._lock:
                err = self._source_error
            if err is not None:
                raise err
        finally:
            self._stop.set()
            # join the router BEFORE sweeping: its in-flight item lands in
            # _dropped (the _q_put/loop-head stop paths), not in limbo
            router.join(timeout=5.0)
            # a consumer abandon skips the in-loop sweep: resolve whatever
            # is still parked/undelivered/tracked now — the results are
            # undeliverable (the consumer is gone), but the session_shed
            # events are the observable record, never silence. On a normal
            # end the sweep already ran and this is an empty no-op.
            self._shed_leftovers(q)
            # the inner stream's stager may be BLOCKED in _feed's q.get():
            # only the sentinel wakes it — without this, stream.close()
            # waits out its join timeout and leaks the stager thread
            try:
                q.put_nowait(_SESSIONS_DONE)
            except queue.Full:
                pass  # a full queue means the feed is live and draining
            close = getattr(stream, "close", None)
            if close is not None:
                close()
            with self._lock:
                self._serving = False
                # stickiness state dies with the serve (a later serve must
                # never warm-start from a previous serve's frames) — the
                # ledger folds into lifetime totals first
                self._totals["sessions"] += len(self._sessions)
                self._totals["frames"] += sum(
                    s.frames for s in self._sessions.values())
                self._totals["warm_hits"] += sum(
                    s.warm_hits for s in self._sessions.values())
                self._totals["resets"] += sum(
                    s.resets for s in self._sessions.values())
                self._sessions.clear()
                self._tid_session.clear()

    def summary(self) -> Dict[str, Any]:
        """Lifetime session ledger (completed serves + the live one)."""
        with self._lock:
            return {
                "sessions": self._totals["sessions"] + len(self._sessions),
                "frames": self._totals["frames"] + sum(
                    s.frames for s in self._sessions.values()),
                "warm_hits": self._totals["warm_hits"] + sum(
                    s.warm_hits for s in self._sessions.values()),
                "resets": self._totals["resets"] + sum(
                    s.resets for s in self._sessions.values()),
            }


_SESSIONS_DONE = object()  # SessionServer feed sentinel


def make_scheduler(
    engine: InferenceEngine, infer_options
) -> Optional[ContinuousBatchingScheduler]:
    """The continuous-batching scheduler the options ask for, or None
    (plain ``engine.stream`` routing). Split out of ``make_stream`` so the
    serving CLIs can hand the instance to ``ServeDrain`` — the drain
    signal must reach ``request_drain``, not just the stream callable."""
    if infer_options is not None and getattr(infer_options, "sched", False):
        return ContinuousBatchingScheduler(
            engine, max_wait_s=infer_options.sched_max_wait,
            max_pending=getattr(infer_options, "max_pending", None),
        )
    return None


_UNSET = object()


def make_stream(
    engine: InferenceEngine, infer_options, scheduler=_UNSET
) -> Callable[[Iterable[InferRequest]], Iterator[InferResult]]:
    """``engine.stream``, or a continuous-batching scheduler's ``serve``
    when the options ask for one — the single routing decision every
    serving CLI shares. A CLI that already built its scheduler (to hand
    it to ``ServeDrain``) passes it as ``scheduler`` (None = plain
    engine routing) so the decision still lives in exactly one place."""
    if scheduler is _UNSET:
        scheduler = make_scheduler(engine, infer_options)
    return engine.stream if scheduler is None else scheduler.serve


__all__ = [
    "ContinuousBatchingScheduler",
    "DrainedError",
    "SchedRequest",
    "SchedStats",
    "SessionServer",
    "SessionShedError",
    "ShedError",
    "StreamSession",
    "default_warm_fn",
    "make_scheduler",
    "make_stream",
]

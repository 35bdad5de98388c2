"""Latency-tiered multi-model serving, the confidence-gated cascade and
the spatial tier (PyTorch port of ``raft_stereo_tpu/runtime/tiers.py``).

MADNet2 exists to be fast and RAFT-Stereo to be accurate; this module
serves both from one process over the port's engine and scheduler:

  * **Registry** (``ModelTier`` + ``TierSet``): N named tiers, each a model
    and the factory of its forward. ``TierSet``
    builds one ``InferenceEngine`` per tier, all on ONE device (the JAX
    package's tiers share one mesh), each with its own ``GraphCache``, and
    a scheduler per tier when the options ask for one; a spatial tier's
    engine serves on its own device list instead. ``update_variables(tier, state_dict)`` pushes
    weights into the named tier's engine only (the online-adaptation
    path); ``request_drain`` fans out to every tier's scheduler, so
    ``ServeDrain.attach(tier_set)`` drains the whole set.
  * **Tier selection** (``TierPolicy`` + ``TieredServer``): an explicit
    ``SchedRequest.tier`` wins; then a deadline at or under
    ``deadline_cutoff_s`` (or a priority at or above ``priority_cutoff``)
    routes to the fast tier; everything else to the default.
    ``IterTierPolicy`` routes one model's iteration tiers the same way.
    ``TieredServer.serve`` is a drop-in stream: a router thread classifies
    each request (``tier_dispatch`` events, ``tier_requests_total`` and
    ``tier_e2e_seconds{tier=}``), one consumer thread a tier drives its
    stream, and results interleave on one output queue; every request
    resolves exactly once, typed errors included. A single-tier policy
    gives that tier's engine's outputs.
  * **Spatial tier** (``spatial_tier`` + ``SpatialServer``): RAFT-Stereo
    with each request's rows split over a device list
    (``parallel.mesh.spatial_mesh``; ``models/raft_stereo_spatial.py``).
    The base tier's scheduler routes a request whose padded bucket exceeds
    the threshold to it (``configure_spatial``); two lanes serve the base
    tier over the incoming requests and the spatial tier over the routed
    ones, and every request resolves exactly once.
  * **Cascade** (``CascadeServer``): every pair runs the fast tier first;
    ``photometric_confidence`` (host numpy: the mean photometric error of
    the right image warped by the fast disparity) gates it; a pair below
    the threshold re-enters the quality tier on its decoded arrays. An
    escalated result replaces the fast one; a failed escalation (a drain
    cut it off) falls back to the held fast result. Events
    ``cascade_accept`` / ``cascade_escalate``, counter
    ``cascade_escalated_total``.

Several engines in one process capture and replay under the rule
``runtime/infer.py::GraphCache`` states: captures are serialised by one
process-wide lock and run in CUDA's thread-local capture mode, on the
graph's own stream, so one tier's capture is never invalidated by another
tier's replays and copies on their consumer threads. A held result is a
host copy (the engine copies every output out of the graph's static buffer
before its next replay), so it survives its engine's later replays.

Threads: ``tier-router`` feeds bounded per-tier queues; ``tier-serve``
consumers (cascade: ``cascade-fast`` / ``cascade-quality``) drive the tier
streams into one unbounded output queue the caller drains. Cross-thread
state lives behind ``self._lock``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.runtime import blackbox, quality, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    FlushRequest,
    InferenceEngine,
    InferOptions,
    InferRequest,
    InferResult,
    InferStats,
)

logger = logging.getLogger(__name__)

_DONE = object()  # end-of-feed sentinel on the per-tier queues


# ------------------------------------------------------------- registry


@dataclass
class ModelTier:
    """One named serving tier: a model and the factory of its forward.

    ``make_forward(model) -> forward(*inputs)`` on the engine's stacked,
    padded device tensors (as ``evaluate.make_engine``'s). The served
    weights are the model's own (``update_variables`` copies into them).
    ``capture`` is False for a forward that reads a scalar back (the
    convergence exit), which runs eagerly; ``graph_key`` names what a graph
    bakes in besides its shapes, and ``aot_extra`` the same with values
    stable across processes (the graph store's key; ``TierSet`` adds the
    tier's name to it, so tiers sharing one ``--aot_dir`` are disjoint).

    ``num_spatial`` other than 1, or a ``devices`` list, makes a spatial
    tier: its engine serves on ``spatial_mesh(num_spatial, devices)`` (0:
    every device), and ``make_forward(model, devices)`` gets that list,
    whose first device the batches are staged to."""

    name: str
    model: Any
    make_forward: Callable[..., Callable]
    divis_by: int = 32
    capture: bool = True
    graph_key: Tuple = ()
    aot_extra: Dict[str, Any] = field(default_factory=dict)
    num_spatial: int = 1
    devices: Optional[Sequence[Any]] = None


def raft_stereo_tier(model, iters: int, *, name: str = "quality") -> ModelTier:
    """The RAFT-Stereo quality tier (``evaluate.make_engine``'s forward:
    test mode, /32 padding)."""

    def make_forward(m):
        def fwd(a, b):
            return m(a, b, iters=iters)[1]

        return fwd

    return ModelTier(name=name, model=model, make_forward=make_forward, divis_by=32,
                     capture=model.config.converge_eps == 0,
                     graph_key=(id(model), repr(model.config), int(iters)),
                     aot_extra={"model": repr(model.config), "iters": int(iters)})


def spatial_tier(model, iters: int, *, name: str = "spatial", num_spatial: int = 0,
                 devices: Optional[Sequence[Any]] = None) -> ModelTier:
    """The spatial tier: ``raft_stereo_tier``'s forward with each batch's
    rows split over ``spatial_mesh(num_spatial, devices)``
    (``SpatialRAFTStereo``; 0: every visible card, ``[cpu]`` without one);
    with one shard, the model's own forward. Buckets pad H to
    ``lcm(32, shards)``."""
    from raft_stereo_tpu_torch.models.raft_stereo_spatial import SpatialRAFTStereo

    def make_forward(m, devs=None):
        sharded = SpatialRAFTStereo(m, devs or [_model_device(m)])

        def fwd(a, b):
            return sharded(a, b, iters=iters)[1]

        fwd.active_shards = sharded.active_shards
        return fwd

    return ModelTier(name=name, model=model, make_forward=make_forward, divis_by=32,
                     capture=model.config.converge_eps == 0,
                     graph_key=(id(model), repr(model.config), int(iters)),
                     aot_extra={"model": repr(model.config), "iters": int(iters)},
                     num_spatial=int(num_spatial),
                     devices=None if devices is None else list(devices))


def madnet2_tier(model, *, name: str = "fast") -> ModelTier:
    """The MADNet2 fast tier (``evaluate_mad.make_mad_engine``'s forward:
    the finest prediction upsampled bilinearly x4 and scaled x-20, /128
    padding)."""
    from raft_stereo_tpu_torch.models.madnet2 import DIVIS_BY
    from raft_stereo_tpu_torch.ops.sampling import bilinear_upsample

    def make_forward(m):
        def fwd(a, b):
            with torch.no_grad():
                return bilinear_upsample(m(a, b)[0], 4) * -20.0

        return fwd

    return ModelTier(name=name, model=model, make_forward=make_forward, divis_by=DIVIS_BY,
                     graph_key=(id(model), type(model).__name__, model.mixed_precision),
                     aot_extra={"model": type(model).__name__,
                                "mixed_precision": bool(model.mixed_precision)})


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class TierSet:
    """N named tiers on one device.

    Builds one ``InferenceEngine`` per tier from ``infer`` (the shared
    options: the same micro-batch, deadlines and retries; each tier's
    divisor, capture mode and graph key), labelled with the tier's name
    (its SLO series, quality sketches and ``engine:<tier>`` blackbox
    provider), plus a continuous-batching scheduler per tier when
    ``infer.sched`` asks for one. With ``infer.aot_dir`` every engine
    shares that graph store, its keys carrying the tier's name and
    ``aot_extra``; every engine is built (and prewarmed) here, before any
    server starts. ``device`` is the first tier's model's;
    every tier's model must live there, but a spatial tier's, whose engine
    serves on its own device list. ``stream_fn(name)`` is the
    tier's serving callable (the scheduler's ``serve`` or the engine's
    ``stream``)."""

    def __init__(self, tiers: Iterable[ModelTier], infer: Optional[InferOptions] = None):
        from raft_stereo_tpu_torch.runtime.scheduler import make_scheduler, make_stream

        tiers = list(tiers)
        if not tiers:
            raise ValueError("TierSet needs at least one ModelTier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        infer = infer or InferOptions()
        self.infer = infer
        self.device = _model_device(tiers[0].model)
        self.tiers: Dict[str, ModelTier] = {t.name: t for t in tiers}
        self.engines: Dict[str, InferenceEngine] = {}
        self.schedulers: Dict[str, Any] = {}
        self._stream_fns: Dict[str, Callable] = {}
        for t in tiers:
            devices = None
            if t.num_spatial != 1 or t.devices is not None:
                from raft_stereo_tpu_torch.parallel.mesh import spatial_mesh

                devices = spatial_mesh(t.num_spatial, t.devices)
                forward = t.make_forward(t.model, devices)
            elif _model_device(t.model) != self.device:
                raise ValueError(f"tier {t.name!r} lives on {_model_device(t.model)}, the set "
                                 f"on {self.device}: every tier serves from one device")
            else:
                forward = t.make_forward(t.model)
            engine = InferenceEngine(
                forward, device=self.device if devices is None else devices[0],
                batch=infer.batch, spatial=devices,
                divis_by=t.divis_by, prefetch_depth=infer.prefetch,
                max_executables=infer.max_executables, deadline_s=infer.deadline_s,
                retries=infer.retries, capture=t.capture, graph_key=(t.name, *t.graph_key),
                # a video frame whose successor depends on its result must
                # not be held by the one-deep dispatch pipeline
                eager_finalize=bool(infer.video), tier=t.name,
                module=t.model, aot_dir=infer.aot_dir, aot_key_extra=dict(t.aot_extra))
            self.engines[t.name] = engine
            sched = make_scheduler(engine, infer)
            self.schedulers[t.name] = sched
            self._stream_fns[t.name] = make_stream(engine, infer, scheduler=sched)

    @property
    def names(self) -> List[str]:
        return list(self.tiers)

    def engine(self, name: str) -> InferenceEngine:
        return self.engines[name]

    def stream_fn(self, name: str) -> Callable:
        return self._stream_fns[name]

    def update_variables(self, name: str, state_dict) -> None:
        """Push new weights into the named tier's engine only."""
        self.engines[name].update_variables(state_dict)

    def request_drain(self, timeout_s: float) -> None:
        """Fan a bounded drain out to every tier's scheduler (the
        ``ServeDrain.attach`` duck type). Plain-engine tiers drain by the
        source stopping, as they always have."""
        for sched in self.schedulers.values():
            if sched is not None:
                sched.request_drain(timeout_s)

    def combined_stats(self) -> InferStats:
        """One merged ``InferStats`` over every tier (a tiered run's
        ``publish_summary`` input): scalars sum, per-bucket volumes and
        latency histograms merge exactly."""
        out = InferStats()
        for engine in self.engines.values():
            s = engine.stats
            for name in ("images", "failed", "batches", "padded_slots", "decode_wait_s",
                         "h2d_stage_s", "device_batch_s", "stream_s", "compile_s",
                         "compiles", "prewarmed", "underruns", "retries", "degraded",
                         "watchdog_trips", "circuits_open"):
                setattr(out, name, getattr(out, name) + getattr(s, name))
            out.batch_ms.extend(s.batch_ms)
            out.batch_valid.extend(s.batch_valid)
            for bucket, n in s.buckets.items():
                out.buckets[bucket] = out.buckets.get(bucket, 0) + n
            for key, hist in s.latency.items():
                mine = out.latency.get(key)
                if mine is None:
                    mine = out.latency[key] = telemetry.LogHistogram(
                        growth=hist.growth, min_value=hist.min_value)
                mine.merge(hist)
        return out


# -------------------------------------------------------------- routing


@dataclass(frozen=True)
class TierPolicy:
    """Which tier serves a request, from its scheduling context: an
    explicit ``tier`` on the request wins; then a deadline at or under
    ``deadline_cutoff_s`` routes to ``fast``; then a priority at or above
    ``priority_cutoff`` (when set); else ``default``."""

    fast: str = "fast"
    default: str = "quality"
    deadline_cutoff_s: Optional[float] = 1.0
    priority_cutoff: Optional[int] = None

    @classmethod
    def single(cls, name: str) -> "TierPolicy":
        """Route every request to one tier (the ``--tier`` mode)."""
        return cls(fast=name, default=name, deadline_cutoff_s=None, priority_cutoff=None)

    def select(self, item) -> Tuple[str, str]:
        """``(tier_name, reason)`` for one ``InferRequest`` or
        ``SchedRequest``."""
        explicit = getattr(item, "tier", None)
        if explicit:
            return str(explicit), "explicit"
        deadline = getattr(item, "deadline_s", None)
        if (self.deadline_cutoff_s is not None and deadline is not None
                and deadline <= self.deadline_cutoff_s):
            return self.fast, "deadline"
        priority = getattr(item, "priority", 0) or 0
        if self.priority_cutoff is not None and priority >= self.priority_cutoff:
            return self.fast, "priority"
        return self.default, "default"


def iter_tier_name(iters: int) -> str:
    """The tier name of one refinement-iteration count (``--iter_tiers``):
    ``iters7``, ``iters16``, ..."""
    return f"iters{int(iters)}"


@dataclass(frozen=True)
class IterTierPolicy:
    """Iteration-tier selection (``--adaptive_iters --iter_tiers``): one
    model at N refinement-iteration counts, each its own engine, routed by
    the request's scheduling context; duck-types ``TierPolicy``.

    An explicit ``SchedRequest.iters`` snaps UP to the nearest allowed tier
    (above the largest: the largest); then an explicit ``tier``; then a
    deadline at or under ``deadline_cutoff_s`` rides the smallest tier;
    everything else the largest, or ``default_iters`` (the overload
    controller's knob, a member of ``tiers``) when set."""

    tiers: Tuple[int, ...]
    deadline_cutoff_s: Optional[float] = 1.0
    default_iters: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(sorted({int(t) for t in self.tiers})))
        if not self.tiers or self.tiers[0] < 1:
            raise ValueError(f"IterTierPolicy needs >= 1 positive iteration tier, got "
                             f"{self.tiers}")
        if self.default_iters is not None:
            object.__setattr__(self, "default_iters", int(self.default_iters))
            if self.default_iters not in self.tiers:
                raise ValueError(f"IterTierPolicy default_iters {self.default_iters} is not "
                                 f"one of the declared tiers {self.tiers}")

    @property
    def fast(self) -> str:
        return iter_tier_name(self.tiers[0])

    @property
    def default(self) -> str:
        return iter_tier_name(self.tiers[-1] if self.default_iters is None
                              else self.default_iters)

    def select(self, item) -> Tuple[str, str]:
        pinned = getattr(item, "iters", None)
        if pinned:
            for it in self.tiers:
                if it >= int(pinned):
                    return iter_tier_name(it), "pinned"
            return self.default, "pinned"
        explicit = getattr(item, "tier", None)
        if explicit:
            return str(explicit), "explicit"
        deadline = getattr(item, "deadline_s", None)
        if (self.deadline_cutoff_s is not None and deadline is not None
                and deadline <= self.deadline_cutoff_s):
            return self.fast, "deadline"
        return self.default, "default"


@dataclass
class TierStats:
    """Routing ledger of one tiered serve (mutated under the server's
    ``_lock``)."""

    dispatched: Dict[str, int] = field(default_factory=dict)
    reasons: Dict[str, int] = field(default_factory=dict)
    completed: Dict[str, int] = field(default_factory=dict)
    failed: Dict[str, int] = field(default_factory=dict)


class _StreamEnd:
    """Per-stream end marker on the output queue."""

    def __init__(self, name: str, error: Optional[BaseException] = None):
        self.name = name
        self.error = error


class TierClosedError(RuntimeError):
    """Typed resolution for a request routed to a tier whose stream had
    already ended (drain bound reached, or the stream died) before the
    request could be admitted."""


class TieredServer:
    """Policy-routed serving over a ``TierSet``.

    ``serve(requests)`` takes the mixed ``InferRequest`` / ``SchedRequest``
    stream the scheduler takes and yields ``InferResult``s in per-tier
    completion order. The source raising, or a tier stream dying,
    re-raises to the consumer after the surviving tiers drain. One serve at
    a time per instance."""

    def __init__(self, tiers: TierSet, policy=None):
        self.tiers = tiers
        self.policy = policy or TierPolicy()
        self._check_policy(self.policy)
        self.stats = TierStats()
        self._lock = threading.Lock()
        self._t0s: Dict[str, Tuple[str, float]] = {}  # trace id -> (tier, t0)
        self._stop = threading.Event()
        # tiers whose consumer ended while the router still runs: routing
        # to them resolves as TierClosedError, never a blocked put
        self._dead: set = set()
        blackbox.register_provider("tiered", self.snapshot)

    def _check_policy(self, policy) -> None:
        for name in {policy.fast, policy.default}:
            if name not in self.tiers.tiers:
                raise ValueError(f"TierPolicy names tier {name!r} but the TierSet has "
                                 f"{self.tiers.names}")

    def snapshot(self) -> Dict[str, Any]:
        """The routing ledger and in-flight census (blackbox, debug server)."""
        with self._lock:
            return {
                "policy": {"fast": self.policy.fast, "default": self.policy.default,
                           "deadline_cutoff_s": self.policy.deadline_cutoff_s,
                           "priority_cutoff": getattr(self.policy, "priority_cutoff", None)},
                "inflight": len(self._t0s),
                "dead_tiers": sorted(self._dead),
                "stats": {"dispatched": dict(self.stats.dispatched),
                          "reasons": dict(self.stats.reasons),
                          "completed": dict(self.stats.completed),
                          "failed": dict(self.stats.failed)},
            }

    def set_policy(self, policy) -> None:
        """The overload controller's actuator: swap the routing policy. The
        router reads ``self.policy`` once a request, so no decision sees
        half of two policies."""
        self._check_policy(policy)
        self.policy = policy

    # ------------------------------------------------------------ plumbing

    def _feed(self, q: "queue.Queue") -> Iterator[Any]:
        """One tier's request feed (consumed on its stager or admission
        thread)."""
        while True:
            item = q.get()
            if item is _DONE:
                return
            yield item

    def _closed_result(self, item, name: str) -> InferResult:
        """Typed resolution for a request bound for a tier whose stream
        already ended; it counts as an SLO miss (canaries excepted)."""
        inner = getattr(item, "request", item)
        tid = getattr(inner, "trace_id", None)
        with self._lock:
            self.stats.failed[name] = self.stats.failed.get(name, 0) + 1
            if tid is not None:
                self._t0s.pop(tid, None)
        if not quality.is_canary(inner.payload):
            telemetry.observe_slo(name, None, ok=False)
        return InferResult(payload=inner.payload, trace_id=tid, error=TierClosedError(
            f"tier {name!r} stream ended before this request was admitted"))

    def _route(self, requests: Iterable[Any], tier_qs: Dict[str, "queue.Queue"],
               out_q: "queue.Queue") -> None:
        """Router thread: classify each request, stamp its trace id and
        routing clock, hand it to its tier's queue."""
        error: Optional[BaseException] = None
        try:
            for item in requests:
                if self._stop.is_set():
                    return
                if isinstance(item, FlushRequest):
                    # a session layer flushing a gated frame out of a plain
                    # tier engine's bucket: the router cannot know which tier
                    # the frame went to, so every plain-engine tier gets it
                    for name, tq in tier_qs.items():
                        if self.tiers.schedulers.get(name) is None:
                            tq.put(item)
                    continue
                name, reason = self.policy.select(item)
                if name not in tier_qs:
                    raise ValueError(f"TierPolicy selected unknown tier {name!r} (have "
                                     f"{sorted(tier_qs)})")
                with self._lock:
                    dead = name in self._dead
                if dead:
                    out_q.put(self._closed_result(item, name))
                    continue
                inner = getattr(item, "request", item)
                tid = getattr(inner, "trace_id", None) or telemetry.new_trace_id()
                inner.trace_id = tid
                deadline = getattr(item, "deadline_s", None)
                priority = getattr(item, "priority", 0) or 0
                with self._lock:
                    self._t0s[tid] = (name, time.perf_counter())
                    self.stats.dispatched[name] = self.stats.dispatched.get(name, 0) + 1
                    self.stats.reasons[reason] = self.stats.reasons.get(reason, 0) + 1
                telemetry.emit("tier_dispatch", tier=name, reason=reason, priority=priority,
                               deadline_ms=None if deadline is None else round(deadline * 1e3, 1),
                               trace_id=tid)
                # a scheduler-backed tier keeps the SchedRequest (its
                # priority and deadline order the tier's queues); a plain
                # engine gets the bare request
                forward = item if (self.tiers.schedulers.get(name) is not None
                                   or inner is item) else inner
                tier_qs[name].put(forward)
        except BaseException as e:  # noqa: BLE001 — a source failure re-raises in serve
            error = e
        finally:
            for q in tier_qs.values():
                q.put(_DONE)
            out_q.put(_StreamEnd("__router__", error))

    def _consume(self, name: str, q: "queue.Queue", out_q: "queue.Queue") -> None:
        """Per-tier consumer thread: drive the tier's stream, account each
        result against its routing clock, forward it."""
        error: Optional[BaseException] = None
        try:
            for res in self.tiers.stream_fn(name)(self._feed(q)):
                self._observe(name, res)
                out_q.put(res)
        except BaseException as e:  # noqa: BLE001 — re-raised by serve
            error = e
        finally:
            out_q.put(_StreamEnd(name, error))

    def _observe(self, name: str, res: InferResult) -> None:
        ent = None
        with self._lock:
            if res.trace_id is not None:
                ent = self._t0s.pop(res.trace_id, None)
            ledger = self.stats.completed if res.ok else self.stats.failed
            ledger[name] = ledger.get(name, 0) + 1
        if ent is not None:
            telemetry.observe("tier_e2e_seconds", time.perf_counter() - ent[1], tier=name)
        telemetry.inc_metric("tier_requests_total", tier=name,
                             status="completed" if res.ok else "failed")

    # --------------------------------------------------------------- serve

    def serve(self, requests: Iterable[Any]) -> Iterator[InferResult]:
        """Route ``requests`` across the tiers; yield every result exactly
        once, interleaved across tiers as they complete."""
        out_q: "queue.Queue" = queue.Queue()
        tier_qs = {name: queue.Queue(maxsize=max(64, 2 * self.tiers.infer.batch))
                   for name in self.tiers.names}
        self._stop.clear()
        with self._lock:
            self._dead.clear()
        router = threading.Thread(target=self._route, args=(requests, tier_qs, out_q),
                                  name="tier-router", daemon=True)
        consumers = [threading.Thread(target=self._consume, args=(name, tier_qs[name], out_q),
                                      name="tier-serve", daemon=True)
                     for name in self.tiers.names]
        router.start()
        for t in consumers:
            t.start()
        pending_ends = 1 + len(consumers)
        errors: List[BaseException] = []
        dead_names: set = set()

        def drain_typed(name):
            q = tier_qs[name]
            while True:
                try:
                    orphan = q.get_nowait()
                except queue.Empty:
                    return
                if orphan is not _DONE and not isinstance(orphan, FlushRequest):
                    yield self._closed_result(orphan, name)

        try:
            while pending_ends:
                item = out_q.get()
                if isinstance(item, _StreamEnd):
                    pending_ends -= 1
                    if item.error is not None:
                        errors.append(item.error)
                    if item.name != "__router__":
                        # a tier stream ended: mark it dead FIRST (the router
                        # then resolves its requests as TierClosedError), then
                        # resolve what is already queued, which also unblocks
                        # a router wedged on the dead tier's full queue
                        with self._lock:
                            self._dead.add(item.name)
                        dead_names.add(item.name)
                        yield from drain_typed(item.name)
                    else:
                        # the router is done: the one put a dead-tier drain
                        # unblocked may have landed after that drain; sweep
                        for name in dead_names:
                            yield from drain_typed(name)
                    continue
                yield item
            if errors:
                raise errors[0]
        finally:
            self._stop.set()
            # unblock a router wedged on a full tier queue, then let the
            # feeds run dry so every stream's stager joins
            for q in tier_qs.values():
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                q.put(_DONE)
            router.join(timeout=5.0)
            for t in consumers:
                t.join(timeout=5.0)
            with self._lock:
                self._t0s.clear()
                self._dead.clear()


# -------------------------------------------------------------- spatial


class SpatialServer:
    """Pixel-aware two-lane serving over a ``TierSet``.

    The base tier's scheduler owns the routing decision
    (``configure_spatial``): a request whose padded bucket H·W exceeds the
    threshold is handed, decoded, to the spatial tier's feed instead of
    boarding the base queues, so a megapixel pair rides the spatial tier
    instead of the per-image circuit fallback. ``serve(requests)`` is a
    drop-in stream: the ``spatial-base`` lane drives the base tier's
    scheduler over the incoming requests, the ``spatial-serve`` lane the
    spatial tier's stream over the routed feed, and results interleave on
    one output queue. Every admitted request resolves exactly once: one
    routed after the spatial lane ended resolves as ``TierClosedError``.
    ``TierSet.request_drain`` fans one drain over both lanes. One serve at
    a time per instance."""

    def __init__(self, tiers: TierSet, *, base: str = "quality", spatial: str = "spatial",
                 threshold: int = 1_000_000):
        for name in (base, spatial):
            if name not in tiers.tiers:
                raise ValueError(f"SpatialServer needs tier {name!r}; the TierSet has "
                                 f"{tiers.names}")
        if base == spatial:
            raise ValueError("spatial base and spatial tiers must differ")
        base_sched = tiers.schedulers.get(base)
        if base_sched is None:
            raise ValueError("SpatialServer needs a scheduler-backed base tier (--sched): "
                             "pixel-aware routing lives in the admission layer")
        self.tiers = tiers
        self.base = base
        self.spatial = spatial
        self.stats = TierStats()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # this serve's channels: the sink reads them under the lock, so a
        # routed request never lands on an earlier serve's queues
        self._feed_q: Optional["queue.Queue"] = None
        self._out_q: Optional["queue.Queue"] = None
        self._spatial_dead = False
        base_sched.configure_spatial(int(threshold), self._sink, tier_name=spatial)
        blackbox.register_provider("spatial", self.snapshot)

    @property
    def threshold(self) -> Optional[int]:
        """The live routing bar (the base scheduler's knob)."""
        return self.tiers.schedulers[self.base].spatial_threshold

    def snapshot(self) -> Dict[str, Any]:
        """The two-lane ledger (blackbox, debug server); each lane's queue
        depths are in its scheduler's own snapshot."""
        sched = self.tiers.schedulers[self.base]
        with self._lock:
            return {
                "base": self.base, "spatial": self.spatial,
                "threshold": sched.spatial_threshold, "threshold_base": sched._spatial_base,
                "spatial_dead": self._spatial_dead,
                "stats": {"dispatched": dict(self.stats.dispatched),
                          "completed": dict(self.stats.completed),
                          "failed": dict(self.stats.failed)},
            }

    def _closed_result(self, item) -> InferResult:
        """A routed request whose spatial lane had already ended: a typed
        failure, counted as an SLO miss (canaries excepted)."""
        inner = getattr(item, "request", item)
        with self._lock:
            self.stats.failed[self.spatial] = self.stats.failed.get(self.spatial, 0) + 1
        if not quality.is_canary(inner.payload):
            telemetry.observe_slo(self.spatial, None, ok=False)
        return InferResult(
            payload=inner.payload,
            error=TierClosedError(f"tier {self.spatial!r} stream ended before this request "
                                  f"was admitted"),
            trace_id=getattr(inner, "trace_id", None))

    def _sink(self, item) -> None:
        """The base scheduler's spatial sink (on its admission thread):
        forward one routed request to the spatial lane, or resolve it typed
        when the lane is gone."""
        with self._lock:
            dead = self._spatial_dead
            feed_q, out_q = self._feed_q, self._out_q
        if out_q is None:
            raise RuntimeError("SpatialServer sink called outside an active serve")
        if dead or feed_q is None:
            out_q.put(self._closed_result(item))
            return
        with self._lock:
            self.stats.dispatched[self.spatial] = self.stats.dispatched.get(self.spatial, 0) + 1
        feed_q.put(item)

    def _guard(self, requests: Iterable[Any]) -> Iterator[Any]:
        """The base lane's source: stops at the next item once the consumer
        has gone."""
        for item in requests:
            if self._stop.is_set():
                return
            yield item

    def _feed(self, q: "queue.Queue") -> Iterator[Any]:
        """The spatial lane's routed feed."""
        while True:
            item = q.get()
            if item is _DONE:
                return
            yield item

    def _consume(self, name: str, source: Iterable[Any], feed_q: "queue.Queue",
                 out_q: "queue.Queue") -> None:
        """One lane's consumer thread. The base lane ending means admission
        is over, so it closes the spatial feed."""
        error: Optional[BaseException] = None
        try:
            for res in self.tiers.stream_fn(name)(source):
                with self._lock:
                    ledger = self.stats.completed if res.ok else self.stats.failed
                    ledger[name] = ledger.get(name, 0) + 1
                telemetry.inc_metric("tier_requests_total", tier=name,
                                     status="completed" if res.ok else "failed")
                out_q.put(res)
        except BaseException as e:  # noqa: BLE001 — re-raised by serve
            error = e
        finally:
            if name == self.base:
                feed_q.put(_DONE)
            else:
                with self._lock:
                    self._spatial_dead = True
            out_q.put(_StreamEnd(name, error))

    def serve(self, requests: Iterable[Any]) -> Iterator[InferResult]:
        """Serve ``requests`` through both lanes; yield every result
        exactly once, interleaved across lanes as they complete."""
        feed_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue()
        self._stop.clear()
        with self._lock:
            self._feed_q, self._out_q = feed_q, out_q
            self._spatial_dead = False
        lanes = [threading.Thread(target=self._consume, name="spatial-base", daemon=True,
                                  args=(self.base, self._guard(requests), feed_q, out_q)),
                 threading.Thread(target=self._consume, name="spatial-serve", daemon=True,
                                  args=(self.spatial, self._feed(feed_q), feed_q, out_q))]
        for t in lanes:
            t.start()
        pending_ends = 2
        errors: List[BaseException] = []

        def drain_typed():
            # feed orphans: routed after the spatial lane died, or still
            # queued when it ended
            while True:
                try:
                    orphan = feed_q.get_nowait()
                except queue.Empty:
                    return
                if orphan is not _DONE:
                    yield self._closed_result(orphan)

        try:
            while pending_ends:
                item = out_q.get()
                if isinstance(item, _StreamEnd):
                    pending_ends -= 1
                    if item.error is not None:
                        errors.append(item.error)
                    if item.name == self.spatial:
                        yield from drain_typed()
                    continue
                yield item
            # the base lane may have routed into the dead spatial lane
            # between that lane's drain and its own end
            yield from drain_typed()
            if errors:
                raise errors[0]
        finally:
            self._stop.set()
            with self._lock:
                self._feed_q, self._out_q = None, None
            for t in lanes:
                t.join(timeout=5.0)


# -------------------------------------------------------------- cascade


def photometric_confidence(left: np.ndarray, right: np.ndarray, disp: np.ndarray) -> float:
    """Left-right photometric consistency of a disparity map, as a
    confidence in [0, 1]: the right image sampled at ``x - disp``
    (bilinear, border-clamped) reconstructs the left one, and the mean
    absolute error of 0-255 images folds into ``1 - err/255``. A non-finite
    disparity (or image) scores ``-inf``, below any threshold."""
    d = disp[..., 0] if disp.ndim == 3 else disp
    if not np.isfinite(d).all():
        return float("-inf")
    h, w = d.shape[:2]
    xs = np.arange(w, dtype=np.float32)[None, :] - d.astype(np.float32)
    xs = np.clip(xs, 0.0, w - 1.0)
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    frac = (xs - x0)[..., None]
    rows = np.arange(h)[:, None]
    recon = right[rows, x0] * (1.0 - frac) + right[rows, x1] * frac
    err = float(np.mean(np.abs(left.astype(np.float32) - recon)))
    if not np.isfinite(err):
        return float("-inf")
    return 1.0 - err / 255.0


@dataclass
class CascadeStats:
    """Exactly-once ledger of a cascade (mutated under ``_lock``): every
    admitted request lands in one of accepted / replaced / fallbacks /
    fast_errors."""

    accepted: int = 0      # confident fast result, served as is
    escalated: int = 0     # sent to the quality tier (replaced + fallbacks)
    replaced: int = 0      # escalations the quality tier resolved
    fallbacks: int = 0     # quality failed or drained: the fast result served
    fast_errors: int = 0   # typed fast-tier errors (no disparity to gate)


class CascadeServer:
    """Confidence-gated big-little cascade over two tiers of a ``TierSet``.

    ``confidence_fn(left, right, disp) -> float`` defaults to
    ``photometric_confidence``; a result at or above ``threshold`` is
    accepted from the fast tier, below it the pair re-enters the quality
    tier on its decoded arrays (no second decode). ``serve`` yields exactly
    one result per request: the accepted fast result, the quality
    replacement, a typed fast-tier error, or, when the quality pass fails,
    the held fast result."""

    def __init__(self, tiers: TierSet, *, fast: str = "fast", quality: str = "quality",
                 threshold: float = 0.85, confidence_fn: Optional[Callable] = None):
        for name in (fast, quality):
            if name not in tiers.tiers:
                raise ValueError(f"CascadeServer needs tier {name!r}; the TierSet has "
                                 f"{tiers.names}")
        if fast == quality:
            raise ValueError("cascade fast and quality tiers must differ")
        self.tiers = tiers
        self.fast = fast
        self.quality = quality
        self.threshold = float(threshold)
        self._conf = confidence_fn or photometric_confidence
        self.stats = CascadeStats()
        self._lock = threading.Lock()
        # trace id -> decoded (left, right), captured during the fast
        # tier's own decode
        self._pairs: Dict[str, Tuple[np.ndarray, ...]] = {}
        # trace id -> (fast result, confidence) while its escalation runs:
        # the fallback that keeps a drained escalation exactly-once
        self._held: Dict[str, Tuple[InferResult, float]] = {}
        self._serving = False
        self._stop = threading.Event()
        blackbox.register_provider("cascade", self.snapshot)

    def snapshot(self) -> Dict[str, Any]:
        """The ledger and the hand-off census (blackbox, debug server)."""
        with self._lock:
            return {"fast": self.fast, "quality": self.quality, "threshold": self.threshold,
                    "serving": self._serving, "pairs_captured": len(self._pairs),
                    "escalations_held": len(self._held),
                    "stats": {"accepted": self.stats.accepted,
                              "escalated": self.stats.escalated,
                              "replaced": self.stats.replaced,
                              "fallbacks": self.stats.fallbacks,
                              "fast_errors": self.stats.fast_errors}}

    def set_threshold(self, threshold: float) -> None:
        """The overload controller's actuator: the confidence bar, in
        [0, 1]. The gate reads it once a fast result, so a swap cannot tear
        a decision."""
        threshold = float(threshold)
        if not 0.0 <= threshold <= 1.0:
            raise ValueError(f"cascade threshold must be in [0, 1], got {threshold}")
        self.threshold = threshold

    # ------------------------------------------------------------ fast leg

    def _wrap_requests(self, requests: Iterable[Any]) -> Iterator[Any]:
        """The fast tier's feed: stamp a trace id and wrap each lazy decode
        so the resolved pair is remembered for the gate and an escalation
        (after the engine's own validation)."""
        for item in requests:
            if self._stop.is_set():  # an abandoned consumer: stop feeding
                return
            inner = getattr(item, "request", item)
            tid = getattr(inner, "trace_id", None) or telemetry.new_trace_id()
            raw, payload = inner.inputs, inner.payload

            def resolve(raw=raw, payload=payload, tid=tid):
                arrays = InferRequest(payload=payload, inputs=raw).resolve()
                if len(arrays) >= 2:
                    with self._lock:
                        self._pairs[tid] = (arrays[0], arrays[1])
                return arrays

            wrapped = InferRequest(payload=payload, inputs=resolve, trace_id=tid)
            if inner is not item and self.tiers.schedulers.get(self.fast) is not None:
                item.request = wrapped
                yield item
            else:
                yield wrapped

    def _confidence(self, pair, output) -> float:
        try:
            return float(self._conf(pair[0], pair[1], output))
        except Exception as e:  # noqa: BLE001 — a broken gate escalates
            logger.warning("cascade confidence function failed (%s: %s): the pair "
                           "escalates", type(e).__name__, str(e)[:200])
            return float("-inf")

    def _resolve_fast(self, res: InferResult, esc_q: "queue.Queue",
                      out_q: "queue.Queue") -> None:
        tid = res.trace_id
        with self._lock:
            pair = self._pairs.pop(tid, None) if tid is not None else None
        if not res.ok or pair is None:
            # a typed fast-tier error, or nothing to gate on: as is
            with self._lock:
                self.stats.fast_errors += 1
            out_q.put(res)
            return
        conf = self._confidence(pair, res.output)
        if np.isfinite(conf):
            quality.observe_confidence(self.fast, conf, payload=res.payload)
        # one knob read a decision: the controller may move the bar
        threshold = self.threshold
        if conf >= threshold:
            with self._lock:
                self.stats.accepted += 1
            telemetry.emit("cascade_accept", confidence=round(conf, 4), threshold=threshold,
                           trace_id=tid)
            quality.observe_escalation(self.fast, False, payload=res.payload)
            out_q.put(res)
            return
        with self._lock:
            self.stats.escalated += 1
            self._held[tid] = (res, conf)
        telemetry.inc_metric("cascade_escalated_total")
        quality.observe_escalation(self.fast, True, payload=res.payload)
        esc_q.put(InferRequest(payload=res.payload, inputs=pair, trace_id=tid))

    def _run_fast(self, requests: Iterable[Any], esc_q: "queue.Queue",
                  out_q: "queue.Queue", fast_done: threading.Event) -> None:
        error: Optional[BaseException] = None
        try:
            stream = self.tiers.stream_fn(self.fast)
            for res in stream(self._wrap_requests(requests)):
                self._resolve_fast(res, esc_q, out_q)
        except BaseException as e:  # noqa: BLE001 — re-raised by serve
            error = e
        finally:
            # the escalation feed ends when the fast leg can make no more;
            # fast_done first, so the quality leg's sweep sees a final _held
            fast_done.set()
            esc_q.put(_DONE)
            out_q.put(_StreamEnd(self.fast, error))

    # --------------------------------------------------------- quality leg

    def _escalation_feed(self, esc_q: "queue.Queue") -> Iterator[InferRequest]:
        while True:
            item = esc_q.get()
            if item is _DONE:
                return
            yield item

    def _emit_escalate(self, conf: Optional[float], outcome: str, tid) -> None:
        telemetry.emit("cascade_escalate",
                       confidence=None if conf is None or not np.isfinite(conf)
                       else round(conf, 4),
                       threshold=self.threshold, outcome=outcome, trace_id=tid)

    def _sweep_held(self, out_q: "queue.Queue") -> None:
        """Resolve every still-held fast result as a fallback; runs after
        ``fast_done``, so nothing is inserted meanwhile."""
        with self._lock:
            leftover = list(self._held.items())
            self._held.clear()
            self.stats.fallbacks += len(leftover)
        for tid, (res, conf) in leftover:
            self._emit_escalate(conf, "fallback", tid)
            out_q.put(res)

    def _run_quality(self, esc_q: "queue.Queue", out_q: "queue.Queue",
                     fast_done: threading.Event) -> None:
        error: Optional[BaseException] = None
        # the escalation feed idles whenever the fast leg has nothing to
        # escalate (a hung fast batch holds it for the fast tier's whole
        # deadline): an idle feed is no stall of this leg, whose device
        # waits keep their deadline
        engine = self.tiers.engine(self.quality)
        idle_watchdog, engine.idle_watchdog = engine.idle_watchdog, False
        try:
            stream = self.tiers.stream_fn(self.quality)
            for qres in stream(self._escalation_feed(esc_q)):
                tid = qres.trace_id
                with self._lock:
                    held = self._held.pop(tid, None) if tid is not None else None
                    if qres.ok or held is None:
                        outcome, final = "replaced", qres
                        self.stats.replaced += 1
                    else:
                        # the escalation failed (a device error, or shed or
                        # drained): the held fast result stands
                        outcome, final = "fallback", held[0]
                        self.stats.fallbacks += 1
                self._emit_escalate(None if held is None else held[1], outcome, tid)
                out_q.put(final)
        except BaseException as e:  # noqa: BLE001 — re-raised by serve
            error = e
        finally:
            engine.idle_watchdog = idle_watchdog
            # the quality stream may end (drain bound, death) while the fast
            # leg still escalates: once it is done, fall the rest back
            try:
                fast_done.wait()
                self._sweep_held(out_q)
            finally:
                out_q.put(_StreamEnd(self.quality, error))

    # --------------------------------------------------------------- serve

    def serve(self, requests: Iterable[Any]) -> Iterator[InferResult]:
        """Serve ``requests`` through the cascade: exactly one result a
        request, in completion order across the two legs."""
        with self._lock:
            if self._serving:
                raise RuntimeError("CascadeServer.serve: a serve is already active on "
                                   "this instance")
            self._serving = True
        self._stop.clear()
        esc_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue()
        fast_done = threading.Event()
        fast_t = threading.Thread(target=self._run_fast,
                                  args=(requests, esc_q, out_q, fast_done),
                                  name="cascade-fast", daemon=True)
        quality_t = threading.Thread(target=self._run_quality, args=(esc_q, out_q, fast_done),
                                     name="cascade-quality", daemon=True)
        fast_t.start()
        quality_t.start()
        pending_ends = 2
        errors: List[BaseException] = []
        try:
            while pending_ends:
                item = out_q.get()
                if isinstance(item, _StreamEnd):
                    pending_ends -= 1
                    if item.error is not None:
                        errors.append(item.error)
                    continue
                yield item
            if errors:
                raise errors[0]
        finally:
            # an abandoned consumer stops the fast feed at its next item;
            # the legs wind down through their own finallys
            self._stop.set()
            fast_t.join(timeout=5.0)
            quality_t.join(timeout=5.0)
            if not (fast_t.is_alive() or quality_t.is_alive()):
                with self._lock:
                    self._pairs.clear()
                    self._held.clear()
                    self._serving = False
            # else the instance stays busy: resetting the ledgers under
            # running legs would corrupt them

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"accepted": self.stats.accepted, "escalated": self.stats.escalated,
                    "replaced": self.stats.replaced, "fallbacks": self.stats.fallbacks,
                    "fast_errors": self.stats.fast_errors, "threshold": self.threshold}


__all__ = [
    "CascadeServer",
    "CascadeStats",
    "IterTierPolicy",
    "ModelTier",
    "TierClosedError",
    "TierPolicy",
    "TierSet",
    "TierStats",
    "TieredServer",
    "iter_tier_name",
    "madnet2_tier",
    "photometric_confidence",
    "raft_stereo_tier",
]

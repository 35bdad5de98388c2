"""Quality observatory: drift sentinels and golden canaries (the port's own
copy of ``raft_stereo_tpu/runtime/quality.py``).

**Drift sentinels.** Every completed user result folds into a streaming,
exactly mergeable :class:`DriftSketch` per tier: a disparity-magnitude
``LogHistogram``, the photometric-confidence distribution, the early-exit
``iters_done`` distribution, and warm-start / escalation rate counters.
The first ``reference_n`` results freeze the *reference* sketch; every
later ``window_n`` results close a *window*, scored against the reference
with PSI (population stability index) and a two-sample KS statistic over
the shared bucket space. Hysteresis (``trip_windows`` consecutive hot
windows to raise, ``clear_windows`` calm ones to clear) keeps a noisy
boundary from oscillating the alarm. Raises and clears emit typed
``quality_drift`` events and ``quality_*`` gauges.

**Golden canaries.** ``--canary_every N`` weaves a deterministic
known-input request after every N user admissions, through the real
scheduler path, as the lowest-priority ``SchedRequest``
(``CANARY_PRIORITY``): the scheduler keeps canaries out of the user
queue-depth gate and the SLO accounting, and its boarding and starvation
rules keep a canary from displacing, shedding or delaying a user request.
Each canary output is checked against its golden (bit-exact on the frozen
fp32 path, a mean-abs bound elsewhere), and ``canary_latch`` consecutive
failures latch: the registered latch callbacks run and the blackbox dumps.

Import contract: this module imports only telemetry, blackbox and numpy
at module level (``SchedRequest``/``InferRequest`` are imported inside
:func:`make_canary`), so ``runtime.infer`` and ``runtime.scheduler`` call
the module hooks without an import cycle. With no monitor installed
(``--no_quality``) every hook returns on its first branch.
"""

from __future__ import annotations

import logging
import math
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from . import blackbox, telemetry
from .telemetry import LogHistogram

logger = logging.getLogger(__name__)

# A canary sorts after every user request at equal deadline (urgency is
# ``(deadline, -priority, seq)`` — the most negative priority loses every
# tie), and the scheduler's starvation boost skips canaries entirely.
CANARY_PRIORITY = -(10 ** 9)

# Sketch bucket parameters: coarser than the latency histograms (PSI over
# ~30 occupied buckets is stable at window_n=32 samples; growth 1.1 would
# shatter the mass over ~200 buckets and drown the signal in noise).
SKETCH_GROWTH = 1.25
_DISP_MIN = 1e-2   # disparities below 0.01 px clamp to bucket 0
_CONF_MIN = 1e-3   # photometric confidence lives in [0, 1]
_ITERS_MIN = 0.5   # iters_done is a small positive integer

# Per-image disparity subsample: enough mass for a stable histogram,
# cheap enough to run on the stager thread for every result.
_DISP_SAMPLES = 64

# Minimum per-side mass before a sensor may score: a 4-sample histogram
# "distribution" is noise, and scoring it is how false positives happen.
_MIN_SENSOR_MASS = 8


@dataclass(frozen=True)
class CanaryPayload:
    """The payload tag that marks a request as a golden canary.

    ``seq`` is the injection ordinal (unique per monitor), ``key`` the
    golden-input variant this canary carries (canaries rotate through a
    small fixed set so one pathological input can't mask a regression on
    another). The isinstance check is the tag — user payloads are opaque
    caller context and can never collide with it."""

    seq: int
    key: int


def is_canary(payload: Any) -> bool:
    """True when ``payload`` tags a golden canary (SLO/capacity exempt)."""
    return isinstance(payload, CanaryPayload)


def canary_inputs(key: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """The deterministic golden input pair for variant ``key`` at (h, w).

    Self-contained: a textured right image and
    a smooth positive disparity field, left rendered as the bilinear warp
    left(x) = right(x - d) — a genuine matching signal, byte-stable across
    processes for a fixed (key, h, w)."""
    r = np.random.RandomState(0x5EED ^ (key * 2654435761 % (2 ** 31)))
    right = (255.0 * r.rand(h, w, 3)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d0 = 4.0 + 2.0 * (key % 4)
    disp = d0 + 1.5 * np.sin(2 * np.pi * xx / w) * np.sin(2 * np.pi * yy / h)
    xi = np.clip(xx.astype(np.float32) - disp.astype(np.float32), 0, w - 1)
    i0 = np.floor(xi).astype(np.int64)
    i1 = np.minimum(i0 + 1, w - 1)
    wgt = (xi - i0)[..., None]
    rows = np.arange(h)[:, None]
    left = right[rows, i0] * (1 - wgt) + right[rows, i1] * wgt
    return left.astype(np.float32), right


# --------------------------------------------------------- sketch + scores


class DriftSketch:
    """The exactly-mergeable output-statistics sketch for one tier.

    Three ``LogHistogram``s (disparity magnitude, photometric confidence,
    early-exit iters_done) plus four rate counters (warm-start reuse,
    cascade escalation). Merging two sketches is exact — bucket counts and
    counters add — and therefore order-independent: per-thread or
    per-window sketches fold into one without losing anything, which is
    what lets the reference be "the first N results" regardless of which
    thread observed them."""

    SENSORS = ("disparity", "confidence", "iters", "warm_rate",
               "escalation_rate")

    def __init__(self) -> None:
        self.disparity = LogHistogram(growth=SKETCH_GROWTH,
                                      min_value=_DISP_MIN)
        self.confidence = LogHistogram(growth=SKETCH_GROWTH,
                                       min_value=_CONF_MIN)
        self.iters = LogHistogram(growth=SKETCH_GROWTH,
                                  min_value=_ITERS_MIN)
        self._lock = threading.Lock()
        self._results = 0
        self._warm = 0
        self._warm_total = 0
        self._escalated = 0
        self._gated = 0

    # --- recording (each method is one sample from one mechanism) ---

    def record_output(self, output: Any) -> None:
        """Fold one completed disparity map in (strided subsample of the
        magnitude — channel 0 when adaptive aux channels ride along)."""
        arr = np.asarray(output)
        if arr.ndim == 3:
            arr = arr[..., 0]
        flat = np.abs(np.asarray(arr, dtype=np.float64)).ravel()
        if flat.size == 0:
            return
        step = max(1, flat.size // _DISP_SAMPLES)
        for v in flat[::step][:_DISP_SAMPLES]:
            if math.isfinite(v):
                self.disparity.record(float(v))
        with self._lock:
            self._results += 1

    def record_confidence(self, conf: float) -> None:
        self.confidence.record(float(conf))

    def record_iters(self, iters_done: int) -> None:
        self.iters.record(float(iters_done))

    def record_warm(self, warm: bool) -> None:
        with self._lock:
            self._warm_total += 1
            if warm:
                self._warm += 1

    def record_gate(self, escalated: bool) -> None:
        with self._lock:
            self._gated += 1
            if escalated:
                self._escalated += 1

    # --- views ---

    @property
    def results(self) -> int:
        with self._lock:
            return self._results

    def rate(self, sensor: str) -> Optional[float]:
        """The warm-reuse / escalation rate, None below the mass floor."""
        with self._lock:
            num, den = ((self._warm, self._warm_total)
                        if sensor == "warm_rate"
                        else (self._escalated, self._gated))
        if den < _MIN_SENSOR_MASS:
            return None
        return num / den

    def merge(self, other: "DriftSketch") -> None:
        """Fold ``other`` in exactly (bucket counts and counters add)."""
        self.disparity.merge(other.disparity)
        self.confidence.merge(other.confidence)
        self.iters.merge(other.iters)
        with other._lock:
            vals = (other._results, other._warm, other._warm_total,
                    other._escalated, other._gated)
        with self._lock:
            self._results += vals[0]
            self._warm += vals[1]
            self._warm_total += vals[2]
            self._escalated += vals[3]
            self._gated += vals[4]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = {
                "results": self._results,
                "warm": self._warm,
                "warm_total": self._warm_total,
                "escalated": self._escalated,
                "gated": self._gated,
            }
        return {
            "counters": counters,
            "disparity": self.disparity.snapshot(),
            "confidence": self.confidence.snapshot(),
            "iters": self.iters.snapshot(),
        }


def psi(ref: Dict[int, int], cur: Dict[int, int],
        epsilon: float = 1e-4) -> float:
    """Population stability index between two bucket-count dicts.

    Both sides normalize to probability over the union of occupied
    buckets, floored at ``epsilon`` (an empty-vs-occupied bucket must
    contribute a large-but-finite term, not an infinity). The classic
    reading: < 0.1 stable, 0.1–0.25 moderate shift, > 0.25 drifted."""
    ref_total = sum(ref.values())
    cur_total = sum(cur.values())
    if ref_total == 0 or cur_total == 0:
        return 0.0
    total = 0.0
    for k in set(ref) | set(cur):
        r = max(ref.get(k, 0) / ref_total, epsilon)
        c = max(cur.get(k, 0) / cur_total, epsilon)
        total += (c - r) * math.log(c / r)
    return total


def ks(ref: Dict[int, int], cur: Dict[int, int]) -> float:
    """Two-sample Kolmogorov-Smirnov statistic over the shared bucket
    index space: max CDF gap in [0, 1]. Buckets are ordinal (geometric
    value ranges), so the CDF walk over sorted indices is meaningful."""
    ref_total = sum(ref.values())
    cur_total = sum(cur.values())
    if ref_total == 0 or cur_total == 0:
        return 0.0
    r_acc = c_acc = 0.0
    gap = 0.0
    for k in sorted(set(ref) | set(cur)):
        r_acc += ref.get(k, 0) / ref_total
        c_acc += cur.get(k, 0) / cur_total
        gap = max(gap, abs(r_acc - c_acc))
    return gap


# ------------------------------------------------------------- sentinels


@dataclass
class QualityConfig:
    """Knobs for one :class:`QualityMonitor` (CLI: ``add_infer_args``)."""

    window_n: int = 32       # user results per comparison window
    reference_n: int = 64    # user results frozen as the reference
    psi_trip: float = 0.25   # per-sensor PSI above this => window is hot
    ks_trip: float = 0.35    # per-sensor KS above this => window is hot
    rate_trip: float = 0.25  # |window rate - reference rate| above this
    trip_windows: int = 2    # consecutive hot windows to RAISE
    clear_windows: int = 2   # consecutive calm windows to CLEAR
    canary_every: int = 0    # inject one canary per N user admissions
    canary_latch: int = 3    # consecutive canary failures to latch
    canary_tol: float = 0.5  # mean-abs-diff EPE proxy bound (px)
    exact: bool = False      # bit-exact goldens (frozen f32 path only)
    golden_dir: Optional[str] = None  # committed goldens (npz per shape)
    canary_hw: Tuple[int, int] = (0, 0)  # canary input shape (from CLI)


class DriftSentinel:
    """Window-over-reference drift detection for ONE tier.

    The first ``reference_n`` results build the reference sketch; it then
    freezes for the sentinel's lifetime and every subsequent ``window_n``
    results close a window that scores against it. ``state`` is a latched
    alarm with hysteresis — ``trip_windows`` consecutive hot windows to
    raise, ``clear_windows`` consecutive calm ones to clear; windows that
    are neither (one sensor warm but under the trip line) advance neither
    streak, so a boundary-riding distribution cannot oscillate the alarm.
    Callers hold the monitor lock; LogHistograms add their own."""

    def __init__(self, tier: str, cfg: QualityConfig) -> None:
        self.tier = tier
        self.cfg = cfg
        self.reference = DriftSketch()
        self.window = DriftSketch()
        self.frozen = False       # reference complete, comparisons armed
        self.active = False       # the latched drift alarm
        self.hot_streak = 0
        self.calm_streak = 0
        self.windows = 0          # comparison windows scored
        self.raises = 0
        self.last_scores: Dict[str, Dict[str, float]] = {}

    def _score_window(self) -> Tuple[Dict[str, Dict[str, float]], bool, bool]:
        """Score the closing window: (per-sensor scores, hot, calm)."""
        scores: Dict[str, Dict[str, float]] = {}
        hot = False
        calm = True
        cfg = self.cfg
        for sensor in ("disparity", "confidence", "iters"):
            ref_h: LogHistogram = getattr(self.reference, sensor)
            cur_h: LogHistogram = getattr(self.window, sensor)
            if (ref_h.count < _MIN_SENSOR_MASS
                    or cur_h.count < _MIN_SENSOR_MASS):
                continue  # a mechanism that is off contributes nothing
            p = psi(ref_h.bucket_counts(), cur_h.bucket_counts())
            k = ks(ref_h.bucket_counts(), cur_h.bucket_counts())
            scores[sensor] = {"psi": round(p, 4), "ks": round(k, 4)}
            if p > cfg.psi_trip or k > cfg.ks_trip:
                hot = True
            if p > cfg.psi_trip / 2 or k > cfg.ks_trip / 2:
                calm = False
        for sensor in ("warm_rate", "escalation_rate"):
            ref_r = self.reference.rate(sensor)
            cur_r = self.window.rate(sensor)
            if ref_r is None or cur_r is None:
                continue
            delta = abs(cur_r - ref_r)
            scores[sensor] = {"value": round(cur_r, 4),
                              "reference": round(ref_r, 4),
                              "delta": round(delta, 4)}
            if delta > cfg.rate_trip:
                hot = True
            if delta > cfg.rate_trip / 2:
                calm = False
        return scores, hot, calm

    def _worst(self) -> Tuple[str, float, float, float, float]:
        """(sensor, psi, ks, value, reference) of the worst-scoring
        sensor — the values the quality_drift event carries."""
        worst = ("none", 0.0, 0.0, 0.0, 0.0)
        badness = -1.0
        for sensor, s in self.last_scores.items():
            b = max(s.get("psi", 0.0), s.get("ks", 0.0),
                    s.get("delta", 0.0))
            if b > badness:
                badness = b
                worst = (sensor, s.get("psi", 0.0), s.get("ks", 0.0),
                         s.get("value", s.get("delta", 0.0)),
                         s.get("reference", 0.0))
        return worst

    # host math over an already-materialized sketch; the engine hands
    # observe hooks host arrays, never device values
    def on_window_closed(self) -> None:  # graftcheck: disable=GC02
        """Score the full window against the frozen reference, step the
        hysteresis, emit raise/clear transitions. Gauges and events run
        here (monitor lock held) — telemetry sinks are lock-free."""
        self.windows += 1
        scores, hot, calm = self._score_window()
        self.last_scores = scores
        cfg = self.cfg
        for sensor, s in scores.items():
            if "psi" in s:
                telemetry.set_gauge("quality_psi", s["psi"],
                                    tier=self.tier, sensor=sensor)
                telemetry.set_gauge("quality_ks", s["ks"],
                                    tier=self.tier, sensor=sensor)
            else:
                telemetry.set_gauge("quality_rate_delta", s["delta"],
                                    tier=self.tier, sensor=sensor)
        if hot:
            self.hot_streak += 1
            self.calm_streak = 0
        elif calm:
            self.calm_streak += 1
            self.hot_streak = 0
        else:
            # boundary window: advance neither streak (no-oscillation)
            self.hot_streak = 0
            self.calm_streak = 0
        transition: Optional[str] = None
        if not self.active and self.hot_streak >= cfg.trip_windows:
            self.active = True
            self.raises += 1
            transition = "raise"
        elif self.active and self.calm_streak >= cfg.clear_windows:
            self.active = False
            transition = "clear"
        telemetry.set_gauge("quality_drift_active", int(self.active),
                            tier=self.tier)
        if transition is not None:
            sensor, p, k, value, reference = self._worst()
            telemetry.emit(
                "quality_drift", tier=self.tier, sensor=sensor,
                state=transition, psi=p, ks=k, value=value,
                reference=reference, windows=self.windows,
                window_n=cfg.window_n,
            )
            telemetry.inc_metric("quality_drift_total", tier=self.tier,
                                 state=transition)
            log = logger.warning if transition == "raise" else logger.info
            log("quality drift %s on tier %r: sensor=%s psi=%.3f ks=%.3f",
                transition, self.tier, sensor, p, k)
        # a fresh window starts empty; the reference stays frozen
        self.window = DriftSketch()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "tier": self.tier,
            "frozen": self.frozen,
            "active": self.active,
            "windows": self.windows,
            "raises": self.raises,
            "hot_streak": self.hot_streak,
            "calm_streak": self.calm_streak,
            "scores": dict(self.last_scores),
            "reference": self.reference.snapshot(),
            "window": self.window.snapshot(),
        }


# -------------------------------------------------------------- canaries


class CanaryChecker:
    """Golden bookkeeping + the consecutive-failure latch.

    Goldens key on ``(tier, key)`` — the same input variant may serve
    from several tiers with legitimately different outputs. With no
    ``golden_dir`` the first pass through each (tier, key) captures its
    golden (outcome ``captured``) and later passes check against it: the
    self-bootstrapping mode every smoke and chaos run uses. A committed
    golden_dir (``save()`` after a blessed run) pins them across
    processes. Callers hold the monitor lock."""

    def __init__(self, cfg: QualityConfig,
                 on_latch: Optional[List[Callable[[str], None]]] = None
                 ) -> None:
        self.cfg = cfg
        self.goldens: Dict[Tuple[str, int], np.ndarray] = {}
        self.consecutive: Dict[str, int] = {}
        self.latched: Dict[str, bool] = {}
        self.passes = 0
        self.failures = 0
        self.captured = 0
        self.checked = 0
        self.on_latch: List[Callable[[str], None]] = list(on_latch or [])
        if cfg.golden_dir:
            self._load(cfg.golden_dir)

    def _path(self, golden_dir: str) -> str:
        h, w = self.cfg.canary_hw
        return os.path.join(golden_dir, f"canary_goldens_{h}x{w}.npz")

    def _load(self, golden_dir: str) -> None:
        path = self._path(golden_dir)
        if not os.path.exists(path):
            return
        with np.load(path) as z:
            for name in z.files:
                tier, _, key = name.rpartition("|")
                self.goldens[(tier, int(key))] = z[name]
        logger.info("loaded %d canary goldens from %s",
                    len(self.goldens), path)

    def save(self, golden_dir: str) -> str:
        """Commit the captured goldens (the regeneration recipe: run the
        serve once fault-free with --canary_every, then save)."""
        os.makedirs(golden_dir, exist_ok=True)
        path = self._path(golden_dir)
        np.savez(path, **{f"{tier}|{key}": arr
                          for (tier, key), arr in self.goldens.items()})
        return path

    # the golden compare IS a host materialization by design: canary
    # outputs arrive as host arrays off the engine's finalize path
    def check(self, tier: str, payload: CanaryPayload, output: Any) -> str:  # graftcheck: disable=GC02
        """Check one canary output; returns the outcome string."""
        arr = np.asarray(output)
        if arr.ndim == 3:
            arr = arr[..., 0]
        golden = self.goldens.get((tier, payload.key))
        self.checked += 1
        mode = "exact" if self.cfg.exact else "epe"
        epe: Optional[float] = None
        if golden is None:
            self.goldens[(tier, payload.key)] = np.array(arr, copy=True)
            self.captured += 1
            outcome = "captured"
        else:
            if self.cfg.exact:
                ok = (golden.shape == arr.shape
                      and bool(np.array_equal(golden, arr)))
                if not ok and golden.shape == arr.shape:
                    epe = float(np.mean(np.abs(
                        np.asarray(arr, np.float64)
                        - np.asarray(golden, np.float64))))
            else:
                ok = golden.shape == arr.shape
                if ok:
                    epe = float(np.mean(np.abs(
                        np.asarray(arr, np.float64)
                        - np.asarray(golden, np.float64))))
                    ok = epe <= self.cfg.canary_tol
            outcome = "pass" if ok else "fail"
        if outcome == "pass":
            self.passes += 1
            self.consecutive[tier] = 0
            telemetry.inc_metric("canary_pass_total", tier=tier)
        elif outcome == "fail":
            self.failures += 1
            self.consecutive[tier] = self.consecutive.get(tier, 0) + 1
            telemetry.inc_metric("canary_fail_total", tier=tier)
        consecutive = self.consecutive.get(tier, 0)
        telemetry.emit(
            "canary_result", tier=tier, seq=payload.seq, key=payload.key,
            outcome=outcome, epe=None if epe is None else round(epe, 4),
            tol=self.cfg.canary_tol, mode=mode, consecutive=consecutive,
        )
        if (outcome == "fail"
                and consecutive >= self.cfg.canary_latch
                and not self.latched.get(tier)):
            self._latch(tier, consecutive)
        return outcome

    def _latch(self, tier: str, consecutive: int) -> None:
        self.latched[tier] = True
        reason = (f"canary latch: {consecutive} consecutive golden "
                  f"failures on tier {tier!r}")
        logger.error("%s — freezing adaptation, snapshotting blackbox",
                     reason)
        telemetry.emit(
            "canary_latch", tier=tier, consecutive=consecutive,
            reason=reason, action="freeze_adapt,blackbox_dump",
        )
        for cb in self.on_latch:
            try:
                cb(reason)
            except Exception:  # noqa: BLE001 — a latch action must not
                logger.exception(  # take down the serving thread it runs on
                    "canary latch action %r failed", cb)
        blackbox.request_dump("canary_latch", reason)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "checked": self.checked,
            "passes": self.passes,
            "failures": self.failures,
            "captured": self.captured,
            "goldens": len(self.goldens),
            "consecutive": dict(self.consecutive),
            "latched": sorted(t for t, v in self.latched.items() if v),
        }


# --------------------------------------------------------------- monitor


class QualityMonitor:
    """The umbrella: per-tier sentinels + the canary checker + the
    controller's fifth guard input, behind one lock.

    Installed via :func:`install` (module hooks route here); registered
    as blackbox provider ``quality`` so every crash dump carries the
    observatory state. ``healthy()`` is the controller guard: False while
    any tier's drift alarm is active or any tier's canary latch fired."""

    def __init__(self, cfg: Optional[QualityConfig] = None) -> None:
        self.cfg = cfg or QualityConfig()
        self._lock = threading.RLock()
        self._sentinels: Dict[str, DriftSentinel] = {}
        self.canaries = CanaryChecker(self.cfg)
        self.injected = 0
        self.user_results = 0

    # --- sentinel routing (monitor lock; histograms take their own) ---

    def _sentinel(self, tier: str) -> DriftSentinel:
        s = self._sentinels.get(tier)
        if s is None:
            s = self._sentinels[tier] = DriftSentinel(tier, self.cfg)
        return s

    def _live(self, tier: str) -> DriftSketch:
        """The sketch currently accumulating for ``tier`` (reference
        until frozen, then the open window)."""
        s = self._sentinel(tier)
        return s.window if s.frozen else s.reference

    def observe_result(self, tier: str, payload: Any, output: Any) -> None:
        """One completed OK result: canaries check their golden, user
        results fold into the live sketch and drive window rollover."""
        if is_canary(payload):
            with self._lock:
                self.canaries.check(tier, payload, output)
            return
        with self._lock:
            sent = self._sentinel(tier)
            self._live(tier).record_output(output)
            self.user_results += 1
            if not sent.frozen:
                if sent.reference.results >= self.cfg.reference_n:
                    sent.frozen = True
                    logger.info(
                        "quality reference frozen for tier %r (%d results)",
                        tier, sent.reference.results)
            elif sent.window.results >= self.cfg.window_n:
                sent.on_window_closed()

    def observe_confidence(self, tier: str, conf: float,
                           payload: Any = None) -> None:
        if is_canary(payload):
            return
        with self._lock:
            self._live(tier).record_confidence(conf)

    def observe_iters(self, tier: str, iters_done: int) -> None:
        with self._lock:
            self._live(tier).record_iters(iters_done)

    def observe_warm(self, tier: str, warm: bool,
                     payload: Any = None) -> None:
        if is_canary(payload):
            return
        with self._lock:
            self._live(tier).record_warm(warm)

    def observe_escalation(self, tier: str, escalated: bool,
                           payload: Any = None) -> None:
        if is_canary(payload):
            return
        with self._lock:
            self._live(tier).record_gate(escalated)

    # --- the controller's fifth guard ---

    def healthy(self) -> bool:
        with self._lock:
            if any(v for v in self.canaries.latched.values()):
                return False
            return not any(s.active for s in self._sentinels.values())

    def add_latch_action(self, cb: Callable[[str], None]) -> None:
        with self._lock:
            self.canaries.on_latch.append(cb)

    def note_injected(self) -> int:
        with self._lock:
            self.injected += 1
            return self.injected

    def snapshot(self) -> Dict[str, Any]:
        """The blackbox-provider view."""
        with self._lock:
            return {
                "config": {
                    "window_n": self.cfg.window_n,
                    "reference_n": self.cfg.reference_n,
                    "psi_trip": self.cfg.psi_trip,
                    "ks_trip": self.cfg.ks_trip,
                    "rate_trip": self.cfg.rate_trip,
                    "trip_windows": self.cfg.trip_windows,
                    "clear_windows": self.cfg.clear_windows,
                    "canary_every": self.cfg.canary_every,
                    "canary_latch": self.cfg.canary_latch,
                    "canary_tol": self.cfg.canary_tol,
                    "exact": self.cfg.exact,
                },
                "healthy": (not any(self.canaries.latched.values())
                            and not any(s.active
                                        for s in self._sentinels.values())),
                "user_results": self.user_results,
                "canaries_injected": self.injected,
                "canaries": self.canaries.snapshot(),
                "tiers": {t: s.snapshot()
                          for t, s in sorted(self._sentinels.items())},
            }


# ------------------------------------------------- module hooks + weaving

_hook_lock = threading.Lock()
_current: Optional[QualityMonitor] = None


def install(monitor: QualityMonitor) -> QualityMonitor:
    """Install ``monitor`` as the process-wide observatory (module hooks
    route to it; blackbox provider ``quality`` registers)."""
    global _current
    with _hook_lock:
        _current = monitor
    blackbox.register_provider("quality", monitor.snapshot)
    return monitor


def uninstall() -> None:
    global _current
    with _hook_lock:
        _current = None


def get() -> Optional[QualityMonitor]:
    return _current


def observe_result(tier: str, payload: Any, output: Any) -> None:
    """Free no-op without a monitor — the --no_quality off path."""
    m = _current
    if m is not None:
        m.observe_result(tier, payload, output)


def observe_confidence(tier: str, conf: float, payload: Any = None) -> None:
    m = _current
    if m is not None:
        m.observe_confidence(tier, conf, payload=payload)


def observe_iters(tier: str, iters_done: int) -> None:
    m = _current
    if m is not None:
        m.observe_iters(tier, iters_done)


def observe_warm(tier: str, warm: bool, payload: Any = None) -> None:
    m = _current
    if m is not None:
        m.observe_warm(tier, warm, payload=payload)


def observe_escalation(tier: str, escalated: bool,
                       payload: Any = None) -> None:
    m = _current
    if m is not None:
        m.observe_escalation(tier, escalated, payload=payload)


def make_canary(monitor: QualityMonitor) -> Any:
    """One canary ``SchedRequest``: deterministic inputs, the canary
    payload tag, and the priority floor. Lazy imports (cycle-free)."""
    from .infer import InferRequest
    from .scheduler import SchedRequest

    seq = monitor.note_injected()
    key = seq % 4  # rotate the golden-input variants
    h, w = monitor.cfg.canary_hw
    return SchedRequest(
        request=InferRequest(payload=CanaryPayload(seq=seq, key=key),
                             inputs=lambda k=key: canary_inputs(k, h, w)),
        priority=CANARY_PRIORITY,
    )


def weave_canaries(requests: Iterable[Any],
                   monitor: Optional[QualityMonitor]) -> Iterator[Any]:
    """Yield the user stream unchanged, injecting one canary after every
    ``canary_every`` user requests. Runs on the admission thread (the
    same generator hand-off every request takes) — canaries ride the
    REAL scheduler/tier/cascade path, not a side channel."""
    if monitor is None or monitor.cfg.canary_every <= 0:
        yield from requests
        return
    every = monitor.cfg.canary_every
    n = 0
    for item in requests:
        yield item
        n += 1
        if n % every == 0:
            yield make_canary(monitor)


def monitor_from_options(opts: Any, height: int, width: int,
                         exact: bool) -> Optional[QualityMonitor]:
    """Build the monitor from engine ``InferOptions`` (None when the
    observatory is off). ``exact`` comes from the wiring: bit-exact
    goldens are only sound on the frozen f32 path (no adaptation, no
    convergence early-exit)."""
    if not getattr(opts, "quality", True):
        return None
    cfg = QualityConfig(
        window_n=getattr(opts, "quality_window", 32),
        reference_n=getattr(opts, "quality_reference", 64),
        canary_every=getattr(opts, "canary_every", 0),
        canary_latch=getattr(opts, "canary_latch", 3),
        canary_tol=getattr(opts, "canary_tol", 0.5),
        golden_dir=getattr(opts, "golden_dir", None),
        exact=exact,
        canary_hw=(height, width),
    )
    return QualityMonitor(cfg)


__all__ = [
    "CANARY_PRIORITY",
    "CanaryChecker",
    "CanaryPayload",
    "DriftSentinel",
    "DriftSketch",
    "QualityConfig",
    "QualityMonitor",
    "canary_inputs",
    "get",
    "install",
    "is_canary",
    "ks",
    "make_canary",
    "monitor_from_options",
    "observe_confidence",
    "observe_escalation",
    "observe_iters",
    "observe_result",
    "observe_warm",
    "psi",
    "uninstall",
    "weave_canaries",
]

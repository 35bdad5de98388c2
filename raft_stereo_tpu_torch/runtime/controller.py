"""Self-tuning overload control (PyTorch port of
``raft_stereo_tpu/runtime/controller.py``; its spatial-bar rung comes with
the spatial tier).

A control thread (``overload-ctrl``, armed by ``--controller``; off by
default, and then no controller code runs) reads the serve's sensors on a
fixed cadence and moves its knobs through the servers' bounded, thread-safe
setters (``CascadeServer.set_threshold``, ``TieredServer.set_policy``,
``AdaptiveServer.set_every``, ``ContinuousBatchingScheduler.
set_max_pending``); every consumer reads its knob once a decision.

  * **Sensors.** The windowed SLO budget burn (the change of the
    ``SLOTracker``'s cumulative counters since the last tick, over the
    budget), the deepest scheduler queue, and the quality observatory's
    verdict.
  * **Degradation ladder.** One rung per actuator present, in fixed order:
    ``cascade_bar`` (lower the confidence bar by 0.3: fewer escalations),
    ``iter_floor`` (route default traffic one iteration tier down),
    ``adapt_pause`` (adapt 4x less often), ``shed_tight`` (halve the
    admission cap). A rung whose actuator is absent is left out at
    construction.
  * **Hysteresis and dwell.** Degrade one rung a tick while a sensor is
    above its high band; promote one rung only after every sensor has been
    below its low band for ``dwell_s`` continuously, and re-arm the dwell
    after each promotion. A cycle would need a sensor above high and below
    low within one dwell, so the ladder cannot oscillate. An unhealthy
    quality verdict holds promotions (never degradations).
  * **Observability.** Every decision is an event (``ctrl_degrade`` /
    ``ctrl_promote`` / ``ctrl_hold``) with the sensor values and, on a
    move, the knob, its new value and its declared [lo, hi]; gauges
    ``ctrl_rung``, ``ctrl_burn``, ``ctrl_queue_depth``,
    ``ctrl_quality_ok``; ``snapshot()`` is a blackbox provider.

The controller touches no CUDA state: its thread only reads counters and
calls setters.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from raft_stereo_tpu_torch.runtime import blackbox, quality, telemetry

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ControllerConfig:
    """The control law's knobs (``--controller_*``). ``burn_low`` and
    ``depth_low`` default to half and a quarter of their high bands."""

    interval_s: float = 0.5     # sensor and actuation cadence
    dwell_s: float = 2.0        # continuous calm a promotion needs
    burn_high: float = 1.0      # windowed SLO budget burn -> degrade
    burn_low: Optional[float] = None    # default burn_high / 2
    depth_high: int = 8         # deepest scheduler queue -> degrade
    depth_low: Optional[int] = None     # default max(1, depth_high // 4)

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError("controller interval_s must be > 0")
        if self.dwell_s < 0:
            raise ValueError("controller dwell_s must be >= 0")
        if self.burn_high <= 0:
            raise ValueError("controller burn_high must be > 0")
        if self.depth_high < 1:
            raise ValueError("controller depth_high must be >= 1")
        if self.burn_low is None:
            object.__setattr__(self, "burn_low", self.burn_high / 2.0)
        if self.depth_low is None:
            object.__setattr__(self, "depth_low", max(1, int(self.depth_high) // 4))
        if not 0 <= self.burn_low < self.burn_high:
            raise ValueError(f"controller needs 0 <= burn_low ({self.burn_low}) < burn_high "
                             f"({self.burn_high})")
        if not 0 < self.depth_low < self.depth_high:
            raise ValueError(f"controller needs 0 < depth_low ({self.depth_low}) < depth_high "
                             f"({self.depth_high})")


@dataclass
class _Rung:
    """One ladder rung: a knob, its declared bound, and the closures over
    the owning server's setter."""

    name: str
    knob: str
    lo: float
    hi: float
    baseline: float      # the value revert() restores
    degraded: float      # the value apply() sets
    apply: Callable[[], None]
    revert: Callable[[], None]


class OverloadController:
    """The control thread over a serving topology's actuators.

    Give it the servers the topology has (``schedulers``, ``cascade``,
    ``tiered`` with an ``IterTierPolicy``, ``adaptive``) and it builds the
    ladder from them. ``start()``/``close()`` bound the thread;
    ``wrap(stream_fn)`` does both around one serve. Ladder state is written
    by the control thread under ``_lock`` and read under it by
    ``snapshot()``; the lock only nests outward into the servers' setters,
    which never call back."""

    THREAD_NAME = "overload-ctrl"

    def __init__(self, *, schedulers: Sequence[Any] = (), cascade: Any = None,
                 tiered: Any = None, adaptive: Any = None,
                 config: Optional[ControllerConfig] = None,
                 burn_fn: Optional[Callable[[], float]] = None,
                 depth_fn: Optional[Callable[[], int]] = None,
                 quality_fn: Optional[Callable[[], bool]] = None):
        self.config = config or ControllerConfig()
        self._schedulers = [s for s in schedulers if s is not None]
        self._burn_fn = burn_fn or self._read_burn
        self._depth_fn = depth_fn or self._read_depth
        self._quality_fn = quality_fn or self._read_quality
        self._ladder: List[_Rung] = self._build_ladder(cascade, tiered, adaptive)
        self._lock = threading.Lock()
        self.rung = 0
        self.degrades = 0
        self.promotes = 0
        self.holds = 0
        self.forced_restores = 0   # rungs close() unwound itself
        self.quality_holds = 0     # promotions held by the quality verdict
        self.last_burn = 0.0
        self.last_depth = 0
        self.last_quality = True
        self._calm_since: Optional[float] = None
        self._slo_last: Dict[str, Tuple[int, int]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        blackbox.register_provider("controller", self.snapshot)

    # -------------------------------------------------------------- ladder

    def _build_ladder(self, cascade, tiered, adaptive) -> List[_Rung]:
        """The degradation ladder in fixed order, from the actuators that
        exist."""
        ladder: List[_Rung] = []
        if cascade is not None:
            base = float(cascade.threshold)
            degraded = max(0.0, round(base - 0.3, 6))
            ladder.append(_Rung(
                name="cascade_bar", knob="cascade_threshold", lo=0.0, hi=1.0,
                baseline=base, degraded=degraded,
                apply=lambda: cascade.set_threshold(degraded),
                revert=lambda: cascade.set_threshold(base)))
        if tiered is not None:
            pol = tiered.policy
            tiers = tuple(getattr(pol, "tiers", ()) or ())
            if len(tiers) >= 2 and hasattr(pol, "default_iters"):
                base_iters = pol.default_iters if pol.default_iters is not None else tiers[-1]
                idx = tiers.index(base_iters)
                if idx > 0:
                    down = tiers[idx - 1]
                    base_pol, deg_pol = pol, dataclasses.replace(pol, default_iters=down)
                    ladder.append(_Rung(
                        name="iter_floor", knob="default_iters", lo=float(tiers[0]),
                        hi=float(tiers[-1]), baseline=float(base_iters), degraded=float(down),
                        apply=lambda: tiered.set_policy(deg_pol),
                        revert=lambda: tiered.set_policy(base_pol)))
        if adaptive is not None:
            base_every = int(adaptive._every)
            degraded_every = base_every * 4
            ladder.append(_Rung(
                name="adapt_pause", knob="adapt_every", lo=float(base_every),
                hi=float(degraded_every), baseline=float(base_every),
                degraded=float(degraded_every),
                apply=lambda: adaptive.set_every(degraded_every),
                revert=lambda: adaptive.set_every(base_every)))
        shed = [s for s in self._schedulers if s.max_pending is not None]
        if shed:
            caps = {id(s): int(s.max_pending) for s in shed}
            halves = {k: max(1, v // 2) for k, v in caps.items()}

            def tighten():
                for s in shed:
                    s.set_max_pending(halves[id(s)])

            def restore():
                for s in shed:
                    s.set_max_pending(caps[id(s)])

            ladder.append(_Rung(
                name="shed_tight", knob="max_pending", lo=1.0, hi=float(max(caps.values())),
                baseline=float(max(caps.values())), degraded=float(max(halves.values())),
                apply=tighten, revert=restore))
        return ladder

    # ------------------------------------------------------------- sensors

    def _read_burn(self) -> float:
        """The worst tier's miss rate over the requests resolved since the
        last tick, over its budget (0.0 with no SLO configured or nothing
        resolved this window)."""
        tel = telemetry.get()
        if tel is None or tel.slo is None:
            return 0.0
        worst = 0.0
        for tier, row in tel.slo.snapshot().items():
            total = int(row.get("total", 0))
            misses = int(row.get("misses", 0))
            last_total, last_misses = self._slo_last.get(tier, (0, 0))
            self._slo_last[tier] = (total, misses)
            d_total = total - last_total
            d_miss = misses - last_misses
            budget = float(row.get("budget", 0.0))
            if d_total <= 0 or budget <= 0:
                continue
            worst = max(worst, (d_miss / d_total) / budget)
        return worst

    def _read_depth(self) -> int:
        """The deepest attached scheduler's pending depth."""
        worst = 0
        for s in self._schedulers:
            try:
                worst = max(worst, int(s.snapshot().get("depth") or 0))
            except Exception:  # noqa: BLE001 — a torn-down scheduler
                continue
        return worst

    def _read_quality(self) -> bool:
        """The quality observatory's verdict; healthy with no monitor."""
        mon = quality.get()
        if mon is None:
            return True
        try:
            return bool(mon.healthy())
        except Exception:  # noqa: BLE001 — the guard never kills a tick
            return True

    # ------------------------------------------------------------ the loop

    def _tick(self) -> None:
        """One control interval: read the sensors, move at most one rung."""
        cfg = self.config
        now = time.monotonic()
        burn = float(self._burn_fn())
        depth = int(self._depth_fn())
        q_ok = bool(self._quality_fn())
        with self._lock:
            self.last_burn, self.last_depth = burn, depth
            self.last_quality = q_ok
            hot = burn > cfg.burn_high or depth > cfg.depth_high
            calm = burn < cfg.burn_low and depth < cfg.depth_low
            if hot:
                self._calm_since = None
                if self.rung < len(self._ladder):
                    r = self._ladder[self.rung]
                    from_rung, self.rung = self.rung, self.rung + 1
                    r.apply()
                    self.degrades += 1
                    reason = "burn" if burn > cfg.burn_high else "depth"
                    logger.warning("overload controller: degrade -> rung %d (%s: %s=%s, burn "
                                   "%.2f, depth %d)", self.rung, r.name, r.knob, r.degraded,
                                   burn, depth)
                    telemetry.emit("ctrl_degrade", rung=self.rung, from_rung=from_rung,
                                   knob=r.knob, value=r.degraded, lo=r.lo, hi=r.hi,
                                   burn=round(burn, 4), depth=depth, reason=reason)
                else:
                    self.holds += 1
                    telemetry.emit("ctrl_hold", rung=self.rung, burn=round(burn, 4),
                                   depth=depth, reason="saturated")
            elif calm and self.rung > 0:
                if self._calm_since is None:
                    self._calm_since = now
                if not q_ok:
                    # drifting outputs hold promotions that spend quality;
                    # the dwell keeps accruing
                    self.holds += 1
                    self.quality_holds += 1
                    telemetry.emit("ctrl_hold", rung=self.rung, burn=round(burn, 4),
                                   depth=depth, reason="quality")
                elif now - self._calm_since >= cfg.dwell_s:
                    r = self._ladder[self.rung - 1]
                    from_rung, self.rung = self.rung, self.rung - 1
                    r.revert()
                    self.promotes += 1
                    # the next promotion needs its own full dwell
                    self._calm_since = now
                    logger.info("overload controller: promote -> rung %d (%s restored: %s=%s)",
                                self.rung, r.name, r.knob, r.baseline)
                    telemetry.emit("ctrl_promote", rung=self.rung, from_rung=from_rung,
                                   knob=r.knob, value=r.baseline, lo=r.lo, hi=r.hi,
                                   burn=round(burn, 4), depth=depth, dwell_s=cfg.dwell_s)
                else:
                    self.holds += 1
                    telemetry.emit("ctrl_hold", rung=self.rung, burn=round(burn, 4),
                                   depth=depth, reason="dwell")
            else:
                # in the band (or at rung 0): hold; calm time counts toward
                # the dwell only while every sensor is below its low band
                if not calm:
                    self._calm_since = None
                self.holds += 1
                telemetry.emit("ctrl_hold", rung=self.rung, burn=round(burn, 4), depth=depth,
                               reason="calm" if calm else "band")
            telemetry.set_gauge("ctrl_rung", self.rung)
        telemetry.set_gauge("ctrl_burn", burn)
        telemetry.set_gauge("ctrl_queue_depth", depth)
        telemetry.set_gauge("ctrl_quality_ok", 1 if q_ok else 0)

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — control never kills serving
                logger.exception("overload controller tick failed: serving goes on with the "
                                 "current knobs")

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "OverloadController":
        """Start the control thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name=self.THREAD_NAME,
                                            daemon=True)
            self._thread.start()
            logger.info("overload controller armed: %d-rung ladder [%s], interval %.2fs, "
                        "dwell %.2fs", len(self._ladder),
                        ", ".join(r.name for r in self._ladder), self.config.interval_s,
                        self.config.dwell_s)
        return self

    def close(self) -> None:
        """Stop the thread and restore any rung not yet promoted back
        (counted in ``forced_restores``)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            while self.rung > 0:
                r = self._ladder[self.rung - 1]
                self.rung -= 1
                self.forced_restores += 1
                try:
                    r.revert()
                except Exception:  # noqa: BLE001 — the server may be torn down
                    logger.exception("overload controller: restoring %s at close failed",
                                     r.name)
        if self.forced_restores:
            logger.warning("overload controller closed while degraded: force-restored %d "
                           "rung(s)", self.forced_restores)

    def wrap(self, stream_fn: Callable) -> Callable:
        """The stream_fn with the control thread bound to each serve."""

        def controlled(requests):
            self.start()
            try:
                yield from stream_fn(requests)
            finally:
                self.close()

        return controlled

    # -------------------------------------------------------- introspection

    def snapshot(self) -> Dict[str, Any]:
        """The ladder position and the decision ledger."""
        with self._lock:
            return {
                "armed": self._thread is not None and self._thread.is_alive(),
                "rung": self.rung,
                "ladder": [{"name": r.name, "knob": r.knob, "lo": r.lo, "hi": r.hi,
                            "baseline": r.baseline, "degraded": r.degraded,
                            "applied": i < self.rung}
                           for i, r in enumerate(self._ladder)],
                "degrades": self.degrades,
                "promotes": self.promotes,
                "holds": self.holds,
                "quality_holds": self.quality_holds,
                "forced_restores": self.forced_restores,
                "last_burn": round(self.last_burn, 4),
                "last_depth": self.last_depth,
                "quality_ok": self.last_quality,
                "interval_s": self.config.interval_s,
                "dwell_s": self.config.dwell_s,
            }


def maybe_controller(infer, *, schedulers: Sequence[Any] = (), cascade: Any = None,
                     tiered: Any = None, adaptive: Any = None) -> Optional[OverloadController]:
    """A controller from ``InferOptions`` when ``--controller`` arms one;
    None otherwise."""
    if not infer.controller:
        return None
    ctrl = OverloadController(
        schedulers=schedulers, cascade=cascade, tiered=tiered, adaptive=adaptive,
        config=ControllerConfig(interval_s=infer.controller_interval,
                                dwell_s=infer.controller_dwell,
                                burn_high=infer.controller_burn_high,
                                depth_high=infer.controller_depth_high))
    if not ctrl._ladder:
        logger.warning("--controller armed but this topology has no actuator (a cascade, "
                       "iteration tiers, an adaptive server, or a scheduler with "
                       "--max_pending): the control thread only observes")
    return ctrl


__all__ = [
    "ControllerConfig",
    "OverloadController",
    "maybe_controller",
]

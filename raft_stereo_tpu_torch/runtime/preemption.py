"""Preemption-safe shutdown: SIGTERM/SIGINT become a step-boundary stop,
and for a serving run a bounded graceful drain (the port's own copy of
``raft_stereo_tpu/runtime/preemption.py``).

The training loop polls ``should_stop`` once a step and, when set, commits
an emergency checkpoint and flushes its metrics before it exits; with
``--resume auto`` the run then continues where it stopped. Across ranks
the flag latched on any one rank stops them all: the loop agrees on it
every ``STOP_AGREE_EVERY`` steps (``runtime/loop.py``).

For a serving run the first signal starts ``ServeDrain``: ``drain_begin``
is emitted, the blackbox dumps, the attached scheduler starts its bounded
drain (``request_drain``), ``wrap_source`` stops pulling requests, pending
buckets flush, in-flight batches complete, whatever the bound cuts off
resolves as a typed ``DrainedError`` result, and ``finish`` emits
``drain_complete``. The second signal is immediate: the previous handler
is restored and the signal re-raised.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from types import FrameType
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

from raft_stereo_tpu_torch.runtime import blackbox, telemetry

logger = logging.getLogger(__name__)


class GracefulShutdown:
    """Context manager that latches termination signals into a flag.

    First signal: request a graceful stop (honoured at the next step
    boundary). Second signal: the previous handler is restored and the
    signal re-raised, so a hung save cannot block a kill. Handlers can only
    be installed from the main thread; elsewhere this is an inert flag
    (with a warning)."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self._stop = threading.Event()
        self._previous: dict = {}
        self._installed = False
        # first-stop hooks: run once, inside the signal handler (or
        # request_stop), so they must be cheap and reentrant-safe
        self._callbacks: List[Callable[[], None]] = []
        self._last_signal: Optional[str] = None

    def __enter__(self) -> "GracefulShutdown":
        try:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._handle)
            self._installed = True
        except ValueError:  # not on the main thread
            logger.warning("GracefulShutdown: not on the main thread; signals will not "
                           "be intercepted")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            self._installed = False

    def _handle(self, signum: int, frame: Optional[FrameType]) -> None:
        if self._stop.is_set():
            logger.warning("second signal %s: restoring previous handler and re-raising",
                           signal.Signals(signum).name)
            signal.signal(signum, self._previous.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self._last_signal = signal.Signals(signum).name
        self._stop.set()
        logger.warning("received %s: will stop at the next step boundary and save an "
                       "emergency checkpoint", self._last_signal)
        try:
            # the sink is reentrant, but a signal handler must never crash
            # the run it is stopping
            telemetry.emit("preempt_signal", signal=self._last_signal)
        except Exception:  # noqa: BLE001
            pass
        self._fire_callbacks()

    def _fire_callbacks(self) -> None:
        for cb in self._callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 — never crash the handler
                logger.exception("GracefulShutdown callback failed")

    def add_callback(self, fn: Callable[[], None]) -> None:
        """Register a first-stop hook (cheap and reentrant-safe: it runs in
        the signal handler), fired once, on the first signal or the first
        ``request_stop``."""
        self._callbacks.append(fn)

    def request_stop(self) -> None:
        """Programmatic stop request: fires the first-stop hooks as a
        signal would."""
        already = self._stop.is_set()
        self._stop.set()
        if not already:
            self._fire_callbacks()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    @property
    def last_signal(self) -> Optional[str]:
        """Name of the signal that triggered the stop, if a signal did."""
        return self._last_signal


class ServeDrain:
    """Graceful-drain orchestration for one serving run.

    Built once over a ``GracefulShutdown``; ``attach`` the scheduler (any
    object with ``request_drain(timeout_s)``, or None for plain engine
    serving, which drains by source truncation and the end-of-stream
    flush); wrap the request source with ``wrap_source``; pass every
    consumed result to ``note_result``; call ``finish`` when the stream
    ends. Without a signal it is a transparent passthrough."""

    def __init__(self, shutdown: GracefulShutdown, *, timeout_s: float = 30.0,
                 label: str = "serving"):
        self.shutdown = shutdown
        self.timeout_s = float(timeout_s)
        self.label = label
        self._scheduler = None
        self._began: Optional[float] = None
        self._finished: Optional[dict] = None
        self._resolved = 0
        self._drained = 0
        shutdown.add_callback(self.begin)

    def attach(self, scheduler) -> None:
        """Register the scheduler the first signal must reach; a signal that
        came before it is forwarded now."""
        self._scheduler = scheduler
        if scheduler is not None and self._began is not None:
            scheduler.request_drain(self.timeout_s)

    @property
    def draining(self) -> bool:
        return self.shutdown.should_stop

    def begin(self) -> None:
        """First-signal hook (idempotent, signal-handler safe)."""
        if self._began is not None:
            return
        self._began = time.monotonic()
        telemetry.emit("drain_begin", signal=self.shutdown.last_signal,
                       timeout_s=self.timeout_s, label=self.label)
        logger.warning("[%s] drain begun (signal=%s): admission stops, pending work "
                       "flushes, bound %.1fs", self.label, self.shutdown.last_signal,
                       self.timeout_s)
        # every drain leaves a blackbox (latch-only: this runs in the handler)
        blackbox.request_dump("drain", self.shutdown.last_signal or "request_stop")
        if self._scheduler is not None:
            self._scheduler.request_drain(self.timeout_s)

    def wrap_source(self, requests: Iterable) -> Iterator:
        """Drain-aware view of a request iterable: the stop flag is checked
        before each pull, and a request already pulled is always handed
        over, so stopping never discards one."""
        it = iter(requests)
        while not self.draining:
            try:
                req = next(it)
            except StopIteration:
                return
            yield req

    def note_result(self, result) -> None:
        """Account one consumed resolution (typed drained errors are the
        drain's casualties)."""
        self._resolved += 1
        err = getattr(result, "error", None)
        if err is not None and getattr(err, "reason", None) == "drained":
            self._drained += 1

    def finish(self) -> Optional[dict]:
        """Emit ``drain_complete`` (only if a drain began) and return its
        payload; idempotent, only the first call emits."""
        if self._began is None:
            return None
        if self._finished is not None:
            return self._finished
        payload = {"duration_ms": round((time.monotonic() - self._began) * 1e3, 1),
                   "resolved": self._resolved, "drained": self._drained, "label": self.label}
        telemetry.emit("drain_complete", duration_ms=payload["duration_ms"],
                       resolved=self._resolved, drained=self._drained, label=self.label)
        logger.warning("[%s] drain complete in %.0f ms: %d result(s) resolved (%d drained)",
                       self.label, payload["duration_ms"], self._resolved, self._drained)
        self._finished = payload
        return payload

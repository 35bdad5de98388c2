"""Preemption-safe shutdown: SIGTERM/SIGINT become a step-boundary stop
(the port's own copy of ``GracefulShutdown``,
``raft_stereo_tpu/runtime/preemption.py:46-141``, without the first-stop
callbacks that only the serving drain uses).

The training loop polls ``should_stop`` once a step and, when set, commits
an emergency checkpoint and flushes its metrics before it exits; with
``--resume auto`` the run then continues where it stopped.
"""

from __future__ import annotations

import logging
import signal
import threading
from types import FrameType
from typing import Optional, Tuple

from raft_stereo_tpu_torch.runtime import telemetry

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

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    @property
    def last_signal(self) -> Optional[str]:
        """Name of the signal that triggered the stop, if a signal did."""
        return self._last_signal

"""Crash forensics: blackbox dumps of a live (or dying) serving process
(the port's own copy of ``raft_stereo_tpu/runtime/blackbox.py``).

  * **Snapshot providers.** The engine, the scheduler and the session
    server register their ``snapshot()`` hooks with the installed dumper
    when they are built (``register_provider``, a free no-op when none is
    installed).
  * **Triggered dumps.** ``request_dump(trigger)`` latches a trigger that
    the ``blackbox-dump`` worker thread polls: the caller pays one RLock'd
    attribute write, so a signal handler may call it. Callers: the
    engine's watchdog trips and stream deaths, ``ServeDrain.begin``, the
    canary latch, and the operator's SIGUSR2 (``watch_signal``; the
    handler only latches).
  * **The dump.** ``blackbox.json``, written atomically (tmp, fsync,
    ``os.replace``): every thread's stack with its role, the telemetry
    ring of recent events, every provider's snapshot (each isolated: one
    that raises becomes an error entry) and the SLO posture. A
    ``blackbox_dump`` event records each dump.

The dumper's lock guards the trigger latch and the provider registry only;
the snapshots and the file write run without it, so a dump cannot deadlock
against the locks the snapshots take. The module imports only the standard
library and the port's telemetry.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from raft_stereo_tpu_torch.runtime import telemetry

logger = logging.getLogger(__name__)

BLACKBOX_NAME = "blackbox.json"

# Thread-name -> role: the JAX package's map, entry for entry, so a dump of
# either package reads in one vocabulary (tests/test_torch_port_blackbox.py
# holds the two equal).
THREAD_ROLES: Dict[str, str] = {
    "MainThread": "main",
    "infer-stager": "stager",
    "device-stager": "stager",
    "sched-admit": "admit",
    "infer-device-wait": "watchdog",
    "ckpt-committer": "committer",
    "tier-router": "admit",
    "session-router": "admit",
    "tier-serve": "dispatch",
    "cascade-fast": "dispatch",
    "cascade-quality": "dispatch",
    "spatial-base": "dispatch",
    "spatial-serve": "dispatch",
    "blackbox-dump": "introspect",
    "debug-server": "introspect",
    "overload-ctrl": "controller",
    "fleet-admit": "admit",
    "fleet-tx": "dispatch",
    "fleet-rx": "dispatch",
    "fleet-health": "introspect",
    "fleet-host-rx": "admit",
    "fleet-restarter": "controller",
}


def thread_role(name: str) -> str:
    """The role of a thread name ('?' for unmapped names —
    e.g. stdlib pool workers — so the dump never invents a role)."""
    return THREAD_ROLES.get(name, "?")


def thread_stacks() -> List[Dict[str, Any]]:
    """Every live thread's stack, role-annotated (newest frame last)."""
    frames = sys._current_frames()
    out: List[Dict[str, Any]] = []
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        stack = traceback.format_stack(frame) if frame is not None else []
        out.append({
            "name": t.name,
            "ident": t.ident,
            "daemon": t.daemon,
            "role": thread_role(t.name),
            "stack": [line.rstrip("\n") for line in stack],
        })
    return out


class BlackboxDumper:
    """One run's crash-forensics sink: provider registry + dump worker.

    Construct once per serving run (the CLIs build it next to the
    telemetry sink); ``request(trigger)`` from anywhere — including a
    signal handler — latches the trigger and wakes the worker; ``close``
    flushes a pending dump and joins the thread. The RLock makes the
    latch safe to take from a handler interrupting a frame that already
    holds it.
    """

    def __init__(self, run_dir: str):
        self.run_dir = str(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.path = os.path.join(self.run_dir, BLACKBOX_NAME)
        self._lock = threading.RLock()
        self._providers: Dict[str, Callable[[], Any]] = {}
        self._event = threading.Event()
        self._trigger: Optional[str] = None
        self._reason: str = ""
        self._closed = False
        self._dumps = 0
        self._signum: Optional[int] = None
        self._prev_handler: Any = None
        self._thread = threading.Thread(
            target=self._run, name="blackbox-dump", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------- providers

    def register(self, kind: str, fn: Callable[[], Any]) -> str:
        """Register a zero-arg snapshot provider under a unique name
        (``kind``, ``kind#2``, ...). Providers must return a JSON-able
        dict; a raising provider degrades to an error entry in the dump,
        never a missing dump. Registrations live for the dumper's whole
        lifetime (there is deliberately no unregister): the dumper is
        run-scoped, and a component that outlives its usefulness shows
        up as a ``#N``-suffixed stale snapshot — evidence, not a leak a
        dump should hide. A process that rebuilds engines repeatedly
        should rebuild its dumper with them."""
        with self._lock:
            name = kind
            n = 2
            while name in self._providers:
                name = f"{kind}#{n}"
                n += 1
            self._providers[name] = fn
            return name

    def providers(self) -> Dict[str, Callable[[], Any]]:
        """A consistent copy of the registry (the debug server's view)."""
        with self._lock:
            return dict(self._providers)

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps

    # ------------------------------------------------------------ trigger

    # The worker's poll period: the latency ceiling between a trigger
    # landing and its dump starting. Polling (vs an Event.set in
    # request()) is deliberate: Event.set acquires a NON-reentrant
    # internal lock, so a handler interrupting the exact frame inside a
    # main-thread set() would self-deadlock — request() must be a pure
    # RLock'd latch.
    POLL_S = 0.1

    def request(self, trigger: str, reason: str = "") -> None:
        """Latch a dump trigger (signal-handler safe: ONE reentrant-lock
        attribute write, nothing else — the worker polls the latch and
        runs the dump)."""
        with self._lock:
            if self._closed:
                return
            self._trigger = str(trigger)
            self._reason = str(reason)

    def _handle(self, signum, frame) -> None:
        """The operator-signal handler: latch-only."""
        self.request("signal", signal.Signals(signum).name)

    def watch_signal(self, signum: int = signal.SIGUSR2) -> bool:
        """Install the operator dump signal (main thread only; elsewhere
        this degrades to a warning and the programmatic triggers)."""
        try:
            self._prev_handler = signal.signal(signum, self._handle)
            self._signum = signum
            return True
        except ValueError:  # pragma: no cover - non-main thread
            logger.warning(
                "blackbox: not on the main thread; the operator dump "
                "signal will not be intercepted"
            )
            return False

    def wait_for_dump(self, n: int = 1, timeout_s: float = 10.0) -> bool:
        """Block (politely) until at least ``n`` dumps completed."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.dumps >= n:
                return True
            time.sleep(0.02)
        return self.dumps >= n

    # --------------------------------------------------------------- dump

    def _run(self) -> None:
        while True:
            # the event only wakes the poll early on close(); triggers
            # are picked up by the poll itself (request() is latch-only)
            self._event.wait(timeout=self.POLL_S)
            with self._lock:
                trigger, reason = self._trigger, self._reason
                self._trigger = None
            if trigger is not None:
                try:
                    self._do_dump(trigger, reason)
                except Exception:  # noqa: BLE001 — forensics must not crash
                    logger.exception("blackbox dump failed")
                with self._lock:
                    self._dumps += 1
            with self._lock:
                done = self._closed and self._trigger is None
            if done:
                return

    def _do_dump(self, trigger: str, reason: str) -> None:
        """Collect + atomically commit one blackbox.json. Runs with NO
        dumper lock held: the snapshots below take the runtime's own
        locks, and holding ours across them would build the exact
        lock-order cycle."""
        t0 = time.perf_counter()
        tel = telemetry.get()
        ring: Dict[str, Any] = {"capacity": 0, "total": 0, "dropped": 0,
                                "events": []}
        slo: Optional[Dict[str, Any]] = None
        if tel is not None:
            try:
                ring = tel.ring_snapshot()
            except Exception as e:  # noqa: BLE001 — best-effort section
                ring["error"] = f"{type(e).__name__}: {e}"
            if tel.slo is not None:
                slo = tel.slo.snapshot()
        snapshots: Dict[str, Any] = {}
        for name, fn in sorted(self.providers().items()):
            try:
                snapshots[name] = fn()
            except Exception as e:  # noqa: BLE001 — isolated per provider
                snapshots[name] = {"error": f"{type(e).__name__}: {e}"}
        threads = thread_stacks()
        doc = {
            "version": 1,
            "trigger": trigger,
            "reason": reason,
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "pid": os.getpid(),
            "dump_ms": None,  # patched below, after collection
            "threads": threads,
            "ring": ring,
            "snapshots": snapshots,
            "slo": slo,
        }
        doc["dump_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        logger.warning(
            "blackbox dump (%s%s) -> %s: %d thread(s), %d ring event(s), "
            "%d snapshot(s)", trigger, f": {reason}" if reason else "",
            self.path, len(threads), len(ring.get("events", [])),
            len(snapshots),
        )
        telemetry.emit(
            "blackbox_dump", trigger=trigger, reason=reason, path=self.path,
            threads=len(threads), ring_events=len(ring.get("events", [])),
            providers=sorted(snapshots),
        )

    # -------------------------------------------------------------- close

    def close(self) -> None:
        """Flush any pending dump, join the worker, restore the signal
        handler (idempotent)."""
        if self._signum is not None:
            try:
                signal.signal(self._signum, self._prev_handler)
            except ValueError:  # pragma: no cover - non-main thread
                pass
            self._signum = None
        with self._lock:
            self._closed = True
        self._event.set()
        self._thread.join(timeout=10.0)


# -------------------------------------------------------- module-level hooks

_current: Optional[BlackboxDumper] = None


def install(dumper: Optional[BlackboxDumper]) -> Optional[BlackboxDumper]:
    """Make ``dumper`` the process-wide forensics sink (None to clear)."""
    global _current
    _current = dumper
    return dumper


def uninstall(dumper: Optional[BlackboxDumper]) -> None:
    """Close ``dumper`` and clear it if installed (idempotent)."""
    global _current
    if dumper is None:
        return
    if _current is dumper:
        _current = None
    dumper.close()


def get() -> Optional[BlackboxDumper]:
    return _current


def request_dump(trigger: str, reason: str = "") -> None:
    """Latch a dump on the installed dumper; free no-op when none is
    installed (one attribute read) — safe on the serving hot path and in
    signal context."""
    d = _current
    if d is not None:
        d.request(trigger, reason)


def register_provider(kind: str, fn: Callable[[], Any]) -> Optional[str]:
    """Register a snapshot provider on the installed dumper; no-op
    (returns None) when none is installed — constructors call this
    unconditionally."""
    d = _current
    if d is not None:
        return d.register(kind, fn)
    return None


__all__ = [
    "BLACKBOX_NAME",
    "BlackboxDumper",
    "THREAD_ROLES",
    "get",
    "install",
    "register_provider",
    "request_dump",
    "thread_role",
    "thread_stacks",
    "uninstall",
]

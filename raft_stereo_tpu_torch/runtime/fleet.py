"""Replica fleet serving: a health-checked router with exactly-once
failover (PyTorch port of ``raft_stereo_tpu/runtime/fleet.py``; the same
events, wire format and contracts).

A single host runs the whole serving ladder (continuous batching, typed
shedding, graceful drain, introspection), but one host is one failure
domain. This module puts N of those hosts behind one front-end
``FleetRouter``: route on live load signals, survive replica loss with
typed, bounded recovery. The contract, piece by piece:

**Topology.** The router (a plain process that never touches the card)
spawns N *worker* processes (``python -m raft_stereo_tpu_torch.runtime.fleet
--spec ...``), all launched together, each a full single-host serving
stack: engine built from a declared factory (``"module:function"``),
``ContinuousBatchingScheduler``, optional ``SessionServer``, a
``DebugServer`` on an ephemeral port, and its own telemetry directory.
Several workers may share one card, each capturing its own CUDA graphs.
All workers share one ``--aot_dir``: the graph store's recipes
(``runtime/aot_store.py``) that one worker commits, every worker of a
later fleet captures while its engine is built, and a worker reports
healthy only once its engine is built.
Requests and results move over a loopback TCP connection per host
(length-prefixed pickle frames carrying numpy arrays on the host, never
torch tensors, so the JAX package's frames read the same); health moves
over the debug server's HTTP surface (``/healthz`` + ``/debug/queues``).

**Routing.** One admission thread applies the global admission ladder
first — the scheduler's own ``sched_shed`` semantics at fleet scope:
``queue_full`` when fleet-wide in-flight depth hits ``max_pending``,
``deadline`` when no healthy host's EWMA service clock can meet a
request's deadline — then picks a host by (1) session affinity
(``SchedRequest.session`` pins to its host while that host is healthy),
(2) least estimated work: ``(in-flight + polled queue depth) * EWMA
service time``. Every placement is a ``fleet_route`` event.

**Failure containment.** A health poller drives a per-host circuit
breaker: consecutive ``/healthz`` failures open the circuit (no new
routes), a half-open probe after a cooldown closes it again; each
transition is a ``fleet_circuit_open`` event. A worker that exits, drops
its connection, or stays unhealthy past ``down_after_s`` is declared
down (``fleet_host_down``) — deliberately *without* killing a merely
unresponsive process, so a zombie host coming back is a real event the
fencing below must survive.

**Exactly-once failover.** The router keeps every in-flight request's
decoded arrays and a per-request *generation* counter. When a host goes
down, each of its in-flight requests is re-dispatched to a healthy
replica with ``generation + 1`` (``fleet_failover outcome=redispatch``);
a request out of failover budget — or with no healthy host left —
resolves as a typed ``FleetHostError`` (``outcome=typed_error``). A
result frame only resolves its request if its generation matches the
table's current one: a zombie host's late result for a re-dispatched
request is *fenced* (counted, dropped), so every source request resolves
exactly once — completed or typed error, never twice, never silently.
Per-request outputs do not depend on the batch's other items at a fixed
batch size, so a fault-free fleet run is bitwise a single-host serve.

**Session affinity + migration.** Video sessions pin to one host; when
that host dies the session migrates with its in-flight frames
(``fleet_route reason=migrate``). The new host's ``SessionServer`` has
no state for the migrated session, so its first frame cold-starts with
the typed reset semantics (``session_warm_start warm=false``) — warm
state never silently crosses hosts.

**Rolling restart.** ``rolling_restart()`` drains hosts one at a time:
SIGTERM (the worker's ``ServeDrain`` stops admission, flushes pending,
completes in-flight), failover of whatever the drain could not finish,
respawn, wait healthy, next host — capacity never drops below N-1 and
zero requests fail (``fleet_drain`` events bracket each host).

``FleetRouter`` duck-types the scheduler's drain surface
(``request_drain``/``snapshot``/``stats``) so ``ServeDrain``,
``DebugServer`` and the blackbox treat a fleet like a scheduler. Its
snapshot adds what a replica costs: each host's seconds from launch to
its portfile and to its first healthy poll, and the router's pickle and
send time a request frame.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import pickle
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from raft_stereo_tpu_torch.runtime import blackbox, telemetry

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
_MAX_FRAME = 1 << 30  # sanity bound on one pickled frame
_FEED_DONE = object()


class FleetHostError(RuntimeError):
    """A request lost with its replica and unrecoverable: its host died
    (or was declared down) with the request in flight, and either the
    failover budget is spent or no healthy replica remains. Always a
    typed resolution — the fleet never drops a request silently."""

    def __init__(self, message: str, host: Optional[int] = None,
                 attempts: int = 0):
        super().__init__(message)
        self.host = host
        self.attempts = attempts


# ----------------------------------------------------------- wire protocol
#
# One loopback TCP connection per host; frames are 4-byte big-endian
# length + pickle. Router -> worker: {"kind": "req", ...} carrying the
# decoded arrays, {"kind": "stop"} to end the worker's feed, {"kind":
# "fi", "what": ...} chaos hooks. Worker -> router: {"kind": "res", ...}
# per resolution, {"kind": "bye"} before a clean close. Arrays travel as
# numpy, so the JAX package's router and workers speak the same frames.
# Pickle is safe here: both ends are the same codebase on the same
# machine, loopback only — the same trust domain as the debug server.


def _pack_frame(obj: Dict[str, Any]) -> bytes:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(data)) + data


def _send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    sock.sendall(_pack_frame(obj))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket,
                timing: Optional[Dict[str, float]] = None) -> Optional[Dict[str, Any]]:
    """One frame, or None at EOF or on a torn frame. ``timing``, when
    given, gets the frame's seconds from its length header to its last
    byte (``recv_s``) and unpickling it (``unpickle_s``)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > _MAX_FRAME:
        return None
    t0 = time.perf_counter()
    body = _recv_exact(sock, n)
    if body is None:
        return None
    t1 = time.perf_counter()
    try:
        obj = pickle.loads(body)
    except Exception:  # noqa: BLE001 — a torn frame ends the connection
        return None
    if timing is not None:
        timing["recv_s"] = t1 - t0
        timing["unpickle_s"] = time.perf_counter() - t1
    return obj


class _RxClock:
    """Received frames and their seconds in receive and unpickle,
    summed; read by another thread than the one that adds."""

    def __init__(self):
        self._lock = threading.Lock()
        self.frames = 0
        self.recv_s = 0.0
        self.unpickle_s = 0.0

    def add(self, timing: Dict[str, float]) -> None:
        with self._lock:
            self.frames += 1
            self.recv_s += timing["recv_s"]
            self.unpickle_s += timing["unpickle_s"]

    def doc(self) -> Dict[str, Any]:
        with self._lock:
            return {"frames": self.frames, "recv_s": self.recv_s,
                    "unpickle_s": self.unpickle_s}


# ----------------------------------------------------------------- worker
#
# A worker is one complete single-host serving process. It differs from
# serve_adaptive only in its source (the router's TCP feed instead of a
# synthetic stream) and sink (result frames back up the same socket).
# SIGTERM keeps its single-host meaning: ServeDrain drains the scheduler
# and the worker exits 0 — which is exactly what the router's rolling
# restart sends.


def _resolve_factory(spec: str) -> Callable[[Dict[str, Any]], Any]:
    """``"module:function"`` -> the callable. The factory receives the
    spec's ``factory_kw`` dict and returns a ready ``InferenceEngine``
    (workers never unpickle code — only data crosses the wire)."""
    mod_name, _, fn_name = spec.partition(":")
    if not mod_name or not fn_name:
        raise ValueError(
            f"engine factory must be 'module:function', got {spec!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


def _worker_feed(q: "queue.Queue", stop: threading.Event) -> Iterator[Any]:
    """The worker's request source, consumed on the scheduler's admission
    thread. Polls so a drain (stop set, no more frames coming) never
    leaves the admission thread parked in ``q.get`` forever."""
    while not stop.is_set():
        try:
            item = q.get(timeout=0.1)
        except queue.Empty:
            continue
        if item is _FEED_DONE:
            return
        yield item


def _worker_rx(sock: socket.socket, q: "queue.Queue",
               stop: threading.Event, debug_ref: List[Any], clock: _RxClock) -> None:
    """Per-worker socket reader ("fleet-host-rx"): decodes router frames
    into SchedRequests for the feed. EOF or a stop frame ends the feed
    exactly once. ``clock`` times each request frame's receive and
    unpickle."""
    from raft_stereo_tpu_torch.runtime.infer import InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

    def put(item: Any) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    timing: Dict[str, float] = {}
    while not stop.is_set():
        frame = _recv_frame(sock, timing)
        if frame is None or frame.get("kind") == "stop":
            put(_FEED_DONE)
            return
        kind = frame.get("kind")
        if kind == "fi":
            # chaos hook: a health-endpoint blackhole closes the debug
            # server while the data path keeps serving — the router must
            # open the circuit and (eventually) fail the host over on
            # health evidence alone
            if frame.get("what") == "health_blackhole" and debug_ref[0]:
                debug_ref[0].close()
                debug_ref[0] = None
            continue
        if kind != "req":
            continue
        clock.add(timing)
        inner = InferRequest(
            payload=(frame["rid"], frame["gen"]),
            inputs=tuple(frame["arrays"]),
            trace_id=frame.get("trace_id"),
        )
        put(SchedRequest(
            inner,
            priority=frame.get("priority", 0),
            deadline_s=frame.get("deadline_s"),
            session=frame.get("session"),
        ))


def _result_frame(res, clock: _RxClock) -> Dict[str, Any]:
    """A result's frame; ``rx`` carries the worker's request frames so far
    and their receive and unpickle seconds (``clock``)."""
    err = res.error
    rid, gen = res.payload
    return {
        "kind": "res", "rid": rid, "gen": gen, "ok": res.ok,
        "bucket": tuple(res.bucket) if res.bucket else None,
        "trace_id": res.trace_id,
        "output": np.ascontiguousarray(res.output) if res.ok else None,
        "etype": type(err).__name__ if err is not None else None,
        "emsg": str(err) if err is not None else None,
        "reason": getattr(err, "reason", None),
        "rx": clock.doc(),
    }


def worker_main(argv: Optional[List[str]] = None) -> int:
    """One fleet host: engine + scheduler (+ sessions) fed by the
    router's socket, full single-host lifecycle (telemetry, blackbox,
    debug server, graceful SIGTERM drain). Exit 0 on a clean drain."""
    ap = argparse.ArgumentParser(description="fleet worker (internal)")
    ap.add_argument("--spec", required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    host_id = int(spec["host_id"])

    from raft_stereo_tpu_torch.runtime.debug_server import DebugServer
    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler,
        SessionServer,
    )

    tel = telemetry.install(
        telemetry.Telemetry(spec["telemetry_dir"], host=host_id))
    bb = blackbox.install(blackbox.BlackboxDumper(spec["telemetry_dir"]))
    debug_ref: List[Any] = [None]
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    conn: Optional[socket.socket] = None
    try:
        factory = _resolve_factory(spec["factory"])
        engine = factory(dict(spec.get("factory_kw") or {}))
        sched = ContinuousBatchingScheduler(
            engine, max_wait_s=float(spec.get("max_wait_s", 0.2)),
            max_pending=spec.get("max_pending"),
        )
        serve_fn = sched.serve
        if spec.get("sessions"):
            serve_fn = SessionServer(sched.serve, forward_sched=True).serve
        debug_ref[0] = DebugServer(0).start()

        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        lsock.settimeout(float(spec.get("accept_timeout_s", 60.0)))
        # the portfile is the spawn handshake: written atomically once the
        # data socket listens, read by the router's spawn loop
        port_doc = {"data_port": lsock.getsockname()[1],
                    "debug_port": debug_ref[0].port, "pid": os.getpid()}
        tmp = spec["portfile"] + ".tmp"
        with open(tmp, "w") as f:
            json.dump(port_doc, f)
        os.replace(tmp, spec["portfile"])
        conn, _ = lsock.accept()
        lsock.close()
        conn.settimeout(None)

        stop = threading.Event()
        q: "queue.Queue" = queue.Queue(maxsize=256)
        clock = _RxClock()
        rx = threading.Thread(
            target=_worker_rx, args=(conn, q, stop, debug_ref, clock),
            name="fleet-host-rx", daemon=True)
        with GracefulShutdown() as shutdown:
            shutdown.add_callback(stop.set)
            drain = ServeDrain(
                shutdown, timeout_s=float(spec.get("drain_timeout", 30.0)),
                label=f"fleet-host{host_id}")
            drain.attach(sched)
            rx.start()
            for res in serve_fn(drain.wrap_source(_worker_feed(q, stop))):
                drain.note_result(res)
                try:
                    _send_frame(conn, _result_frame(res, clock))
                except OSError:
                    # the router is gone: keep draining (every request
                    # still resolves locally; the router fences anyway)
                    pass
            drain.finish()
            stop.set()
        try:
            _send_frame(conn, {"kind": "bye"})
        except OSError:
            pass
        try:
            # the reader may be parked in recv on a router that sends no
            # more: end its read side so it sees EOF now
            conn.shutdown(socket.SHUT_RD)
        except OSError:
            pass
        rx.join(timeout=5.0)
        return 0
    finally:
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        try:
            lsock.close()
        except OSError:
            pass
        if debug_ref[0] is not None:
            debug_ref[0].close()
        blackbox.uninstall(bb)
        telemetry.uninstall(tel)


# ----------------------------------------------------------------- router


# GC10: reached under the router's _restart_lock only through
# FleetRouter._spawn_host, a cold control plane (see there)
def _log_tail(path: str, n_bytes: int = 4000) -> str:  # graftcheck: disable=GC10
    """The end of a worker's log, for a spawn failure's message."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n_bytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


@dataclass
class _Entry:
    """One in-flight source request, retained until its exactly-once
    resolution. ``arrays`` are the decoded inputs — kept so a failover
    can re-dispatch without re-reading the (already consumed) source;
    ``gen`` is the fencing generation: only a result frame carrying the
    current value may resolve this entry."""
    rid: int
    payload: Any
    trace_id: str
    arrays: Tuple[np.ndarray, ...]
    priority: int = 0
    deadline_s: Optional[float] = None
    session: Optional[str] = None
    gen: int = 0
    host_id: int = -1
    attempts: int = 0
    t_admit: float = 0.0
    t_dispatch: float = 0.0


class _Host:
    """Router-side replica handle: process + data socket + live health /
    circuit / load state. All mutable state is guarded by the router
    lock; the socket is written only by this host's tx thread."""

    def __init__(self, host_id: int):
        self.id = host_id
        self.proc: Optional[subprocess.Popen] = None
        self.sock: Optional[socket.socket] = None
        self.debug_port: Optional[int] = None
        self.pid: Optional[int] = None
        self.state = "spawning"          # spawning|up|draining|down
        self.circuit = "closed"          # closed|open|half_open
        self.consec_fail = 0
        self.fail_since: Optional[float] = None
        self.opened_at: Optional[float] = None
        self.ewma_ms = 0.0
        self.inflight = 0
        self.queue_depth = 0             # last polled /debug/queues depth
        self.dispatched = 0
        self.resolved = 0
        self.outbox: "queue.Queue" = queue.Queue()
        self.tx: Optional[threading.Thread] = None
        self.rx: Optional[threading.Thread] = None
        self.incarnation = 0
        # the latest incarnation's start-up: launch time, seconds to its
        # portfile and to its first healthy poll
        self.t_launch: Optional[float] = None
        self.spawn_s: Optional[float] = None
        self.ready_s: Optional[float] = None
        # request frames this host's tx thread wrote, and its seconds
        # pickling and sending them (the send blocks while the worker's
        # socket buffer is full)
        self.tx_frames = 0
        self.tx_pickle_s = 0.0
        self.tx_send_s = 0.0
        # result frames this host's rx thread read: receive and unpickle
        self.rx_clock = _RxClock()

    @property
    def routable(self) -> bool:
        return self.state == "up" and self.circuit == "closed"


class _TxStop:
    pass


_TX_STOP = _TxStop()


class FleetRouter:
    """Front-end for N single-host serving processes (module docstring
    has the full contract). Duck-types the scheduler surface ``ServeDrain``
    and the debug/blackbox providers expect: ``serve(requests)`` yields
    one ``InferResult`` per source request, ``request_drain`` makes
    SIGTERM mean fleet-wide graceful drain, ``snapshot()`` is the live
    introspection document."""

    def __init__(self, factory: str, n_hosts: int, *,
                 factory_kw: Optional[Dict[str, Any]] = None,
                 workdir: str,
                 max_wait_s: float = 0.2,
                 max_pending: Optional[int] = None,
                 host_max_pending: Optional[int] = None,
                 drain_timeout: float = 30.0,
                 sessions: bool = False,
                 poll_interval_s: float = 0.25,
                 fail_threshold: int = 3,
                 probe_cooldown_s: float = 0.75,
                 down_after_s: float = 2.5,
                 max_failovers: int = 2,
                 spawn_timeout_s: float = 180.0,
                 health_timeout_s: float = 1.0,
                 stall_timeout_s: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self._factory = factory
        self._factory_kw = dict(factory_kw or {})
        self.n_hosts = n_hosts
        self._workdir = workdir
        self._max_wait_s = float(max_wait_s)
        self.max_pending = max_pending
        self._host_max_pending = host_max_pending
        self._drain_timeout = float(drain_timeout)
        self._sessions = bool(sessions)
        self._poll_interval_s = float(poll_interval_s)
        self._fail_threshold = int(fail_threshold)
        self._probe_cooldown_s = float(probe_cooldown_s)
        self._down_after_s = float(down_after_s)
        self._max_failovers = int(max_failovers)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._health_timeout_s = float(health_timeout_s)
        self._stall_timeout_s = (
            float(stall_timeout_s) if stall_timeout_s is not None
            else max(30.0, 2.0 * self._drain_timeout))
        self._env = dict(env) if env else None

        self._hosts: List[_Host] = [_Host(i) for i in range(n_hosts)]
        self._lock = threading.Lock()
        self._table: Dict[int, _Entry] = {}
        self._affinity: Dict[str, int] = {}
        self._out: "queue.Queue" = queue.Queue()
        self._next_rid = 0
        self._started = False
        self._closing = False
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._drain_t0: Optional[float] = None
        self._drain_done = False
        self._source_done = False
        self._n_source = 0
        self._source_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._admit_thread: Optional[threading.Thread] = None
        self._restart_lock = threading.Lock()
        # counters (snapshot / summary / chaos assertions)
        self.fenced = 0
        self.failovers = 0
        self.typed_losses = 0
        self.routed = 0
        self.shed = 0
        self.shed_reasons: Dict[str, int] = {}
        # each worker incarnation's receive side, from its last result frame
        self._worker_rx: Dict[Tuple[int, int], Dict[str, Any]] = {}
        blackbox.register_provider("fleet", self.snapshot)

    # ------------------------------------------------------ lifecycle

    def start(self) -> "FleetRouter":
        """Launch every worker at once, wait for each portfile handshake,
        connect the data sockets, and start the health poller. A worker
        that dies or stalls in its spawn fails the start, and the others
        are killed."""
        if self._started:
            return self
        self._started = True
        os.makedirs(self._workdir, exist_ok=True)
        launched = []
        try:
            for host in self._hosts:
                launched.append((host, self._launch_host(host)))
            for host, launch in launched:
                self._connect_host(host, *launch)
        except BaseException:
            self._abort_spawn([proc for _h, (proc, _p, _l) in launched])
            raise
        self._health_thread = threading.Thread(
            target=self._health_run, name="fleet-health", daemon=True)
        self._health_thread.start()
        return self

    def _abort_spawn(self, procs: List[subprocess.Popen]) -> None:
        self._closing = True
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
        for host in self._hosts:
            self._retire_io(host)

    # GC10: the spawn's file/subprocess I/O (in _launch_host, _connect_host
    # and _log_tail) runs under _restart_lock by design — that lock exists
    # only to serialize rolling restarts (a cold control plane); no
    # request-path thread ever takes it, so the blocking cannot convoy
    # serving. _lock, the request path's, is never held across it.
    def _spawn_host(self, host: _Host) -> None:
        self._connect_host(host, *self._launch_host(host))

    # GC10: under _restart_lock only through _spawn_host (see there)
    def _launch_host(self, host: _Host  # graftcheck: disable=GC10
                     ) -> Tuple[subprocess.Popen, str, str]:
        """Write one worker's spec and start its process; returns the
        process, its portfile and its log."""
        host.incarnation += 1
        tag = f"host{host.id}.{host.incarnation}"
        tel_dir = os.path.join(self._workdir, f"host{host.id}")
        portfile = os.path.join(self._workdir, f"{tag}.port.json")
        spec = {
            "factory": self._factory,
            "factory_kw": self._factory_kw,
            "host_id": host.id,
            "telemetry_dir": tel_dir,
            "portfile": portfile,
            "max_wait_s": self._max_wait_s,
            "max_pending": self._host_max_pending,
            "drain_timeout": self._drain_timeout,
            "sessions": self._sessions,
        }
        spec_path = os.path.join(self._workdir, f"{tag}.spec.json")
        # a stale portfile from a previous run in the same workdir would
        # short-circuit the handshake onto a dead port
        try:
            os.unlink(portfile)
        except OSError:
            pass
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        log_path = os.path.join(self._workdir, f"{tag}.log")
        env = dict(os.environ)
        # the worker must resolve `-m raft_stereo_tpu_torch.runtime.fleet` to
        # THIS package no matter the caller's cwd (the router may have
        # imported it off sys.path[0] rather than an installed dist)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        prior = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (pkg_root if not prior
                             else pkg_root + os.pathsep + prior)
        if self._env:
            env.update(self._env)
        host.t_launch = time.monotonic()
        host.spawn_s = host.ready_s = None
        with open(log_path, "ab") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "raft_stereo_tpu_torch.runtime.fleet",
                 "--spec", spec_path],
                stdout=logf, stderr=subprocess.STDOUT, env=env,
            )
        return proc, portfile, log_path

    # GC10: under _restart_lock only through _spawn_host (see there)
    def _connect_host(self, host: _Host,  # graftcheck: disable=GC10
                      proc: subprocess.Popen, portfile: str, log_path: str) -> None:
        """Wait for a launched worker's portfile, connect its data socket
        and start its tx/rx threads."""
        deadline = host.t_launch + self._spawn_timeout_s
        doc = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"fleet host {host.id} died during spawn "
                    f"(rc={proc.returncode}); log: {log_path}\n"
                    f"{_log_tail(log_path)}")
            try:
                with open(portfile) as f:
                    doc = json.load(f)
                break
            except (OSError, ValueError):
                time.sleep(0.05)
        if doc is None:
            proc.kill()
            raise RuntimeError(
                f"fleet host {host.id} did not hand back a portfile "
                f"within {self._spawn_timeout_s:.0f}s; log: {log_path}")
        sock = socket.create_connection(
            ("127.0.0.1", doc["data_port"]), timeout=10.0)
        sock.settimeout(None)
        with self._lock:
            host.spawn_s = time.monotonic() - host.t_launch
            host.proc = proc
            host.sock = sock
            host.debug_port = doc["debug_port"]
            host.pid = doc["pid"]
            host.state = "up"
            host.circuit = "closed"
            host.consec_fail = 0
            host.fail_since = None
            host.opened_at = None
            host.inflight = 0
            host.queue_depth = 0
            host.outbox = queue.Queue()
        host.tx = threading.Thread(
            target=self._tx_run, args=(host, sock, host.outbox),
            name="fleet-tx", daemon=True)
        host.rx = threading.Thread(
            target=self._rx_run, args=(host, sock, host.incarnation),
            name="fleet-rx", daemon=True)
        host.tx.start()
        host.rx.start()
        logger.info("fleet host %d up: pid=%d data=%d debug=%d",
                    host.id, doc["pid"], doc["data_port"], doc["debug_port"])

    # --------------------------------------------------------- serving

    def serve(self, requests: Iterable[Any]) -> Iterator[Any]:
        """Serve the stream through the fleet; yields exactly one
        ``InferResult`` per source request, in resolution order."""
        if not self._started:
            self.start()
        with self._lock:
            self._source_done = False
            self._n_source = 0
            self._source_error = None
        self._admit_thread = threading.Thread(
            target=self._admit_run, args=(requests,),
            name="fleet-admit", daemon=True)
        self._admit_thread.start()
        yielded = 0
        last_progress = time.monotonic()
        while True:
            with self._lock:
                src_done = self._source_done
                done = src_done and yielded >= self._n_source
            if done:
                break
            try:
                res = self._out.get(timeout=0.2)
            except queue.Empty:
                now = time.monotonic()
                self._enforce_drain_deadline(now)
                if src_done and now - last_progress \
                        > self._stall_timeout_s:
                    # liveness backstop: a resolution the failover
                    # machinery somehow lost still resolves typed — the
                    # exactly-once contract survives even a router bug
                    self._resolve_stalled()
                continue
            yielded += 1
            last_progress = time.monotonic()
            yield res
        if self._admit_thread is not None:
            self._admit_thread.join(timeout=10.0)
        if self._draining and not self._drain_done:
            self._finish_drain(forced=False)
        with self._lock:
            src_error = self._source_error
        if src_error is not None:
            raise src_error

    def _admit_run(self, requests: Iterable[Any]) -> None:
        """Admission thread ("fleet-admit"): decode, apply the global
        admission ladder, place on a host. The decode runs here — the
        arrays are retained per entry for failover re-dispatch."""
        from raft_stereo_tpu_torch.runtime.infer import InferRequest, InferResult

        n = 0
        try:
            for item in requests:
                n += 1
                inner = getattr(item, "request", item)
                payload = getattr(inner, "payload", None)
                tid = getattr(inner, "trace_id", None) \
                    or telemetry.new_trace_id()
                try:
                    if isinstance(inner, InferRequest):
                        arrays = inner.resolve()
                    else:
                        arrays = InferRequest(
                            payload=payload,
                            inputs=getattr(inner, "inputs", inner)).resolve()
                except Exception as e:  # noqa: BLE001 — typed decode error
                    self._out.put(InferResult(
                        payload=payload, error=e, trace_id=tid))
                    continue
                entry = _Entry(
                    rid=self._alloc_rid(), payload=payload, trace_id=tid,
                    arrays=arrays,
                    priority=getattr(item, "priority", 0) or 0,
                    deadline_s=getattr(item, "deadline_s", None),
                    session=getattr(item, "session", None),
                    t_admit=time.monotonic(),
                )
                shed = self._admission_shed(entry)
                if shed is not None:
                    self._out.put(InferResult(
                        payload=payload, error=shed, trace_id=tid))
                    continue
                host, reason = self._place(entry)
                if host is None:
                    with self._lock:
                        self.typed_losses += 1
                    self._out.put(InferResult(
                        payload=payload,
                        error=FleetHostError(
                            "no healthy replica to route to", host=None,
                            attempts=0),
                        trace_id=tid))
                    continue
                with self._lock:
                    self._table[entry.rid] = entry
                self._dispatch(entry, host, reason)
        except BaseException as e:  # noqa: BLE001 — surfaced by serve()
            with self._lock:
                self._source_error = e
        finally:
            with self._lock:
                self._n_source = n
                self._source_done = True

    def _alloc_rid(self) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            return rid

    def _admission_shed(self, entry: _Entry) -> Optional[Exception]:
        """The scheduler's typed admission ladder at fleet scope: drained
        / queue_full / deadline-unmeetable — all ``sched_shed`` events,
        all typed error resolutions, never silent."""
        from raft_stereo_tpu_torch.runtime.scheduler import DrainedError, ShedError

        with self._lock:
            depth = len(self._table)
            draining = self._draining
        if draining:
            self._note_shed("drained", depth)
            return DrainedError(
                "fleet draining: admission stopped")
        if self.max_pending is not None and depth >= self.max_pending:
            self._note_shed("queue_full", depth)
            return ShedError(
                f"fleet admission queue full ({depth} >= "
                f"{self.max_pending})", reason="queue_full")
        if entry.deadline_s is not None:
            est_ms = self._best_est_ms()
            if est_ms is not None and est_ms > entry.deadline_s * 1000.0:
                self._note_shed("deadline", depth,
                                deadline_ms=entry.deadline_s * 1000.0,
                                est_ms=est_ms)
                return ShedError(
                    f"deadline {entry.deadline_s * 1000.0:.0f}ms unmeetable:"
                    f" best replica estimate {est_ms:.0f}ms",
                    reason="deadline")
        return None

    def _note_shed(self, reason: str, depth: int,
                   deadline_ms: Optional[float] = None,
                   est_ms: Optional[float] = None) -> None:
        with self._lock:
            self.shed += 1
            self.shed_reasons[reason] = \
                self.shed_reasons.get(reason, 0) + 1
        telemetry.emit("sched_shed", reason=reason, bucket=None,
                       depth=depth, deadline_ms=deadline_ms, est_ms=est_ms)

    def _best_est_ms(self) -> Optional[float]:
        """Min over routable hosts of the EWMA-clocked queue estimate —
        the fleet's deadline-unmeetable bound. None until any host has a
        service-time observation (never shed on no evidence)."""
        best = None
        with self._lock:
            for host in self._hosts:
                if not host.routable or host.ewma_ms <= 0.0:
                    continue
                est = (host.inflight + host.queue_depth + 1) * host.ewma_ms
                if best is None or est < best:
                    best = est
        return best

    def _place(self, entry: _Entry,
               exclude: Optional[int] = None) -> Tuple[Optional[_Host], str]:
        """Pick the host for one request: session affinity while the
        pinned host is routable, else least estimated work. A brief
        retry window rides out a circuit probe so a transient blip does
        not turn into a typed loss."""
        deadline = time.monotonic() + min(2.0, self._down_after_s)
        while True:
            with self._lock:
                reason = "least_loaded"
                if entry.session is not None:
                    pinned = self._affinity.get(entry.session)
                    if pinned is not None and pinned != exclude \
                            and self._hosts[pinned].routable:
                        return self._hosts[pinned], "affinity"
                    reason = "migrate" if pinned is not None else "session"
                candidates = [h for h in self._hosts
                              if h.routable and h.id != exclude]
                if not candidates:
                    candidates = [h for h in self._hosts if h.routable]
                if candidates:
                    host = min(
                        candidates,
                        key=lambda h: ((h.inflight + h.queue_depth)
                                       * max(h.ewma_ms, 1.0), h.id))
                    if entry.session is not None:
                        self._affinity[entry.session] = host.id
                    return host, reason
                if self._draining or self._closing:
                    return None, "none"
            if time.monotonic() >= deadline:
                return None, "none"
            time.sleep(0.05)

    def _dispatch(self, entry: _Entry, host: _Host, reason: str) -> None:
        with self._lock:
            entry.host_id = host.id
            entry.t_dispatch = time.monotonic()
            host.inflight += 1
            host.dispatched += 1
            depth = len(self._table)
            est = (host.inflight + host.queue_depth) * host.ewma_ms
            self.routed += 1
        telemetry.emit(
            "fleet_route", host=host.id, reason=reason,
            session=entry.session, depth=depth,
            est_ms=round(est, 1), trace_id=entry.trace_id)
        host.outbox.put({
            "kind": "req", "rid": entry.rid, "gen": entry.gen,
            "arrays": entry.arrays, "priority": entry.priority,
            "deadline_s": entry.deadline_s, "session": entry.session,
            "trace_id": entry.trace_id,
        })

    # --------------------------------------------------- host I/O threads

    def _tx_run(self, host: _Host, sock: socket.socket,
                outbox: "queue.Queue") -> None:
        """Per-host writer ("fleet-tx"): the only thread that writes this
        host's socket, so a hung worker (full socket buffer) can never
        wedge admission or failover — the blocking send is isolated
        here."""
        while True:
            frame = outbox.get()
            if isinstance(frame, _TxStop):
                return
            t0 = time.perf_counter()
            data = _pack_frame(frame)
            t1 = time.perf_counter()
            try:
                sock.sendall(data)
            except OSError:
                if not self._closing:
                    self._host_down(host, "send_error")
                return
            if frame.get("kind") == "req":
                with self._lock:
                    host.tx_frames += 1
                    host.tx_pickle_s += t1 - t0
                    host.tx_send_s += time.perf_counter() - t1

    def _rx_run(self, host: _Host, sock: socket.socket,
                incarnation: int) -> None:
        """Per-host reader ("fleet-rx"): result frames resolve (or fence,
        or fail over) their entries; EOF means the worker is gone."""
        timing: Dict[str, float] = {}
        while True:
            frame = _recv_frame(sock, timing)
            if frame is None:
                with self._lock:
                    stale = host.incarnation != incarnation
                    state = host.state
                if stale or self._closing or state == "down":
                    return
                self._host_down(
                    host,
                    "drain_exit" if state == "draining" else "conn_lost")
                return
            if frame.get("kind") == "res":
                host.rx_clock.add(timing)
                self._on_result(host, incarnation, frame)

    def _on_result(self, host: _Host, incarnation: int,
                   frame: Dict[str, Any]) -> None:
        from raft_stereo_tpu_torch.runtime.infer import InferResult

        with self._lock:
            if frame.get("rx") is not None:
                # the worker's receive side, cumulative in its incarnation
                self._worker_rx[(host.id, incarnation)] = frame["rx"]
            entry = self._table.get(frame["rid"])
            current = (entry is not None and entry.gen == frame["gen"]
                       and host.incarnation == incarnation)
            if not current:
                # generation fence: a late result from a host already
                # declared down (its entries re-dispatched at gen+1) —
                # or from a previous incarnation — must never resolve
                self.fenced += 1
                return
            host.resolved += 1
            if host.inflight > 0:
                host.inflight -= 1
            if frame["ok"]:
                dt_ms = (time.monotonic() - entry.t_dispatch) * 1000.0
                host.ewma_ms = (dt_ms if host.ewma_ms == 0.0
                                else 0.8 * host.ewma_ms + 0.2 * dt_ms)
        if not frame["ok"] and frame.get("reason") is not None \
                and not self._draining and not self._closing:
            # a worker-side lifecycle rejection (its own drain or
            # overload) is the router's problem, not the caller's: retry
            # on another replica while budget and capacity allow
            if self._try_failover(entry, from_host=host.id):
                return
        error = None if frame["ok"] else self._rebuild_error(frame)
        self._resolve(entry, InferResult(
            payload=entry.payload, output=frame.get("output"),
            bucket=frame.get("bucket"), error=error,
            trace_id=entry.trace_id))

    @staticmethod
    def _rebuild_error(frame: Dict[str, Any]) -> Exception:
        """Reconstruct the worker's typed error across the wire; the
        lifecycle types keep their identity (chaos budgets key on them),
        anything else arrives as a RuntimeError tagged with its type."""
        from raft_stereo_tpu_torch.runtime import scheduler as sched_mod

        etype, emsg = frame.get("etype"), frame.get("emsg") or ""
        cls = getattr(sched_mod, str(etype), None)
        if cls is not None and isinstance(cls, type) \
                and issubclass(cls, Exception):
            try:
                if issubclass(cls, sched_mod.ShedError) \
                        and cls is not sched_mod.DrainedError:
                    return cls(emsg, reason=frame.get("reason") or "shed")
                return cls(emsg)
            except TypeError:
                pass
        return RuntimeError(f"{etype}: {emsg}")

    def _resolve(self, entry: _Entry, result: Any) -> None:
        with self._lock:
            if self._table.pop(entry.rid, None) is None:
                self.fenced += 1
                return
        self._out.put(result)

    # ------------------------------------------------- failure handling

    def _host_down(self, host: _Host, reason: str) -> None:
        """Declare one host down (idempotent) and fail its in-flight
        requests over. The process is deliberately NOT killed here: a
        zombie that answers late is exactly what the generation fence
        exists for."""
        with self._lock:
            if host.state == "down":
                return
            host.state = "down"
            host.circuit = "open"
            moved = [e for e in self._table.values()
                     if e.host_id == host.id]
        telemetry.emit(
            "fleet_host_down", host=host.id, reason=reason,
            inflight=len(moved), pid=host.pid)
        logger.warning("fleet host %d down (%s): %d request(s) in flight",
                       host.id, reason, len(moved))
        for entry in moved:
            self._try_failover(entry, from_host=host.id, forced=True)

    def _try_failover(self, entry: _Entry, *, from_host: int,
                      forced: bool = False) -> bool:
        """Exactly-once failover for one entry: bump the generation (the
        fence), re-dispatch within budget, resolve typed past it.
        Returns False only when the entry should resolve with its
        original (non-forced) result instead."""
        from raft_stereo_tpu_torch.runtime.infer import InferResult
        from raft_stereo_tpu_torch.runtime.scheduler import DrainedError

        with self._lock:
            if entry.rid not in self._table:
                return True  # already resolved (or fenced) elsewhere
            entry.gen += 1
            entry.attempts += 1
            attempts = entry.attempts
        if self._draining and forced:
            telemetry.emit(
                "fleet_failover", host=None, from_host=from_host,
                attempt=attempts, outcome="typed_error",
                trace_id=entry.trace_id)
            self._resolve(entry, InferResult(
                payload=entry.payload,
                error=DrainedError(
                    "fleet drain cut the failover short"),
                trace_id=entry.trace_id))
            return True
        target = None
        if attempts <= self._max_failovers:
            target, _reason = self._place(entry, exclude=from_host)
        if target is None:
            if not forced:
                with self._lock:
                    entry.gen -= 1
                    entry.attempts -= 1
                return False
            with self._lock:
                self.typed_losses += 1
            telemetry.emit(
                "fleet_failover", host=None, from_host=from_host,
                attempt=attempts, outcome="typed_error",
                trace_id=entry.trace_id)
            self._resolve(entry, InferResult(
                payload=entry.payload,
                error=FleetHostError(
                    f"request lost with host {from_host} after "
                    f"{attempts} attempt(s)", host=from_host,
                    attempts=attempts),
                trace_id=entry.trace_id))
            return True
        with self._lock:
            self.failovers += 1
        telemetry.emit(
            "fleet_failover", host=target.id, from_host=from_host,
            attempt=attempts, outcome="redispatch",
            trace_id=entry.trace_id)
        self._dispatch(entry, target,
                       "migrate" if entry.session is not None
                       else "failover")
        return True

    # ------------------------------------------------------ health poll

    def _health_run(self) -> None:
        """Health poller ("fleet-health"): process liveness, /healthz,
        /debug/queues depths, and the per-host circuit breaker state
        machine — closed -> open on consecutive failures, open ->
        half_open after the cooldown, half_open -> closed on one good
        probe (or back to open on a bad one). A host unhealthy past
        ``down_after_s`` is declared down."""
        while not self._stop.wait(self._poll_interval_s):
            for host in list(self._hosts):
                with self._lock:
                    state = host.state
                    proc = host.proc
                if state in ("down", "spawning") or proc is None:
                    continue
                if proc.poll() is not None:
                    if state == "draining":
                        # planned exit: the rx EOF path resolves/fails
                        # over whatever the drain left behind
                        continue
                    self._host_down(host, "exit")
                    continue
                if host.circuit == "open" and host.opened_at is not None \
                        and time.monotonic() - host.opened_at \
                        >= self._probe_cooldown_s:
                    self._circuit(host, "half_open", "probe")
                ok, doc = self._poll_host(host)
                now = time.monotonic()
                if ok:
                    with self._lock:
                        host.consec_fail = 0
                        host.fail_since = None
                        self._note_ready(host, now)
                    if host.circuit != "closed":
                        self._circuit(host, "closed", "probe_ok")
                    if doc.get("draining") and host.state == "up":
                        with self._lock:
                            host.state = "draining"
                    continue
                with self._lock:
                    host.consec_fail += 1
                    if host.fail_since is None:
                        host.fail_since = now
                    fails = host.consec_fail
                    fail_since = host.fail_since
                if host.circuit == "closed" \
                        and fails >= self._fail_threshold:
                    self._circuit(host, "open", "health_fail")
                elif host.circuit == "half_open":
                    self._circuit(host, "open", "probe_fail")
                if now - fail_since >= self._down_after_s \
                        and host.state != "down":
                    self._host_down(host, "health")

    @staticmethod
    def _note_ready(host: _Host, now: float) -> None:
        """First healthy poll of this incarnation (router lock held)."""
        if host.ready_s is None and host.t_launch is not None:
            host.ready_s = now - host.t_launch

    def _circuit(self, host: _Host, state: str, reason: str) -> None:
        with self._lock:
            if host.circuit == state:
                return
            host.circuit = state
            host.opened_at = time.monotonic() if state == "open" else None
            fails = host.consec_fail
        telemetry.emit("fleet_circuit_open", host=host.id, state=state,
                       failures=fails, reason=reason)

    def _poll_host(self, host: _Host) -> Tuple[bool, Dict[str, Any]]:
        import urllib.request

        if host.debug_port is None:
            return False, {}
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{host.debug_port}/healthz",
                    timeout=self._health_timeout_s) as r:
                doc = json.loads(r.read())
        except Exception:  # noqa: BLE001 — any failure is a health miss
            return False, {}
        if not doc.get("ok"):
            return False, doc
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{host.debug_port}/debug/queues",
                    timeout=self._health_timeout_s) as r:
                queues = json.loads(r.read())
        except Exception:  # noqa: BLE001 — depths are advisory
            queues = {}
        depth = 0
        for snap in (queues or {}).values():
            if isinstance(snap, dict):
                d = snap.get("pending_depth")
                if d is None:
                    d = sum(
                        b.get("pending", 0)
                        for b in (snap.get("buckets") or {}).values()
                        if isinstance(b, dict))
                depth += int(d or 0)
        with self._lock:
            host.queue_depth = depth
        return True, doc

    # ------------------------------------------------------ drain/restart

    def request_drain(self, timeout_s: Optional[float] = None) -> None:
        """Fleet-wide graceful drain (the scheduler surface ``ServeDrain``
        calls on the first SIGTERM): stop admission, SIGTERM every
        worker (each drains its own scheduler), resolve what cannot
        finish in time as typed drained errors. Non-blocking — the serve
        loop enforces the deadline."""
        timeout = self._drain_timeout if timeout_s is None else timeout_s
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._drain_t0 = time.monotonic()
            self._drain_deadline = self._drain_t0 + float(timeout)
            pending = len(self._table)
            up = [h for h in self._hosts if h.state == "up"]
        telemetry.emit("fleet_drain", host=None, phase="begin",
                       pending=pending)
        for host in up:
            with self._lock:
                host.state = "draining"
            self._signal_host(host, signal.SIGTERM)

    def _signal_host(self, host: _Host, sig: int) -> None:
        proc = host.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(sig)
        except OSError:
            pass

    def _enforce_drain_deadline(self, now: float) -> None:
        if not self._draining or self._drain_done:
            return
        with self._lock:
            deadline = self._drain_deadline
            empty = not self._table
        if empty:
            self._finish_drain(forced=False)
        elif deadline is not None and now >= deadline:
            self._finish_drain(forced=True)

    def _finish_drain(self, *, forced: bool) -> None:
        from raft_stereo_tpu_torch.runtime.infer import InferResult
        from raft_stereo_tpu_torch.runtime.scheduler import DrainedError

        with self._lock:
            if self._drain_done:
                return
            self._drain_done = True
            leftovers = list(self._table.values())
            t0 = self._drain_t0 or time.monotonic()
        for entry in leftovers:
            with self._lock:
                entry.gen += 1  # fence any still-running worker attempt
            self._resolve(entry, InferResult(
                payload=entry.payload,
                error=DrainedError(
                    "fleet drain timeout: request resolved as drained"),
                trace_id=entry.trace_id))
        telemetry.emit(
            "fleet_drain", host=None, phase="complete",
            pending=len(leftovers),
            duration_ms=round((time.monotonic() - t0) * 1000.0, 1))
        if forced:
            logger.warning(
                "fleet drain deadline: %d request(s) resolved as drained",
                len(leftovers))

    def rolling_restart(self,
                        wait_healthy_s: Optional[float] = None) -> None:
        """Restart every host one at a time — drain (SIGTERM), respawn,
        wait healthy, next — so capacity never drops below N-1 and no
        request fails: a drained worker completes its in-flight work,
        and whatever its drain could not finish fails over to the other
        replicas."""
        wait_s = (self._spawn_timeout_s if wait_healthy_s is None
                  else wait_healthy_s)
        with self._restart_lock:
            for host in list(self._hosts):
                t0 = time.monotonic()
                with self._lock:
                    alive = host.state in ("up", "draining")
                    pending = host.inflight
                if alive:
                    telemetry.emit("fleet_drain", host=host.id,
                                   phase="begin", pending=pending)
                    with self._lock:
                        if host.state == "up":
                            host.state = "draining"
                    self._signal_host(host, signal.SIGTERM)
                    deadline = time.monotonic() + self._drain_timeout + 10.0
                    while time.monotonic() < deadline:
                        if host.proc is None \
                                or host.proc.poll() is not None:
                            break
                        time.sleep(0.05)
                    else:
                        self._signal_host(host, signal.SIGKILL)
                    # the rx EOF path has now failed over any leftovers;
                    # wait for it so the old socket is fully retired
                    if host.rx is not None:
                        host.rx.join(timeout=5.0)
                    telemetry.emit(
                        "fleet_drain", host=host.id, phase="complete",
                        duration_ms=round(
                            (time.monotonic() - t0) * 1000.0, 1))
                self._retire_io(host)
                self._spawn_host(host)
                self._wait_healthy(host, wait_s)

    def _wait_healthy(self, host: _Host, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ok, _doc = self._poll_host(host)
            if ok:
                with self._lock:
                    self._note_ready(host, time.monotonic())
                return
            time.sleep(0.1)
        raise RuntimeError(
            f"fleet host {host.id} did not turn healthy within "
            f"{timeout_s:.0f}s after restart")

    def _retire_io(self, host: _Host) -> None:
        host.outbox.put(_TX_STOP)
        if host.tx is not None:
            host.tx.join(timeout=5.0)
        if host.sock is not None:
            try:
                host.sock.close()
            except OSError:
                pass
        if host.rx is not None:
            host.rx.join(timeout=5.0)
        host.tx = host.rx = None
        host.sock = None

    # -------------------------------------------------------- inspection

    def host_pid(self, host_id: int) -> Optional[int]:
        return self._hosts[host_id].pid

    def inject_health_blackhole(self, host_id: int) -> None:
        """Chaos hook: make one worker's health endpoint vanish while its
        data path keeps serving — the router must recover on health
        evidence alone."""
        self._hosts[host_id].outbox.put(
            {"kind": "fi", "what": "health_blackhole"})

    @property
    def stats(self) -> "FleetRouter":
        return self  # duck-types scheduler.stats for ServeDrain logging

    @property
    def admitted(self) -> int:
        return self.routed

    def snapshot(self) -> Dict[str, Any]:
        """Live fleet document (blackbox provider + debug surfaces)."""
        with self._lock:
            return {
                "kind": "fleet",
                "n_hosts": self.n_hosts,
                "draining": self._draining,
                "pending_depth": len(self._table),
                "routed": self.routed,
                "failovers": self.failovers,
                "fenced": self.fenced,
                "typed_losses": self.typed_losses,
                "shed": dict(self.shed_reasons),
                "sessions": len(self._affinity),
                "hosts": {
                    str(h.id): {
                        "state": h.state, "circuit": h.circuit,
                        "pid": h.pid, "inflight": h.inflight,
                        "queue_depth": h.queue_depth,
                        "ewma_ms": round(h.ewma_ms, 2),
                        "dispatched": h.dispatched,
                        "resolved": h.resolved,
                        "consec_fail": h.consec_fail,
                        "incarnation": h.incarnation,
                        "spawn_s": h.spawn_s,
                        "ready_s": h.ready_s,
                    } for h in self._hosts
                },
                "wire": self._wire_locked(),
            }

    def _wire_locked(self) -> Dict[str, Any]:
        """The wire's cost a frame, in ms: the router's pickle and send of
        each request frame; the workers' receive (length header to last
        byte) and unpickle of it, as their result frames last reported;
        the router's receive and unpickle of each result frame."""
        def ms(total_s, n):
            return 1e3 * total_s / n if n else None

        n = sum(h.tx_frames for h in self._hosts)
        worker = list(self._worker_rx.values())
        n_w = sum(d["frames"] for d in worker)
        results = [h.rx_clock.doc() for h in self._hosts]
        n_r = sum(d["frames"] for d in results)
        return {"frames": n,
                "pickle_ms": ms(sum(h.tx_pickle_s for h in self._hosts), n),
                "send_ms": ms(sum(h.tx_send_s for h in self._hosts), n),
                "worker_frames": n_w,
                "worker_recv_ms": ms(sum(d["recv_s"] for d in worker), n_w),
                "worker_unpickle_ms": ms(sum(d["unpickle_s"] for d in worker), n_w),
                "result_frames": n_r,
                "result_recv_ms": ms(sum(d["recv_s"] for d in results), n_r),
                "result_unpickle_ms": ms(sum(d["unpickle_s"] for d in results), n_r)}

    def summary(self) -> Dict[str, Any]:
        return self.snapshot()

    def _resolve_stalled(self) -> None:
        from raft_stereo_tpu_torch.runtime.infer import InferResult

        with self._lock:
            stalled = list(self._table.values())
        for entry in stalled:
            with self._lock:
                entry.gen += 1
                self.typed_losses += 1
            telemetry.emit(
                "fleet_failover", host=None, from_host=entry.host_id,
                attempt=entry.attempts, outcome="typed_error",
                trace_id=entry.trace_id)
            self._resolve(entry, InferResult(
                payload=entry.payload,
                error=FleetHostError(
                    "fleet stalled: request resolved as typed loss",
                    host=entry.host_id, attempts=entry.attempts),
                trace_id=entry.trace_id))

    # ------------------------------------------------------------- close

    def close(self) -> None:
        """Tear the fleet down: stop workers (graceful stop frame, then
        SIGTERM, then SIGKILL), join every router thread. Idempotent."""
        if self._closing:
            return
        self._closing = True
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
        for host in self._hosts:
            if host.sock is not None and host.state != "down":
                host.outbox.put({"kind": "stop"})
        deadline = time.monotonic() + max(5.0, self._drain_timeout)
        for host in self._hosts:
            proc = host.proc
            if proc is None:
                continue
            if host.state == "down":
                # an already-declared-down host (possibly a hung zombie)
                # gets no grace: its requests were failed over long ago
                self._signal_host(host, signal.SIGKILL)
            else:
                while proc.poll() is None and time.monotonic() < deadline:
                    time.sleep(0.05)
                if proc.poll() is None:
                    self._signal_host(host, signal.SIGTERM)
                    try:
                        proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        self._signal_host(host, signal.SIGKILL)
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
            self._retire_io(host)
        if self._admit_thread is not None:
            self._admit_thread.join(timeout=5.0)

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m raft_stereo_tpu_torch.runtime.fleet --spec SPEC`` is the
    worker entrypoint the router spawns; there is no other CLI here (the
    operator CLI is ``raft_stereo_tpu_torch.serve_fleet``)."""
    return worker_main(argv)


if __name__ == "__main__":
    sys.exit(main())

"""The port's replica fleet on the CPU (``raft_stereo_tpu_torch/runtime/fleet.py``
and ``serve_fleet.py``): the ten cases of ``tests/test_fleet.py`` under their
names, on the port's router and worker processes with the port's toy
engine; frames written by the JAX router read by the port's and the
reverse; the toy engine against the JAX toy; and the router's events
against the JAX router's. (The CLI, a worker without its card, and MADNet2
against the JAX engine are ``tests/test_torch_port_fleet_cli.py``.)

Every worker is spawned with ``device="cpu"`` and one intra-op thread,
under the router's spawn timeout, so a stuck worker fails its test instead
of hanging the suite. The toy engine and the fleet are held to a single
host bitwise.
"""

import ast
import hashlib
import json
import os
import signal
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_stereo_tpu import serve_fleet as jax_serve_fleet
from raft_stereo_tpu.runtime import fleet as jax_fleet
from raft_stereo_tpu.runtime import infer as jinfer
from raft_stereo_tpu.runtime import telemetry as jtelemetry
from raft_stereo_tpu_torch import serve_fleet
from raft_stereo_tpu_torch.runtime import fleet, telemetry
from raft_stereo_tpu_torch.runtime.fleet import (
    FleetHostError,
    FleetRouter,
    _recv_frame,
    _resolve_factory,
    _send_frame,
)
from raft_stereo_tpu_torch.runtime.infer import InferRequest
from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest, ShedError

SHAPES = ((24, 48), (40, 72))
TOY_KW = {"model": "toy", "device": "cpu", "batch": 2, "infer_timeout": 6.0,
          "retries": 1, "warm": False}
# the workers share the machine's cores with the other test workers
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SPAWN_TIMEOUT_S = 60.0
FLEET_EVENTS = ("fleet_route", "fleet_host_down", "fleet_failover", "fleet_circuit_open",
                "fleet_drain")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _requests(n, seed=0, session_of=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = SHAPES[i % len(SHAPES)]
        req = InferRequest(
            payload=i,
            inputs=(rng.rand(h, w, 3).astype(np.float32),
                    rng.rand(h, w, 3).astype(np.float32)),
        )
        if session_of is not None:
            req = SchedRequest(req, session=session_of(i))
        out.append(req)
    return out


def _sha(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _router(tmp_path, n_hosts=2, factory_kw=None, **kw):
    kwargs = dict(
        factory_kw=dict(TOY_KW, **(factory_kw or {})),
        workdir=str(tmp_path / "fleet"),
        max_wait_s=0.1,
        poll_interval_s=0.1,
        fail_threshold=3,
        probe_cooldown_s=0.4,
        down_after_s=1.2,
        drain_timeout=8.0,
        spawn_timeout_s=SPAWN_TIMEOUT_S,
        env=WORKER_ENV,
    )
    kwargs.update(kw)
    return FleetRouter(serve_fleet.FACTORY, n_hosts, **kwargs)


@pytest.fixture
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    yield t
    telemetry.uninstall(t)


def _events(tmp_path, name=None):
    path = tmp_path / "tel" / "events.jsonl"
    if not path.exists():
        return []
    with open(path) as f:
        evs = [json.loads(line) for line in f if line.strip()]
    return [e for e in evs if name is None or e.get("event") == name]


# ---------------------------------------------------------- wire protocol


class TestWireProtocol:
    def test_roundtrip_preserves_arrays(self):
        a, b = socket.socketpair()
        try:
            frame = {
                "kind": "req", "rid": 7, "gen": 2,
                "arrays": (np.arange(12, dtype=np.float32).reshape(3, 4),),
                "session": "s1",
            }
            _send_frame(a, frame)
            got = _recv_frame(b)
            assert got["kind"] == "req" and got["rid"] == 7
            assert got["gen"] == 2 and got["session"] == "s1"
            np.testing.assert_array_equal(got["arrays"][0], frame["arrays"][0])
        finally:
            a.close()
            b.close()

    def test_eof_and_torn_frame_read_as_none(self):
        a, b = socket.socketpair()
        a.close()
        assert _recv_frame(b) is None  # clean EOF
        b.close()
        a, b = socket.socketpair()
        try:
            # a length header promising bytes that never arrive
            a.sendall(b"\x00\x00\x00\xff" + b"xx")
            a.close()
            assert _recv_frame(b) is None
        finally:
            b.close()

    def test_factory_spec_validation(self):
        with pytest.raises(ValueError, match="module:function"):
            _resolve_factory("not-a-factory")

    @pytest.mark.parametrize("writer", ["jax_to_port", "port_to_jax"])
    def test_frames_cross_between_the_packages(self, writer):
        """Frames carry numpy arrays on the host, so a JAX router and a
        port worker (or the reverse) read each other's frames bitwise."""
        send, recv = ((jax_fleet._send_frame, _recv_frame) if writer == "jax_to_port"
                      else (_send_frame, jax_fleet._recv_frame))
        rng = np.random.RandomState(3)
        frame = {"kind": "req", "rid": 11, "gen": 1, "priority": 2, "deadline_s": 0.5,
                 "session": "video0", "trace_id": "t-11",
                 "arrays": (rng.rand(37, 61, 3).astype(np.float32),
                            (rng.rand(37, 61, 3) * 255).astype(np.float32))}
        result = {"kind": "res", "rid": 11, "gen": 1, "ok": True, "bucket": (64, 64),
                  "trace_id": "t-11", "output": rng.rand(37, 61, 1).astype(np.float32),
                  "etype": None, "emsg": None, "reason": None}
        a, b = socket.socketpair()
        try:
            for sent in (frame, result, {"kind": "bye"}):
                # the socket buffer is smaller than a frame: write on a thread
                t = threading.Thread(target=send, args=(a, sent))
                t.start()
                got = recv(b)
                t.join(timeout=10.0)
                assert not t.is_alive()
                assert set(got) == set(sent)
                for k, v in sent.items():
                    if k == "arrays":
                        assert all(x.dtype == y.dtype and _sha(x) == _sha(y)
                                   for x, y in zip(got[k], v))
                    elif isinstance(v, np.ndarray):
                        assert got[k].dtype == v.dtype and _sha(got[k]) == _sha(v)
                    else:
                        assert got[k] == v
        finally:
            a.close()
            b.close()


# -------------------------------------------------------- serving contracts


class TestFleetServing:
    def test_fault_free_bit_identical_to_single_host(self, tmp_path, tel):
        n = 10
        with _router(tmp_path) as router:
            results = {res.payload: res for res in router.serve(iter(_requests(n)))}
            deadline = time.monotonic() + 10.0  # the first health polls may trail the serve
            while time.monotonic() < deadline and any(
                    h["ready_s"] is None for h in router.snapshot()["hosts"].values()):
                time.sleep(0.05)
            snap = router.snapshot()
        assert sorted(results) == list(range(n))
        assert all(res.ok for res in results.values())

        engine = serve_fleet.build_engine(dict(TOY_KW))
        single = {res.payload: res for res in engine.stream(_requests(n))}
        for i in range(n):
            assert _sha(results[i].output) == _sha(single[i].output), (
                f"request {i}: fleet output differs from single-host")
        routes = _events(tmp_path, "fleet_route")
        assert len(routes) == n
        assert {e["host"] for e in routes} == {0, 1}  # both replicas used
        assert not _events(tmp_path, "fleet_host_down")
        # what a replica costs: start-up seconds and the router's wire time
        for h in snap["hosts"].values():
            assert 0 < h["spawn_s"] <= h["ready_s"] < SPAWN_TIMEOUT_S
        wire = snap["wire"]
        assert wire["frames"] == n and wire["pickle_ms"] > 0
        # each worker had read every request it answered before its last result
        assert wire["worker_frames"] == n and wire["result_frames"] == n
        assert all(wire[k] > 0 for k in ("worker_recv_ms", "worker_unpickle_ms",
                                         "result_recv_ms", "result_unpickle_ms"))

    def test_sigkill_failover_exactly_once(self, tmp_path, tel):
        n = 16
        seen = {}
        with _router(tmp_path) as router:
            it = router.serve(iter(_requests(n)))
            first = next(it)
            seen[first.payload] = 1
            os.kill(router.host_pid(0), signal.SIGKILL)
            for res in it:
                seen[res.payload] = seen.get(res.payload, 0) + 1
                if not res.ok:
                    assert isinstance(res.error, FleetHostError), res.error
            snap = router.snapshot()
        assert sorted(seen) == list(range(n))
        assert all(c == 1 for c in seen.values()), "double resolution"
        assert snap["hosts"]["0"]["state"] == "down"
        downs = _events(tmp_path, "fleet_host_down")
        assert downs and downs[0]["host"] == 0
        assert _events(tmp_path, "fleet_failover"), (
            "host died mid-stream but no failover decision was logged")

    def test_admission_sheds_typed_over_max_pending(self, tmp_path, tel):
        n = 12
        with _router(tmp_path, max_pending=2) as router:
            results = list(router.serve(iter(_requests(n))))
        assert len(results) == n
        shed = [r for r in results if not r.ok]
        assert shed, "max_pending=2 under a 12-request flood never shed"
        for res in shed:
            assert isinstance(res.error, ShedError)
            assert res.error.reason == "queue_full"
        assert router.stats.shed_reasons.get("queue_full") == len(shed)
        evs = _events(tmp_path, "sched_shed")
        assert len([e for e in evs if e["reason"] == "queue_full"]) == len(shed)

    def test_close_is_idempotent_and_leak_free(self, tmp_path, tel):
        router = _router(tmp_path)
        with router:
            list(router.serve(iter(_requests(4))))
        router.close()  # second close: no-op
        time.sleep(0.3)
        alive = [t.name for t in threading.enumerate() if t.name.startswith("fleet-")]
        assert alive == [], f"router threads leaked: {alive}"
        for h in router._hosts:
            assert h.proc.poll() is not None, f"host {h.id} outlived close()"

    def test_rolling_restart_zero_failed_requests(self, tmp_path, tel):
        n = 30

        def paced():
            for req in _requests(n):
                yield req
                time.sleep(0.05)

        with _router(tmp_path) as router:
            it = router.serve(paced())
            results = [next(it) for _ in range(6)]
            restarter = threading.Thread(target=router.rolling_restart, daemon=True)
            restarter.start()
            results.extend(it)
            restarter.join(timeout=90.0)
            assert not restarter.is_alive()
            snap = router.snapshot()
        assert len(results) == n
        assert all(res.ok for res in results), [str(r.error) for r in results if not r.ok]
        for h in ("0", "1"):
            assert snap["hosts"][h]["incarnation"] == 2
            assert snap["hosts"][h]["state"] == "up"
        drains = _events(tmp_path, "fleet_drain")
        assert {e.get("host") for e in drains if e.get("phase") == "begin"} == {0, 1}

    def test_zombie_results_are_fenced_never_double_resolved(self, tmp_path, tel):
        # A paced stream keeps work flowing onto the SIGSTOPped host until
        # the router declares it down (in-flight fails over, gens bumped);
        # the SIGCONT zombie then completes and sends the STALE
        # generations: every one must hit the fence, never a second
        # resolution.
        n = 20
        seen = {}

        def paced():
            for req in _requests(n):
                yield req
                time.sleep(0.06)

        with _router(tmp_path) as router:
            it = router.serve(paced())
            first = next(it)
            seen[first.payload] = 1
            pid = router.host_pid(1)
            os.kill(pid, signal.SIGSTOP)
            # resume well after the router's down bound (down_after_s=1.2
            # + ~1s/poll while the health read times out) so the host is
            # always declared down first
            timer = threading.Timer(3.5, lambda: os.kill(pid, signal.SIGCONT))
            timer.start()
            try:
                for res in it:
                    seen[res.payload] = seen.get(res.payload, 0) + 1
                downs = _events(tmp_path, "fleet_host_down")
                assert downs and downs[0]["host"] == 1
                if downs[0].get("inflight"):
                    # the zombie held fenced work: wait for its late
                    # results to arrive and be counted at the fence
                    deadline = time.monotonic() + 6.0
                    while (time.monotonic() < deadline
                           and router.snapshot()["fenced"] == 0):
                        time.sleep(0.1)
                    assert router.snapshot()["fenced"] >= 1
            finally:
                timer.cancel()
                try:
                    os.kill(pid, signal.SIGCONT)
                except (ProcessLookupError, OSError):
                    pass
        assert sorted(seen) == list(range(n))
        assert all(c == 1 for c in seen.values()), "zombie double-resolve"

    def test_session_affinity_pins_and_migrates_on_host_loss(self, tmp_path, tel):
        n = 16
        reqs = _requests(n, session_of=lambda i: f"s{i % 2}")

        def paced():
            for req in reqs:
                yield req
                time.sleep(0.05)

        with _router(tmp_path, factory_kw={"warm": True}, sessions=True) as router:
            it = router.serve(paced())
            results = [next(it) for _ in range(4)]
            routes = _events(tmp_path, "fleet_route")
            by_session = {}
            for e in routes:
                if e.get("session"):
                    by_session.setdefault(e["session"], set()).add(e["host"])
            assert by_session, "session tags never reached fleet_route"
            for hosts in by_session.values():
                assert len(hosts) == 1, "affinity split a session"
            victim = routes[0]["host"]
            os.kill(router.host_pid(victim), signal.SIGKILL)
            results.extend(it)
        assert sorted(r.payload for r in results) == list(range(n))
        reasons = {e["reason"] for e in _events(tmp_path, "fleet_route")}
        assert "affinity" in reasons
        assert "migrate" in reasons or "failover" in reasons, (
            f"no migration after killing the pinned host: {reasons}")
        # the migrated session's first frame on its new host cold-starts
        # (typed reset), read from the survivor's own telemetry
        survivor = 1 - victim
        path = tmp_path / "fleet" / f"host{survivor}" / "events.jsonl"
        warm = [json.loads(line) for line in path.read_text().splitlines()
                if '"session_warm_start"' in line]
        assert any(not e["warm"] for e in warm)


# ----------------------------------------------- the port's own contracts


def test_toy_engine_is_the_jax_toy_arithmetic():
    """The port's toy forward, ``(a * 2 - b)`` summed over channels, on the
    JAX toy engine's inputs: the same values."""
    reqs = _requests(6)
    jengine = jax_serve_fleet.build_engine({"model": "toy", "batch": 2, "infer_timeout": 30.0})
    want = {r.payload: r.output for r in jengine.stream(iter(
        [jinfer.InferRequest(payload=r.payload, inputs=r.inputs) for r in reqs]))}
    got = {r.payload: r.output for r in serve_fleet.build_engine(dict(TOY_KW)).stream(reqs)}
    assert sorted(got) == sorted(want) == list(range(6))
    for i in range(6):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=1e-6)


def _emits(path):
    """``telemetry.emit`` calls in a module: event name → keyword names."""
    out = {}
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit" and node.args
                and isinstance(node.args[0], ast.Constant)):
            out.setdefault(node.args[0].value, set()).add(
                tuple(sorted(k.arg for k in node.keywords)))
    return out


def test_events_match_the_jax_router():
    """Every event the port's router emits, with the same fields at every
    call, as the JAX router's; the five fleet events declared alike."""
    got = _emits(fleet.__file__)
    want = _emits(jax_fleet.__file__)
    assert got == want
    assert set(FLEET_EVENTS) <= set(got)
    for name in FLEET_EVENTS:
        assert telemetry.EVENT_SCHEMA[name] == jtelemetry.EVENT_SCHEMA[name]

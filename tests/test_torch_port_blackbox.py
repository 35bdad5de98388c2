"""The port's blackbox (``runtime/blackbox.py``) on the CPU: the blackbox
cases of ``tests/test_introspection.py``, under the same names, against the
port's dumper, engine, scheduler and drain; the thread-role map held equal
to the JAX module's; and an operator signal on a live scheduled serve, whose
dump must hold the engine, scheduler and session providers and the thread
stacks with their roles.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from raft_stereo_tpu.runtime import blackbox as jax_blackbox
from raft_stereo_tpu_torch.runtime import blackbox, infer, telemetry
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferRequest
from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
from raft_stereo_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler,
    SchedRequest,
    SessionServer,
)

WAIT_S = 10.0  # every engine's deadline


@pytest.fixture
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "run"), ring_capacity=64))
    yield t
    telemetry.uninstall(t)


@pytest.fixture
def dumper(tel):
    d = blackbox.install(blackbox.BlackboxDumper(tel.run_dir))
    yield d
    blackbox.uninstall(d)


def _emit_n(n, start=0):
    for i in range(start, start + n):
        telemetry.emit("sched_admit", bucket=[32, 64], depth=i, priority=0,
                       deadline_ms=None, trace_id=f"t{i}")


# ------------------------------------------------------ blackbox dumper


def test_dump_contents_and_isolation(tel, dumper):
    _emit_n(5)
    dumper.register("good", lambda: {"answer": 42})
    dumper.register("broken", lambda: 1 / 0)
    dumper.request("watchdog_trip", "unit test")
    assert dumper.wait_for_dump(1)
    doc = json.load(open(os.path.join(tel.run_dir, blackbox.BLACKBOX_NAME)))
    assert doc["trigger"] == "watchdog_trip" and doc["reason"] == "unit test"
    roles = {t["name"]: t["role"] for t in doc["threads"]}
    assert roles.get("MainThread") == "main"
    assert roles.get("blackbox-dump") == "introspect"
    assert any(t["stack"] for t in doc["threads"])
    assert len(doc["ring"]["events"]) >= 5
    assert doc["snapshots"]["good"] == {"answer": 42}
    assert "ZeroDivisionError" in doc["snapshots"]["broken"]["error"]
    events = [json.loads(line) for line in open(os.path.join(tel.run_dir, "events.jsonl"))
              if line.strip()]
    bb = [e for e in events if e["event"] == "blackbox_dump"]
    assert bb and bb[-1]["trigger"] == "watchdog_trip"
    assert not os.path.exists(dumper.path + ".tmp")


def test_register_names_unique(tel, dumper):
    assert dumper.register("engine", lambda: {}) == "engine"
    assert dumper.register("engine", lambda: {}) == "engine#2"


def test_signal_latch_dumps_and_restores_handler(tel, dumper):
    prev = signal.getsignal(signal.SIGUSR2)
    assert dumper.watch_signal()
    os.kill(os.getpid(), signal.SIGUSR2)
    assert dumper.wait_for_dump(1)
    doc = json.load(open(dumper.path))
    assert doc["trigger"] == "signal" and doc["reason"] == "SIGUSR2"
    dumper.close()
    assert signal.getsignal(signal.SIGUSR2) is prev


def test_drain_begin_requests_dump(tel, dumper):
    shutdown = GracefulShutdown()  # not entered: no handlers installed
    drain = ServeDrain(shutdown, timeout_s=5.0, label="unit")
    shutdown.request_stop()
    assert dumper.wait_for_dump(1)
    assert json.load(open(dumper.path))["trigger"] == "drain"
    drain.finish()


def test_dump_while_emitting_never_deadlocks(tel, dumper):
    stop = threading.Event()

    def storm():
        while not stop.is_set():
            _emit_n(10)

    workers = [threading.Thread(target=storm) for _ in range(3)]
    for w in workers:
        w.start()
    try:
        for k in range(5):
            dumper.request("signal", f"storm {k}")
            assert dumper.wait_for_dump(k + 1, timeout_s=20.0), \
                "dump wedged against the emit storm"
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=10.0)
    assert not any(w.is_alive() for w in workers)


def test_thread_roles_match_the_jax_map():
    """The dump's role vocabulary is the JAX package's, entry for entry."""
    assert blackbox.THREAD_ROLES == jax_blackbox.THREAD_ROLES
    for name in ("infer-stager", "sched-admit", "session-router", "infer-device-wait",
                 "blackbox-dump", "unnamed-pool-worker"):
        assert blackbox.thread_role(name) == jax_blackbox.thread_role(name)


def test_request_dump_noop_without_dumper():
    blackbox.request_dump("watchdog_trip")  # must not raise
    assert blackbox.register_provider("x", lambda: {}) is None


# ------------------------------------------------------- snapshot hooks


def _linear_fn(a, b):
    return (a * 2.0 - b).sum(-1, keepdim=True)


def _toy_engine(batch=2, **kw):
    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(_linear_fn, device="cpu", batch=batch, **kw)


def test_scheduler_snapshot_queues_and_drain(tmp_path):
    engine = _toy_engine()
    sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
    a = np.zeros((24, 48, 3), np.float32)
    sched._admit_one(InferRequest(payload=0, inputs=(a, a)))
    sched._admit_one(InferRequest(payload=1, inputs=(a, a)))
    snap = sched.snapshot()
    assert snap["depth"] == 2
    assert snap["buckets"]["32x64"]["pending"] == 2
    assert snap["buckets"]["32x64"]["oldest_wait_s"] >= 0.0
    assert snap["draining"] is False
    sched.request_drain(5.0)
    snap = sched.snapshot()
    assert snap["draining"] is True
    assert snap["drain_remaining_s"] is not None


def test_engine_snapshot_fields():
    engine = _toy_engine()
    snap = engine.snapshot()
    assert snap["tier"] == "serving" and snap["batch"] == 2
    assert snap["stats"]["images"] == 0
    engine2 = _toy_engine(tier="fast")
    assert engine2.snapshot()["tier"] == "fast"
    assert engine2.tier_label == "fast"


def test_engine_and_scheduler_self_register(tel, dumper):
    engine = _toy_engine()
    ContinuousBatchingScheduler(engine, max_wait_s=1.0)
    SessionServer(engine.stream)
    names = set(dumper.providers())
    assert {"engine:serving", "scheduler:serving", "sessions"} <= names


def test_cli_introspection_arms_the_signal_and_tears_down(tmp_path):
    """``install_cli_introspection``: with --telemetry_dir a dumper watching
    SIGUSR2 is installed, and the teardown uninstalls it and restores the
    handler; without it nothing is installed."""
    class Args:
        telemetry_dir = None

    teardown = infer.install_cli_introspection(Args())
    assert blackbox.get() is None
    teardown()
    Args.telemetry_dir = str(tmp_path / "run")
    prev = signal.getsignal(signal.SIGUSR2)
    teardown = infer.install_cli_introspection(Args())
    try:
        assert blackbox.get() is not None
        assert signal.getsignal(signal.SIGUSR2) is not prev
    finally:
        teardown()
        teardown()  # idempotent
    assert blackbox.get() is None and signal.getsignal(signal.SIGUSR2) is prev


def test_operator_signal_during_a_scheduled_serve(tmp_path):
    """SIGUSR2 on a live scheduler-backed session serve with a backlog: the
    dump parses, holds the engine, scheduler and session providers with a
    pending bucket, and the thread stacks with their roles (main, admit,
    stager); the serve then completes every request."""
    run_dir = str(tmp_path / "run")
    t = telemetry.install(telemetry.Telemetry(run_dir))
    d = blackbox.install(blackbox.BlackboxDumper(run_dir))
    d.watch_signal()
    gate = threading.Event()
    # the session layer appends a warm slot to every request
    engine = InferenceEngine(lambda a, b, warm: _linear_fn(a, b), device="cpu", batch=2,
                             deadline_s=WAIT_S)
    sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
    sessions = SessionServer(sched.serve, forward_sched=True, warm_start=False)
    rng = np.random.RandomState(0)
    arrays = [(rng.rand(24, 48, 3).astype(np.float32), rng.rand(24, 48, 3).astype(np.float32))
              for _ in range(5)]

    def source():
        for i in range(3):  # one full batch and one request left pending
            yield InferRequest(payload=i, inputs=arrays[i])
        gate.wait(timeout=30.0)
        for i in range(3, 5):
            yield SchedRequest(InferRequest(payload=i, inputs=arrays[i]))

    results = []

    def consume():
        for res in sessions.serve(source()):
            results.append(res)

    # the consumer on a worker, so the main thread (where signals land)
    # can signal a live serve
    worker = threading.Thread(target=consume, name="t-consumer")
    try:
        worker.start()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and sched.snapshot()["depth"] < 1:
            time.sleep(0.02)
        assert sched.snapshot()["depth"] >= 1, "backlog never formed"
        os.kill(os.getpid(), signal.SIGUSR2)
        assert d.wait_for_dump(1, timeout_s=15.0)
        gate.set()
        worker.join(timeout=60.0)
        assert not worker.is_alive()
    finally:
        gate.set()
        worker.join(timeout=10.0)
        blackbox.uninstall(d)
        telemetry.uninstall(t)
    assert sorted(r.payload for r in results) == [0, 1, 2, 3, 4]
    assert all(r.ok for r in results)
    doc = json.load(open(os.path.join(run_dir, blackbox.BLACKBOX_NAME)))
    assert doc["trigger"] == "signal" and doc["reason"] == "SIGUSR2"
    roles = {th["name"]: th["role"] for th in doc["threads"]}
    assert roles.get("MainThread") == "main"
    assert roles.get("sched-admit") == "admit"
    assert roles.get("infer-stager") == "stager"
    assert roles.get("session-router") == "admit"
    assert {"engine:serving", "scheduler:serving", "sessions"} <= set(doc["snapshots"])
    assert doc["snapshots"]["scheduler:serving"]["buckets"]["32x64"]["pending"] >= 1
    assert doc["snapshots"]["sessions"]["serving"] is True
    assert doc["ring"]["events"], "event ring missing from the dump"

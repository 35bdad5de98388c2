"""The port's serving lifecycle on the CPU: the cases of
``tests/test_lifecycle.py``, under the same names, against the port's
scheduler (``runtime/scheduler.py``), ``GracefulShutdown`` and
``ServeDrain`` (``runtime/preemption.py``) and the dispatch-stall injector
(``runtime/faultinject.py``), over the port's engine with a stand-in
forward; and the drain through the port's validators.

The JAX file's two ``AdaptiveServer`` cases wait for the adaptive server's
port; in their place: the stall injector's scope, and a drain of the
evaluate path (``evaluate._iter_predictions``) on a tiny model, engine and
per-image. Every engine has a deadline, so a hang fails its test.
"""

import json
import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferOptions, InferRequest
from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
from raft_stereo_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler,
    DrainedError,
    SchedRequest,
    ShedError,
)

WAIT_S = 10.0  # every engine's deadline


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _linear_fn(a, b):
    return (a * 2.0 - b).sum(-1, keepdim=True)


def _requests(n, h=24, w=48, seed=0):
    rng = np.random.RandomState(seed)
    return [InferRequest(payload=i, inputs=(rng.rand(h, w, 3).astype(np.float32),
                                            rng.rand(h, w, 3).astype(np.float32)))
            for i in range(n)]


def _engine(batch=2, **kw):
    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(_linear_fn, device="cpu", batch=batch, **kw)


def _events(run_dir):
    with open(f"{run_dir}/events.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(autouse=True)
def _reset_faults():
    faultinject.reset()
    yield
    faultinject.reset()


@pytest.fixture()
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    yield t
    telemetry.uninstall(t)


# ----------------------------------------------------------- stall injector


class TestSchedStallInjector:
    def test_armed_ordinal_stalls_dispatch(self):
        faultinject.arm(sched_stall={1}, sched_stall_ms=200)
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        before = faultinject.sched_dispatch_attempts()
        t0 = time.perf_counter()
        out = list(sched.serve(iter(_requests(2))))
        dt = time.perf_counter() - t0
        assert len(out) == 2 and all(r.ok for r in out)
        assert dt >= 0.2
        assert faultinject.sched_dispatch_attempts() > before

    def test_unarmed_is_free(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        out = list(sched.serve(iter(_requests(2, seed=1))))
        assert len(out) == 2 and all(r.ok for r in out)

    def test_scope_stalls_only_the_named_scheduler(self, monkeypatch):
        """RAFT_FI_SCHED_STALL_SCOPE: only the scheduler of that tier stalls,
        and its ordinals count its own passes."""
        monkeypatch.setenv("RAFT_FI_SCHED_STALL", "1:300")
        monkeypatch.setenv("RAFT_FI_SCHED_STALL_SCOPE", "victim")
        other = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        t0 = time.perf_counter()
        assert all(r.ok for r in other.serve(iter(_requests(2))))
        assert time.perf_counter() - t0 < 0.3
        victim = ContinuousBatchingScheduler(_engine(tier="victim"), max_wait_s=30.0)
        t0 = time.perf_counter()
        assert all(r.ok for r in victim.serve(iter(_requests(2))))
        assert time.perf_counter() - t0 >= 0.3


# ----------------------------------------------------------------- shedding


class TestShedding:
    def test_queue_full_sheds_typed_and_observable(self, tmp_path, tel):
        faultinject.arm(sched_stall={1}, sched_stall_ms=500)
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0, max_pending=3)
        out = list(sched.serve(iter(_requests(10))))
        assert len(out) == 10
        assert sorted(r.payload for r in out) == list(range(10))
        shed = [r for r in out if not r.ok]
        assert shed and all(isinstance(r.error, ShedError) for r in shed)
        assert all(r.error.reason == "queue_full" for r in shed)
        assert sched.stats.shed == len(shed)
        assert sched.stats.shed_reasons == {"queue_full": len(shed)}
        events = _events(tel.run_dir)
        ev = [e for e in events if e["event"] == "sched_shed"]
        assert len(ev) == len(shed)
        assert all(e["reason"] == "queue_full" and e["trace_id"] for e in ev)
        counters = tel.metrics._snapshot()[0]
        assert any(name == "sched_shed_total" and ("reason", "queue_full") in labels
                   for name, labels in counters)

    def test_queue_full_admission_is_bounded_not_blocking(self):
        faultinject.arm(sched_stall={1, 2, 3}, sched_stall_ms=400)
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0, max_pending=2)
        admit_gaps = []
        t_last = [None]

        def paced():
            for r in _requests(12, seed=3):
                now = time.perf_counter()
                if t_last[0] is not None:
                    admit_gaps.append(now - t_last[0])
                t_last[0] = now
                yield r

        out = list(sched.serve(paced()))
        assert len(out) == 12
        assert max(admit_gaps) < 0.35, max(admit_gaps)

    def test_unmeetable_deadline_shed_via_ewma(self, tmp_path, tel):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0, max_pending=64)
        list(sched.serve(iter(_requests(2))))  # primes the EWMA
        with sched._cond:
            assert sched._service_ewma
        reqs = _requests(4, seed=5)
        stream = [SchedRequest(reqs[0]), SchedRequest(reqs[1]),
                  SchedRequest(reqs[2], deadline_s=1e-4),
                  SchedRequest(reqs[3])]
        out = {r.payload: r for r in sched.serve(iter(stream))}
        assert len(out) == 4
        assert not out[2].ok and isinstance(out[2].error, ShedError)
        assert out[2].error.reason == "deadline"
        assert all(out[i].ok for i in (0, 1, 3))
        ev = [e for e in _events(tel.run_dir) if e["event"] == "sched_shed"]
        assert len(ev) == 1 and ev[0]["reason"] == "deadline"
        assert ev[0]["est_ms"] and ev[0]["est_ms"] > ev[0]["deadline_ms"]

    def test_no_shedding_without_max_pending(self):
        faultinject.arm(sched_stall={1}, sched_stall_ms=300)
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        reqs = _requests(8, seed=7)
        stream = [SchedRequest(r, deadline_s=1e-4) for r in reqs]
        out = list(sched.serve(iter(stream)))
        assert len(out) == 8 and all(r.ok for r in out)
        assert sched.stats.shed == 0

    def test_max_pending_validation(self):
        with pytest.raises(ValueError, match="max_pending"):
            ContinuousBatchingScheduler(_engine(), max_pending=0)


# -------------------------------------------------------------------- drain


class TestDrain:
    def test_drain_truncates_source_and_completes_admitted(self, tmp_path, tel):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        shutdown = GracefulShutdown()  # flag only; no handlers installed
        drain = ServeDrain(shutdown, timeout_s=10.0, label="t")
        drain.attach(sched)
        accepted = []

        def counted(source):
            for r in source:
                accepted.append(r.payload)
                yield r

        def paced():
            for r in _requests(40, seed=2):
                yield r
                time.sleep(0.01)

        seen = []
        for res in sched.serve(counted(drain.wrap_source(paced()))):
            drain.note_result(res)
            seen.append(res)
            if len(seen) == 3:
                shutdown.request_stop()
        info = drain.finish()
        assert all(r.ok for r in seen)
        assert sorted(r.payload for r in seen) == sorted(accepted)
        assert len(accepted) < 40
        assert info["resolved"] == len(seen) and info["drained"] == 0
        names = [e["event"] for e in _events(tel.run_dir)]
        assert "drain_begin" in names and "drain_complete" in names
        assert names.index("drain_begin") < names.index("drain_complete")

    def test_drain_timeout_resolves_typed_drained(self, tmp_path, tel):
        faultinject.arm(sched_stall={2, 3, 4, 5}, sched_stall_ms=400)
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        shutdown = GracefulShutdown()
        drain = ServeDrain(shutdown, timeout_s=0.25, label="t")
        drain.attach(sched)
        accepted = []

        def counted(source):
            for r in source:
                accepted.append(r.payload)
                yield r

        got = []
        for res in sched.serve(counted(drain.wrap_source(iter(_requests(16, seed=3))))):
            drain.note_result(res)
            got.append(res)
            if len(got) == 2:
                shutdown.request_stop()
        info = drain.finish()
        assert sorted(r.payload for r in got) == sorted(accepted)
        drained = [r for r in got if not r.ok]
        assert drained and all(isinstance(r.error, DrainedError) for r in drained)
        assert info["drained"] == len(drained)
        ev = [e for e in _events(tel.run_dir) if e["event"] == "sched_shed"]
        assert len(ev) == len(drained)
        assert all(e["reason"] == "drained" for e in ev)

    def test_drain_latches_for_instance_lifetime(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        sched.request_drain(0.0)
        time.sleep(0.01)
        out = list(sched.serve(iter(_requests(3, seed=9))))
        assert len(out) == 3
        assert all(isinstance(r.error, DrainedError) for r in out)

    def test_request_drain_idempotent_and_property(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        assert not sched.draining
        sched.request_drain(5.0)
        with sched._cond:
            first = sched._drain_deadline
        sched.request_drain(500.0)
        with sched._cond:
            assert sched._drain_deadline == first
        assert sched.draining


# -------------------------------------------------------- ServeDrain plumbing


class TestServeDrain:
    def test_transparent_without_signal(self):
        shutdown = GracefulShutdown()
        drain = ServeDrain(shutdown, timeout_s=5.0)
        reqs = _requests(4)
        assert list(drain.wrap_source(iter(reqs))) == reqs
        assert drain.finish() is None

    def test_finish_idempotent_single_drain_complete(self, tel):
        shutdown = GracefulShutdown()
        drain = ServeDrain(shutdown, timeout_s=5.0, label="t")
        shutdown.request_stop()
        drain.begin()
        first = drain.finish()
        assert first is not None
        assert drain.finish() == first
        events = [e["event"] for e in _events(tel.run_dir)]
        assert events.count("drain_complete") == 1

    def test_callbacks_fire_once(self):
        shutdown = GracefulShutdown()
        fired = []
        shutdown.add_callback(lambda: fired.append(1))
        shutdown.request_stop()
        shutdown.request_stop()
        assert fired == [1]
        assert shutdown.should_stop

    def test_attach_after_begin_forwards_drain(self):
        shutdown = GracefulShutdown()
        drain = ServeDrain(shutdown, timeout_s=5.0)
        shutdown.request_stop()
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        drain.attach(sched)
        assert sched.draining

    def test_callback_exception_never_breaks_stop(self):
        shutdown = GracefulShutdown()
        shutdown.add_callback(lambda: 1 / 0)
        fired = []
        shutdown.add_callback(lambda: fired.append(1))
        shutdown.request_stop()
        assert shutdown.should_stop and fired == [1]


# ------------------------------------------------- the validators' drain

TINY = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                        corr_radius=2, corr_implementation="alt")


class _Samples:
    """A dataset of ``n`` seeded 32x64 samples, (img1, img2, flow, valid),
    each read taking ``read_s`` (a slow decode, so a stop lands before the
    source is exhausted); ``read`` records the indices read."""

    def __init__(self, n, read_s=0.2):
        rng = np.random.RandomState(4)
        self.items = [((rng.rand(32, 64, 3) * 255).astype(np.float32),
                       (rng.rand(32, 64, 3) * 255).astype(np.float32),
                       np.zeros((32, 64, 2), np.float32), np.ones((32, 64), np.float32))
                      for _ in range(n)]
        self.read_s = read_s
        self.read = []

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        time.sleep(self.read_s)
        self.read.append(i)
        return self.items[i]


@pytest.mark.parametrize("route", ["engine_sched", "per_image"])
def test_validator_predictions_drain_mid_stream(route, tel):
    """A stop after the second prediction: the source stops, every sample
    read (admitted) is predicted, the rest never are; the per-image path
    stops at the next pair. Both emit drain_begin and drain_complete once."""
    model = evaluate.load_model(TINY, device="cpu")
    shutdown = GracefulShutdown()
    drain = ServeDrain(shutdown, timeout_s=WAIT_S, label="evaluate")
    infer = (InferOptions(batch=2, sched=True, deadline_s=WAIT_S, quality=False)
             if route == "engine_sched" else None)
    ds = _Samples(12)
    got = []
    for i, pred, _ in evaluate._iter_predictions(model, 2, ds, infer, drain):
        assert pred.shape == (32, 64) and np.isfinite(pred).all()
        got.append(i)
        if len(got) == 2:
            shutdown.request_stop()
    assert 2 <= len(got) < 12
    assert sorted(got) == sorted(ds.read)
    names = [e["event"] for e in _events(tel.run_dir)]
    assert names.count("drain_begin") == 1 and names.count("drain_complete") == 1


# ------------------------------------------------------ a long-lived feed


@pytest.mark.parametrize("idle_watchdog", [True, False])
def test_idle_watchdog_on_a_long_lived_feed(idle_watchdog):
    """A feed that stays quiet past the engine's deadline: with the idle
    watchdog (the default) the stream fails with InferStallError; without
    it the engine waits while the source lives, and serves the late
    requests (the deadline still bounds every device wait)."""
    from raft_stereo_tpu_torch.runtime.infer import InferStallError

    engine = _engine(batch=1, deadline_s=0.3, idle_watchdog=idle_watchdog)
    reqs = _requests(2, seed=13)

    def quiet():
        yield reqs[0]
        time.sleep(0.8)
        yield reqs[1]

    out = []
    if idle_watchdog:
        with pytest.raises(InferStallError):
            for r in engine.stream(quiet()):
                out.append(r)
        assert engine.stats.watchdog_trips == 1
    else:
        out = list(engine.stream(quiet()))
        assert [r.payload for r in out] == [0, 1] and all(r.ok for r in out)
        assert engine.stats.watchdog_trips == 0

"""The port engine's fault tolerance (``raft_stereo_tpu_torch/runtime/infer.py``):
the cases of ``tests/test_infer_robustness.py``, under the same names,
against the port's ``InferenceEngine`` with a stand-in forward on the CPU.

The four injected serving faults (decode failure, compile failure, device
OOM, device hang), the stager's sentinel contract, the deadline watchdog
on both waits, retries, the circuit breaker and the degraded path, the
graph cache under a failing capture, and the summary and budget helpers.
On the CPU a key's "compile" is its first eager run, so the compile
injector takes the route a capture takes on the card. Every engine here
has a deadline of at most 2 s, so a hang fails its test instead of the
suite; an injected hang parks a thread that ``faultinject.reset()``
releases.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    GraphCache,
    InferenceEngine,
    InferRequest,
    InferStallError,
    StreamSummary,
    enforce_failure_budget,
    last_summary,
    publish_summary,
    reset_summary,
)

DEADLINE = 0.5  # the watchdog tests' deadline
WAIT_S = 2.0    # every other engine's: no wait in this file outlasts it


@pytest.fixture(autouse=True)
def _fi_reset():
    faultinject.reset()
    yield
    faultinject.reset()  # also releases any parked injected-hang thread


@pytest.fixture()
def tel_events(tmp_path):
    """Install a telemetry sink; returns a callable reading its events."""
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))

    def events(name=None):
        tel.flush_trace()
        out = [json.loads(line)
               for line in (tmp_path / "events.jsonl").read_text().splitlines()
               if line.strip()]
        return [e for e in out if name is None or e["event"] == name]

    yield events
    telemetry.uninstall(tel)


def _linear_fn(a, b):
    return (a * 2.0 - b).sum(-1, keepdim=True)


def _requests(n, shape=(24, 48), seed=0):
    rng = np.random.RandomState(seed)
    return [InferRequest(payload=i, inputs=(rng.rand(*shape, 3).astype(np.float32),
                                            rng.rand(*shape, 3).astype(np.float32)))
            for i in range(n)]


def _reference(req):
    a, b = (torch.from_numpy(x)[None] for x in req.inputs)
    return _linear_fn(a, b)[0].numpy()


def _engine(**kw):
    kw.setdefault("batch", 4)
    kw.setdefault("retry_backoff_s", 0.01)
    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(_linear_fn, device="cpu", **kw)


# ------------------------------------------------- per-request isolation


class TestDecodeIsolation:
    def test_injected_decode_failure_is_isolated(self, tel_events):
        faultinject.arm(infer_decode_fail={2})
        eng = _engine(batch=2)
        results = {r.payload: r for r in eng.stream(iter(_requests(5)))}
        assert sorted(results) == [0, 1, 2, 3, 4]
        failed = [r for r in results.values() if not r.ok]
        assert len(failed) == 1 and failed[0].payload == 1
        assert isinstance(failed[0].error, OSError)
        assert failed[0].output is None
        for i in (0, 2, 3, 4):  # survivors are numerically untouched
            np.testing.assert_array_equal(results[i].output, _reference(_requests(5)[i]))
        assert eng.stats.failed == 1 and eng.stats.images == 4
        ev = tel_events("request_failed")
        assert len(ev) == 1 and ev[0]["stage"] == "decode"

    def test_env_var_arming(self, monkeypatch):
        monkeypatch.setenv("RAFT_FI_INFER_DECODE_FAIL", "1,3")
        eng = _engine(batch=2)
        results = list(eng.stream(iter(_requests(4))))
        assert sum(not r.ok for r in results) == 2
        assert {r.payload for r in results if not r.ok} == {0, 2}

    def test_lazy_decode_exception_is_isolated(self):
        good = _requests(3)

        def bad_decode():
            raise ValueError("corrupt input")

        reqs = [good[0], InferRequest(payload="bad", inputs=bad_decode), good[2]]
        eng = _engine(batch=2)
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        bad = results["bad"]
        assert not bad.ok and isinstance(bad.error, ValueError)
        assert results[0].ok and results[2].ok

    def test_invalid_inputs_are_isolated(self):
        rng = np.random.RandomState(0)
        mismatched = InferRequest(payload="mismatch",
                                  inputs=(rng.rand(24, 48, 3).astype(np.float32),
                                          rng.rand(32, 48, 3).astype(np.float32)))
        eng = _engine(batch=2)
        results = {r.payload: r for r in eng.stream(iter(_requests(2) + [mismatched]))}
        assert not results["mismatch"].ok
        assert "share one (H, W)" in str(results["mismatch"].error)
        assert results[0].ok and results[1].ok


# ------------------------------------------------ stager sentinel contract


class TestStagerSentinel:
    def test_empty_request_stream_terminates(self):
        eng = _engine(deadline_s=DEADLINE)
        assert list(eng.stream(iter([]))) == []

    def test_source_iterator_exception_still_surfaces(self):
        def requests():
            yield from _requests(2)
            raise OSError("decode stream died")

        eng = _engine(batch=4, deadline_s=DEADLINE)
        with pytest.raises(OSError, match="decode stream died"):
            list(eng.stream(requests()))

    def test_killed_stager_surfaces_not_hangs(self, monkeypatch):
        """A stager killed mid-stream, past the per-request isolation, must
        surface at the consumer through the sentinel in ``finally``."""

        def kill(self, put, items, bucket):
            raise RuntimeError("stager killed mid-stream")

        monkeypatch.setattr(InferenceEngine, "_stage_put", kill)
        eng = _engine(batch=2, deadline_s=DEADLINE)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="stager killed"):
            list(eng.stream(iter(_requests(4))))
        assert time.perf_counter() - t0 < 2 * DEADLINE + 2.0

    def test_early_consumer_stop_joins_stager(self):
        eng = _engine(batch=1, prefetch_depth=1)
        gen = eng.stream(iter(_requests(6)))
        assert next(gen).ok
        gen.close()  # early stop: the stop event must unblock a full queue

    def test_staging_failure_fails_batch_not_stream(self, monkeypatch, tel_events):
        def bad_stage(self, items, bucket):
            raise RuntimeError("pad exploded")

        monkeypatch.setattr(InferenceEngine, "_stage", bad_stage)
        eng = _engine(batch=2)
        results = list(eng.stream(iter(_requests(2))))
        assert len(results) == 2 and all(not r.ok for r in results)
        ev = tel_events("request_failed")
        assert len(ev) == 2 and all(e["stage"] == "stage" for e in ev)


# ----------------------------------------------------- deadline watchdog


class TestWatchdog:
    def test_stalled_stager_raises_with_diagnostics(self, tel_events):
        gate = threading.Event()

        def requests():
            gate.wait(timeout=10 * DEADLINE)  # a decode that does not return in time
            yield from ()

        eng = _engine(deadline_s=DEADLINE)
        try:
            t0 = time.perf_counter()
            with pytest.raises(InferStallError, match="staged nothing"):
                list(eng.stream(requests()))
            assert time.perf_counter() - t0 < DEADLINE + 2.0
        finally:
            gate.set()  # release the (daemon) stager
        assert eng.stats.watchdog_trips == 1
        ev = tel_events("watchdog_trip")
        assert len(ev) == 1 and ev[0]["where"] == "stager"

    def test_injected_device_hang_fails_batch_only(self, tel_events):
        faultinject.arm(infer_hang={1})
        eng = _engine(batch=4, deadline_s=DEADLINE)
        reqs = _requests(8)
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert len(results) == 8
        hung = [p for p, r in results.items() if not r.ok]
        ok = [p for p, r in results.items() if r.ok]
        assert len(hung) == 4 and len(ok) == 4  # exactly one batch failed
        for p in ok:
            np.testing.assert_array_equal(results[p].output, _reference(reqs[p]))
        assert eng.stats.watchdog_trips == 1
        assert eng.stats.failed == 4 and eng.stats.images == 4
        ev = tel_events("watchdog_trip")
        assert len(ev) == 1 and ev[0]["where"] == "device"
        assert len(tel_events("request_failed")) == 4

    def test_constructor_validation(self):
        with pytest.raises(ValueError):
            _engine(deadline_s=0)
        with pytest.raises(ValueError):
            _engine(retries=-1)


# --------------------------------------- retry / circuit break / degrade


class TestCompileRecovery:
    def test_transient_compile_failure_retries(self, tel_events):
        faultinject.arm(infer_compile_fail={1})
        eng = _engine(batch=2, retries=2)
        reqs = _requests(2)
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())
        np.testing.assert_array_equal(results[0].output, _reference(reqs[0]))
        assert eng.stats.retries == 1 and eng.stats.circuits_open == 0
        ev = tel_events("infer_retry")
        assert len(ev) == 1 and ev[0]["kind"] == "compile"
        assert tel_events("bucket_circuit_open") == []

    def test_persistent_compile_failure_circuit_breaks(self, tel_events):
        # 3 armed ordinals > retries=2 budget (3 attempts in all)
        faultinject.arm(infer_compile_fail={1, 2, 3})
        eng = _engine(batch=2, retries=2)
        reqs = _requests(5)  # 2 full micro-batches + 1 partial, one bucket
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        # every request still served, by the per-image path
        assert all(r.ok for r in results.values())
        for i, req in enumerate(reqs):
            np.testing.assert_array_equal(results[i].output, _reference(req))
        assert eng.stats.circuits_open == 1
        assert eng.stats.degraded == 3  # every batch of the broken bucket
        assert len(tel_events("bucket_circuit_open")) == 1
        assert tel_events("bucket_circuit_open")[0]["reason"] == "compile"
        assert len(tel_events("infer_degraded")) == 3
        # no recompile storm: batches 2 and 3 never attempted a compile
        assert faultinject.infer_compile_attempts() == 3
        # the partial batch's filler slot is never computed on the degraded
        # path: 5 valid items -> 5 per-image waits, not 6
        assert faultinject.infer_wait_attempts() == 5

    def test_circuit_state_persists_across_streams(self):
        faultinject.arm(infer_compile_fail={1, 2, 3})
        eng = _engine(batch=2, retries=2)
        assert all(r.ok for r in eng.stream(iter(_requests(2))))
        attempts = faultinject.infer_compile_attempts()
        assert all(r.ok for r in eng.stream(iter(_requests(2, seed=1))))
        assert faultinject.infer_compile_attempts() == attempts


class TestOOMDegradation:
    def test_oom_halves_until_it_fits(self, tel_events):
        faultinject.arm(infer_oom_batch=4)  # B >= 4 OOMs; halves fit
        eng = _engine(batch=4, retries=2)
        reqs = _requests(12)  # three full micro-batches, one bucket
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())
        for i, req in enumerate(reqs):
            np.testing.assert_array_equal(results[i].output, _reference(req))
        assert eng.stats.degraded == 3 and eng.stats.failed == 0
        ev = tel_events("infer_degraded")
        # batch 2 was already in flight (one-deep pipeline) when batch 1's
        # OOM set the cap, so it OOMs once more; batch 3 dispatches straight
        # at the remembered cap
        assert [e["reason"] for e in ev] == ["oom", "oom", "oom_capped"]
        assert all(e["micro_batch"] == 2 for e in ev)  # 4 -> 2 fit
        assert tel_events("bucket_circuit_open") == []
        # the halves ran as their own key, (bucket, 2)
        assert {b for (_, b, *_rest) in eng._compiled} == {4, 2}

    def test_oom_at_floor_fails_batch(self, tel_events):
        faultinject.arm(infer_oom_batch=1)  # nothing fits, even per-image
        eng = _engine(batch=2, retries=1)
        results = list(eng.stream(iter(_requests(2))))
        assert len(results) == 2 and all(not r.ok for r in results)
        assert all(isinstance(r.error, torch.cuda.OutOfMemoryError) for r in results)
        assert eng.stats.failed == 2
        ev = tel_events("request_failed")
        assert len(ev) == 2 and all(e["stage"] == "device" for e in ev)


    def test_oom_raised_by_the_forward_halves_the_batch(self, tel_events):
        """The OOM the allocator raises comes out of the forward itself (a
        warm-up, capture or eager launch), not the wait: the same halving."""
        def fn(a, b):
            if a.shape[0] >= 4:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in forward)")
            return _linear_fn(a, b)

        eng = InferenceEngine(fn, device="cpu", batch=4, retry_backoff_s=0.01,
                              deadline_s=WAIT_S)
        reqs = _requests(10)  # two full micro-batches and a partial one
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())
        for i, req in enumerate(reqs):
            np.testing.assert_array_equal(results[i].output, _reference(req))
        ev = tel_events("infer_degraded")
        # the second batch is dispatched before the first's OOM sets the cap
        assert [e["reason"] for e in ev] == ["oom", "oom", "oom_capped"]
        assert all(e["micro_batch"] == 2 for e in ev)
        assert ev[0]["error"].startswith("OutOfMemoryError")
        assert eng.stats.retries == 0 and eng._bucket_cap == {(32, 64): 2}


class TestDispatchRetry:
    def test_transient_dispatch_error_retries(self, monkeypatch, tel_events):
        calls = {"n": 0}
        orig = InferenceEngine._wait_device

        def flaky(self, launch, batch_size, trace_ids=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient device error")
            return orig(self, launch, batch_size, trace_ids)

        monkeypatch.setattr(InferenceEngine, "_wait_device", flaky)
        eng = _engine(batch=2, retries=2)
        reqs = _requests(2)
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())
        np.testing.assert_array_equal(results[1].output, _reference(reqs[1]))
        assert eng.stats.retries == 1
        ev = tel_events("infer_retry")
        assert len(ev) == 1 and ev[0]["kind"] == "dispatch"

    def test_synchronous_dispatch_failure_recovers(self, monkeypatch, tel_events):
        """A dispatch that raises at call time (a launch rejected before any
        wait) walks the same retry ladder instead of killing the stream."""
        orig = InferenceEngine._executable
        state = {"calls": 0}

        def flaky_exec(self, staged):
            fn = orig(self, staged)

            def wrapper(*a, **kw):
                state["calls"] += 1
                if state["calls"] == 1:
                    raise RuntimeError("launch rejected synchronously")
                return fn(*a, **kw)

            return wrapper

        monkeypatch.setattr(InferenceEngine, "_executable", flaky_exec)
        eng = _engine(batch=2, retries=2)
        reqs = _requests(2)
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())
        np.testing.assert_array_equal(results[0].output, _reference(reqs[0]))
        assert eng.stats.retries == 1 and eng.stats.failed == 0
        assert tel_events("infer_retry")[0]["kind"] == "dispatch"

    def test_persistent_synchronous_dispatch_failure_degrades(self, monkeypatch, tel_events):
        def dead_exec(self, staged):
            def wrapper(*a, **kw):
                raise RuntimeError("launch always rejected")

            return wrapper

        monkeypatch.setattr(InferenceEngine, "_executable", dead_exec)
        eng = _engine(batch=2, retries=1)
        reqs = _requests(2)
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())  # the per-image path served them
        for i, req in enumerate(reqs):
            np.testing.assert_array_equal(results[i].output, _reference(req))
        assert eng.stats.circuits_open == 1
        assert tel_events("bucket_circuit_open")[0]["reason"] == "dispatch"

    def test_persistent_dispatch_error_circuit_breaks_to_fallback(self, monkeypatch,
                                                                  tel_events):
        orig = InferenceEngine._wait_device

        def batch_always_dies(self, launch, batch_size, trace_ids=None):
            # the full batch fails every time; the per-image path (batch 1)
            # works
            if batch_size > 1:
                raise RuntimeError("persistent device error")
            return orig(self, launch, batch_size, trace_ids)

        monkeypatch.setattr(InferenceEngine, "_wait_device", batch_always_dies)
        eng = _engine(batch=2, retries=1)
        reqs = _requests(2)
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())
        for i, req in enumerate(reqs):
            np.testing.assert_array_equal(results[i].output, _reference(req))
        assert eng.stats.circuits_open == 1 and eng.stats.degraded == 1
        assert tel_events("bucket_circuit_open")[0]["reason"] == "dispatch"


# ------------------------------------------- GraphCache under failure


@pytest.fixture()
def eager_capture(monkeypatch):
    """``GraphCache`` with its CUDA warm-up and capture replaced by a call
    of ``fn`` (the cache's bookkeeping is what is under test)."""
    monkeypatch.setattr(GraphCache, "_capture", lambda self, fn, inputs: fn(*inputs))


class TestAOTCacheFailure:
    """The JAX ``AOTCache`` cases, against the port's ``GraphCache``."""

    def test_failed_compile_does_not_poison_cache(self, eager_capture):
        boom = {"arm": True}

        def capture(k):
            if boom["arm"]:
                raise RuntimeError("compile died")
            return f"exec-{k}"

        cache = GraphCache(max_entries=2)
        with pytest.raises(RuntimeError, match="compile died"):
            cache.get("a", capture, ("a",))
        assert "a" not in cache and len(cache) == 0
        assert (cache.hits, cache.misses) == (0, 1)
        boom["arm"] = False
        assert cache.get("a", capture, ("a",)) == "exec-a"  # the same key retries cleanly
        assert "a" in cache and len(cache) == 1
        assert (cache.hits, cache.misses) == (0, 2)
        assert cache.get("a", capture, ("a",)) == "exec-a"
        assert (cache.hits, cache.misses) == (1, 2)

    def test_lru_and_counters_stay_correct_across_failure(self, eager_capture, monkeypatch):
        fail_keys = {"bad"}

        def capture(k):
            if k in fail_keys:
                raise RuntimeError(k)
            return _Entry(f"exec-{k}")

        cache = GraphCache(max_entries=2)
        cache.get("a", capture, ("a",))
        cache.get("b", capture, ("b",))
        with pytest.raises(RuntimeError):
            cache.get("bad", capture, ("bad",))
        # the failure neither evicted nor inserted anything
        assert len(cache) == 2 and "a" in cache and "b" in cache
        cache.get("a", capture, ("a",))  # refresh "a"
        cache.get("c", capture, ("c",))  # evicts "b" (LRU), unaffected by the failure
        assert "b" not in cache and "a" in cache and "c" in cache
        assert (cache.hits, cache.misses) == (1, 4)
        fail_keys.clear()
        assert cache.get("bad", capture, ("bad",)).name == "exec-bad"  # retriable after a fix


class _Entry:
    """An evictable stand-in for a captured forward (``graph.reset()``)."""

    def __init__(self, name):
        self.name = name
        self.graph = self

    def reset(self):
        pass


@pytest.mark.gpu
def test_failed_capture_leaves_no_entry_and_releases_the_pool():
    """On the card: a warm-up that raises leaves no entry and, with no
    graph left, drops the pool; the next capture of the key succeeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cache = GraphCache(max_entries=2)
    x = torch.ones(4, 8)
    state = {"fail": True}

    def fn(t):
        if state["fail"]:
            raise torch.cuda.OutOfMemoryError("injected at warm-up")
        return t * 2

    with pytest.raises(torch.cuda.OutOfMemoryError):
        cache.get("k", fn, (x,))
    assert "k" not in cache and cache._pool is None and cache.captures == 0
    state["fail"] = False
    out = cache.run("k", fn, (x,))
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), x * 2) and cache.captures == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["raise", "readback", "oom"])
def test_capture_that_breaks_midway_keeps_the_pool(kind):
    """On the card, with one key captured (so the shared pool exists): a
    forward that breaks only while the stream captures (a raise; a real
    allocator OOM; a host read-back, which invalidates the capture) leaves
    no entry. The first two keep the pool; the read-back spoils it for
    later captures, which move to a fresh one. Either way the key then
    captures and replays exactly the eager output, and the first key still
    replays its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    xa, xb = torch.randn(4, 256, generator=gen), torch.randn(2, 256, generator=gen)
    w = torch.randn(256, generator=gen).cuda()
    armed = {"on": False}

    def fn(t):
        y = torch.tanh(t * w) + t.roll(1, dims=1)
        if armed["on"] and torch.cuda.is_current_stream_capturing():
            if kind == "raise":
                raise RuntimeError("raised while the stream captures")
            if kind == "readback":
                y.sum().item()
            if kind == "oom":
                torch.empty(1 << 50, dtype=torch.uint8, device=t.device)
        return y * 2

    want_a, want_b = fn(xa.cuda()), fn(xb.cuda())
    cache = GraphCache(max_entries=4)
    assert torch.equal(cache.run("a", fn, (xa,)), want_a)
    pool = cache._pool
    assert pool is not None
    armed["on"] = True
    with pytest.raises(RuntimeError) as err:  # OutOfMemoryError is one too
        cache.get("b", fn, (xb,))
    assert kind != "oom" or err.type is torch.cuda.OutOfMemoryError
    assert "b" not in cache and len(cache) == 1 and cache.captures == 1
    assert cache._pool == (None if kind == "readback" else pool)
    assert not torch.cuda.is_current_stream_capturing()
    armed["on"] = False
    out_b = cache.run("b", fn, (xb,)).clone()
    out_a = cache.run("a", fn, (xa,)).clone()
    torch.cuda.synchronize()
    assert torch.equal(out_b, want_b) and torch.equal(out_a, want_a)
    assert cache.captures == 2 and (cache._pool == pool) == (kind != "readback")


# ------------------------------------------------- summary + budget helpers


class TestSummaryAndBudget:
    def test_stream_summary_fracs(self):
        s = StreamSummary(completed=3, failed=1, degraded=2)
        assert s.total == 4 and s.failed_frac == 0.25
        assert StreamSummary(0, 0, 0).failed_frac == 0.0

    def test_publish_and_enforce(self, capsys):
        reset_summary()
        enforce_failure_budget(0.0)  # nothing published -> no-op
        eng = _engine(batch=2)
        faultinject.arm(infer_decode_fail={1})
        list(eng.stream(iter(_requests(4))))
        s = publish_summary(eng.stats, label="test")
        out = capsys.readouterr().out
        assert "3/4 completed" in out and "1 failed" in out
        assert last_summary() == s
        enforce_failure_budget(0.5)  # 0.25 <= 0.5: within budget
        with pytest.raises(SystemExit):
            enforce_failure_budget(0.0)  # strict default
        reset_summary()

    def test_all_clean_never_exits(self):
        reset_summary()
        eng = _engine(batch=2)
        list(eng.stream(iter(_requests(2))))
        publish_summary(eng.stats, label="test")
        enforce_failure_budget(0.0)
        reset_summary()

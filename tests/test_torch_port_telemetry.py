"""The port's runtime telemetry (``raft_stereo_tpu_torch/runtime/telemetry.py``)
against the JAX package's, on the CPU.

  * ``LogHistogram`` and ``MetricsRegistry``, fed the same seeded
    observations in both packages, give identical quantiles and identical
    Prometheus text (this test may import the JAX module; the port may not);
  * the cases of ``tests/test_observability.py`` that cover the registry,
    the sink, trace ids and latency summaries, against the port's engine
    with a stand-in forward;
  * ``train.main`` with ``--telemetry`` and the NaN and IO injections armed
    writes the events that the JAX ``train.main`` writes for the same
    scenario, each with the same payload keys, all declared in the JAX
    ``EVENT_SCHEMA``; a preempted and resumed run with rotation and a
    quarantined sample writes the lifecycle events, declared too;
  * ``frame_io`` takes its retry budget, backoff and injected failures from
    the environment; ``tools/run_report.py`` reads the port's run
    directories; the profile window and the recompile detector.
"""

import json
import math
import random

import fixture_trees as ft  # tests/ is on sys.path (pytest rootdir insert)
import numpy as np
import pytest
import torch

from raft_stereo_tpu.runtime import telemetry as jax_telemetry
from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    InferenceEngine,
    InferRequest,
    publish_summary,
    reset_summary,
)
from tools import run_report
from tools.run_report import build_report, parse_prometheus, print_human

WAIT_S = 2.0  # every engine's deadline: no wait in this file outlasts it


@pytest.fixture(autouse=True)
def _clean():
    faultinject.reset()
    telemetry.install(None)
    reset_summary()
    yield
    telemetry.install(None)
    faultinject.reset()
    reset_summary()


# ------------------------------------------------- parity with the JAX module


def _observations(seed=0, n=3000):
    rng = random.Random(seed)
    return [math.exp(rng.uniform(-9, 3)) for _ in range(n)]


def test_the_event_schema_is_the_jax_one():
    assert telemetry.EVENT_SCHEMA == jax_telemetry.EVENT_SCHEMA
    assert telemetry.RESERVED_KEYS == jax_telemetry.RESERVED_KEYS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_histogram_matches_jax(seed):
    ours, theirs = telemetry.LogHistogram(), jax_telemetry.LogHistogram()
    for v in _observations(seed) + [0.0, float("nan"), 1e-9]:
        ours.record(v)
        theirs.record(v)
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)
    assert ours.quantiles(qs) == theirs.quantiles(qs)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.bucket_counts() == theirs.bucket_counts()
    assert ours.rel_error() == theirs.rel_error()


def test_metrics_registry_prometheus_text_matches_jax():
    ours, theirs = telemetry.MetricsRegistry(), jax_telemetry.MetricsRegistry()
    for reg in (ours, theirs):
        rng = np.random.RandomState(3)
        for i in range(400):
            bucket = ("544x960", "480x640")[i % 2]
            reg.observe("infer_e2e_seconds", float(rng.lognormal(-3, 1)), bucket=bucket)
            reg.observe("train_step_seconds", float(rng.lognormal(0, 0.2)))
            reg.inc("infer_requests_total", status=("completed", "failed")[i % 7 == 0])
        reg.set_gauge("up", 1)
        reg.set_gauge("queue_depth", 2.5, tier="serving")
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert ours.latency_snapshot() == theirs.latency_snapshot()


def test_slo_tracker_matches_jax():
    ours, theirs = telemetry.SLOTracker(50.0, 0.05), jax_telemetry.SLOTracker(50.0, 0.05)
    for v in _observations(4, 200):
        for t in (ours, theirs):
            t.observe("serving", v / 100, ok=v < 5)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.to_prometheus() == theirs.to_prometheus()


def test_importing_telemetry_needs_only_the_standard_library():
    import subprocess
    import sys

    code = ("import sys; import raft_stereo_tpu_torch.runtime.telemetry as t; "
            "print('torch' in sys.modules, 'numpy' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=str(ft.__file__).rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_device_memory_stats_is_none_without_a_card():
    # the CPU build has torch imported and no card
    assert telemetry.device_memory_stats() is None


# ------------------------------------------------- registry + prometheus


class TestMetricsRegistry:
    def test_prometheus_round_trip(self):
        r = telemetry.MetricsRegistry()
        r.inc("infer_requests_total", 3, status="completed")
        r.inc("infer_requests_total", 1, status="failed")
        r.set_gauge("up", 1)
        for v in (0.01, 0.02, 0.4):
            r.observe("infer_e2e_seconds", v, bucket="64x96")
        text = r.to_prometheus()
        assert "# TYPE infer_e2e_seconds summary" in text
        prom = parse_prometheus(text)
        counts = {lb.get("status"): v for lb, v in prom["infer_requests_total"]}
        assert counts == {"completed": 3.0, "failed": 1.0}
        qs = {lb["quantile"]: v for lb, v in prom["infer_e2e_seconds"] if "quantile" in lb}
        assert set(qs) == {"0.5", "0.95", "0.99"}
        assert qs["0.5"] <= qs["0.95"] <= qs["0.99"]
        (_, total), = prom["infer_e2e_seconds_sum"]
        assert total == pytest.approx(0.43, rel=1e-6)
        (_, n), = prom["infer_e2e_seconds_count"]
        assert n == 3

    def test_module_hooks_are_noops_without_sink(self):
        telemetry.install(None)
        telemetry.observe("x_seconds", 1.0)  # must not raise
        telemetry.inc_metric("x_total")
        telemetry.set_gauge("x", 2.0)
        assert telemetry.metrics_registry() is None

    def test_sink_writes_metrics_prom_and_heartbeat_latency(self, tmp_path):
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        telemetry.observe("train_step_seconds", 0.2)
        telemetry.observe("train_step_seconds", 0.3)
        tel.write_heartbeat(step=2)
        telemetry.uninstall(tel)
        prom = parse_prometheus((tmp_path / "metrics.prom").read_text())
        (_, n), = prom["train_step_seconds_count"]
        assert n == 2
        hb = json.loads((tmp_path / "heartbeat.json").read_text())
        snap = hb["latency"]["train_step_seconds"][""]
        assert snap["count"] == 2 and snap["p50"] is not None

    def test_no_metrics_no_prom_file(self, tmp_path):
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        tel.write_heartbeat(step=1)
        telemetry.uninstall(tel)
        assert not (tmp_path / "metrics.prom").exists()

    def test_heartbeat_crash_mid_write_leaves_previous_intact(self, tmp_path):
        tel = telemetry.Telemetry(str(tmp_path))
        tel.write_heartbeat(step=1)
        faultinject.arm(crash="heartbeat_write")
        with pytest.raises(faultinject.InjectedCrash):
            tel.write_heartbeat(step=2)
        assert json.loads((tmp_path / "heartbeat.json").read_text())["step"] == 1
        tel.close()


# --------------------------------------------------- trace-id propagation


def _linear_fn(a, b):
    return (a * 2.0 - b).sum(-1, keepdim=True)


def _requests(n, shape=(24, 48), trace_ids=None):
    rng = np.random.RandomState(0)
    return [InferRequest(payload=i, inputs=(rng.rand(*shape, 3).astype(np.float32),
                                            rng.rand(*shape, 3).astype(np.float32)),
                         trace_id=trace_ids[i] if trace_ids else None)
            for i in range(n)]


def _engine(**kw):
    kw.setdefault("batch", 2)
    kw.setdefault("retry_backoff_s", 0.01)
    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(_linear_fn, device="cpu", **kw)


@pytest.fixture()
def tel_dir(tmp_path):
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
    yield tmp_path
    telemetry.uninstall(tel)


def _events(tmp_path, name=None):
    out = [json.loads(line) for line in (tmp_path / "events.jsonl").read_text().splitlines()
           if line.strip()]
    return [e for e in out if name is None or e["event"] == name]


class TestTraceIds:
    def test_new_trace_id_is_fresh_hex_in_every_process(self):
        """16 hex chars, as the JAX module's; unique; untouched by a caller
        seeding ``random``; and the reseed a forked child runs draws other
        ids than the parent's generator would."""
        saved = random.getstate()
        try:
            random.seed(0)
            ids = [telemetry.new_trace_id() for _ in range(20000)]
            random.seed(0)
            assert telemetry.new_trace_id() not in ids
        finally:
            random.setstate(saved)
        assert len(set(ids)) == len(ids)
        assert all(len(t) == 16 and int(t, 16) >= 0 for t in ids)
        assert len(jax_telemetry.new_trace_id()) == 16
        parent = random.Random()
        parent.setstate(telemetry._trace_rng.getstate())
        telemetry._reseed_trace_ids()  # what a forked child runs first
        assert telemetry.new_trace_id() != f"{parent.getrandbits(64):016x}"

    def test_results_carry_caller_supplied_and_assigned_ids(self, tel_dir):
        # slots 0/2 name their own ids; slots 1/3 leave it to the stager
        reqs = _requests(4)
        reqs[0].trace_id = "caller-0"
        reqs[2].trace_id = "caller-2"
        eng = _engine()
        res = {r.payload: r for r in eng.stream(iter(reqs))}
        assert res[0].trace_id == "caller-0"
        assert res[2].trace_id == "caller-2"
        assigned = {res[1].trace_id, res[3].trace_id}
        assert all(t and t not in ("caller-0", "caller-2") for t in assigned)
        assert len(assigned) == 2  # unique per request
        # every batch commit names exactly its requests' ids
        commits = _events(tel_dir, "infer_batch_commit")
        committed = [t for e in commits for t in e["trace_ids"]]
        assert sorted(committed) == sorted(r.trace_id for r in res.values())

    def test_propagation_through_retry_circuit_fallback(self, tel_dir):
        # the compile fails on every attempt for the first key: retry ->
        # budget spent -> circuit -> per-image path; the same trace ids
        # appear at every rung of the ladder
        faultinject.arm(infer_compile_fail={0, 1, 2, 3, 4, 5})
        eng = _engine(batch=2, retries=2)
        reqs = _requests(4, trace_ids=[f"t{i}" for i in range(4)])
        res = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in res.values())  # the per-image path served them all
        retries = _events(tel_dir, "infer_retry")
        assert retries and all(set(e["trace_ids"]) == {"t0", "t1"} for e in retries)
        circuit, = _events(tel_dir, "bucket_circuit_open")
        assert set(circuit["trace_ids"]) == {"t0", "t1"}
        degraded = _events(tel_dir, "infer_degraded")
        assert degraded and set(degraded[0]["trace_ids"]) == {"t0", "t1"}
        # the second batch goes straight to the (already open) circuit
        assert {tuple(e["trace_ids"]) for e in degraded} == {("t0", "t1"), ("t2", "t3")}
        # results still carry their ids through the degraded path
        assert [res[i].trace_id for i in range(4)] == ["t0", "t1", "t2", "t3"]

    def test_failed_decode_carries_trace_id(self, tel_dir):
        faultinject.arm(infer_decode_fail={1})
        eng = _engine()
        reqs = _requests(3, trace_ids=["a", "b", "c"])
        res = {r.payload: r for r in eng.stream(iter(reqs))}
        assert not res[0].ok and res[0].trace_id == "a"
        failed, = _events(tel_dir, "request_failed")
        assert failed["trace_id"] == "a" and failed["stage"] == "decode"

    def test_latency_summary_and_stream_summary(self, tel_dir):
        eng = _engine()
        list(eng.stream(iter(_requests(5))))
        summary = eng.stats.latency_summary()
        bucket, = summary.keys()
        comps = summary[bucket]
        for c in ("queue_wait", "decode", "h2d", "device", "e2e"):
            assert c in comps, (c, comps)
            row = comps[c]
            assert row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"] <= row["max_ms"]
        assert comps["e2e"]["count"] == 5
        s = publish_summary(eng.stats, label="t")
        assert s.latency == summary
        # the engine fed the registry too: prom carries the same buckets
        prom = telemetry.get().metrics.to_prometheus()
        assert f'infer_e2e_seconds{{bucket="{bucket}",quantile="0.5"}}' in prom
        assert 'infer_requests_total{status="completed"} 5' in prom

    def test_every_engine_event_is_declared(self, tel_dir):
        faultinject.arm(infer_decode_fail={2}, infer_oom_batch=2)
        eng = _engine(batch=2)
        list(eng.stream(iter(_requests(5))))
        publish_summary(eng.stats, label="t")
        events = _events(tel_dir)
        assert {"bucket_compile", "infer_batch_commit", "request_failed", "infer_degraded",
                "stream_summary"} <= {e["event"] for e in events}
        _check_declared(events)


def _check_declared(events):
    for e in events:
        assert e["event"] in jax_telemetry.EVENT_SCHEMA, e
        allowed = set(jax_telemetry.EVENT_SCHEMA[e["event"]]) | jax_telemetry.RESERVED_KEYS
        assert set(e) <= allowed, (e["event"], set(e) - allowed)


# ------------------------------------------------------------ run_report


class _ListWriter:
    """File-like adapter so print_human renders into a list of lines."""

    def __init__(self, out):
        self._out = out

    def write(self, s):
        if s != "\n":
            self._out.append(s.rstrip("\n"))

    def flush(self):
        pass


class TestRunReport:
    def _serve(self, run_dir, n=4):
        tel = telemetry.install(telemetry.Telemetry(str(run_dir)))
        eng = _engine()
        list(eng.stream(iter(_requests(n))))
        publish_summary(eng.stats, label="rr")
        telemetry.uninstall(tel)

    def test_malformed_event_lines_counted_not_fatal(self, tmp_path):
        self._serve(tmp_path)
        with open(tmp_path / "events.jsonl", "a") as f:
            f.write('{"event": "infer_batch_co')  # a SIGKILL'd tail
        report = build_report(str(tmp_path))
        assert report["events"]["malformed_lines"] == 1
        assert report["events"]["total"] > 0  # intact lines still parsed
        out = []
        print_human(report, out=_ListWriter(out))
        assert "1 malformed line(s) skipped" in "\n".join(out)

    def test_tail_attribution_section(self, tmp_path):
        self._serve(tmp_path, n=6)
        report = build_report(str(tmp_path))
        lat = report["latency"]
        assert lat["requests"]["completed"] == 6
        bucket, = lat["buckets"].keys()
        b = lat["buckets"][bucket]
        assert set(b["e2e_ms"]) == {"p50", "p95", "p99", "max"}
        assert b["tail_ratio_p99_over_p50"] >= 1.0
        att = b["attribution"]
        assert att and abs(sum(att.values()) - 1.0) < 0.01
        assert set(att) <= {"queue_wait", "decode", "h2d", "device"}
        out = []
        print_human(report, out=_ListWriter(out))
        text = "\n".join(out)
        assert "e2e p50" in text and "time attribution:" in text

    def test_no_prom_no_latency_section(self, tmp_path):
        (tmp_path / "events.jsonl").write_text(
            '{"event": "run_start", "t_wall": 0, "t_mono": 0, "host": 0}\n')
        report = build_report(str(tmp_path))
        assert report["latency"] is None


# ------------------------------------------- training: the JAX run's events

# The same scenario in both packages: a small model on a fixture SceneFlow
# tree, two steps at batch 8 (the JAX mesh's 8 CPU devices, one item each),
# a periodic checkpoint every step, the first batch NaN-poisoned and the
# first file read failing once.
SCENARIO = ["--train_datasets", "sceneflow", "--batch_size", "8", "--num_steps", "2",
            "--image_size", "32", "48", "--train_iters", "2", "--valid_iters", "2",
            "--noyjitter", "--validation_frequency", "1", "--hidden_dims", "32", "32", "32",
            "--corr_levels", "2", "--corr_radius", "2", "--telemetry"]


def _run_events(run_dir):
    return [json.loads(ln) for ln in (run_dir / "events.jsonl").read_text().splitlines()
            if ln.strip()]


def test_train_telemetry_writes_the_jax_runs_events(tmp_path, monkeypatch):
    from raft_stereo_tpu import train as jax_train
    from raft_stereo_tpu_torch import train

    ft.build_sceneflow(str(tmp_path), n_train=8)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RAFT_FI_NAN_STEP", "1")
    monkeypatch.setenv("RAFT_FI_IO_FAIL_READS", "1")
    runs = {}
    for name, run in (("port", lambda: train.main(["--name", "port", *SCENARIO],
                                                   device="cpu")),
                      ("jax", lambda: jax_train.main(["--name", "jax", *SCENARIO]))):
        faultinject.reset()
        from raft_stereo_tpu.runtime import faultinject as jax_faultinject

        jax_faultinject.reset()
        run()
        runs[name] = _run_events(tmp_path / "runs" / name)
    port, jax_run = runs["port"], runs["jax"]

    def by_name(events):
        out = {}
        for e in events:
            out.setdefault(e["event"], []).append(e)
        return out

    got, want = by_name(port), by_name(jax_run)
    assert {"io_retry", "nan_skip", "run_start", "run_end", "checkpoint_commit"} <= set(want)
    assert set(got) == set(want)
    for name, events in got.items():
        # every event of a kind carries the keys the JAX run's carry
        assert {frozenset(e) for e in events} == {frozenset(e) for e in want[name]}, name
        assert len(events) == len(want[name]), name
    _check_declared(port)
    assert got["nan_skip"][0]["step"] == 1 and got["run_end"][0]["outcome"] == "completed"

    run_dir = tmp_path / "runs" / "port"
    hb = json.loads((run_dir / "heartbeat.json").read_text())
    assert hb["step"] == 2 and hb["skipped_steps"] == 1 and hb["events"]["nan_skip"] == 1
    json.loads((run_dir / "trace_host.json").read_text())
    prom = parse_prometheus((run_dir / "metrics.prom").read_text())
    (_, n), = prom["train_step_seconds_count"]
    assert n == 2
    # MetricLogger rows fold in the event counters
    rows = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["event/nan_skip"] == 1.0
    # tools/run_report.py reads the port's run directory
    assert run_report.main([str(run_dir)]) == 0
    report = build_report(str(run_dir))
    assert report["events"]["total"] == len(port)


def test_profile_window_writes_a_chrome_trace(tmp_path):
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
    pw = telemetry.ProfileWindow(2, 3, str(tmp_path / "profile"))
    for step in range(1, 5):
        pw.on_step_start(step)
        torch.ones(8, 8).sum()
        pw.on_step_end(step)
    pw.close()
    telemetry.uninstall(tel)
    trace = json.loads((tmp_path / "profile" / "steps_2_3.pt.trace.json").read_text())
    assert trace["traceEvents"]
    names = [e["event"] for e in _events(tmp_path)]
    assert names == ["profile_start", "profile_stop"]


def test_recompile_detector_counts_repeat_captures_and_is_inert_on_eager_steps(tmp_path):
    from raft_stereo_tpu_torch.runtime.infer import GraphCache

    tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
    assert telemetry.RecompileDetector(lambda s, b: (s, {})).check(1) is False  # eager step
    cache = GraphCache(max_entries=1)
    det = telemetry.RecompileDetector(cache)
    cache.captures_by_key.update({"a": 1})
    assert det.check(1) is False
    cache.captures_by_key.update({"a": 1})  # "a" evicted and captured again
    assert det.check(2) is True and det.check(3) is False
    telemetry.uninstall(tel)
    ev, = _events(tmp_path, "recompile")
    assert ev["step"] == 2 and ev["cache_size"] == 0


def test_io_retry_budget_backoff_and_injection_come_from_the_environment(tmp_path,
                                                                         monkeypatch):
    from raft_stereo_tpu_torch.data import frame_io

    path = str(tmp_path / "d.pfm")
    frame_io.write_pfm(path, np.ones((4, 6), np.float32))
    monkeypatch.setenv("RAFT_IO_BACKOFF", "0")
    monkeypatch.setenv("RAFT_IO_RETRIES", "1")
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path / "run")))
    faultinject.arm(io_fail_reads={1})
    np.testing.assert_array_equal(frame_io.read_pfm(path), np.ones((4, 6), np.float32))
    faultinject.reset()
    monkeypatch.setenv("RAFT_FI_IO_FAIL_READS", "1,2")
    with pytest.raises(OSError, match="injected IO failure on read attempt 2"):
        frame_io.read_pfm(path)  # one retry, then the budget is spent
    assert faultinject.io_read_attempts() == 2
    telemetry.uninstall(tel)
    ev = _events(tmp_path / "run", "io_retry")
    assert [e["attempt"] for e in ev] == [1, 1] and all(e["path"] == path for e in ev)
    _check_declared(ev)


def test_train_lifecycle_events_preemption_resume_rotation_quarantine(tmp_path, monkeypatch):
    """SIGTERM at step 2, ``--resume auto`` to step 4, a periodic
    checkpoint every step with one kept, and one sample whose disparity
    file is gone: the preemption, resume, rotation and quarantine events,
    each declared in the JAX schema."""
    from raft_stereo_tpu_torch import train

    ft.build_sceneflow(str(tmp_path), n_train=6)
    gone = next((tmp_path / "datasets").rglob("0003.pfm"))
    gone.unlink()
    monkeypatch.chdir(tmp_path)
    args = ["--name", "life", "--num_steps", "4", "--validation_frequency", "1",
            "--keep_ckpts", "1", "--batch_size", "2", "--image_size", "32", "48",
            "--train_iters", "2", "--hidden_dims", "32", "32", "32", "--corr_levels", "2",
            "--corr_radius", "2"]
    monkeypatch.setenv("RAFT_FI_SIGTERM_STEP", "2")
    cut = train.main(args, device="cpu")
    assert cut.preempted and cut.total_steps == 2
    monkeypatch.delenv("RAFT_FI_SIGTERM_STEP")
    faultinject.reset()
    done = train.main(args + ["--resume", "auto"], device="cpu")
    assert done.total_steps == 4 and not done.preempted
    events = _run_events(tmp_path / "runs" / "life")
    names = [e["event"] for e in events]
    for want in ("preempt_signal", "preempt", "resume", "checkpoint_rotate", "quarantine",
                 "checkpoint_enqueue", "checkpoint_commit"):
        assert want in names, (want, sorted(set(names)))
    assert names.count("run_start") == 2 and names.count("run_end") == 2
    ends = [e["outcome"] for e in events if e["event"] == "run_end"]
    assert ends == ["preempted", "completed"]
    preempt, = [e for e in events if e["event"] == "preempt"]
    assert preempt["step"] == 2 and preempt["emergency_ckpt"].endswith("2_life")
    resume, = [e for e in events if e["event"] == "resume"]
    assert resume["step"] == 2 and resume["stream_pos"] == 2
    _check_declared(events)

"""The port's continuous-batching scheduler (``runtime/scheduler.py``) on
the CPU: the cases of ``tests/test_scheduler.py``, under the same names,
against the port's scheduler over the port's engine with a stand-in
forward, and the scheduler held to the JAX package's on a tiny RAFT model.

The parity case runs the JAX scheduler over the JAX engine and the port's
over the port's, on the same carried weights and one seeded mixed stream
with deadlines and priorities: both must dispatch the same groups in the
same order, and give outputs within the engine test's tolerance. Every
engine here has a deadline, so a scheduler that hangs fails its test (the
engine's stall watchdog) instead of the suite.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu import evaluate as jax_evaluate
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.runtime import faultinject as jax_faultinject
from raft_stereo_tpu.runtime import infer as jax_infer
from raft_stereo_tpu.runtime import scheduler as jax_scheduler
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    FlushRequest,
    InferenceEngine,
    InferOptions,
    InferRequest,
)
from raft_stereo_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler,
    SchedRequest,
    make_stream,
)
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

WAIT_S = 10.0  # every engine's deadline: no wait in this file outlasts it


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fi_reset():
    faultinject.reset()
    yield
    faultinject.reset()


def _linear_fn(a, b):
    return (a * 2.0 - b).sum(-1, keepdim=True)


def _requests(shapes, seed=0, payload_prefix=""):
    rng = np.random.RandomState(seed)
    return [
        InferRequest(
            payload=f"{payload_prefix}{i}" if payload_prefix else i,
            inputs=(rng.rand(h, w, 3).astype(np.float32),
                    rng.rand(h, w, 3).astype(np.float32)),
        )
        for i, (h, w) in enumerate(shapes)
    ]


def _engine(batch=4, **kw):
    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(_linear_fn, device="cpu", batch=batch, **kw)


def _events(run_dir):
    with open(f"{run_dir}/events.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


# ------------------------------------------------------------- equivalence


class TestFifoEquivalence:
    def test_bit_identical_to_engine_on_fifo_stream(self):
        """Bucket-contiguous arrival (with a partial drain per bucket): the
        scheduler forms exactly the engine's batches, outputs bitwise."""
        shapes = [(24, 48)] * 5 + [(40, 72)] * 6
        eng_a = _engine()
        want = {r.payload: r.output for r in eng_a.stream(iter(_requests(shapes)))}
        eng_b = _engine()
        sched = ContinuousBatchingScheduler(eng_b, max_wait_s=30.0)
        got = {r.payload: r.output for r in sched.serve(iter(_requests(shapes)))}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert eng_b.stats.images == len(shapes)
        assert sched.stats.admitted == len(shapes)
        assert sched.stats.flush_reasons.get("drain", 0) == 2

    def test_interleaved_mixed_stream_per_item_exact(self):
        """Arrival interleaves two buckets; every result still equals the
        per-item forward bitwise (reordering only regroups)."""
        shapes = [(24, 48), (40, 72)] * 5 + [(24, 48)]
        reqs = _requests(shapes, seed=3)
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        results = {r.payload: r for r in sched.serve(iter(reqs))}
        assert sorted(results) == list(range(len(reqs)))
        for i, req in enumerate(reqs):
            a, b = (torch.from_numpy(x)[None] for x in req.inputs)
            np.testing.assert_array_equal(results[i].output, _linear_fn(a, b)[0].numpy())

    def test_make_stream_routing(self):
        eng = _engine()
        assert make_stream(eng, None) == eng.stream
        assert make_stream(eng, InferOptions()) == eng.stream
        routed = make_stream(eng, InferOptions(sched=True, sched_max_wait=1.0))
        assert routed != eng.stream
        out = list(routed(iter(_requests([(24, 48)] * 2))))
        assert len(out) == 2 and all(r.ok for r in out)


# ---------------------------------------------------------------- ordering


class TestDispatchOrdering:
    def _admit_all(self, sched, items):
        for item in items:
            sched._admit_one(item)

    def test_earliest_deadline_full_bucket_first(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        a = _requests([(24, 48)] * 4, payload_prefix="a")
        b = _requests([(40, 72)] * 4, payload_prefix="b")
        self._admit_all(sched, a)
        self._admit_all(sched, [SchedRequest(r, deadline_s=0.5) for r in b])
        g1 = sched._next_group()
        g2 = sched._next_group()
        assert [r.payload for r in g1] == ["b0", "b1", "b2", "b3"]
        assert [r.payload for r in g2] == ["a0", "a1", "a2", "a3"]

    def test_priority_breaks_deadline_ties(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        a = _requests([(24, 48)] * 4, payload_prefix="a")
        b = _requests([(40, 72)] * 4, payload_prefix="b")
        self._admit_all(sched, a)
        self._admit_all(sched, [SchedRequest(r, priority=5) for r in b])
        g1 = sched._next_group()
        assert [r.payload for r in g1] == ["b0", "b1", "b2", "b3"]

    def test_fifo_between_equal_full_buckets(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        a = _requests([(24, 48)] * 4, payload_prefix="a")
        b = _requests([(40, 72)] * 4, payload_prefix="b")
        self._admit_all(sched, b)
        self._admit_all(sched, a)
        assert [r.payload for r in sched._next_group()][0] == "b0"

    def test_urgent_item_boards_the_batch_first(self):
        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
        reqs = _requests([(24, 48)] * 3, payload_prefix="r")
        self._admit_all(sched, [
            SchedRequest(reqs[0]),
            SchedRequest(reqs[1]),
            SchedRequest(reqs[2], deadline_s=0.1),
        ])
        g1 = sched._next_group()
        assert [r.payload for r in g1] == ["r2", "r0"]

    def test_starved_request_boards_ahead_of_urgent_newcomers(self):
        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=0.05)
        reqs = _requests([(24, 48)] * 3, payload_prefix="r")
        sched._admit_one(reqs[0])  # plain: no deadline (urgency = inf)
        time.sleep(0.07)           # r0 starves past max_wait
        sched._admit_one(SchedRequest(reqs[1], deadline_s=1.0))
        sched._admit_one(SchedRequest(reqs[2], deadline_s=1.0))
        g1 = sched._next_group()
        assert [r.payload for r in g1] == ["r0", "r1"]

    def test_partial_group_carries_flush_token(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=30.0)
        with sched._cond:
            sched._closed = False
        self._admit_all(sched, _requests([(24, 48)] * 2))
        with sched._cond:
            sched._closed = True  # end of stream: drain
        group = sched._next_group()
        assert isinstance(group[-1], FlushRequest)
        assert group[-1].bucket == (32, 64) and len(group) == 3
        assert sched.stats.flush_reasons == {"drain": 1}


# ---------------------------------------------------------------- fairness


class TestFairness:
    def test_partial_bucket_flushes_under_max_wait(self, tmp_path):
        """A 2-item bucket (never fillable) is dispatched mid-stream by the
        anti-starvation bound while the popular bucket keeps producing."""
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        try:
            rare = _requests([(40, 72)] * 2, payload_prefix="rare")
            bulk = _requests([(24, 48)] * 8, seed=5, payload_prefix="bulk")

            def paced():
                yield from rare
                for r in bulk:
                    yield r
                    time.sleep(0.05)

            sched = ContinuousBatchingScheduler(_engine(), max_wait_s=0.15)
            results = list(sched.serve(paced()))
        finally:
            telemetry.uninstall(tel)
        assert len(results) == 10 and all(r.ok for r in results)
        assert sched.stats.flush_reasons.get("max_wait", 0) >= 1
        flushes = [e for e in _events(tmp_path) if e["event"] == "sched_flush"]
        assert any(e["reason"] == "max_wait" and e["bucket"] == [64, 96] for e in flushes)

    def test_wait_histogram_and_depth_gauge_recorded(self, tmp_path):
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        try:
            sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
            list(sched.serve(iter(_requests([(24, 48)] * 4))))
            snap = tel.metrics.latency_snapshot()
            gauges = tel.metrics._snapshot()[1]
        finally:
            telemetry.uninstall(tel)
        assert "sched_wait_seconds" in snap
        (label,) = {k for k in snap["sched_wait_seconds"]}
        assert label == "bucket=32x64"
        assert snap["sched_wait_seconds"][label]["count"] == 4
        assert any(name == "sched_queue_depth" for name, _ in gauges)


# ------------------------------------------------------- engine passthrough


class TestEngineContracts:
    def test_failed_decode_isolated_with_trace(self, tmp_path):
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        try:
            def boom():
                raise OSError("decode died")

            reqs = _requests([(24, 48)] * 3)
            reqs.insert(1, InferRequest(payload="bad", inputs=boom,
                                        trace_id="feedcafe00000001"))
            sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
            results = list(sched.serve(iter(reqs)))
        finally:
            telemetry.uninstall(tel)
        ok = [r for r in results if r.ok]
        bad = [r for r in results if not r.ok]
        assert len(ok) == 3 and len(bad) == 1
        assert bad[0].payload == "bad"
        assert isinstance(bad[0].error, OSError)
        assert bad[0].trace_id == "feedcafe00000001"
        events = _events(tmp_path)
        failed = [e for e in events if e["event"] == "request_failed"]
        assert len(failed) == 1 and failed[0]["trace_id"] == "feedcafe00000001"
        admits = [e for e in events if e["event"] == "sched_admit"]
        assert any(e["trace_id"] == "feedcafe00000001" and e["bucket"] is None for e in admits)

    def test_trace_id_propagates_admission_to_commit(self, tmp_path):
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        try:
            reqs = _requests([(24, 48)] * 2)
            reqs[0].trace_id = "feedcafe00000002"
            sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
            results = {r.payload: r for r in sched.serve(iter(reqs))}
        finally:
            telemetry.uninstall(tel)
        assert results[0].trace_id == "feedcafe00000002"
        events = _events(tmp_path)
        admits = [e for e in events if e["event"] == "sched_admit"]
        commits = [e for e in events if e["event"] == "infer_batch_commit"]
        assert any(e["trace_id"] == "feedcafe00000002" for e in admits)
        assert any("feedcafe00000002" in (e.get("trace_ids") or []) for e in commits)

    def test_source_exception_raises_after_draining_admitted(self):
        served = []

        def requests():
            yield from _requests([(24, 48)] * 2)
            raise OSError("source died")

        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
        with pytest.raises(OSError, match="source died"):
            for r in sched.serve(requests()):
                served.append(r)
        assert all(r.ok for r in served)

    def test_reusable_across_serves_and_engine_state_persists(self):
        eng = _engine(batch=2)
        sched = ContinuousBatchingScheduler(eng, max_wait_s=30.0)
        list(sched.serve(iter(_requests([(24, 48)] * 2))))
        compiles = eng.stats.compiles
        out = list(sched.serve(iter(_requests([(24, 48)] * 2, seed=9))))
        assert len(out) == 2 and eng.stats.compiles == compiles  # the key is known
        assert sched.stats.batches == 2

    def test_double_serve_rejected(self):
        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)

        def slow():
            yield from _requests([(24, 48)] * 2)

        it = sched.serve(slow())
        next(it)
        with pytest.raises(RuntimeError, match="already active"):
            next(sched.serve(iter(_requests([(24, 48)] * 2))))
        it.close()

    def test_constructor_validation(self):
        with pytest.raises(ValueError, match="max_wait_s"):
            ContinuousBatchingScheduler(_engine(), max_wait_s=0)
        with pytest.raises(ValueError, match="admit_depth"):
            ContinuousBatchingScheduler(_engine(batch=8), admit_depth=4)

    def test_admit_depth_scales_with_large_batch(self):
        eng = _engine(batch=128)
        sched = ContinuousBatchingScheduler(eng)
        assert sched.admit_depth >= 128
        assert make_stream(eng, InferOptions(sched=True)) != eng.stream

    def test_consumer_abandon_releases_threads(self):
        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
        it = sched.serve(iter(_requests([(24, 48)] * 6)))
        first = next(it)
        assert first.ok
        t0 = time.perf_counter()
        it.close()
        assert time.perf_counter() - t0 < 10.0
        out = list(sched.serve(iter(_requests([(24, 48)] * 2, seed=11))))
        assert len(out) == 2


# ----------------------------------------------- the scheduler against JAX

JAX_CFG = JaxConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
                    corr_implementation="alt")
PORT_CFG = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                            corr_radius=2, corr_implementation="alt")
ITERS = 2
# A mixed stream over two buckets, (32, 64) and (64, 96), with deadlines far
# apart (the admission clock's jitter cannot reorder them) and priorities.
PARITY_STREAM = [  # (h, w, deadline_s, priority)
    (24, 48, None, 0), (40, 72, None, 0), (24, 48, 20.0, 0), (32, 64, None, 3),
    (40, 72, 5.0, 0), (24, 48, None, 0), (40, 72, None, 7), (24, 48, 10.0, 0),
    (24, 48, None, 1), (40, 72, None, 0), (32, 64, None, 0),
]


def _recorded_groups(sched, groups):
    """Wrap ``sched._next_group`` to record each dispatched group's payloads
    (its flush token dropped)."""
    inner = sched._next_group

    def record():
        group = inner()
        if group is not None:
            groups.append([r.payload for r in group if hasattr(r, "payload")])
        return group

    sched._next_group = record


def test_dispatch_groups_and_outputs_match_the_jax_scheduler():
    """The same carried weights and the same seeded mixed stream, with
    deadlines and priorities, through the JAX scheduler over the JAX engine
    and the port's over the port's (batch 4). The first dispatch pass
    stalls (each package's own RAFT_FI_SCHED_STALL point) until the whole
    stream is admitted, so both pick from the same queues: the groups must
    be the same, in the same order; every output within the engine test's
    tolerance (atol 5e-3 on the upsampled disparity)."""
    rng = np.random.RandomState(21)
    arrays = [tuple((rng.rand(h, w, 3) * 255).astype(np.float32) for _ in range(2))
              for h, w, _, _ in PARITY_STREAM]

    jmodel = JaxRAFTStereo(JAX_CFG)
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(0))
    jengine = jax_evaluate.make_engine(jmodel, variables, ITERS,
                                       jax_infer.InferOptions(batch=4, deadline_s=60.0))
    jsched = jax_scheduler.ContinuousBatchingScheduler(jengine, max_wait_s=30.0)
    jgroups = []
    _recorded_groups(jsched, jgroups)
    jstream = [jax_scheduler.SchedRequest(jax_infer.InferRequest(payload=i, inputs=arrays[i]),
                                          priority=p, deadline_s=d)
               for i, (_, _, d, p) in enumerate(PARITY_STREAM)]
    jax_faultinject.reset()
    jax_faultinject.arm(sched_stall={1}, sched_stall_ms=400)
    try:
        want = {r.payload: r for r in jsched.serve(iter(jstream))}
    finally:
        jax_faultinject.reset()

    model = evaluate.load_model(PORT_CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    engine = evaluate.make_engine(model, ITERS, InferOptions(batch=4, deadline_s=60.0))
    sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
    groups = []
    _recorded_groups(sched, groups)
    stream = [SchedRequest(InferRequest(payload=i, inputs=arrays[i]), priority=p, deadline_s=d)
              for i, (_, _, d, p) in enumerate(PARITY_STREAM)]
    faultinject.arm(sched_stall={1}, sched_stall_ms=400)
    got = {r.payload: r for r in sched.serve(iter(stream))}

    assert groups == jgroups
    assert sum(len(g) for g in groups) == len(PARITY_STREAM)
    assert sched.stats.full_batches == jsched.stats.full_batches
    assert sched.stats.flush_reasons == jsched.stats.flush_reasons
    assert sorted(got) == sorted(want) == list(range(len(PARITY_STREAM)))
    for i, (h, w, _, _) in enumerate(PARITY_STREAM):
        assert got[i].ok and want[i].ok
        assert got[i].output.shape == (h, w, 1) and got[i].bucket == want[i].bucket
        np.testing.assert_allclose(got[i].output, np.asarray(want[i].output), atol=5e-3,
                                   rtol=1e-4)


def test_serving_flags_and_options_keep_the_jax_defaults():
    """Every serving flag of the port is a JAX flag with the JAX default,
    and the options both packages derive from the defaults, and from the
    scheduler and adaptive flags, agree field by field."""
    import argparse

    from raft_stereo_tpu_torch.runtime import infer

    p, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    infer.add_infer_args(p)
    jax_infer.add_infer_args(jp)
    mine = {a.dest: a.default for a in p._actions if a.dest != "help"}
    theirs = {a.dest: a.default for a in jp._actions if a.dest != "help"}
    assert set(mine) <= set(theirs)
    assert {k: theirs[k] for k in mine} == mine
    for argv in ([], ["--sched", "--sched_max_wait", "0.5", "--max_pending", "8",
                      "--drain_timeout", "3", "--canary_every", "4", "--golden_dir", "g"],
                 ["--adaptive_iters", "--iter_tiers", "7,16", "--converge_eps", "0.2",
                  "--no_quality", "--quality_window", "8"]):
        opts = infer.options_from_args(p.parse_args(argv))
        jopts = jax_infer.options_from_args(jp.parse_args(argv))
        for f in InferOptions.__dataclass_fields__:
            assert getattr(opts, f) == getattr(jopts, f), f

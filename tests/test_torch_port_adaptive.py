"""Adaptive compute and video serving in the port, on the CPU: the cases of
``tests/test_adaptive_compute.py``, under the same names, against the port
(``runtime/infer.py``: ``parse_iter_tiers``, the options' gating,
``wrap_adaptive_stream``, ``eager_finalize``; ``runtime/scheduler.py``:
``SessionServer``; ``runtime/tiers.py``: ``IterTierPolicy`` and the
iteration tiers behind ``evaluate.make_serving``; the model's
``converge_eps`` exit with and without ``flow_init``); and, held to the JAX
package on the same inputs and carried weights, ``forward_interpolate`` and
``default_warm_fn`` (bitwise), the warm-started adaptive forward
(``evaluate.make_adaptive_forward``) and the iteration tiers' outputs and
dispatch (within the engine test's tolerance). Also ``update_variables`` on
the CPU, and ``demo.main --serve_video`` and ``--iter_tiers`` end to end.

Every engine here has a deadline, so a hang fails its test.
"""

import json
import queue
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu import evaluate as jax_evaluate
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.runtime import scheduler as jax_scheduler
from raft_stereo_tpu.utils import warm_start as jax_warm_start
from raft_stereo_tpu_torch import demo, evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.evaluate import make_serving
from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    ADAPTIVE_AUX_CHANNELS,
    InferenceEngine,
    InferOptions,
    InferRequest,
    InferResult,
    parse_iter_tiers,
    wrap_adaptive_stream,
)
from raft_stereo_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler,
    SchedRequest,
    SessionServer,
    SessionShedError,
    default_warm_fn,
)
from raft_stereo_tpu_torch.utils.warm_start import forward_interpolate
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(hidden_dims=(64, 64, 64), n_gru_layers=2)
WAIT_S = 10.0  # every engine's deadline


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(seed=0, **cfg):
    return evaluate.load_model(RAFTStereoConfig(**{**SMALL, **cfg}), device="cpu", seed=seed)


def _imgs(h=32, w=64, seed=0, batch=1):
    r = np.random.RandomState(seed)
    return (torch.from_numpy((r.rand(batch, h, w, 3) * 255).astype(np.float32)),
            torch.from_numpy((r.rand(batch, h, w, 3) * 255).astype(np.float32)))


def _events(td):
    return [json.loads(line) for line in open(f"{td}/events.jsonl") if line.strip()]


# ------------------------------------------------------------- CLI / config


def test_parse_iter_tiers():
    assert parse_iter_tiers("7,16,32") == (7, 16, 32)
    assert parse_iter_tiers("16,7,7") == (7, 16)
    assert parse_iter_tiers((4, 2)) == (2, 4)
    assert parse_iter_tiers(None) is None
    assert parse_iter_tiers("") is None
    with pytest.raises(ValueError):
        parse_iter_tiers("7,x")
    with pytest.raises(ValueError):
        parse_iter_tiers("0,4")


def test_options_gating_without_umbrella():
    """--iter_tiers / --converge_eps are inert while --adaptive_iters is
    absent: the options equal the defaults."""
    import argparse

    from raft_stereo_tpu_torch.runtime.infer import add_infer_args, options_from_args

    def opts(argv):
        p = argparse.ArgumentParser()
        add_infer_args(p)
        return options_from_args(p.parse_args(argv))

    off = opts(["--iter_tiers", "2,4", "--converge_eps", "0.5"])
    assert off == opts([])
    on = opts(["--adaptive_iters", "--iter_tiers", "2,4", "--converge_eps", "0.5"])
    assert on.adaptive_iters and on.iter_tiers == (2, 4)
    assert on.converge_eps == 0.5 and on.video is False


def test_config_rejects_negative_eps():
    with pytest.raises(ValueError):
        RAFTStereoConfig(converge_eps=-0.1)


# ------------------------------------------------------- model early exit


def test_eps_zero_is_the_unchanged_scan_path():
    m0, me = _model(), _model(converge_eps=0.0)
    i1, i2 = _imgs()
    out0, oute = m0(i1, i2, iters=3), me(i1, i2, iters=3)
    assert len(out0) == 2 and len(oute) == 2
    assert torch.equal(out0[1], oute[1]) and torch.equal(out0[0], oute[0])


def test_early_exit_never_changes_results_when_not_firing():
    m0, me = _model(), _model(converge_eps=1e-9)
    i1, i2 = _imgs()
    l0, d0 = m0(i1, i2, iters=3)
    le, de, it = me(i1, i2, iters=3)
    assert int(it) == 3
    assert torch.equal(de, d0) and torch.equal(le, l0)
    assert list(m0.state_dict()) == list(me.state_dict())


def test_early_exit_fires_and_counts():
    me = _model(converge_eps=1e9)
    i1, i2 = _imgs()
    _, _, it = me(i1, i2, iters=6)
    assert int(it) == 2  # one probe step and the masked one
    _, _, it1 = me(i1, i2, iters=1)
    assert int(it1) == 1


def test_early_exit_respects_flow_init():
    m0, me = _model(), _model(converge_eps=1e-9)
    i1, i2 = _imgs()
    lowres, _ = m0(i1, i2, iters=2)
    out0 = m0(i1, i2, iters=2, flow_init=lowres)
    oute = me(i1, i2, iters=2, flow_init=lowres)
    assert torch.equal(oute[1], out0[1])


# --------------------------------------------------- aux channels + wrapper


def test_wrap_adaptive_stream_strips_and_counts():
    tiers_total, tiers_done = 8, 5
    out = np.zeros((6, 10, 1 + ADAPTIVE_AUX_CHANNELS), np.float32)
    out[..., 0] = 7.0
    out[..., 1] = tiers_done
    out[..., 2] = tiers_total

    def stream_fn(requests):
        for req in requests:
            yield InferResult(payload=req.payload, output=out.copy(), bucket=(32, 64),
                              trace_id="t1")

    with tempfile.TemporaryDirectory() as td:
        tel = telemetry.install(telemetry.Telemetry(td))
        try:
            res = list(wrap_adaptive_stream(stream_fn)([InferRequest(payload=0, inputs=None)]))
        finally:
            telemetry.uninstall(tel)
        assert res[0].output.shape == (6, 10, 1)
        assert float(res[0].output[0, 0, 0]) == 7.0
        ee = [e for e in _events(td) if e["event"] == "refine_early_exit"]
        assert len(ee) == 1 and ee[0]["saved"] == 3
        assert ee[0]["iters"] == 8 and ee[0]["iters_done"] == 5

    def err_stream(requests):
        yield InferResult(payload=1, error=RuntimeError("x"))
        yield InferResult(payload=2, output=np.zeros((4, 4, 1), np.float32))

    res = list(wrap_adaptive_stream(err_stream)([]))
    assert not res[0].ok and res[1].output.shape == (4, 4, 1)


# ------------------------------------------------------------- refusals


def test_adaptive_rejects_per_image():
    import argparse

    from raft_stereo_tpu_torch.evaluate import add_model_args, load_model
    from raft_stereo_tpu_torch.runtime.infer import add_infer_args

    p = argparse.ArgumentParser()
    add_model_args(p)
    add_infer_args(p)
    args = p.parse_args(["--adaptive_iters", "--per_image", "--converge_eps", "0.3"])
    with pytest.raises(SystemExit):
        load_model(args, device="cpu")


@pytest.mark.parametrize("flag", [["--tier", "quality"], ["--cascade"], ["--aot_dir", "d"]])
def test_adaptive_rejects_tier_cascade_combo(flag):
    """Iteration tiers of one model and the multi-model --tier/--cascade are
    two routers with no defined policy in series: refused, as the JAX CLI
    refuses them; the port's CLI has no executable store (--aot_dir)."""
    with pytest.raises(SystemExit):
        evaluate.main(["--dataset", "eth3d", "--adaptive_iters", *flag], device="cpu")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        make_serving(_model(), 4, InferOptions(adaptive_iters=True, tier="quality"))


def test_adaptive_serving_rejects_config_mismatch():
    with pytest.raises(ValueError):
        make_serving(_model(), 4, InferOptions(adaptive_iters=True, converge_eps=0.5))


# ------------------------------------------------------------- tier policy


def test_iter_tier_policy_precedence():
    from raft_stereo_tpu_torch.runtime.tiers import IterTierPolicy, iter_tier_name

    pol = IterTierPolicy((7, 16, 32))
    assert pol.fast == "iters7" and pol.default == "iters32"
    req = InferRequest(payload=0, inputs=None)
    # a pin snaps up to the nearest allowed tier
    assert pol.select(SchedRequest(req, iters=7)) == ("iters7", "pinned")
    assert pol.select(SchedRequest(req, iters=10)) == ("iters16", "pinned")
    assert pol.select(SchedRequest(req, iters=99)) == ("iters32", "pinned")
    # an explicit tier name wins over the deadline
    assert pol.select(SchedRequest(req, tier="iters16", deadline_s=0.1)) == \
        ("iters16", "explicit")
    # deadline-tight rides the smallest tier; the default the largest
    assert pol.select(SchedRequest(req, deadline_s=0.5)) == ("iters7", "deadline")
    assert pol.select(SchedRequest(req, deadline_s=30.0)) == ("iters32", "default")
    assert pol.select(req) == ("iters32", "default")
    assert iter_tier_name(7) == "iters7"
    with pytest.raises(ValueError):
        IterTierPolicy(())
    with pytest.raises(ValueError):
        IterTierPolicy((0, 4))


def test_iter_tier_serving_routes_and_strips(tmp_path):
    """Two iteration tiers of one tiny model behind make_serving: pins route
    to the right tier (tier_dispatch events), every result resolves once,
    and consumers see the stripped [H, W, 1] contract. One count serves on
    one engine, eagerly with the convergence exit."""
    model = _model(converge_eps=0.05)
    infer = InferOptions(batch=2, adaptive_iters=True, iter_tiers=(2, 4), converge_eps=0.05,
                         deadline_s=WAIT_S)
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
    try:
        serving, stream = make_serving(model, 4, infer)

        def requests():
            for i in range(4):
                a = np.random.default_rng(i).random((32, 64, 3), dtype=np.float32) * 255
                yield SchedRequest(InferRequest(payload=i, inputs=(a, a)),
                                   iters=2 if i % 2 else None)

        outs = {res.payload: res for res in stream(requests())}
    finally:
        telemetry.uninstall(tel)
    assert len(outs) == 4 and all(r.ok for r in outs.values())
    assert all(r.output.shape == (32, 64, 1) for r in outs.values())
    disp = [(e["tier"], e["reason"]) for e in _events(tmp_path) if e["event"] == "tier_dispatch"]
    assert sorted(disp) == [("iters2", "pinned")] * 2 + [("iters4", "default")] * 2, disp
    assert sorted(serving.tier_set.names) == ["iters2", "iters4"]
    assert not any(e.capture for e in serving.tier_set.engines.values())
    engine, _ = make_serving(model, 16, InferOptions(adaptive_iters=True, iter_tiers=(16,),
                                                     converge_eps=0.05))
    assert isinstance(engine, InferenceEngine) and not engine.capture


def test_video_multi_tier_plain_engines_never_starve():
    """Video + iteration tiers without --sched routes gated frames to plain
    tier engines at batch 2: the session layer's FlushRequest reaches the
    routed tier (the TieredServer passes it to its plain tiers), or frame 0
    would wait for batchmates its own gate forbids."""
    infer = InferOptions(batch=2, adaptive_iters=True, converge_eps=0.05, iter_tiers=(2, 4),
                         video=True, deadline_s=WAIT_S)
    serving, stream = make_serving(_model(converge_eps=0.05), 4, infer)

    def requests():
        for i in range(3):
            a, b = _frame(7, h=32)
            yield SchedRequest(InferRequest(payload=i, inputs=(a, b)), session="v")

    res = list(stream(requests()))
    assert len(res) == 3 and all(r.ok for r in res), [str(r.error) for r in res if not r.ok]


@pytest.mark.parametrize("eps", [0.0, 0.05], ids=["captured_route", "early_exit"])
def test_iter_tiers_serve_as_the_jax_tiers(eps, tmp_path):
    """The same carried weights and mixed contexts through the port's and
    the JAX package's make_serving with --iter_tiers 2,4 (batch 2): each
    payload goes to the same tier for the same reason, and its disparity is
    within the engine test's tolerance of the JAX one (atol 5e-3, rtol
    1e-4)."""
    from raft_stereo_tpu.runtime import infer as jinfer
    from raft_stereo_tpu.runtime import telemetry as jtelemetry

    cfg = dict(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
               corr_implementation="alt", converge_eps=eps)
    jmodel = JaxRAFTStereo(JaxConfig(**cfg))
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    variables = jax.jit(lambda k: JaxRAFTStereo(JaxConfig(**{**cfg, "converge_eps": 0.0})).init(
        k, img, img, iters=1, test_mode=True))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(9)
    pairs = [tuple((rng.rand(32, 64, 3) * 255).astype(np.float32) for _ in range(2))
             for _ in range(6)]
    ctx = [dict(iters=2), dict(), dict(deadline_s=0.5), dict(iters=3), dict(tier="iters2"),
           dict(deadline_s=5.0)]

    jtel = jtelemetry.install(jtelemetry.Telemetry(str(tmp_path / "jax")))
    try:
        _, jstream = jax_evaluate.make_serving(
            jmodel, variables, 4, jinfer.InferOptions(batch=2, adaptive_iters=True,
                                                      iter_tiers=(2, 4), converge_eps=eps))
        want = {r.payload: r for r in jstream(iter(
            [jax_scheduler.SchedRequest(jinfer.InferRequest(payload=i, inputs=p), **c)
             for i, (p, c) in enumerate(zip(pairs, ctx))]))}
    finally:
        jtelemetry.uninstall(jtel)
    model = evaluate.load_model(RAFTStereoConfig(**cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path / "port")))
    try:
        _, stream = make_serving(model, 4, InferOptions(batch=2, adaptive_iters=True,
                                                        iter_tiers=(2, 4), converge_eps=eps,
                                                        deadline_s=WAIT_S))
        got = {r.payload: r for r in stream(iter(
            [SchedRequest(InferRequest(payload=i, inputs=p), **c)
             for i, (p, c) in enumerate(zip(pairs, ctx))]))}
    finally:
        telemetry.uninstall(tel)

    def routes(run_dir):
        return sorted((e["tier"], e["reason"]) for e in _events(run_dir)
                      if e["event"] == "tier_dispatch")

    assert routes(tmp_path / "port") == routes(tmp_path / "jax")
    assert sorted(got) == sorted(want) == list(range(6))
    for k, r in got.items():
        assert r.ok and want[k].ok and r.output.shape == (32, 64, 1)
        np.testing.assert_allclose(r.output, np.asarray(want[k].output), atol=5e-3, rtol=1e-4)


def test_demo_iter_tiers_end_to_end(tmp_path):
    """``demo.main --adaptive_iters --iter_tiers 2,3`` with a tiny model:
    every pair is served (by the default, largest tier) and saved; the
    merged stats count each pair once."""
    _write_frames(tmp_path / "frames", 3)
    run = demo.main(["--hidden_dims", "32", "32", "32", "--n_gru_layers", "1",
                     "--corr_levels", "2", "--corr_radius", "2", "--corr_implementation", "alt",
                     "--valid_iters", "3", "--adaptive_iters", "--iter_tiers", "2,3",
                     "-l", str(tmp_path / "frames" / "*" / "im0.png"),
                     "-r", str(tmp_path / "frames" / "*" / "im1.png"),
                     "--output_directory", str(tmp_path / "out"), "--infer_batch", "2",
                     "--infer_timeout", str(WAIT_S)], device="cpu")
    assert run.saved == 3 and run.shapes == [(32, 64, 1)] * 3
    assert run.engine.stats.images == 3 and run.graphs is None
    assert run.engine.tier_set.engine("iters3").stats.images == 3


# --------------------------------------------------------- session serving


def _toy_engine(batch=2, chain=False, **kw):
    """A toy 3-slot engine: output channel 0 a function of the pair; with
    ``chain`` the warm slot's per-item mean is folded in, so a warm frame's
    output contains its predecessor's."""

    def fn(a, b, warm):
        base = (a * 2.0 - b).sum(-1, keepdim=True)
        if chain:
            base = base + warm[..., :1].mean(dim=(1, 2), keepdim=True)
        return base

    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(fn, device="cpu", batch=batch, eager_finalize=True, **kw)


def _frame(i, h=24, w=48):
    r = np.random.RandomState(i)
    return r.rand(h, w, 3).astype(np.float32), r.rand(h, w, 3).astype(np.float32)


def _ident(d):
    return np.stack([d, np.zeros_like(d)], -1)


def test_session_serializes_and_warm_starts():
    engine = _toy_engine(chain=True)
    server = SessionServer(engine.stream, warm_fn=_ident)

    def requests():
        for i in range(4):
            yield SchedRequest(InferRequest(payload=("s", i),
                                            inputs=lambda i=i: _frame(i, h=32, w=64)),
                               session="s0")
        yield InferRequest(payload="plain", inputs=lambda: _frame(9, h=32, w=64))

    with tempfile.TemporaryDirectory() as td:
        tel = telemetry.install(telemetry.Telemetry(td))
        try:
            res = list(server.serve(requests()))
        finally:
            telemetry.uninstall(tel)
    assert all(r.ok for r in res), [str(r.error) for r in res if not r.ok]
    by_payload = {r.payload: r.output for r in res}
    assert len(by_payload) == 5
    session_order = [r.payload[1] for r in res if r.payload != "plain"]
    assert session_order == sorted(session_order)

    def base(i):
        a, b = _frame(i, h=32, w=64)
        return (a * 2.0 - b).sum(-1, keepdims=True)

    np.testing.assert_allclose(by_payload[("s", 0)], base(0), rtol=1e-5)
    prev = by_payload[("s", 0)]
    for i in range(1, 4):
        expect = base(i) + np.float32(prev[..., 0].mean())
        np.testing.assert_allclose(by_payload[("s", i)], expect, rtol=1e-4)
        prev = by_payload[("s", i)]
    np.testing.assert_allclose(by_payload["plain"], base(9), rtol=1e-5)
    assert server.summary()["warm_hits"] == 3


def test_session_sticky_under_scheduler_reordering():
    engine = _toy_engine(batch=2)
    sched = ContinuousBatchingScheduler(engine, max_wait_s=0.1)
    server = SessionServer(sched.serve, forward_sched=True, warm_fn=_ident)

    def requests():
        for i in range(6):
            yield SchedRequest(InferRequest(payload=("a", i), inputs=lambda i=i: _frame(i)),
                               session="a")
            other = InferRequest(payload=("b", i), inputs=lambda i=i: _frame(100 + i, h=40))
            yield SchedRequest(other, priority=5)

    res = list(server.serve(requests()))
    assert all(r.ok for r in res)
    order_a = [r.payload[1] for r in res if r.payload[0] == "a"]
    assert order_a == sorted(order_a)
    assert len(res) == 12


def test_session_resets_typed_after_error():
    engine = _toy_engine(batch=1)
    server = SessionServer(engine.stream, warm_fn=_ident)

    def requests():
        for i in range(4):
            yield SchedRequest(InferRequest(payload=i, inputs=lambda i=i: _frame(i)),
                               session="s")

    with tempfile.TemporaryDirectory() as td:
        tel = telemetry.install(telemetry.Telemetry(td))
        faultinject.reset()
        faultinject.arm(infer_decode_fail={2})  # frame payload 1
        try:
            res = {r.payload: r for r in server.serve(requests())}
        finally:
            faultinject.reset()
            telemetry.uninstall(tel)
        assert not res[1].ok and res[0].ok and res[2].ok and res[3].ok
        warm = {e["frame"]: e for e in _events(td) if e["event"] == "session_warm_start"}
        assert warm[0]["warm"] is False and warm[0]["reason"] == "first"
        assert 1 not in warm
        assert warm[2]["warm"] is False and warm[2]["reason"] == "reset"
        assert warm[3]["warm"] is True


def test_session_drain_resolves_parked_typed():
    engine = _toy_engine(batch=1)

    def truncated_stream(requests):
        for k, res in enumerate(engine.stream(requests)):
            yield res
            if k == 0:
                return

    server = SessionServer(truncated_stream, warm_fn=_ident)

    def requests():
        for i in range(4):
            yield SchedRequest(InferRequest(payload=i, inputs=lambda i=i: _frame(i)),
                               session="s")

    with tempfile.TemporaryDirectory() as td:
        tel = telemetry.install(telemetry.Telemetry(td))
        try:
            res = {r.payload: r for r in server.serve(requests())}
        finally:
            telemetry.uninstall(tel)
        assert len(res) == 4
        assert res[0].ok
        shed = [p for p, r in res.items() if not r.ok and isinstance(r.error, SessionShedError)]
        assert shed, res
        assert sum(1 for e in _events(td) if e["event"] == "session_shed") == len(shed)


def test_session_state_never_crosses_serves():
    engine = _toy_engine(batch=1)
    server = SessionServer(engine.stream, warm_fn=_ident)

    def requests():
        yield SchedRequest(InferRequest(payload=0, inputs=lambda: _frame(0)), session="s")

    with tempfile.TemporaryDirectory() as td:
        tel = telemetry.install(telemetry.Telemetry(td))
        try:
            assert [r.ok for r in server.serve(requests())] == [True]
            assert [r.ok for r in server.serve(requests())] == [True]
        finally:
            telemetry.uninstall(tel)
        warm = [e for e in _events(td) if e["event"] == "session_warm_start"]
        assert [e["warm"] for e in warm] == [False, False]
        assert server.summary()["frames"] == 2
        assert server.summary()["warm_hits"] == 0


def test_session_consumer_abandon_leaves_no_threads():
    def stagers():
        return sum(1 for t in threading.enumerate() if t.name == "infer-stager" and t.is_alive())

    before = stagers()
    engine = _toy_engine(batch=1)
    server = SessionServer(engine.stream, warm_fn=_ident)

    def requests():
        for i in range(6):
            yield SchedRequest(InferRequest(payload=i, inputs=lambda i=i: _frame(i)),
                               session="s")

    gen = server.serve(requests())
    first = next(gen)
    assert first.ok
    gen.close()
    deadline = time.monotonic() + 5.0
    while stagers() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert stagers() == before, "abandoned serve leaked a stager thread"
    res = list(server.serve(requests()))
    assert len(res) == 6 and all(r.ok for r in res)


def test_eager_finalize_serves_dependent_streams():
    """A source whose request t+1 depends on result t completes under
    eager_finalize; the default stays off."""
    engine = _toy_engine(batch=1)
    assert InferenceEngine(lambda a, b: a, device="cpu", batch=1).eager_finalize is False
    results_q: "queue.Queue" = queue.Queue()

    def dependent():
        a, b = _frame(0)
        yield InferRequest(payload=0, inputs=(a, b, np.zeros(a.shape[:2] + (2,), np.float32)))
        got = results_q.get(timeout=WAIT_S)  # must arrive BEFORE request 1
        a, b = _frame(1)
        yield InferRequest(payload=(1, got),
                           inputs=(a, b, np.zeros(a.shape[:2] + (2,), np.float32)))

    n = 0
    for res in engine.stream(dependent()):
        assert res.ok
        results_q.put(res.payload)
        n += 1
    assert n == 2


# --------------------------------------------------------------- video e2e


def test_video_serving_end_to_end():
    model = _model(converge_eps=0.05)
    infer = InferOptions(batch=1, adaptive_iters=True, converge_eps=0.05, video=True,
                         deadline_s=WAIT_S)
    with tempfile.TemporaryDirectory() as td:
        tel = telemetry.install(telemetry.Telemetry(td))
        try:
            serving, stream = make_serving(model, 3, infer)

            def requests():
                for i in range(3):
                    a, b = _frame(7)  # identical frames
                    yield SchedRequest(InferRequest(payload=i, inputs=(a, b)), session="v")

            res = list(stream(requests()))
        finally:
            telemetry.uninstall(tel)
        assert all(r.ok for r in res) and len(res) == 3
        assert all(r.output.shape == (24, 48, 1) for r in res)
        warm = [e for e in _events(td) if e["event"] == "session_warm_start"]
        assert [e["warm"] for e in warm] == [False, True, True]
        assert not serving.capture and serving.eager_finalize


def _write_frames(root, n, h=32, w=64):
    from PIL import Image

    rng = np.random.RandomState(3)
    tex = (rng.rand(h, w + 16, 3) * 255).astype(np.uint8)
    for k in range(n):
        d = root / f"frame{k}"
        d.mkdir(parents=True)
        Image.fromarray(np.ascontiguousarray(tex[:, k:k + w])).save(d / "im0.png")
        Image.fromarray(np.ascontiguousarray(tex[:, k + 4:k + 4 + w])).save(d / "im1.png")


def test_demo_serve_video_end_to_end(tmp_path):
    """``demo.main --serve_video --adaptive_iters --converge_eps`` on three
    frames with a tiny model: one session, frames served in order, the
    first cold and the rest warm, each output [H, W, 1]; --serve_video
    without --adaptive_iters is refused."""
    _write_frames(tmp_path / "frames", 3)
    tiny = ["--hidden_dims", "32", "32", "32", "--n_gru_layers", "1", "--corr_levels", "2",
            "--corr_radius", "2", "--corr_implementation", "alt", "--valid_iters", "3",
            "-l", str(tmp_path / "frames" / "*" / "im0.png"),
            "-r", str(tmp_path / "frames" / "*" / "im1.png"),
            "--output_directory", str(tmp_path / "out"), "--infer_batch", "1",
            "--infer_timeout", str(WAIT_S)]
    with pytest.raises(SystemExit, match="--adaptive_iters"):
        demo.main(tiny + ["--serve_video"], device="cpu")
    run = demo.main(tiny + ["--serve_video", "--adaptive_iters", "--converge_eps", "0.05",
                            "--telemetry_dir", str(tmp_path / "tel")], device="cpu")
    assert run.saved == 3 and run.shapes == [(32, 64, 1)] * 3 and len(run.seconds) == 3
    events = _events(tmp_path / "tel")
    warm = [e for e in events if e["event"] == "session_warm_start"]
    assert [(e["frame"], e["warm"]) for e in warm] == [(0, False), (1, True), (2, True)]
    assert sorted(p.name for p in (tmp_path / "out").glob("*.png")) == [
        f"frame{k}.png" for k in range(3)]


# ------------------------------------------ warm start against the JAX package


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_interpolate_equals_the_jax_helper(seed):
    """Seeded flows (x only, x and y, targets off the image): the port's
    forward_interpolate and default_warm_fn equal the JAX helpers bitwise."""
    rng = np.random.RandomState(seed)
    h, w = 24 + 5 * seed, 40 + 7 * seed
    xy = (rng.randn(h, w, 2) * (3.0 + 4 * seed)).astype(np.float32)
    x_only = np.stack([xy[..., 0], np.zeros_like(xy[..., 0])], -1)
    for flow in (xy, x_only):
        got, want = forward_interpolate(flow), jax_warm_start.forward_interpolate(flow)
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    disp = xy[..., 0]
    assert default_warm_fn(disp).tobytes() == jax_scheduler.default_warm_fn(disp).tobytes()


JAX_TINY = JaxConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
                     corr_implementation="alt")
PORT_TINY = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                             corr_radius=2, corr_implementation="alt")


@pytest.fixture(scope="module")
def jax_tiny_variables():
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    return jax.jit(lambda k: JaxRAFTStereo(JAX_TINY).init(
        k, img, img, iters=1, test_mode=True))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("eps", [0.0, 1e-9, 1e9])
def test_warm_started_adaptive_forward_matches_jax(eps, jax_tiny_variables):
    """``make_adaptive_forward(model, 3, video=True)`` against the JAX one on
    the same carried weights, images and warm slot (a forward-interpolated
    disparity field of a few px): the disparity within the engine test's
    tolerance (atol 5e-3, rtol 1e-4), the aux channels ([iters_done,
    iters_total] with the exit armed) equal; with the exit never firing
    (1e-9) and always firing (1e9)."""
    import dataclasses

    jmodel = JaxRAFTStereo(dataclasses.replace(JAX_TINY, converge_eps=eps))
    variables = jax_tiny_variables
    rng = np.random.RandomState(5)
    a = (rng.rand(2, 32, 64, 3) * 255).astype(np.float32)
    b = (rng.rand(2, 32, 64, 3) * 255).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:64].astype(np.float32)
    slot = np.stack([default_warm_fn(-(4.0 + 2.0 * np.sin(xx / 9.0) + k * yy / 16.0))
                     for k in range(2)]).astype(np.float32)
    want = np.asarray(jax.jit(jax_evaluate.make_adaptive_forward(jmodel, 3, video=True))(
        variables, a, b, slot))

    model = evaluate.load_model(dataclasses.replace(PORT_TINY, converge_eps=eps), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = evaluate.make_adaptive_forward(model, 3, video=True)(
        *(torch.from_numpy(x) for x in (a, b, slot))).numpy()
    assert got.shape == want.shape == (2, 32, 64, 1 + (ADAPTIVE_AUX_CHANNELS if eps else 0))
    np.testing.assert_allclose(got[..., :1], want[..., :1], atol=5e-3, rtol=1e-4)
    if eps:
        np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
        assert got[0, 0, 0, 1] == (3 if eps < 1 else 2) and got[0, 0, 0, 2] == 3
    # the warm start matters: a zero slot gives another disparity
    cold = evaluate.make_adaptive_forward(model, 3, video=True)(
        torch.from_numpy(a), torch.from_numpy(b), torch.zeros(slot.shape)).numpy()
    assert np.abs(cold[..., 0] - got[..., 0]).max() > 1e-2


# --------------------------------------------------------- update_variables

TINY = dict(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2)


def _serve(engine, seed=11):
    rng = np.random.RandomState(seed)
    reqs = [InferRequest(payload=i, inputs=tuple((rng.rand(h, w, 3) * 255).astype(np.float32)
                                                 for _ in range(2)))
            for i, (h, w) in enumerate([(32, 64), (24, 48), (40, 72)])]
    return {r.payload: r.output for r in engine.stream(iter(reqs))}


def test_update_variables_serves_the_new_weights():
    """After ``update_variables(state_dict)`` the engine serves what a fresh
    engine on those weights serves (bitwise, on the CPU's eager forward),
    with no new compile; a foreign state dict is refused."""
    old = _model(seed=0, **TINY)
    engine = evaluate.make_engine(old, 2, InferOptions(batch=2, deadline_s=WAIT_S))
    before = _serve(engine)
    compiles = engine.stats.compiles
    new = _model(seed=1, **TINY)
    engine.update_variables(new.state_dict())
    after = _serve(engine)
    want = _serve(evaluate.make_engine(new, 2, InferOptions(batch=2, deadline_s=WAIT_S)))
    assert engine.stats.compiles == compiles
    for k in want:
        np.testing.assert_array_equal(after[k], want[k])
        assert not np.array_equal(after[k], before[k])
    sd = new.state_dict()
    with pytest.raises(KeyError):
        engine.update_variables({k: v for k, v in list(sd.items())[1:]})
    name = next(k for k, v in sd.items() if v.ndim == 4)
    with pytest.raises(ValueError):
        engine.update_variables({**sd, name: sd[name][:1]})
    with pytest.raises(RuntimeError):
        InferenceEngine(lambda a, b: a, device="cpu").update_variables(sd)

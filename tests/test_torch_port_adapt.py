"""Online-adaptation serving of the port (``runtime/adapt.py``, the
adaptation injectors of ``runtime/faultinject.py``) on the CPU: the MAD
adaptation step against optax, and the cases of
``tests/test_adapt_serving.py`` on the port's server, held to the JAX
server on the same synthetic rig.

The rig is the JAX rig's: MADNet2 initialised by the JAX package at
PRNGKey(0), carried into the port by ``state_dict_from_jax``; requests of
64x96 (padded to 128x128 inside), an engine at batch 2, Adam at 1e-4 after
the global-norm clip. Each server gets a fresh adapting copy of the initial
weights and optimizer; the served module is a separate one, reset between
tests through ``update_variables``.

Tolerances: after two adaptation steps every Adam moment within
5e-2·max|optax| + 1e-12 per tensor. Each framework decides the sign of a
pre-activation within rounding of zero by its own fp32 arithmetic, and
LeakyReLU's slope there is 1 or 0.2: on the first step's frame one such
pre-activation of decoder2's fourth conv (|x| < 1e-6) flips, which moves
decoder2's and block2's weight gradients by up to 2.2e-2 of their scale
(measured on the CPU; on frames with no flip they agree within 6e-6).
Every parameter within 1e-6 of
optax's wherever its first moment exceeds 1e-2 of its tensor's largest (an
Adam step moves an element by about ±lr = 1e-4, its sign the gradient's;
where the gradient is within rounding of zero that sign is noise on both
sides, so there the bound is the two steps' size); on identical gradients
the optimizer matches optax's chain to 1e-7; served disparities within 1e-3 px of the JAX server's
and proxies within 1e-4 relative. ``--no_adapt`` serving is bitwise the
plain engine.
"""

import argparse
import json

import jax
import numpy as np
import optax
import pytest
import torch

from raft_stereo_tpu.evaluate_mad import make_mad_engine as jax_make_mad_engine
from raft_stereo_tpu.models import MADNet2 as JaxMADNet2
from raft_stereo_tpu.parallel import create_train_state
from raft_stereo_tpu.runtime import adapt as jadapt
from raft_stereo_tpu.runtime import infer as jinfer
from raft_stereo_tpu.train_mad import fetch_mad_optimizer as jax_fetch_mad_optimizer
from raft_stereo_tpu_torch.evaluate_mad import make_mad_engine
from raft_stereo_tpu_torch.models.madnet2 import MADNet2
from raft_stereo_tpu_torch.parallel.train_step import TrainState, apply_update
from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.adapt import (
    AdaptConfig,
    AdaptiveServer,
    AdaptPolicy,
    ProxyLossMonitor,
    make_adapt_step,
    make_proxy_fn,
)
from raft_stereo_tpu_torch.runtime.infer import InferOptions, InferRequest, InferStats
from raft_stereo_tpu_torch.serve_adaptive import photometric_shift, synthetic_frame
from raft_stereo_tpu_torch.train_mad import fetch_mad_optimizer
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

H, W = 64, 96
PARAM_ATOL = 1e-6
ILL_COND = 1e-2  # of a tensor's largest first moment: below it Adam's sign is noise
MOMENT_RTOL, MOMENT_ATOL = 5e-2, 1e-12  # see the module docstring
OUT_ATOL = 1e-3
PROXY_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_faults():
    faultinject.reset()
    yield
    faultinject.reset()


def _opt_args(lr=1e-4, wdecay=0.0):
    return argparse.Namespace(variant="mad", lr=lr, wdecay=wdecay)


def _state(sd, lr=1e-4, wdecay=0.0) -> TrainState:
    model = MADNet2()
    model.load_state_dict(sd, strict=True)
    optimizer, scheduler, _ = fetch_mad_optimizer(_opt_args(lr, wdecay),
                                                  list(model.parameters()))
    return TrainState(model.train(), optimizer, scheduler)


@pytest.fixture(scope="module")
def jax_vars():
    im = np.zeros((1, 128, 128, 3), np.float32)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(JaxMADNet2().init)(jax.random.PRNGKey(0), im, im))


@pytest.fixture(scope="module")
def rig(jax_vars):
    sd = state_dict_from_jax(jax_vars)
    served = MADNet2()
    served.load_state_dict(sd, strict=True)
    served.eval().requires_grad_(False)
    engine = make_mad_engine(served, infer=InferOptions(batch=2, prefetch=1))
    return {"sd": sd, "engine": engine,
            "step": make_adapt_step("full", guard=True, with_proxy=True),
            "proxy": make_proxy_fn()}


def _requests(n, seed0=0, shift=False):
    def decode(i):
        pair = synthetic_frame(seed0 + i, H, W)
        if shift:
            pair = tuple(photometric_shift(x, 1.8, 0.65, 8.0) for x in pair)
        return pair

    return [InferRequest(payload=i, inputs=lambda i=i: decode(i)) for i in range(n)]


def _server(rig, tmp_path, **cfg_kwargs):
    """A fresh server: the served module reset to the initial weights and a
    fresh adapting copy of them."""
    rig["engine"].update_variables(rig["sd"])
    rig["engine"].stats = InferStats()
    return AdaptiveServer(rig["engine"], _state(rig["sd"]), str(tmp_path / "snapshots"),
                          AdaptConfig(adapt_mode="full", **cfg_kwargs), name="t",
                          adapt_step_fn=rig["step"], proxy_fn=rig["proxy"])


def _params_equal(model, sd) -> bool:
    return all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


def _events(path):
    return [json.loads(line) for line in open(path) if line.strip()]


# ------------------------------------------------ the step against optax


def _batch(seed):
    a, b = synthetic_frame(seed, H, W)
    return {"img1": a[None], "img2": b[None]}


def test_two_mad_steps_on_different_blocks_match_optax(jax_vars):
    """Two unguarded MAD steps, blocks 0 then 3, with weight decay: every
    parameter and both Adam moments against optax's chain. The second step
    moves block 0 on its moments alone (its gradient is zero), which only
    an optimizer that updates every parameter does."""
    tx, _ = jax_fetch_mad_optimizer(_opt_args(1e-4, 1e-5))
    jstate = create_train_state(jax_vars, tx)
    jstep = jadapt.make_adapt_step(JaxMADNet2(), tx, "mad")
    state = _state(state_dict_from_jax(jax_vars), 1e-4, 1e-5)
    step = make_adapt_step("mad")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    after_first = None
    for seed, idx in ((1, 0), (2, 3)):
        batch = _batch(seed)
        jstate, jinfo = jstep(jstate, batch, idx)
        state, info = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, idx)
        assert info["finite"]
        np.testing.assert_allclose(float(info["loss"]), float(jinfo["loss"]), rtol=1e-5)
        after_first = after_first or {k: v.clone() for k, v in state.model.state_dict().items()}
    # block 0 (level 2) got no gradient in the second step and still moved
    assert all(not torch.equal(v, after_first[k]) for k, v in state.model.state_dict().items()
               if k.startswith(("decoder2.", "feature_extraction.block2.")))
    assert state.step == int(jstate.step) == 2
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    adam = jstate.opt_state[2][0]
    mu = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, adam.mu)})
    nu = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, adam.nu)})
    moved = 0
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == 2
        for got, ref in ((st["exp_avg"], mu[name]), (st["exp_avg_sq"], nu[name])):
            err = float((got - ref).abs().max())
            assert err <= MOMENT_RTOL * float(ref.abs().max()) + MOMENT_ATOL, (name, err)
        # Adam moves an element by lr·m̂/(√v̂ + eps): about ±lr wherever the
        # gradient is large against its rounding, so the parameters agree
        # tightly except where the first moment is within rounding of zero
        # (the sign there is noise on both sides); no element moves more
        # than the two steps' size
        diff = (p.detach() - want[name]).abs()
        noisy = mu[name].abs() <= ILL_COND * mu[name].abs().max()
        assert bool((diff[~noisy] <= PARAM_ATOL).all()), (name, float(diff[~noisy].max()))
        assert float(diff.max()) <= 2 * 2 * 1e-4, name
        moved += int(not torch.equal(p.detach(), before[name]))
    # the decay moves every weight; a (zero-initialised) bias moves only in
    # the two sampled levels
    sampled = ("decoder2.", "feature_extraction.block2.", "decoder5.",
               "feature_extraction.block5.")
    assert moved == sum(p.ndim > 1 or n.startswith(sampled)
                        for n, p in state.model.named_parameters())


def test_mad_optimizer_is_the_optax_chain_on_block_sparse_gradients(jax_vars):
    """``fetch_mad_optimizer`` + ``apply_update`` against optax's chain on
    the same gradients: two steps, each on one block only (the rest zero),
    the first past the clip; every parameter and moment to fp32 rounding."""
    tx, _ = jax_fetch_mad_optimizer(_opt_args(1e-4, 1e-5))
    params = jax.tree_util.tree_map(np.asarray, jax_vars["params"])
    opt_state = tx.init(params)
    update = jax.jit(lambda g, o, p: (lambda u, o2: (optax.apply_updates(p, u), o2))(
        *tx.update(g, o, p)))
    state = _state(state_dict_from_jax(jax_vars), 1e-4, 1e-5)
    rng = np.random.RandomState(0)
    for block, scale in (("decoder2", 3.0), ("decoder5", 1e-3)):
        grads = jax.tree_util.tree_map(np.zeros_like, params)
        for k, v in grads[block].items():
            grads[block][k] = {n: (scale * rng.randn(*a.shape)).astype(np.float32)
                               for n, a in v.items()}
        params, opt_state = update(grads, opt_state, params)
        port_grads = state_dict_from_jax({"params": grads})
        state.optimizer.zero_grad(set_to_none=True)
        for n, p in state.model.named_parameters():
            if n.startswith(block):
                p.grad = port_grads[n].clone()
        state, _ = apply_update(state, torch.tensor(1.0), {})
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
    mu = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                               opt_state[2][0].mu)})
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=0, atol=1e-7)
        torch.testing.assert_close(state.optimizer.state[p]["exp_avg"], mu[n], rtol=1e-6,
                                   atol=1e-12)


def test_guarded_nan_step_leaves_weights_and_moments_untouched(jax_vars):
    state = _state(state_dict_from_jax(jax_vars))
    step = make_adapt_step("mad", guard=True, with_proxy=True)
    good = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    state, info = step(state, good, 1)
    assert info["finite"] and np.isfinite(float(info["proxy"]))
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {n: {k: v.clone() for k, v in state.optimizer.state[p].items()}
               for n, p in state.model.named_parameters()}
    lr = state.lr
    bad = dict(good, img1=torch.full_like(good["img1"], float("nan")))
    state, info = step(state, bad, 2)
    assert not info["finite"] and state.step == 2  # a skip is counted, not rewound
    assert _params_equal(state.model, params)
    for n, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            assert torch.equal(v, moments[n][k]), (n, k)
    assert state.lr == lr


# ---------------------------------------------------------- host-side units


class TestProxyLossMonitor:
    def test_warmup_never_fires(self):
        m = ProxyLossMonitor(regress_factor=1.5, warmup=3)
        assert not any(m.update(v) for v in (1.0, 100.0, 1000.0))

    def test_detects_regression_and_resets(self):
        m = ProxyLossMonitor(regress_factor=1.5, warmup=1)
        assert m.update(1.0) is False
        assert m.update(1.02) is False
        assert m.update(10.0) is True
        m.reset()
        assert m.update(10.0) is False

    def test_gentle_drift_does_not_fire(self):
        m = ProxyLossMonitor(regress_factor=2.0, warmup=1)
        v = 1.0
        for _ in range(50):
            assert m.update(v) is False
            v *= 1.02

    def test_non_finite_observations_ignored(self):
        m = ProxyLossMonitor(regress_factor=1.5, warmup=1)
        m.update(1.0)
        assert m.update(float("nan")) is False
        assert m.count == 1

    def test_degraded_vs_best(self):
        m = ProxyLossMonitor(regress_factor=10.0, warmup=1)
        m.update(2.0)
        m.update(1.0)
        assert not m.degraded(1.5)
        for _ in range(6):
            m.update(4.0)
        assert m.degraded(1.5)

    def test_matches_the_jax_monitor_on_a_random_trajectory(self):
        port = ProxyLossMonitor(regress_factor=1.3, warmup=2)
        ref = jadapt.ProxyLossMonitor(regress_factor=1.3, warmup=2)
        rng = np.random.RandomState(0)
        for i, v in enumerate(np.exp(rng.randn(60))):
            if i == 30:
                port.reset()
                ref.reset()
            assert port.update(v) == ref.update(v)
            assert port.degraded(1.2) == ref.degraded(1.2)
            assert (port.ema_fast, port.ema_slow, port.best_fast) == (
                ref.ema_fast, ref.ema_slow, ref.best_fast)


class TestAdaptPolicy:
    def test_validation(self):
        with pytest.raises(ValueError):
            AdaptPolicy(mode="sometimes")
        with pytest.raises(ValueError):
            AdaptPolicy(every=0)

    def test_every_n_defaults(self):
        p = AdaptPolicy(every=4)
        assert p.mode == "every_n" and p.every == 4


class TestAdaptInjectors:
    def test_nan_ordinals(self):
        faultinject.arm(adapt_nan={2})
        assert faultinject.adapt_nan_point() is False
        assert faultinject.adapt_nan_point() is True
        assert faultinject.adapt_nan_point() is False
        assert faultinject.adapt_attempts() == 3

    def test_regress_ordinals_inflate(self):
        faultinject.arm(adapt_regress={2})
        assert faultinject.adapt_regress_point(1.5) == 1.5
        assert faultinject.adapt_regress_point(1.5) == 15.0
        assert faultinject.adapt_regress_checks() == 2

    def test_env_arming(self, monkeypatch):
        monkeypatch.setenv("RAFT_FI_ADAPT_NAN", "1")
        assert faultinject.adapt_nan_point() is True
        monkeypatch.setenv("RAFT_FI_ADAPT_REGRESS", "1")
        assert faultinject.adapt_regress_point(2.0) == 20.0


# ------------------------------------------------------------- serving rails


def test_serve_adapts_snapshots_and_updates_engine(rig, tmp_path):
    from raft_stereo_tpu_torch.runtime.checkpoint import find_latest_checkpoint

    engine = rig["engine"]
    engine.update_variables(rig["sd"])
    (before,) = list(engine.stream(iter(_requests(1))))
    assert before.ok
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    try:
        srv = _server(rig, tmp_path, policy=AdaptPolicy(every=2), snapshot_every=1)
        results = list(srv.serve(_requests(4)))
    finally:
        telemetry.uninstall(tel)
    assert len(results) == 4 and all(r.ok for r in results)
    s = srv.summary()
    assert s["failed"] == 0 and s["adapt_steps"] == 2 and s["rollbacks"] == 0
    assert len(srv.proxy_history) == 2
    assert not _params_equal(srv.state.model, rig["sd"])
    # the served module holds the adapted weights, and serves them
    assert _params_equal(engine.module, srv.state.model.state_dict())
    (after,) = list(engine.stream(iter(_requests(1))))
    assert after.ok and not np.array_equal(after.output, before.output)
    latest = find_latest_checkpoint(str(tmp_path / "snapshots"))
    assert latest is not None and latest.tag == "periodic"
    events = _events(tmp_path / "tel" / "events.jsonl")
    types = [e["event"] for e in events]
    assert types.count("adapt_step") == 2 and "adapt_snapshot" in types
    steps = [e for e in events if e["event"] == "adapt_step"]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["proxy"]) for e in steps)


def test_no_adapt_bit_identical_to_engine(rig, tmp_path):
    engine = rig["engine"]
    engine.update_variables(rig["sd"])
    direct = {}
    for start in (0, 2):  # the server's chunks (policy.every = 2)
        for r in engine.stream(iter(_requests(4)[start:start + 2])):
            direct[r.payload] = r.output
    srv = _server(rig, tmp_path, adapt=False, policy=AdaptPolicy(every=2))
    served = {r.payload: r.output for r in srv.serve(_requests(4))}
    assert set(served) == set(direct)
    for k in served:
        assert served[k].tobytes() == direct[k].tobytes(), f"request {k} differs"
    assert srv.adapt_steps == 0 and _params_equal(srv.state.model, rig["sd"])
    assert len(srv.proxy_history) == 2
    assert not (tmp_path / "snapshots").exists()  # a frozen server writes none


def test_injected_nan_guard_skip_then_rollback(rig, tmp_path):
    faultinject.arm(adapt_nan={1})
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    try:
        srv = _server(rig, tmp_path, policy=AdaptPolicy(every=2), max_adapt_skips=1,
                      snapshot_every=100)
        results = list(srv.serve(_requests(2)))
    finally:
        telemetry.uninstall(tel)
    assert len(results) == 2 and all(r.ok for r in results)
    assert srv.adapt_skips == 1 and srv.rollbacks == 1
    assert srv.adapt_steps == 0 and not srv.frozen
    assert _params_equal(srv.state.model, rig["sd"])
    events = _events(tmp_path / "tel" / "events.jsonl")
    types = [e["event"] for e in events]
    assert types.index("adapt_skip") < types.index("adapt_rollback")
    rollback = [e for e in events if e["event"] == "adapt_rollback"][-1]
    assert rollback["reason"] == "nan_streak" and rollback["restored"] is True


def test_injected_regression_rolls_back_then_freezes(rig, tmp_path):
    faultinject.arm(adapt_regress={2})
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    try:
        srv = _server(rig, tmp_path, policy=AdaptPolicy(every=2), regress_factor=1.5,
                      regress_warmup=1, max_rollbacks=1, snapshot_every=100)
        results = list(srv.serve(_requests(6)))
    finally:
        telemetry.uninstall(tel)
    assert len(results) == 6 and all(r.ok for r in results)
    assert srv.regressions == 1 and srv.rollbacks == 1
    assert srv.frozen
    assert srv.adapt_steps == 1
    # rolled back to the entry snapshot, and the engine serves it again
    assert _params_equal(srv.state.model, rig["sd"])
    assert _params_equal(rig["engine"].module, rig["sd"])
    types = [e["event"] for e in _events(tmp_path / "tel" / "events.jsonl")]
    assert "adapt_regress" in types and "adapt_frozen" in types
    assert types.index("adapt_regress") < types.index("adapt_rollback")
    assert "adapt_eval" in types


def test_malformed_request_isolated_from_adaptation(rig, tmp_path):
    good = _requests(1)[0]

    def bad_decode():
        a, b = synthetic_frame(1, H, W)
        return a, b[: H // 2]

    reqs = [good, InferRequest(payload="bad", inputs=bad_decode)]
    srv = _server(rig, tmp_path, policy=AdaptPolicy(every=2), snapshot_every=100)
    results = {r.payload: r for r in srv.serve(reqs)}
    assert results[0].ok and not results["bad"].ok
    assert srv.adapt_steps == 1 and not srv.frozen
    assert srv.engine.stats.failed == 1


def test_refuses_snapshot_dir_with_foreign_checkpoints(rig, tmp_path):
    from raft_stereo_tpu_torch.runtime.checkpoint import commit_checkpoint, verify_checkpoint

    snap = tmp_path / "snapshots"
    snap.mkdir()
    foreign = str(snap / "150000_trained")
    commit_checkpoint(foreign, _state(rig["sd"]), step=150000, tag="periodic")
    with pytest.raises(ValueError, match="did not write"):
        _server(rig, tmp_path, policy=AdaptPolicy(every=2))
    assert verify_checkpoint(foreign)


def test_on_degrade_policy_holds_when_healthy(rig, tmp_path):
    srv = _server(rig, tmp_path,
                  policy=AdaptPolicy(mode="on_degrade", every=2, degrade_factor=50.0))
    results = list(srv.serve(_requests(4)))
    assert all(r.ok for r in results)
    assert srv.adapt_steps == 0 and srv.holds == 2
    assert len(srv.proxy_history) == 2


def test_adapted_proxy_trend_beats_frozen_on_shifted_domain(rig, tmp_path):
    n = 12
    frozen = _server(rig, tmp_path / "frozen", adapt=False, policy=AdaptPolicy(every=1))
    assert all(r.ok for r in frozen.serve(_requests(n, shift=True)))
    adapted = _server(rig, tmp_path / "adapted", policy=AdaptPolicy(every=1),
                      snapshot_every=100)
    assert all(r.ok for r in adapted.serve(_requests(n, shift=True)))
    fr, ad = frozen.summary(), adapted.summary()
    assert ad["adapt_steps"] == n // 2 and ad["rollbacks"] == 0
    assert ad["proxy_mean_second_half"] < ad["proxy_mean_first_half"]
    assert ad["proxy_mean_second_half"] < fr["proxy_mean_second_half"]


def test_the_server_is_the_jax_server_on_the_same_rig(rig, jax_vars, tmp_path):
    """The same weights, optimizer and stream (4 shifted requests, a step
    every 2) through the JAX server and the port's: the same accounting,
    proxies and served disparities within tolerance; and the JAX summary
    computed from the port server's state equals the port's summary."""
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    jmodel = JaxMADNet2()
    jstate = create_train_state(jax_vars, tx)
    jengine = jax_make_mad_engine(jmodel, {"params": jstate.params},
                                  infer=jinfer.InferOptions(batch=2, prefetch=1))
    jsrv = jadapt.AdaptiveServer(
        jmodel, jengine, jstate, tx, str(tmp_path / "jax"),
        jadapt.AdaptConfig(adapt_mode="full", policy=jadapt.AdaptPolicy(every=2)), name="t")
    jreqs = [jinfer.InferRequest(payload=r.payload, inputs=r.inputs)
             for r in _requests(4, seed0=7, shift=True)]
    want = {r.payload: r.output for r in jsrv.serve(jreqs)}
    srv = _server(rig, tmp_path, policy=AdaptPolicy(every=2))
    got = {r.payload: r.output for r in srv.serve(_requests(4, seed0=7, shift=True))}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=OUT_ATOL)
    s, js = srv.summary(), jsrv.summary()
    assert list(s) == list(js)
    for k in ("served", "failed", "adapt_steps", "adapt_skips", "regressions", "rollbacks",
              "snapshots", "holds", "frozen", "controller_distribution"):
        assert s[k] == js[k], k
    np.testing.assert_allclose(srv.proxy_history, jsrv.proxy_history, rtol=PROXY_RTOL)
    assert jadapt.AdaptiveServer.summary(srv) == s
    assert jadapt.AdaptiveServer.snapshot(srv) == srv.snapshot()


# -------------------------------------------- adaptive server under a drain


class TestAdaptiveDrainSkip:
    """The two ``AdaptiveServer`` cases of ``tests/test_lifecycle.py``: a
    draining server skips every adaptation opportunity and still serves."""

    def _server(self, tmp_path, should_stop, calls):
        from raft_stereo_tpu_torch.runtime.infer import InferenceEngine

        engine = InferenceEngine(lambda a, b: a[..., :1] - b[..., :1], device="cpu", batch=2)
        server = AdaptiveServer(
            engine, None, str(tmp_path / "snap"),
            AdaptConfig(adapt=False),  # the constructor writes no snapshot
            adapt_step_fn=lambda *a: None, proxy_fn=lambda *a: None, should_stop=should_stop)
        server._adapt_opportunity = lambda: calls.append(1)
        return server

    def test_opportunities_skipped_while_draining(self, tmp_path):
        calls = []
        server = self._server(tmp_path, lambda: True, calls)
        out = list(server.serve(iter(_requests(4, seed0=11))))
        assert len(out) == 4 and all(r.ok for r in out)
        assert calls == []

    def test_opportunities_taken_when_not_draining(self, tmp_path):
        calls = []
        server = self._server(tmp_path, lambda: False, calls)
        out = list(server.serve(iter(_requests(4, seed0=11))))
        assert len(out) == 4 and len(calls) >= 1

"""The port's overload controller on the CPU
(``raft_stereo_tpu_torch/runtime/controller.py``): the 19 cases of
``tests/test_controller.py``, under the same names, and the port held to
the JAX controller: from the same sensor trace on the same fake clock,
with the same fake actuators, the same ladder, the same decisions, the same
event sequence (every event's payload) and the same knob values after each
tick.

The dwell is timed on a fake clock (each module's ``time`` replaced by one
whose ``monotonic`` the test advances) in place of the JAX file's sleeps;
the knob-swap races run a setter thread against a live serve, ordered by
nothing but the serve itself.
"""

import dataclasses
import json
import pathlib
import threading
import types

import numpy as np
import pytest
import torch

from raft_stereo_tpu.runtime import controller as jcontroller
from raft_stereo_tpu.runtime import telemetry as jtelemetry
from raft_stereo_tpu_torch.runtime import controller as controller_mod
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.runtime.adapt import AdaptiveServer
from raft_stereo_tpu_torch.runtime.controller import (
    ControllerConfig,
    OverloadController,
    maybe_controller,
)
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferOptions, InferRequest
from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler
from raft_stereo_tpu_torch.runtime.tiers import (
    CascadeServer,
    IterTierPolicy,
    ModelTier,
    TierPolicy,
    TierSet,
    TieredServer,
)

WAIT_S = 30.0


# ------------------------------------------------------------ fake plant


class FakeCascade:
    def __init__(self, threshold=0.5):
        self.threshold = threshold
        self.sets = []

    def set_threshold(self, t):
        t = float(t)
        if not 0.0 <= t <= 1.0:
            raise ValueError(t)
        self.threshold = t
        self.sets.append(t)


@dataclasses.dataclass(frozen=True)
class FakePolicy:
    tiers: tuple = (4, 8)
    default_iters: int = 8


class FakeTiered:
    def __init__(self):
        self.policy = FakePolicy()
        self.sets = []

    def set_policy(self, p):
        self.policy = p
        self.sets.append(p)


class FakeAdaptive:
    def __init__(self, every=2):
        self._every = every

    def set_every(self, every):
        every = int(every)
        if every < 1:
            raise ValueError(every)
        self._every = every


class FakeScheduler:
    def __init__(self, max_pending=12, depth=0):
        self.max_pending = max_pending
        self.depth = depth

    def set_max_pending(self, n):
        if n is not None and int(n) < 1:
            raise ValueError(n)
        self.max_pending = n

    def snapshot(self):
        return {"depth": self.depth}


class FakeClock:
    """A module's ``time`` with a hand-advanced ``monotonic``."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(controller_mod, "time", types.SimpleNamespace(monotonic=c.monotonic))
    return c


class Plant:
    """A full fake topology with hand-cranked sensors; ticks run inline (the
    thread is never started), so every decision is deterministic."""

    def __init__(self, module=controller_mod, **cfg):
        self.burn, self.depth = 0.0, 0
        self.cascade = FakeCascade()
        self.tiered = FakeTiered()
        self.adaptive = FakeAdaptive()
        self.sched = FakeScheduler()
        self.ctrl = module.OverloadController(
            schedulers=[self.sched], cascade=self.cascade, tiered=self.tiered,
            adaptive=self.adaptive, config=module.ControllerConfig(**cfg),
            burn_fn=lambda: self.burn, depth_fn=lambda: self.depth)

    def tick(self, burn=None, depth=None):
        if burn is not None:
            self.burn = burn
        if depth is not None:
            self.depth = depth
        self.ctrl._tick()
        return self.ctrl.rung

    def knobs(self):
        return (self.cascade.threshold, self.tiered.policy.default_iters,
                self.adaptive._every, self.sched.max_pending)


@pytest.fixture()
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    yield t
    telemetry.uninstall(t)


def _events(run_dir, kinds=None):
    p = pathlib.Path(run_dir) / "events.jsonl"
    if not p.exists():
        return []
    rows = [json.loads(ln) for ln in p.read_text().splitlines() if ln.strip()]
    return [e for e in rows if kinds is None or e["event"] in kinds]


# ------------------------------------------------------------ config law


class TestControllerConfig:
    def test_band_defaults(self):
        cfg = ControllerConfig(burn_high=2.0, depth_high=8)
        assert cfg.burn_low == 1.0
        assert cfg.depth_low == 2

    def test_depth_low_floor(self):
        assert ControllerConfig(depth_high=2).depth_low == 1

    @pytest.mark.parametrize("kw", [
        {"interval_s": 0.0},
        {"dwell_s": -1.0},
        {"burn_high": 0.0},
        {"depth_high": 0},
        {"burn_low": 1.5, "burn_high": 1.0},
        {"depth_low": 8, "depth_high": 8},
        {"depth_low": 0, "depth_high": 8},
    ])
    def test_rejects_inverted_bands(self, kw):
        with pytest.raises(ValueError):
            ControllerConfig(**kw)


# ------------------------------------------------------------ the ladder


class TestLadder:
    def test_degrades_one_rung_per_tick_in_order(self, tel):
        p = Plant(dwell_s=10.0)
        assert [r.name for r in p.ctrl._ladder] == [
            "cascade_bar", "iter_floor", "adapt_pause", "shed_tight"]
        assert p.tick(burn=5.0) == 1
        assert p.cascade.threshold == pytest.approx(0.2)
        assert p.tiered.policy.default_iters == 8  # untouched below rung 2
        assert p.tick() == 2
        assert p.tiered.policy.default_iters == 4
        assert p.tick() == 3
        assert p.adaptive._every == 8  # 2 * 4
        assert p.tick() == 4
        assert p.sched.max_pending == 6  # 12 // 2
        # saturated: a hotter tick holds, it does not re-actuate
        sets_before = list(p.cascade.sets)
        assert p.tick(burn=50.0) == 4
        assert p.cascade.sets == sets_before
        assert p.ctrl.degrades == 4 and p.ctrl.holds == 1
        kinds = [e["event"] for e in _events(tel.run_dir,
                                             {"ctrl_degrade", "ctrl_hold", "ctrl_promote"})]
        assert kinds == ["ctrl_degrade"] * 4 + ["ctrl_hold"]

    def test_depth_alone_triggers_degrade(self):
        p = Plant(depth_high=3)
        assert p.tick(burn=0.0, depth=4) == 1
        assert p.ctrl.degrades == 1
        assert p.cascade.threshold == pytest.approx(0.2)

    def test_missing_actuators_skip_rungs(self):
        ctrl = OverloadController(schedulers=[FakeScheduler()], config=ControllerConfig(),
                                  burn_fn=lambda: 0.0, depth_fn=lambda: 0)
        assert [r.name for r in ctrl._ladder] == ["shed_tight"]

    def test_promote_needs_full_dwell_and_rearms(self, tel, clock):
        p = Plant(dwell_s=0.15)
        p.tick(burn=5.0)
        p.tick()  # rung 2
        assert p.tick(burn=0.0, depth=0) == 2    # the dwell starts: hold
        clock.now += 0.2
        assert p.tick() == 1                     # dwell satisfied: promote
        assert p.tiered.policy.default_iters == 8  # restored
        assert p.tick() == 1                     # re-armed: hold, no cascade
        clock.now += 0.2
        assert p.tick() == 0
        assert p.cascade.threshold == pytest.approx(0.5)  # fully unwound
        assert p.ctrl.promotes == 2 and p.ctrl.forced_restores == 0
        assert p.tick() == 0  # at rung 0 a calm tick is a plain hold
        holds = _events(tel.run_dir, {"ctrl_hold"})
        assert [e["reason"] for e in holds] == ["dwell", "dwell", "calm"]

    def test_band_excursion_resets_dwell(self, clock):
        # burn between low (0.5) and high (1.0): neither degrade nor dwell
        p = Plant(dwell_s=0.15)
        p.tick(burn=5.0)
        p.tick(burn=0.0)          # calm: the dwell starts
        clock.now += 0.2
        assert p.tick(burn=0.7) == 1   # band: holds and resets the clock
        assert p.tick(burn=0.0) == 1   # calm again: a fresh dwell
        assert p.ctrl.promotes == 0
        clock.now += 0.2
        assert p.tick() == 0

    def test_close_force_restores_remaining_rungs(self):
        p = Plant()
        p.tick(burn=5.0)
        p.tick()
        p.tick()
        p.ctrl.close()
        assert p.ctrl.rung == 0 and p.ctrl.forced_restores == 3
        assert p.cascade.threshold == pytest.approx(0.5)
        assert p.tiered.policy.default_iters == 8
        assert p.adaptive._every == 2

    def test_events_carry_values_inside_declared_bounds(self, tel):
        p = Plant(dwell_s=0.0)
        for _ in range(4):
            p.tick(burn=5.0)
        for _ in range(4):
            p.tick(burn=0.0, depth=0)
        moves = _events(tel.run_dir, {"ctrl_degrade", "ctrl_promote"})
        assert len(moves) == 8
        for e in moves:
            assert e["lo"] <= e["value"] <= e["hi"], e
            assert e["rung"] == e["from_rung"] + (1 if e["event"] == "ctrl_degrade" else -1)

    def test_snapshot_reflects_ladder_position(self):
        p = Plant()
        p.tick(burn=5.0)
        snap = p.ctrl.snapshot()
        assert snap["rung"] == 1 and snap["degrades"] == 1
        assert snap["ladder"][0]["applied"] is True
        assert snap["ladder"][1]["applied"] is False
        assert snap["armed"] is False  # the thread never started

    def test_maybe_controller_off_returns_none(self):
        assert maybe_controller(InferOptions(batch=2)) is None


# ------------------------------------------------ the ladder against JAX

# (burn, depth, clock advance before the tick): overload by burn, by depth,
# the band, calm spells shorter and longer than the dwell, saturation
TRACE = [(5.0, 0, 0.1), (0.0, 9, 0.1), (2.0, 0, 0.1), (0.7, 0, 0.1), (0.0, 0, 0.1),
         (0.0, 0, 0.3), (0.0, 1, 0.1), (0.0, 0, 0.1), (0.0, 0, 0.5), (0.0, 0, 0.1),
         (3.0, 12, 0.1), (3.0, 12, 0.1), (3.0, 12, 0.1), (3.0, 12, 0.1), (3.0, 12, 0.1),
         (0.4, 3, 0.1), (0.1, 1, 0.1), (0.0, 0, 0.6), (0.0, 0, 0.6), (0.0, 0, 0.6),
         (0.0, 0, 0.6), (0.0, 0, 0.6), (0.0, 0, 0.1)]
_VOLATILE = ("t_wall", "t_mono", "host")


def test_ladder_decides_as_the_jax_controller(tmp_path, monkeypatch):
    """The same sensor trace on the same fake clock through both
    controllers, each over its own copy of the fake plant: after every tick
    the same rung and knob values, and at the end the same events (names
    and payloads) in the same order, the same counters and the same
    snapshot; close() restores the same way."""
    clocks = {}
    for name, mod in (("port", controller_mod), ("jax", jcontroller)):
        clocks[name] = FakeClock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clocks[name].monotonic))
    cfg = dict(interval_s=0.1, dwell_s=0.5, burn_high=1.0, depth_high=8)
    port, jax_ = Plant(controller_mod, **cfg), Plant(jcontroller, **cfg)
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path / "port")))
    jtel = jtelemetry.install(jtelemetry.Telemetry(str(tmp_path / "jax")))
    try:
        for burn, depth, dt in TRACE:
            for c in clocks.values():
                c.now += dt
            assert port.tick(burn, depth) == jax_.tick(burn, depth)
            assert port.knobs() == jax_.knobs(), (burn, depth)
        snap, jsnap = port.ctrl.snapshot(), jax_.ctrl.snapshot()
        port.ctrl.close()
        jax_.ctrl.close()
    finally:
        telemetry.uninstall(tel)
        jtelemetry.uninstall(jtel)
    assert snap == jsnap
    assert port.knobs() == jax_.knobs()
    assert port.ctrl.forced_restores == jax_.ctrl.forced_restores
    kinds = {"ctrl_degrade", "ctrl_promote", "ctrl_hold"}
    mine = [{k: v for k, v in e.items() if k not in _VOLATILE}
            for e in _events(tmp_path / "port", kinds)]
    theirs = [{k: v for k, v in e.items() if k not in _VOLATILE}
              for e in _events(tmp_path / "jax", kinds)]
    assert mine == theirs
    names = [e["event"] for e in mine]
    assert {"ctrl_degrade", "ctrl_promote", "ctrl_hold"} <= set(names)
    assert len(mine) == len(TRACE)


# --------------------------------------------------- actuator validation


class _Toy(torch.nn.Module):
    def __init__(self, scale):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(float(scale)), requires_grad=False)


def _linear_forward(m):
    return lambda a, b: (a * m.scale - b).sum(-1, keepdim=True)


def _tier(name, scale):
    return ModelTier(name=name, model=_Toy(scale), make_forward=_linear_forward)


def _two_tiers():
    return TierSet([_tier("fast", 2.0), _tier("quality", 3.0)],
                   InferOptions(batch=2, deadline_s=WAIT_S))


def _engine(batch=2):
    return InferenceEngine(_linear_forward(_Toy(2.0)), device="cpu", batch=batch,
                           deadline_s=WAIT_S)


class TestSetterValidation:
    def test_cascade_threshold_bounded(self):
        casc = CascadeServer(_two_tiers(), threshold=0.5, confidence_fn=lambda l, r, d: 1.0)
        for bad in (1.5, -0.1):
            with pytest.raises(ValueError, match=r"\[0, 1\]"):
                casc.set_threshold(bad)
        casc.set_threshold(0.0)
        assert casc.threshold == 0.0

    def test_scheduler_max_pending_bounded(self):
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=1.0)
        with pytest.raises(ValueError, match=">= 1"):
            sched.set_max_pending(0)
        sched.set_max_pending(None)  # None: the blocking backpressure, valid
        assert sched.max_pending is None

    def test_adaptive_every_bounded(self):
        class Dummy:
            set_every = AdaptiveServer.set_every

        with pytest.raises(ValueError, match=">= 1"):
            Dummy().set_every(0)

    def test_tiered_policy_must_name_real_tiers(self):
        srv = TieredServer(_two_tiers(), TierPolicy())
        with pytest.raises(ValueError, match="names tier"):
            srv.set_policy(TierPolicy(fast="nope"))

    def test_iter_tier_policy_default_must_be_member(self):
        with pytest.raises(ValueError, match="not one of"):
            IterTierPolicy(tiers=(4, 8), default_iters=6)


# ----------------------------------------------------- swaps against serves


def _requests(n, h=24, w=48):
    rng = np.random.RandomState(0)
    for i in range(n):
        yield InferRequest(payload=i, inputs=(rng.rand(h, w, 3).astype(np.float32),
                                              rng.rand(h, w, 3).astype(np.float32)))


class TestKnobSwapRaces:
    """A setter hammered against a live serve never tears a decision:
    exactly-once resolution, and every decision's event carries one of the
    two values, never a mix."""

    def test_scheduler_serve_vs_max_pending_flips(self):
        n = 24
        sched = ContinuousBatchingScheduler(_engine(), max_wait_s=0.05)
        stop = threading.Event()

        def hammer():
            v = 1
            while not stop.is_set():
                sched.set_max_pending(1 if v else 8)
                v ^= 1

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            results = list(sched.serve(_requests(n)))
        finally:
            stop.set()
            t.join(timeout=WAIT_S)
        assert sorted(r.payload for r in results) == list(range(n))
        for r in results:
            assert r.ok or r.error, r
        assert any(r.ok for r in results)  # the cap of 8 let work through

    def test_cascade_serve_vs_threshold_flips(self, tel):
        n = 24
        casc = CascadeServer(_two_tiers(), threshold=0.0, confidence_fn=lambda l, r, d: 0.5)
        stop = threading.Event()

        def hammer():
            v = 1
            while not stop.is_set():
                casc.set_threshold(0.0 if v else 1.0)
                v ^= 1

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            results = {r.payload: r for r in casc.serve(_requests(n))}
        finally:
            stop.set()
            t.join(timeout=WAIT_S)
        assert sorted(results) == list(range(n))
        assert all(r.ok for r in results.values())
        s = casc.summary()
        assert s["accepted"] + s["escalated"] == n
        for e in _events(tel.run_dir, {"cascade_accept", "cascade_escalate"}):
            assert e["threshold"] in (0.0, 1.0), e

"""The port's quality observatory (``runtime/quality.py``) on the CPU: the
cases of ``tests/test_quality.py``, under the same names, against the
port's module, scheduler and engine (a stand-in forward); and the sketch,
its scores and the canary inputs held equal to the JAX module's on the same
seeded data.

Every engine has a deadline, so a hang fails its test.
"""

import threading
import time

import numpy as np
import pytest

from raft_stereo_tpu.runtime import quality as jax_quality
from raft_stereo_tpu_torch.runtime import faultinject, quality, telemetry
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferRequest
from raft_stereo_tpu_torch.runtime.quality import (
    CANARY_PRIORITY,
    CanaryChecker,
    CanaryPayload,
    DriftSketch,
    QualityConfig,
    QualityMonitor,
    canary_inputs,
    ks,
    psi,
    weave_canaries,
)
from raft_stereo_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler,
    SchedRequest,
)

WAIT_S = 10.0  # every engine's deadline


def _linear_fn(a, b):
    return (a * 2.0 - b).sum(-1, keepdim=True)


def _engine(batch=4, **kw):
    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(_linear_fn, device="cpu", batch=batch, **kw)


def _user_requests(n, h=24, w=48, seed=0):
    rng = np.random.RandomState(seed)
    return [
        InferRequest(payload=i, inputs=(rng.rand(h, w, 3).astype(np.float32),
                                        rng.rand(h, w, 3).astype(np.float32)))
        for i in range(n)
    ]


@pytest.fixture(autouse=True)
def _clean_hooks():
    """Every test starts and ends with no monitor installed and no armed
    fault injectors — the module hooks are process-global state."""
    quality.uninstall()
    faultinject.reset()
    yield
    quality.uninstall()
    faultinject.reset()


# ---------------------------------------------------------------- sketches


class TestDriftSketch:
    def _fill(self, sketch, values, warm=(), gates=()):
        for v in values:
            sketch.record_output(np.full((4, 4, 1), v, np.float32))
        for w in warm:
            sketch.record_warm(w)
        for g in gates:
            sketch.record_gate(g)

    def test_merge_is_exact_and_order_independent(self):
        """Split one sample stream across sketches in two different
        orders: every merged snapshot is identical to the single-sketch
        fold — the property that lets the reference be 'the first N
        results' regardless of which thread observed them."""
        rng = np.random.RandomState(7)
        values = list(rng.lognormal(1.0, 1.2, size=60))
        warm = [bool(b) for b in rng.randint(0, 2, size=30)]

        whole = DriftSketch()
        self._fill(whole, values, warm=warm)

        a, b = DriftSketch(), DriftSketch()
        self._fill(a, values[:17], warm=warm[:9])
        self._fill(b, values[17:], warm=warm[9:])
        a.merge(b)

        c, d = DriftSketch(), DriftSketch()
        self._fill(d, values[41:], warm=warm[22:])
        self._fill(c, values[:41], warm=warm[:22])
        d.merge(c)

        assert a.snapshot() == whole.snapshot()
        assert d.snapshot() == whole.snapshot()

    def test_rate_sensor_mass_floor(self):
        """Below the mass floor a rate sensor abstains (None) instead of
        screaming over 3 samples; at the floor it reports exactly."""
        s = DriftSketch()
        for _ in range(7):
            s.record_warm(True)
        assert s.rate("warm_rate") is None
        s.record_warm(False)
        assert s.rate("warm_rate") == pytest.approx(7 / 8)
        assert s.rate("escalation_rate") is None  # independent denominators

    def test_psi_ks_identical_vs_disjoint(self):
        same = {1: 50, 2: 30, 3: 20}
        assert psi(same, dict(same)) == pytest.approx(0.0)
        assert ks(same, dict(same)) == pytest.approx(0.0)
        shifted = {10: 50, 11: 30, 12: 20}
        assert psi(same, shifted) > 1.0
        assert ks(same, shifted) == pytest.approx(1.0)
        # empty sides score 0 (no evidence is not drift)
        assert psi({}, same) == 0.0
        assert ks(same, {}) == 0.0


# --------------------------------------------------------------- sentinels


def _tiny_monitor(**over):
    cfg = dict(window_n=4, reference_n=8, trip_windows=2, clear_windows=2,
               psi_trip=0.25, ks_trip=0.35, rate_trip=0.25)
    cfg.update(over)
    return QualityMonitor(QualityConfig(**cfg))


def _feed(mon, n, value, tier="serving"):
    for _ in range(n):
        mon.observe_result(tier, None, np.full((4, 4, 1), value, np.float32))


class TestDriftSentinel:
    def test_reference_freezes_then_windows_score(self):
        mon = _tiny_monitor()
        _feed(mon, 8, 1.0)
        sent = mon._sentinels["serving"]
        assert sent.frozen and sent.windows == 0
        _feed(mon, 4, 1.0)
        assert sent.windows == 1 and not sent.active

    def test_raise_needs_consecutive_hot_windows(self):
        """One hot window is noise; trip_windows consecutive ones are an
        alarm. The raise emits exactly one typed transition."""
        mon = _tiny_monitor()
        _feed(mon, 8, 1.0)
        sent = mon._sentinels["serving"]
        _feed(mon, 4, 400.0)  # hot window 1: no raise yet
        assert not sent.active and mon.healthy()
        _feed(mon, 4, 400.0)  # hot window 2: raise
        assert sent.active and sent.raises == 1
        assert not mon.healthy()

    def test_hysteresis_cannot_oscillate(self):
        """raise -> one calm window -> still active; a second consecutive
        calm window clears; a lone hot window after that re-arms nothing."""
        mon = _tiny_monitor()
        _feed(mon, 8, 1.0)
        sent = mon._sentinels["serving"]
        _feed(mon, 8, 400.0)  # two hot windows: raised
        assert sent.active
        _feed(mon, 4, 1.0)    # calm window 1: latched alarm holds
        assert sent.active
        _feed(mon, 4, 1.0)    # calm window 2: clears
        assert not sent.active and mon.healthy()
        _feed(mon, 4, 400.0)  # a single flappy hot window: no re-raise
        assert not sent.active

    def test_flapping_windows_never_raise(self):
        """Alternating hot/calm windows break every consecutive streak:
        the alarm must stay down however long the flapping runs."""
        mon = _tiny_monitor()
        _feed(mon, 8, 1.0)
        sent = mon._sentinels["serving"]
        for _ in range(6):
            _feed(mon, 4, 400.0)
            _feed(mon, 4, 1.0)
        assert not sent.active and sent.raises == 0


# ---------------------------------------------------------------- canaries


class TestCanaries:
    def test_inputs_deterministic(self):
        a1, b1 = canary_inputs(2, 24, 48)
        a2, b2 = canary_inputs(2, 24, 48)
        assert np.array_equal(a1, a2) and np.array_equal(b1, b2)
        a3, _ = canary_inputs(3, 24, 48)
        assert not np.array_equal(a1, a3)

    def test_capture_then_exact_check(self):
        c = CanaryChecker(QualityConfig(exact=True, canary_latch=3))
        out = np.arange(12, dtype=np.float32).reshape(3, 4)
        assert c.check("t", CanaryPayload(1, 0), out) == "captured"
        assert c.check("t", CanaryPayload(2, 0), out.copy()) == "pass"
        flipped = out.copy()
        flipped[0, 0] += 1e-6  # ONE ulp-ish change must fail exact mode
        assert c.check("t", CanaryPayload(3, 0), flipped) == "fail"

    def test_epe_mode_tolerance(self):
        c = CanaryChecker(QualityConfig(exact=False, canary_tol=0.5))
        out = np.ones((3, 4), np.float32)
        c.check("t", CanaryPayload(1, 0), out)
        assert c.check("t", CanaryPayload(2, 0), out + 0.4) == "pass"
        assert c.check("t", CanaryPayload(3, 0), out + 0.6) == "fail"

    def test_latch_fires_actions_once_and_isolated(self):
        """canary_latch consecutive failures latch exactly once; a raising
        action must not stop the next one (the freeze must land even when
        the blackbox hook blows up)."""
        calls = []
        c = CanaryChecker(QualityConfig(exact=True, canary_latch=2))
        c.on_latch.append(lambda reason: (_ for _ in ()).throw(
            RuntimeError("boom")))
        c.on_latch.append(calls.append)
        out = np.ones((3, 4), np.float32)
        c.check("t", CanaryPayload(1, 0), out)
        c.check("t", CanaryPayload(2, 0), out + 1)  # fail 1: below latch
        assert not calls
        c.check("t", CanaryPayload(3, 0), out + 1)  # fail 2: latch
        assert len(calls) == 1 and "consecutive" in calls[0]
        c.check("t", CanaryPayload(4, 0), out + 1)  # fail 3: already latched
        assert len(calls) == 1
        assert c.snapshot()["latched"] == ["t"]

    def test_pass_resets_consecutive_count(self):
        c = CanaryChecker(QualityConfig(exact=True, canary_latch=2))
        out = np.ones((3, 4), np.float32)
        c.check("t", CanaryPayload(1, 0), out)
        c.check("t", CanaryPayload(2, 0), out + 1)    # fail (1 consecutive)
        c.check("t", CanaryPayload(3, 0), out)        # pass resets
        c.check("t", CanaryPayload(4, 0), out + 1)    # fail (1 again)
        assert not c.latched

    def test_golden_save_load_roundtrip(self, tmp_path):
        cfg = QualityConfig(exact=True, canary_hw=(3, 4))
        c = CanaryChecker(cfg)
        out = np.arange(12, dtype=np.float32).reshape(3, 4)
        c.check("fast", CanaryPayload(1, 0), out)
        c.check("quality", CanaryPayload(2, 1), out * 2)
        path = c.save(str(tmp_path))
        c2 = CanaryChecker(QualityConfig(exact=True, canary_hw=(3, 4),
                                         golden_dir=str(tmp_path)))
        assert len(c2.goldens) == 2
        # loaded goldens CHECK instead of capturing
        assert c2.check("fast", CanaryPayload(1, 0), out) == "pass"
        assert c2.check("quality", CanaryPayload(2, 1), out) == "fail"
        assert path.endswith("canary_goldens_3x4.npz")


# ------------------------------------------------------------ module hooks


class TestModuleHooks:
    def test_uninstalled_hooks_are_noops(self):
        assert quality.get() is None
        quality.observe_result("t", 1, np.ones((2, 2)))
        quality.observe_confidence("t", 0.5)
        quality.observe_iters("t", 3)
        quality.observe_warm("t", True)
        quality.observe_escalation("t", False)
        assert quality.get() is None

    def test_install_get_uninstall(self):
        mon = QualityMonitor()
        assert quality.install(mon) is mon
        assert quality.get() is mon
        quality.observe_result("t", None, np.ones((2, 2), np.float32))
        assert mon.user_results == 1
        quality.uninstall()
        assert quality.get() is None


# ------------------------------------------------------------------ weave


class TestWeave:
    def test_cadence_and_priority_floor(self):
        mon = QualityMonitor(QualityConfig(canary_every=3, canary_hw=(8, 8)))
        users = list(range(7))
        woven = list(weave_canaries(iter(users), mon))
        kinds = ["c" if isinstance(x, SchedRequest)
                 and quality.is_canary(x.request.payload) else "u"
                 for x in woven]
        assert kinds == ["u", "u", "u", "c", "u", "u", "u", "c", "u"]
        canaries = [x for x, k in zip(woven, kinds) if k == "c"]
        assert all(c.priority == CANARY_PRIORITY for c in canaries)
        assert [c.request.payload.seq for c in canaries] == [1, 2]

    def test_passthrough_without_monitor_or_cadence(self):
        users = list(range(5))
        assert list(weave_canaries(iter(users), None)) == users
        mon = QualityMonitor(QualityConfig(canary_every=0))
        assert list(weave_canaries(iter(users), mon)) == users


# -------------------------------------------------- the priority floor


class TestPriorityFloor:
    """The acceptance criterion: canaries ride the REAL scheduler path
    but can never displace, delay, or shed user traffic."""

    def _canary(self, mon):
        return quality.make_canary(mon)

    def test_canary_never_displaces_a_user_from_a_batch(self):
        """A full batch of users + a queued canary: the batch is the
        users; the canary stays parked."""
        mon = QualityMonitor(QualityConfig(canary_every=1, canary_hw=(24, 48)))
        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
        sched._admit_one(self._canary(mon))  # admitted FIRST: oldest
        for r in _user_requests(2):
            sched._admit_one(r)
        group = sched._next_group()
        assert [r.payload for r in group] == [0, 1]
        with sched._cond:
            assert sched._canary_depth == 1

    def test_canary_rides_a_spare_slot(self):
        """One user + one canary, batch of 2: the canary boards the slot
        no user is contending for — ride-along, not displacement — and
        the user boards first."""
        mon = QualityMonitor(QualityConfig(canary_every=1, canary_hw=(24, 48)))
        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=30.0)
        sched._admit_one(self._canary(mon))
        sched._admit_one(_user_requests(1)[0])
        with sched._cond:
            sched._closed = True  # end of stream: the partial drains
        group = sched._next_group()
        payloads = [getattr(r, "payload", None) for r in group]
        assert payloads[0] == 0 and quality.is_canary(payloads[1])

    def test_canary_only_bucket_never_dispatches_midserve(self):
        """A parked canary is invisible to the picker and the starvation
        clock while the stream lives; it resolves at drain/close."""
        mon = QualityMonitor(QualityConfig(canary_every=1, canary_hw=(24, 48)))
        sched = ContinuousBatchingScheduler(_engine(batch=2), max_wait_s=0.01)
        with sched._cond:
            sched._closed = False  # stream open (serve() normally does this)
        sched._admit_one(self._canary(mon))
        time.sleep(0.03)  # way past max_wait_s: a user would have flushed
        now = time.monotonic()
        with sched._cond:
            assert sched._pick_locked(now) is None
            assert sched._next_wait_locked(now) is None
            sched._closed = True
            assert sched._pick_locked(now) is not None  # drain path

    def test_queue_full_gate_counts_users_only(self):
        """max_pending guards USER depth on both sides: queued canaries
        never consume a user's admission slot, and a canary arriving at a
        saturated user queue is itself shed — never the other way."""
        mon = QualityMonitor(QualityConfig(canary_every=1, canary_hw=(24, 48)))
        sched = ContinuousBatchingScheduler(_engine(batch=4), max_wait_s=30.0,
                                            max_pending=2)
        sched._admit_one(self._canary(mon))
        sched._admit_one(self._canary(mon))
        for r in _user_requests(2):  # admitted despite 2 queued canaries
            sched._admit_one(r)
        with sched._cond:
            assert sched._depth == 4 and sched._canary_depth == 2
        # user queue now saturated: the NEXT user is shed...
        sched._admit_one(_user_requests(3)[2])
        shed = sched._take_shed()
        assert [r.payload for r in shed] == [2]
        assert sched.stats.shed_reasons == {"queue_full": 1}
        # ...and so is a canary (it adds no load under overload)
        sched._admit_one(self._canary(mon))
        shed = sched._take_shed()
        assert len(shed) == 1 and quality.is_canary(shed[0].payload)
        with sched._cond:
            assert sched._canary_depth == 2  # the shed one never queued

    def test_slo_counts_users_only(self, tmp_path):
        """End-to-end through the real serve loop: every user result is
        SLO-accounted, no canary is — completions and sheds both."""
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        tel.configure_slo(5000.0, 0.1)
        try:
            mon = quality.install(QualityMonitor(QualityConfig(
                canary_every=2, canary_hw=(24, 48), exact=True)))
            sched = ContinuousBatchingScheduler(_engine(batch=2),
                                                max_wait_s=0.05)
            users = _user_requests(6)
            results = list(sched.serve(
                weave_canaries(iter(users), mon)))
            user_results = [r for r in results
                            if not quality.is_canary(r.payload)]
            assert len(user_results) == 6
            assert all(r.ok for r in results)
            snap = tel.slo.snapshot()
            assert sum(row["total"] for row in snap.values()) == 6
        finally:
            quality.uninstall()
            telemetry.uninstall(tel)

    def test_canary_results_fold_into_canary_ledger_not_sketch(self, tmp_path):
        """The same serve: canary outputs check goldens, user outputs
        build the reference — canaries never pollute the drift sketch."""
        tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
        try:
            mon = quality.install(QualityMonitor(QualityConfig(
                canary_every=3, canary_hw=(24, 48), exact=True,
                reference_n=64)))
            sched = ContinuousBatchingScheduler(_engine(batch=2),
                                                max_wait_s=0.05)
            list(sched.serve(weave_canaries(iter(_user_requests(6)), mon)))
            assert mon.user_results == 6
            assert mon.canaries.checked == 2
            sent = mon._sentinels["serving"]
            assert sent.reference.results == 6  # users only
        finally:
            quality.uninstall()
            telemetry.uninstall(tel)


# ---------------------------------------------------------- warm poison


class TestWarmPoison:
    def test_programmatic_arm_poisons_armed_ordinal_only(self):
        faultinject.arm(warm_poison={2}, warm_poison_fill=7.0)
        slot = np.ones((3, 4), np.float32)
        out1 = faultinject.warm_poison_point(slot)
        assert np.array_equal(out1, slot)
        out2 = faultinject.warm_poison_point(slot)
        assert np.all(out2 == 7.0) and out2.shape == slot.shape
        out3 = faultinject.warm_poison_point(slot)
        assert np.array_equal(out3, slot)
        assert faultinject.warm_reuse_attempts() == 3

    def test_env_arming_with_fill(self, monkeypatch):
        monkeypatch.setenv("RAFT_FI_WARM_POISON", "1:3.5")
        slot = np.ones((2, 2), np.float32)
        assert np.all(faultinject.warm_poison_point(slot) == 3.5)


# ------------------------------------------------------------- thread race


class TestConcurrency:
    def test_concurrent_observers_one_tier(self):
        """Four threads folding results concurrently: the counters add up
        exactly (the sketch locks) and the monitor survives the race."""
        mon = _tiny_monitor(window_n=100, reference_n=1000)
        errs = []

        def fold(k):
            try:
                for _ in range(50):
                    mon.observe_result(
                        "serving", None, np.full((4, 4, 1), float(k + 1)))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=fold, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert mon.user_results == 200
        assert mon._sentinels["serving"].reference.results == 200


# ------------------------------------------------- against the JAX module


def _stream_values(seed):
    rng = np.random.RandomState(seed)
    outputs = [rng.lognormal(1.0, 1.5, size=(6, 8, 1)).astype(np.float32) for _ in range(20)]
    outputs[3][0, 0, 0] = np.nan  # non-finite samples are skipped
    confs = list(rng.rand(30))
    iters = list(rng.randint(1, 33, size=30))
    warm = [bool(b) for b in rng.randint(0, 2, size=30)]
    gates = [bool(b) for b in rng.randint(0, 2, size=25)]
    return outputs, confs, iters, warm, gates


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_sketch_equals_the_jax_sketch(seed):
    """The same outputs, confidences, iteration counts, warm and gate
    samples into both modules' sketches: equal snapshots and rates."""
    outputs, confs, iters, warm, gates = _stream_values(seed)
    mine, theirs = DriftSketch(), jax_quality.DriftSketch()
    for sk in (mine, theirs):
        for o in outputs:
            sk.record_output(o)
        for c in confs:
            sk.record_confidence(c)
        for n in iters:
            sk.record_iters(int(n))
        for w in warm:
            sk.record_warm(w)
        for g in gates:
            sk.record_gate(g)
    assert mine.snapshot() == theirs.snapshot()
    for sensor in ("warm_rate", "escalation_rate"):
        assert mine.rate(sensor) == theirs.rate(sensor)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_psi_ks_equal_the_jax_scores(seed):
    """Seeded bucket-count dicts (overlapping and disjoint supports, empty
    sides): the port's PSI and KS equal the JAX module's exactly."""
    rng = np.random.RandomState(seed)
    for _ in range(20):
        ref = {int(k): int(v) for k, v in zip(rng.randint(-5, 30, size=12),
                                              rng.randint(0, 50, size=12))}
        cur = {int(k): int(v) for k, v in zip(rng.randint(0, 40, size=9),
                                              rng.randint(0, 50, size=9))}
        for a, b in ((ref, cur), (cur, ref), (ref, {}), ({}, cur), (ref, dict(ref))):
            assert psi(a, b) == jax_quality.psi(a, b)
            assert ks(a, b) == jax_quality.ks(a, b)


@pytest.mark.parametrize("key,h,w", [(0, 24, 48), (1, 24, 48), (2, 37, 51), (3, 64, 96),
                                     (6, 16, 16)])
def test_canary_inputs_equal_the_jax_inputs(key, h, w):
    left, right = canary_inputs(key, h, w)
    jleft, jright = jax_quality.canary_inputs(key, h, w)
    assert left.dtype == jleft.dtype and right.dtype == jright.dtype
    assert left.tobytes() == jleft.tobytes() and right.tobytes() == jright.tobytes()

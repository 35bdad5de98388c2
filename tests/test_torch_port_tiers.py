"""The port's tiers on the CPU (``raft_stereo_tpu_torch/runtime/tiers.py``):
the 35 cases of ``tests/test_tiers.py``, under the same names, on the
port's engine and scheduler with stand-in forwards whose tiers compute
different math (a misrouted request is a wrong answer, not a miscount);
and the port held to the JAX module on the same inputs:

  * ``photometric_confidence`` within 1e-6 relative;
  * ``TierPolicy`` and ``IterTierPolicy``: the same decision for every
    request of a seeded stream of mixed scheduling contexts;
  * a TINY cascade (MADNet2 fast tier, a small RAFT-Stereo quality tier,
    weights carried by ``state_dict_from_jax``): the same accept or
    escalate decision per pair as the JAX ``CascadeServer``, and each
    served disparity within the tolerance of its tier
    (``tests/test_torch_port_mad_cli.py``'s 1e-4 of the scale + 1e-5 for
    MADNet2, ``tests/test_torch_port_engine.py``'s atol 5e-3 / rtol 1e-4
    for RAFT-Stereo).

The JAX file's mesh case (``test_engines_share_one_mesh``) is held on its
counterpart: the port's tiers share one device. No test orders threads
with a sleep: held sources wait on events, and threads are joined.
"""

import json
import pathlib
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import MADNet2 as JaxMADNet2
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.runtime import infer as jinfer
from raft_stereo_tpu.runtime import scheduler as jsched
from raft_stereo_tpu.runtime import telemetry as jtelemetry
from raft_stereo_tpu.runtime import tiers as jtiers
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    InferenceEngine,
    InferOptions,
    InferRequest,
    InferResult,
)
from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest
from raft_stereo_tpu_torch.runtime.tiers import (
    CascadeServer,
    IterTierPolicy,
    ModelTier,
    TierClosedError,
    TierPolicy,
    TierSet,
    TieredServer,
    madnet2_tier,
    photometric_confidence,
    raft_stereo_tier,
)
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

FAST_SCALE, QUALITY_SCALE = 2.0, 3.0
WAIT_S = 30.0  # every engine's deadline and every join's bound


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Toy(torch.nn.Module):
    """A stand-in model: out = sum_c(a * scale - b), its weight ``scale``."""

    def __init__(self, scale):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(float(scale)), requires_grad=False)


def _linear_forward(m):
    def fwd(a, b):
        return (a * m.scale - b).sum(-1, keepdim=True)

    return fwd


def _tier(name, scale, divis_by=32, device="cpu"):
    return ModelTier(name=name, model=_Toy(scale).to(device), make_forward=_linear_forward,
                     divis_by=divis_by)


def _two_tiers(**opts):
    opts.setdefault("deadline_s", WAIT_S)
    return TierSet([_tier("fast", FAST_SCALE), _tier("quality", QUALITY_SCALE)],
                   InferOptions(batch=2, **opts))


def _pair(i, h=24, w=48):
    rng = np.random.RandomState(i)
    return (rng.rand(h, w, 3).astype(np.float32), rng.rand(h, w, 3).astype(np.float32))


def _expected(i, scale, h=24, w=48):
    a, b = _pair(i, h, w)
    return (a * np.float32(scale) - b).sum(-1, keepdims=True)


def _assert_tier_math(output, want):
    """The routing proof: the result is ONE tier's math (the reduction order
    differs from numpy's by ulps; the scales differ by far more)."""
    np.testing.assert_allclose(output, want, rtol=1e-4, atol=1e-4)


def _events(run_dir):
    p = pathlib.Path(run_dir) / "events.jsonl"
    if not p.exists():
        return []
    return [json.loads(ln) for ln in p.read_text().splitlines() if ln.strip()]


def _join_named(*names):
    """Join every live thread of ``names``; returns those still alive."""
    for t in threading.enumerate():
        if t.name in names:
            t.join(timeout=WAIT_S)
    return [t.name for t in threading.enumerate() if t.name in names]


@pytest.fixture()
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    yield t
    telemetry.uninstall(t)


# ------------------------------------------------------------- registry


class TestTierSet:
    def test_needs_at_least_one_tier(self):
        with pytest.raises(ValueError, match="at least one"):
            TierSet([], InferOptions(batch=2))

    def test_duplicate_names_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            TierSet([_tier("a", 1.0), _tier("a", 2.0)], InferOptions(batch=2))

    def test_engines_share_one_mesh(self):
        """The JAX tiers share one device mesh; the port's share one device
        (its counterpart: one card per process). A tier on another device
        is refused."""
        ts = _two_tiers()
        assert {e.device for e in ts.engines.values()} == {ts.device} == {torch.device("cpu")}
        with pytest.raises(ValueError, match="one device"):
            TierSet([_tier("fast", 2.0), _tier("quality", 3.0, device="meta")],
                    InferOptions(batch=2))

    def test_per_tier_divis_by(self):
        ts = TierSet([_tier("fast", 2.0, divis_by=128), _tier("quality", 3.0, divis_by=32)],
                     InferOptions(batch=2))
        assert ts.engine("fast").divis_by == 128
        assert ts.engine("quality").divis_by == 32

    def test_update_variables_reaches_only_the_named_tier(self):
        ts = _two_tiers()
        srv = TieredServer(ts, TierPolicy.single("fast"))
        (res,) = list(srv.serve(iter([InferRequest(payload=0, inputs=_pair(0))])))
        _assert_tier_math(res.output, _expected(0, FAST_SCALE))
        ts.update_variables("fast", {"scale": torch.tensor(5.0)})
        (res2,) = list(srv.serve(iter([InferRequest(payload=0, inputs=_pair(0))])))
        _assert_tier_math(res2.output, _expected(0, 5.0))
        srv_q = TieredServer(ts, TierPolicy.single("quality"))
        (res3,) = list(srv_q.serve(iter([InferRequest(payload=0, inputs=_pair(0))])))
        _assert_tier_math(res3.output, _expected(0, QUALITY_SCALE))

    def test_combined_stats_merge(self):
        ts = _two_tiers()
        srv = TieredServer(ts, TierPolicy(deadline_cutoff_s=1.0))

        def reqs():
            for i in range(4):
                r = InferRequest(payload=i, inputs=_pair(i))
                yield SchedRequest(r, deadline_s=0.5) if i % 2 else r

        assert len(list(srv.serve(reqs()))) == 4
        stats = ts.combined_stats()
        assert stats.images == 4
        assert stats.batches == ts.engine("fast").stats.batches + \
            ts.engine("quality").stats.batches
        total = sum(h.snapshot()["count"] for (c, _), h in stats.latency.items() if c == "e2e")
        assert total == 4


# --------------------------------------------------------------- policy


class TestTierPolicy:
    def test_precedence(self):
        pol = TierPolicy(deadline_cutoff_s=1.0, priority_cutoff=5)
        r = InferRequest(payload=0, inputs=())
        assert pol.select(r) == ("quality", "default")
        assert pol.select(SchedRequest(r, deadline_s=0.5)) == ("fast", "deadline")
        assert pol.select(SchedRequest(r, deadline_s=10.0)) == ("quality", "default")
        assert pol.select(SchedRequest(r, priority=7)) == ("fast", "priority")
        assert pol.select(SchedRequest(r, deadline_s=0.1, tier="quality")) == \
            ("quality", "explicit")

    def test_single(self):
        pol = TierPolicy.single("fast")
        r = InferRequest(payload=0, inputs=())
        assert pol.select(SchedRequest(r, deadline_s=99.0)) == ("fast", "default")

    def test_unknown_policy_tier_fails_fast(self):
        ts = _two_tiers()
        with pytest.raises(ValueError, match="names tier"):
            TieredServer(ts, TierPolicy(fast="bogus"))


def _jax_tier(name, scale):
    def make_forward(model):
        return lambda v, a, b: (a * v["scale"] - b).sum(-1, keepdims=True)

    return jtiers.ModelTier(name=name, model=f"toy-{name}",
                            variables={"scale": np.float32(scale)}, make_forward=make_forward)


@pytest.mark.parametrize("sched", [False, True], ids=["engine", "sched"])
def test_tierset_snapshot_nests_as_the_jax_snapshot(sched):
    """``TierSet.snapshot``: each tier's engine and scheduler snapshot under
    the tier's name, keyed and nested as the JAX ``TierSet.snapshot``; the
    scheduler is None for a tier without one."""
    jts = jtiers.TierSet([_jax_tier("fast", FAST_SCALE), _jax_tier("quality", QUALITY_SCALE)],
                         jinfer.InferOptions(batch=2, sched=sched))
    ts = TierSet([_tier("fast", FAST_SCALE), _tier("quality", QUALITY_SCALE)],
                 InferOptions(batch=2, sched=sched))
    snap, jsnap = ts.snapshot(), jts.snapshot()
    assert list(snap) == list(jsnap) == ["fast", "quality"]
    for name in snap:
        assert set(snap[name]) == set(jsnap[name]) == {"engine", "scheduler"}
        assert snap[name]["engine"] == ts.engines[name].snapshot()
        assert (snap[name]["scheduler"] is None) == (jsnap[name]["scheduler"] is None) \
            == (not sched)
        if sched:
            assert snap[name]["scheduler"] == ts.schedulers[name].snapshot()
            assert set(snap[name]["scheduler"]) == set(jsnap[name]["scheduler"])


def _contexts(n=64, seed=5):
    """A seeded stream of scheduling contexts: (deadline, priority, tier,
    iters), each None or a value on either side of the cutoffs."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append((rng.choice([None, 0.1, 0.5, 1.0, 1.5, 30.0]),
                    int(rng.choice([0, 0, 3, 5, 9])),
                    rng.choice([None, None, "quality", "fast", "iters16"]),
                    rng.choice([None, None, 1, 7, 8, 16, 20, 99])))
    return out


@pytest.mark.parametrize("kind", ["tier_policy", "iter_tier_policy"])
def test_policies_decide_as_the_jax_policies(kind):
    """Every request of a seeded stream of mixed contexts (deadlines around
    the cutoff, priorities around it, explicit tiers and iteration pins)
    gets the JAX policy's (tier, reason), plain requests too."""
    if kind == "tier_policy":
        pols = [(TierPolicy(deadline_cutoff_s=1.0, priority_cutoff=5),
                 jtiers.TierPolicy(deadline_cutoff_s=1.0, priority_cutoff=5)),
                (TierPolicy.single("fast"), jtiers.TierPolicy.single("fast")),
                (TierPolicy(), jtiers.TierPolicy())]
    else:
        pols = [(IterTierPolicy((7, 16, 32)), jtiers.IterTierPolicy((7, 16, 32))),
                (IterTierPolicy((7, 16, 32), default_iters=16),
                 jtiers.IterTierPolicy((7, 16, 32), default_iters=16)),
                (IterTierPolicy((2, 4), deadline_cutoff_s=None),
                 jtiers.IterTierPolicy((2, 4), deadline_cutoff_s=None))]
    for pol, jpol in pols:
        assert (pol.fast, pol.default) == (jpol.fast, jpol.default)
        r, jr = InferRequest(payload=0, inputs=()), jinfer.InferRequest(payload=0, inputs=())
        assert pol.select(r) == jpol.select(jr)
        for deadline, priority, tier, iters in _contexts():
            mine = SchedRequest(r, priority=priority, deadline_s=deadline, tier=tier,
                                iters=iters)
            theirs = jsched.SchedRequest(jr, priority=priority, deadline_s=deadline, tier=tier,
                                         iters=iters)
            assert pol.select(mine) == jpol.select(theirs), (deadline, priority, tier, iters)


# ------------------------------------------------------- tiered serving


class TestTieredServer:
    def test_mixed_stream_routes_by_deadline_and_math_proves_it(self, tel):
        ts = _two_tiers()
        srv = TieredServer(ts, TierPolicy(deadline_cutoff_s=1.0))

        def reqs():
            for i in range(8):
                r = InferRequest(payload=i, inputs=_pair(i))
                yield SchedRequest(r, deadline_s=0.25) if i % 2 else r

        out = {r.payload: r for r in srv.serve(reqs())}
        assert sorted(out) == list(range(8))
        assert all(r.ok for r in out.values())
        for i, r in out.items():
            _assert_tier_math(r.output, _expected(i, FAST_SCALE if i % 2 else QUALITY_SCALE))
        assert srv.stats.dispatched == {"fast": 4, "quality": 4}
        assert srv.stats.reasons == {"deadline": 4, "default": 4}
        assert srv.stats.completed == {"fast": 4, "quality": 4}
        disp = [e for e in _events(tel.run_dir) if e["event"] == "tier_dispatch"]
        assert len(disp) == 8
        assert {e["tier"] for e in disp} == {"fast", "quality"}
        assert all(e.get("trace_id") for e in disp)
        prom = tel.metrics.to_prometheus()
        assert 'tier_e2e_seconds{tier="fast"' in prom or \
            'tier_e2e_seconds_bucket{tier="fast"' in prom
        assert 'tier_requests_total{status="completed",tier="quality"}' in prom

    def test_single_tier_bit_identical_to_plain_engine(self):
        ts = TierSet([_tier("quality", QUALITY_SCALE)], InferOptions(batch=2))
        srv = TieredServer(ts, TierPolicy.single("quality"))

        def reqs():
            for i in range(5):  # 2 full batches + 1 partial
                yield InferRequest(payload=i, inputs=_pair(i))

        tiered = {r.payload: r.output for r in srv.serve(reqs())}
        plain = InferenceEngine(_linear_forward(_Toy(QUALITY_SCALE)), device="cpu", batch=2)
        want = {r.payload: r.output for r in plain.stream(reqs())}
        assert sorted(tiered) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(tiered[k], want[k])

    def test_sched_backed_tiers_route_and_resolve(self):
        ts = _two_tiers(sched=True)
        assert all(s is not None for s in ts.schedulers.values())
        srv = TieredServer(ts, TierPolicy(deadline_cutoff_s=1.0))

        def reqs():
            for i in range(6):
                r = InferRequest(payload=i, inputs=_pair(i))
                yield SchedRequest(r, deadline_s=0.5 if i % 2 else None, priority=i)

        out = {r.payload: r for r in srv.serve(reqs())}
        assert sorted(out) == list(range(6)) and all(r.ok for r in out.values())
        for i, r in out.items():
            _assert_tier_math(r.output, _expected(i, FAST_SCALE if i % 2 else QUALITY_SCALE))

    def test_decode_failure_is_typed_and_isolated(self):
        ts = _two_tiers()
        srv = TieredServer(ts, TierPolicy.single("quality"))

        def reqs():
            yield InferRequest(payload=0, inputs=_pair(0))

            def boom():
                raise OSError("decode died")

            yield InferRequest(payload=1, inputs=boom)
            yield InferRequest(payload=2, inputs=_pair(2))

        out = {r.payload: r for r in srv.serve(reqs())}
        assert sorted(out) == [0, 1, 2]
        assert out[0].ok and out[2].ok
        assert not out[1].ok and isinstance(out[1].error, OSError)
        assert srv.stats.failed == {"quality": 1}

    def test_source_error_reraises_after_tiers_drain(self):
        ts = _two_tiers()
        srv = TieredServer(ts, TierPolicy.single("quality"))

        def bad():
            yield InferRequest(payload=0, inputs=_pair(0))
            raise RuntimeError("source died")

        with pytest.raises(RuntimeError, match="source died"):
            list(srv.serve(bad()))

    def test_explicit_unknown_tier_is_a_stream_failure(self):
        ts = _two_tiers()
        srv = TieredServer(ts, TierPolicy())

        def reqs():
            yield SchedRequest(InferRequest(payload=0, inputs=_pair(0)), tier="bogus")

        with pytest.raises(ValueError, match="unknown tier"):
            list(srv.serve(reqs()))

    def test_abandoned_consumer_cleans_up_threads(self):
        ts = _two_tiers()
        srv = TieredServer(ts, TierPolicy.single("quality"))

        def reqs():
            for i in range(50):
                yield InferRequest(payload=i, inputs=lambda i=i: _pair(i))

        g = srv.serve(reqs())
        next(g)
        g.close()
        assert not _join_named("tier-router", "tier-serve")

    def test_drain_fans_out_to_every_tier(self):
        ts = _two_tiers(sched=True)
        ts.request_drain(0.0)  # an expired bound: everything drains
        srv = TieredServer(ts, TierPolicy(deadline_cutoff_s=1.0))

        def reqs():
            for i in range(4):
                r = InferRequest(payload=i, inputs=_pair(i))
                yield SchedRequest(r, deadline_s=0.5) if i % 2 else r

        out = list(srv.serve(reqs()))
        assert len(out) == 4
        assert all(not r.ok and getattr(r.error, "reason", None) == "drained" for r in out)

    def test_tier_stream_early_end_resolves_typed_never_hangs(self):
        # a tier stream that dies with the router backed up behind its
        # bounded queue: every request still resolves, the one served plus
        # typed TierClosedError results
        ts = _two_tiers()

        def one_then_done(feed):
            for item in feed:
                inner = getattr(item, "request", item)
                arrays = inner.resolve()
                yield InferResult(payload=inner.payload, output=arrays[0][..., :1],
                                  trace_id=inner.trace_id)
                return

        ts._stream_fns["fast"] = one_then_done
        srv = TieredServer(ts, TierPolicy.single("fast"))

        def reqs():
            for i in range(200):  # >> the 64-slot tier queue bound
                yield InferRequest(payload=i, inputs=lambda i=i: _pair(i))

        box = {}

        def run():
            box["out"] = list(srv.serve(reqs()))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "TieredServer.serve hung on a dead tier"
        out = box["out"]
        assert len(out) == 200 and sorted(r.payload for r in out) == list(range(200))
        assert sum(1 for r in out if r.ok) == 1
        assert all(isinstance(r.error, TierClosedError) for r in out if not r.ok)
        assert srv._t0s == {}


# --------------------------------------------------------------- cascade


def _marker_conf(left, right, disp):
    return float(left[0, 0, 0])


def _marked_pair(i, conf):
    a, b = _pair(i)
    a = a.copy()
    a[0, 0, 0] = conf
    return a, b


class TestCascadeServer:
    def test_needs_both_tiers(self):
        ts = TierSet([_tier("quality", 3.0)], InferOptions(batch=2))
        with pytest.raises(ValueError, match="needs tier"):
            CascadeServer(ts)

    def test_accept_escalate_split_and_replacement_math(self, tel):
        ts = _two_tiers()
        casc = CascadeServer(ts, threshold=0.5, confidence_fn=_marker_conf)

        def reqs():
            for i in range(6):
                conf = 0.0 if i in (1, 4) else 1.0
                yield InferRequest(payload=i, inputs=lambda i=i, c=conf: _marked_pair(i, c))

        out = {r.payload: r for r in casc.serve(reqs())}
        assert sorted(out) == list(range(6))
        assert all(r.ok for r in out.values())
        for i, r in out.items():
            a, b = _marked_pair(i, 0.0 if i in (1, 4) else 1.0)
            scale = QUALITY_SCALE if i in (1, 4) else FAST_SCALE
            _assert_tier_math(r.output, (a * np.float32(scale) - b).sum(-1, keepdims=True))
        s = casc.summary()
        assert s["accepted"] == 4 and s["escalated"] == 2
        assert s["replaced"] == 2 and s["fallbacks"] == 0
        events = _events(tel.run_dir)
        acc = [e for e in events if e["event"] == "cascade_accept"]
        esc = [e for e in events if e["event"] == "cascade_escalate"]
        assert len(acc) == 4 and len(esc) == 2
        assert all(e["outcome"] == "replaced" for e in esc)
        assert all(e["threshold"] == 0.5 for e in acc + esc)

    def test_threshold_extremes(self):
        ts = _two_tiers()
        accept_all = CascadeServer(ts, threshold=-1.0, confidence_fn=_marker_conf)
        out = list(accept_all.serve(InferRequest(payload=i, inputs=_marked_pair(i, 0.0))
                                    for i in range(3)))
        assert accept_all.stats.accepted == 3
        assert all(r.ok for r in out)
        escalate_all = CascadeServer(ts, threshold=2.0, confidence_fn=_marker_conf)
        out = list(escalate_all.serve(InferRequest(payload=i, inputs=_marked_pair(i, 1.0))
                                      for i in range(3)))
        assert escalate_all.stats.escalated == 3
        assert escalate_all.stats.replaced == 3
        assert all(r.ok for r in out)

    def test_fast_tier_error_resolves_once_no_escalation(self):
        ts = _two_tiers()
        casc = CascadeServer(ts, threshold=2.0, confidence_fn=_marker_conf)

        def reqs():
            def boom():
                raise OSError("decode died")

            yield InferRequest(payload=0, inputs=boom)
            yield InferRequest(payload=1, inputs=_marked_pair(1, 1.0))

        out = {r.payload: r for r in casc.serve(reqs())}
        assert sorted(out) == [0, 1]
        assert not out[0].ok and isinstance(out[0].error, OSError)
        assert out[1].ok
        assert casc.stats.fast_errors == 1 and casc.stats.escalated == 1

    def test_drained_escalation_falls_back_to_fast_result(self):
        # the drain lands between the fast pass and the escalation: only the
        # quality scheduler is expired, the held fast results stand
        ts = _two_tiers(sched=True)
        ts.schedulers["quality"].request_drain(0.0)
        casc = CascadeServer(ts, threshold=2.0, confidence_fn=_marker_conf)
        out = {r.payload: r for r in casc.serve(
            InferRequest(payload=i, inputs=_marked_pair(i, 1.0)) for i in range(4))}
        assert sorted(out) == list(range(4))
        assert all(r.ok for r in out.values())
        for i, r in out.items():
            a, b = _marked_pair(i, 1.0)
            _assert_tier_math(r.output, (a * np.float32(FAST_SCALE) - b).sum(-1, keepdims=True))
        s = casc.summary()
        assert s["escalated"] == 4 and s["fallbacks"] == 4

    def test_quality_stream_early_end_falls_back_never_drops(self):
        ts = _two_tiers()
        ts._stream_fns["quality"] = lambda feed: iter(())
        casc = CascadeServer(ts, threshold=2.0, confidence_fn=_marker_conf)
        out = {r.payload: r for r in casc.serve(
            InferRequest(payload=i, inputs=_marked_pair(i, 1.0)) for i in range(6))}
        assert sorted(out) == list(range(6))
        assert all(r.ok for r in out.values())
        for i, r in out.items():
            a, b = _marked_pair(i, 1.0)
            _assert_tier_math(r.output, (a * np.float32(FAST_SCALE) - b).sum(-1, keepdims=True))
        s = casc.summary()
        assert s["escalated"] == 6 and s["fallbacks"] == 6
        assert s["replaced"] == 0

    def test_abandoned_consumer_cleans_up_and_instance_reusable(self):
        ts = _two_tiers()
        casc = CascadeServer(ts, threshold=-1.0, confidence_fn=_marker_conf)

        def reqs(n):
            for i in range(n):
                yield InferRequest(payload=i, inputs=lambda i=i: _marked_pair(i, 1.0))

        g = casc.serve(reqs(50))
        next(g)
        g.close()  # abandoned mid-stream: the stop ends the feed
        assert not _join_named("cascade-fast", "cascade-quality")
        out = list(casc.serve(reqs(3)))
        assert len(out) == 3 and all(r.ok for r in out)

    def test_broken_confidence_fn_escalates(self):
        ts = _two_tiers()

        def broken(left, right, disp):
            raise RuntimeError("gate exploded")

        casc = CascadeServer(ts, threshold=0.5, confidence_fn=broken)
        out = list(casc.serve(InferRequest(payload=i, inputs=_pair(i)) for i in range(2)))
        assert all(r.ok for r in out)
        assert casc.stats.escalated == 2

    def test_serve_reentry_guard(self):
        ts = _two_tiers()
        casc = CascadeServer(ts, threshold=0.5, confidence_fn=_marker_conf)
        slow = queue.Queue()

        def reqs():
            # two full micro-batches before holding the source open: batch
            # 1's results surface once batch 2 is staged behind it
            for i in range(4):
                yield InferRequest(payload=i, inputs=_marked_pair(i, 1.0))
            slow.get(timeout=WAIT_S)  # hold the serve open

        g = casc.serve(reqs())
        next(g)
        with pytest.raises(RuntimeError, match="already active"):
            next(casc.serve(iter([])))
        slow.put(None)
        g.close()

    def test_mixed_divis_by_tiers(self):
        # fast /128 (MADNet2's buckets), quality /32: the escalation re-pads
        ts = TierSet([_tier("fast", FAST_SCALE, divis_by=128),
                      _tier("quality", QUALITY_SCALE, divis_by=32)], InferOptions(batch=2))
        casc = CascadeServer(ts, threshold=2.0, confidence_fn=_marker_conf)
        out = {r.payload: r for r in casc.serve(
            InferRequest(payload=i, inputs=_marked_pair(i, 1.0)) for i in range(3))}
        assert all(r.ok for r in out.values()) and len(out) == 3
        for i, r in out.items():
            a, b = _marked_pair(i, 1.0)
            _assert_tier_math(r.output,
                              (a * np.float32(QUALITY_SCALE) - b).sum(-1, keepdims=True))


# ------------------------------------------------- photometric confidence


class TestPhotometricConfidence:
    def test_true_disparity_beats_wrong_disparity(self):
        from raft_stereo_tpu_torch.serve_adaptive import synthetic_frame

        h, w = 48, 96
        left, right = synthetic_frame(3, h, w)
        cands = {d: photometric_confidence(left, right, np.full((h, w, 1), d, np.float32))
                 for d in np.arange(0.0, 14.0, 0.5)}
        best_d = max(cands, key=cands.get)
        assert cands[best_d] > cands[0.0] + 0.005
        assert 3.0 <= best_d <= 12.0  # synthetic_frame draws d0 in [5, 9]

    def test_asymmetric_shift_lowers_confidence(self):
        from raft_stereo_tpu_torch.serve_adaptive import photometric_shift, synthetic_frame

        h, w = 48, 96
        left, right = synthetic_frame(7, h, w)
        disp = np.full((h, w, 1), 7.0, np.float32)
        base = photometric_confidence(left, right, disp)
        shifted = photometric_confidence(left, photometric_shift(right, 1.8, 0.65, 8.0), disp)
        assert shifted < base - 0.02

    def test_nan_disparity_escalates(self):
        left = np.full((8, 16, 3), 100.0, np.float32)
        conf = photometric_confidence(left, left, np.full((8, 16, 1), np.nan, np.float32))
        assert not (conf >= 0.5)

    def test_2d_and_3d_disparity_accepted(self):
        left = np.full((8, 16, 3), 100.0, np.float32)
        d2 = photometric_confidence(left, left, np.zeros((8, 16), np.float32))
        d3 = photometric_confidence(left, left, np.zeros((8, 16, 1), np.float32))
        assert d2 == d3 == 1.0


def test_photometric_confidence_matches_jax():
    """The port's copy against the JAX function on the same inputs, within
    1e-6 relative: seeded images and disparities (planes, ramps reaching
    past both borders, random fields, 2-D and 3-D), a NaN disparity and a
    NaN image."""
    from raft_stereo_tpu.serve_adaptive import synthetic_frame as jax_frame

    rng = np.random.RandomState(11)
    cases = []
    for seed in range(4):
        left, right = jax_frame(seed, 40, 72)
        cases += [(left, right, np.full((40, 72, 1), 6.5, np.float32)),
                  (left, right, (rng.rand(40, 72, 1) * 20 - 4).astype(np.float32)),
                  (left, right, np.tile(np.linspace(-10, 90, 72, dtype=np.float32),
                                        (40, 1)))]
    nan_img = cases[0][0].copy()
    nan_img[3, 5, 1] = np.nan
    cases += [(cases[0][0], cases[0][1], np.full((40, 72, 1), np.nan, np.float32)),
              (nan_img, cases[0][1], cases[0][2])]
    for left, right, disp in cases:
        got = photometric_confidence(left, right, disp)
        want = jtiers.photometric_confidence(left, right, disp)
        if np.isinf(want):
            assert got == want
        else:
            assert abs(got - want) <= 1e-6 * abs(want), (got, want)


# ------------------------------------------- the cascade against the JAX one

TINY_RAFT = dict(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
                 corr_implementation="alt")
CASCADE_ITERS = 2
MAD_RTOL, MAD_ATOL = 1e-4, 1e-5        # tests/test_torch_port_mad_cli.py
RAFT_RTOL, RAFT_ATOL = 1e-4, 5e-3      # tests/test_torch_port_engine.py


def test_cascade_decides_as_the_jax_cascade(tmp_path):
    """A TINY cascade on both sides, weights carried by state_dict_from_jax:
    MADNet2 as the fast tier, a small RAFT-Stereo (2 iterations) as the
    quality tier, batch 2, the default photometric gate with the threshold
    at the middle of the widest gap between the JAX confidences (so a
    decision cannot hinge on rounding). Each pair gets the JAX cascade's
    decision (its cascade_accept / cascade_escalate event), and each served
    disparity is within its tier's tolerance of the JAX one."""
    n, (h, w) = 4, (64, 96)
    rng = np.random.RandomState(3)
    pairs = [tuple((rng.rand(h, w, 3) * 255).astype(np.float32) for _ in range(2))
             for _ in range(n)]
    im = np.zeros((1, 128, 128, 3), np.float32)
    jmad = JaxMADNet2()
    mad_vars = jax.jit(jmad.init)(jax.random.PRNGKey(0), im, im)
    jraft = JaxRAFTStereo(JaxConfig(**TINY_RAFT))
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    raft_vars = jax.jit(lambda k: jraft.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(0))

    jts = jtiers.TierSet([jtiers.madnet2_tier(jmad, mad_vars),
                          jtiers.raft_stereo_tier(jraft, raft_vars, CASCADE_ITERS)],
                         jinfer.InferOptions(batch=2))
    fast_out = {r.payload: r.output for r in jts.stream_fn("fast")(
        iter([jinfer.InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs)]))}
    confs = sorted(jtiers.photometric_confidence(pairs[i][0], pairs[i][1], fast_out[i])
                   for i in range(n))
    gaps = [(confs[k + 1] - confs[k], k) for k in range(1, n - 2)]
    gap, k = max(gaps)
    threshold = 0.5 * (confs[k] + confs[k + 1])

    def decisions(run_dir):
        return {e["trace_id"]: e["event"] for e in _events(run_dir)
                if e["event"] in ("cascade_accept", "cascade_escalate")}

    jtel = jtelemetry.install(jtelemetry.Telemetry(str(tmp_path / "jax")))
    try:
        jres = {r.payload: r for r in jtiers.CascadeServer(jts, threshold=threshold).serve(
            iter([jinfer.InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs)]))}
    finally:
        jtelemetry.uninstall(jtel)
    jdec = {k: decisions(tmp_path / "jax")[r.trace_id] for k, r in jres.items()}

    mad = make_madnet2()
    mad.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, mad_vars)),
                        strict=True)
    raft = evaluate.load_model(RAFTStereoConfig(**TINY_RAFT), device="cpu")
    raft.load_state_dict(state_dict_from_jax(raft_vars), strict=True)
    ts = TierSet([madnet2_tier(mad), raft_stereo_tier(raft, CASCADE_ITERS)],
                 InferOptions(batch=2, deadline_s=WAIT_S))
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "port")))
    try:
        casc = CascadeServer(ts, threshold=threshold)
        res = {r.payload: r for r in casc.serve(
            iter([InferRequest(payload=i, inputs=p) for i, p in enumerate(pairs)]))}
    finally:
        telemetry.uninstall(t)
    dec = {k: decisions(tmp_path / "port")[r.trace_id] for k, r in res.items()}
    assert sorted(res) == sorted(jres) == list(range(n))
    assert dec == jdec, (dec, jdec, confs, threshold)
    assert set(dec.values()) == {"cascade_accept", "cascade_escalate"}  # both legs ran
    esc = sum(v == "cascade_escalate" for v in jdec.values())
    assert casc.summary() == {"accepted": n - esc, "escalated": esc, "replaced": esc,
                              "fallbacks": 0, "fast_errors": 0, "threshold": threshold}
    for k, r in res.items():
        assert r.ok and jres[k].ok and r.output.shape == (h, w, 1)
        want = np.asarray(jres[k].output)
        err = float(np.abs(r.output - want).max())
        if dec[k] == "cascade_accept":
            assert err <= MAD_RTOL * float(np.abs(want).max()) + MAD_ATOL, (k, err)
        else:
            np.testing.assert_allclose(r.output, want, rtol=RAFT_RTOL, atol=RAFT_ATOL)


# ------------------------------------------------------------ CLI wiring


class TestCliWiring:
    def test_evaluate_mad_rejects_tier_flags(self):
        from raft_stereo_tpu_torch import evaluate_mad

        with pytest.raises(SystemExit, match="fast tier"):
            evaluate_mad.main(["--cascade"], device="cpu")
        with pytest.raises(SystemExit, match="fast tier"):
            evaluate_mad.main(["--tier", "quality"], device="cpu")

    def test_serve_adaptive_rejects_unknown_tier(self, tmp_path, monkeypatch):
        from raft_stereo_tpu_torch import serve_adaptive

        monkeypatch.chdir(tmp_path)
        with pytest.raises(SystemExit, match="adapted MADNet2"):
            serve_adaptive.main(["--tier", "quality", "--source", "synthetic",
                                 "--num_requests", "1"], device="cpu")

    def test_serve_adaptive_cascade_accept_all(self, tmp_path, monkeypatch):
        """The adapted MADNet2 is the fast tier of a two-tier TierSet with a
        RAFT-Stereo quality tier, serving through the CascadeServer; an
        accept-everything threshold keeps the quality tier cold."""
        from raft_stereo_tpu_torch import serve_adaptive

        monkeypatch.chdir(tmp_path)
        res = serve_adaptive.main([
            "--name", "t-casc", "--source", "synthetic", "--synthetic_size", "64", "96",
            "--num_requests", "4", "--no_adapt", "--infer_batch", "2", "--cascade",
            "--cascade_threshold=-1e9", "--quality_iters", "1"], device="cpu")
        assert res["served"] == 4 and res["failed"] == 0, res
        assert res["cascade"]["accepted"] == 4, res
        assert res["cascade"]["escalated"] == 0, res
        acc = [e for e in _events("runs/t-casc") if e["event"] == "cascade_accept"]
        assert len(acc) == 4
        assert serve_adaptive.last_server().engine.stats.compiles == 1
        # the cascade it served through, public to the caller of main
        casc = serve_adaptive.last_cascade()
        assert casc.tiers.engine("fast") is serve_adaptive.last_server().engine
        assert casc.tiers.engine("quality").stats.compiles == 0
        assert casc.summary()["accepted"] == 4

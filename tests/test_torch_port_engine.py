"""The port's batched inference engine (``runtime/infer.py``) and its bucket
padding (``ops/pad.py``) on the CPU, against the JAX package's.

Bucket padding is held to the JAX functions byte for byte. The engine is
held to the JAX engine on the same carried weights and the same mixed-shape
requests; its mechanics (partial batches and their filler, failures that
stay with their request, the stall watchdog, ``FlushRequest``, ordering)
are driven with a cheap stand-in forward. ``GraphCache``'s bookkeeping runs
here with its capture stubbed; the captures themselves are
``tests/test_torch_port_cuda.py``'s.
"""

import argparse
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu import evaluate as jax_evaluate
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.ops import pad as jax_pad
from raft_stereo_tpu.runtime import infer as jax_infer
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.ops import pad
from raft_stereo_tpu_torch.runtime import infer
from raft_stereo_tpu_torch.runtime.infer import (
    CapturedForward,
    FlushRequest,
    GraphCache,
    InferenceEngine,
    InferOptions,
    InferRequest,
    InferStallError,
)
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

CPU = torch.device("cpu")
# 9 items over two buckets: (32, 64) x6 -> a full batch of 4 and a partial
# one of 2; (64, 96) x3 -> one partial batch.
MIXED_SHAPES = [(24, 48), (40, 72), (24, 48), (32, 64), (24, 48),
                (40, 72), (24, 48), (24, 48), (40, 72)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- bucket padding

SHAPES = [(1, 1), (24, 48), (31, 33), (32, 64), (37, 51), (40, 72), (45, 70), (63, 97),
          (100, 1)]


@pytest.mark.parametrize("divis_by", [8, 32])
@pytest.mark.parametrize("h,w", SHAPES)
def test_bucket_shape_matches_jax(h, w, divis_by):
    for divis_h in (None, divis_by, 3 * divis_by):
        assert pad.bucket_shape(h, w, divis_by, divis_h=divis_h) == \
            jax_pad.bucket_shape(h, w, divis_by, divis_h=divis_h)
    x = np.zeros((1, h, w, 3), np.float32)
    (xp,) = pad.InputPadder(x.shape, divis_by=divis_by).pad(x)
    assert pad.bucket_shape(h, w, divis_by) == xp.shape[1:3]


@pytest.mark.parametrize("divis_by,num_spatial", [(32, 1), (32, 2), (32, 3), (8, 6), (32, 0)])
def test_spatial_divis_matches_jax(divis_by, num_spatial):
    assert pad.spatial_divis(divis_by, num_spatial) == jax_pad.spatial_divis(divis_by, num_spatial)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("shapes", [[(24, 48), (32, 64), (30, 40)], [(37, 51)] * 3,
                                    [(40, 72), (33, 65), (64, 96)]])
def test_batch_padder_matches_jax_byte_for_byte(shapes, mode):
    rng = np.random.RandomState(len(shapes[0]) + shapes[0][0])
    items = [rng.rand(h, w, 3).astype(np.float32) for h, w in shapes]
    bp = pad.BatchPadder(shapes, mode=mode, divis_by=32)
    jbp = jax_pad.BatchPadder(shapes, mode=mode, divis_by=32)
    assert bp.bucket == jbp.bucket
    stacked = bp.pad(items)
    assert stacked.tobytes() == jbp.pad(items).tobytes()
    for i, x in enumerate(items):  # each item as the per-image padder pads it
        (want,) = pad.InputPadder(x[None].shape, mode=mode, divis_by=32).pad(x[None])
        assert stacked[i].tobytes() == want[0].tobytes()
        np.testing.assert_array_equal(bp.unpad(stacked, i), x)
    out = bp.unpad_all(stacked, valid=2)
    assert len(out) == 2 and all(np.array_equal(a, b) for a, b in zip(out, items))
    with pytest.raises(ValueError):
        bp.unpad_all(stacked, valid=len(shapes) + 1)


def test_batch_padder_rejects_a_foreign_shape():
    with pytest.raises(ValueError, match="bucket"):
        pad.BatchPadder([(24, 48), (40, 72)], divis_by=32)
    with pytest.raises(ValueError):
        pad.BatchPadder([], divis_by=32)


# ----------------------------------------------------- the engine against JAX

JAX_CFG = JaxConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
                    corr_implementation="alt")
PORT_CFG = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                            corr_radius=2, corr_implementation="alt")
ITERS = 2


def _requests(shapes, seed=0, channels=3, scale=255.0):
    rng = np.random.RandomState(seed)
    return [InferRequest(payload=i, inputs=tuple(
        (rng.rand(h, w, channels) * scale).astype(np.float32) for _ in range(2)))
        for i, (h, w) in enumerate(shapes)]


def test_engine_matches_the_jax_engine():
    """The same carried weights and mixed-shape requests through both
    engines (batch 4: two buckets, both with a partial batch): every payload
    comes back once, within fp32's tolerance of the whole forward
    (tests/test_torch_port_slice.py: atol 5e-3 on the upsampled output)."""
    jmodel = JaxRAFTStereo(JAX_CFG)
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(0))
    jengine = jax_evaluate.make_engine(jmodel, variables, ITERS, jax_infer.InferOptions(batch=4))
    jreqs = [jax_infer.InferRequest(payload=r.payload, inputs=r.inputs)
             for r in _requests(MIXED_SHAPES)]
    want = {r.payload: r.output for r in jengine.stream(iter(jreqs))}

    model = evaluate.load_model(PORT_CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    engine = evaluate.make_engine(model, ITERS, InferOptions(batch=4))
    assert not engine.capture  # eager on the CPU
    got = [r for r in engine.stream(iter(_requests(MIXED_SHAPES)))]
    assert sorted(r.payload for r in got) == list(range(len(MIXED_SHAPES)))
    assert all(r.ok for r in got)
    for r in got:
        h, w = MIXED_SHAPES[r.payload]
        assert r.output.shape == (h, w, 1) and r.bucket == pad.bucket_shape(h, w)
        np.testing.assert_allclose(r.output, want[r.payload], atol=5e-3, rtol=1e-4)
    s = engine.stats
    assert (s.images, s.failed, s.batches, s.padded_slots) == (9, 0, 3, 3)
    assert s.buckets == jengine.stats.buckets == {(32, 64): 6, (64, 96): 3}
    assert engine.graphs.captures == 0 and len(engine.graphs) == 0


# --------------------------------------------------- the engine's mechanics


def _linear(a, b):
    """Cheap stand-in forward: [B, H, W, 3] x2 -> [B, H, W, 1]."""
    return (2.0 * a - b).sum(-1, keepdim=True)


def _want(req):
    a, b = req.inputs
    return (2.0 * a - b).sum(-1, keepdims=True)


def _engine(**kw):
    kw.setdefault("batch", 4)
    return InferenceEngine(kw.pop("fn", _linear), device=CPU, **kw)


def test_partial_batches_serve_and_their_filler_never_surfaces():
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        return _linear(a, b)

    reqs = _requests(MIXED_SHAPES, scale=1.0)
    eng = _engine(fn=fn)
    out = list(eng.stream(iter(reqs)))
    assert calls == [4, 4, 4]  # every batch, partial ones included, runs at batch 4
    assert sorted(r.payload for r in out) == list(range(9))  # each payload once
    for r in out:
        np.testing.assert_array_equal(r.output, _want(reqs[r.payload]))
    assert eng.stats.padded_slots == 3 and eng.stats.images == 9
    # a stream smaller than one batch
    eng = _engine()
    out = list(eng.stream(iter(_requests([(24, 48)], scale=1.0))))
    assert [r.payload for r in out] == [0] and eng.stats.padded_slots == 3


def test_order_within_a_batch_is_request_order():
    shapes = [(24, 48), (40, 72), (24, 48), (24, 48), (40, 72), (24, 48)]
    out = [r.payload for r in _engine(batch=4).stream(iter(_requests(shapes, scale=1.0)))]
    # bucket (32, 64) fills first (0, 2, 3, 5); the partial (64, 96) batch
    # is flushed at the end of the stream
    assert out == [0, 2, 3, 5, 1, 4]


def test_a_failing_decode_becomes_an_error_result_and_the_stream_goes_on():
    reqs = _requests([(24, 48)] * 5, scale=1.0)

    def broken():
        raise OSError("corrupt file")

    reqs[2] = InferRequest(payload=2, inputs=broken)
    reqs[4] = InferRequest(payload=4, inputs=(np.zeros((24, 48, 3)), np.zeros((20, 48, 3))))
    eng = _engine(batch=2)
    out = {r.payload: r for r in eng.stream(iter(reqs))}
    assert sorted(out) == [0, 1, 2, 3, 4]
    assert isinstance(out[2].error, OSError) and out[2].output is None and out[2].bucket is None
    assert isinstance(out[4].error, ValueError) and not out[4].ok
    for i in (0, 1, 3):
        np.testing.assert_array_equal(out[i].output, _want(reqs[i]))
    assert (eng.stats.images, eng.stats.failed) == (3, 2)


def test_a_failing_forward_fails_its_batch_only():
    def fn(a, b):
        if a.shape[1] == 64 and a.shape[2] == 96:
            raise RuntimeError("kernel launch failed")
        return _linear(a, b)

    eng = _engine(fn=fn)
    out = {r.payload: r for r in eng.stream(iter(_requests(MIXED_SHAPES, scale=1.0)))}
    bad = [i for i, s in enumerate(MIXED_SHAPES) if pad.bucket_shape(*s) == (64, 96)]
    assert sorted(out) == list(range(9))
    assert sorted(i for i, r in out.items() if not r.ok) == bad
    assert all(isinstance(out[i].error, RuntimeError) for i in bad)
    assert (eng.stats.images, eng.stats.failed) == (6, 3)


def test_a_stalled_stager_raises():
    release = threading.Event()

    def requests():
        yield from _requests([(24, 48)] * 4, scale=1.0)
        release.wait(30)  # the next request never comes in time
        yield from _requests([(24, 48)], scale=1.0)

    eng = _engine(deadline_s=0.3)
    got = []
    try:
        with pytest.raises(InferStallError, match="staged nothing"):
            for r in eng.stream(requests()):
                got.append(r.payload)
    finally:
        release.set()
    # the batch staged before the stall was dispatched; its results were
    # held for the next batch (one dispatch in flight), which never came
    assert eng.stats.batches == 1 and got == []


def test_the_request_source_raising_fails_the_stream():
    def requests():
        yield from _requests([(24, 48)] * 2, scale=1.0)
        raise OSError("source died")

    with pytest.raises(OSError, match="source died"):
        list(_engine().stream(requests()))


def test_flush_request_stages_a_partial_batch_now():
    reqs = _requests([(24, 48)] * 6 + [(40, 72)], scale=1.0)
    eng = _engine()
    stream = reqs[:2] + [FlushRequest((32, 64))] + reqs[2:4] + [FlushRequest()] + reqs[4:]
    out = [r.payload for r in eng.stream(iter(stream))]
    # [0, 1] flushed, [2, 3] flushed with every bucket, then [4, 5] and [6]
    # at the end of the stream in sorted bucket order
    assert out == [0, 1, 2, 3, 4, 5, 6]
    assert eng.stats.batches == 4 and eng.stats.padded_slots == 2 + 2 + 2 + 3
    # an unknown or empty bucket is a no-op
    eng = _engine()
    out = [r.payload for r in eng.stream(iter([FlushRequest((96, 96))] + reqs[:4]))]
    assert out == [0, 1, 2, 3] and eng.stats.batches == 1


def test_engine_refuses_bad_options():
    for kw in ({"batch": 0}, {"prefetch_depth": 0}, {"deadline_s": 0.0}):
        with pytest.raises(ValueError):
            _engine(**kw)
    with pytest.raises(ValueError):
        GraphCache(max_entries=0)


def test_make_engine_and_make_forward_run_eagerly_where_they_must():
    model = evaluate.load_model(PORT_CFG, device="cpu")
    eng = evaluate.make_engine(model, ITERS, InferOptions(batch=2, max_executables=3))
    assert not eng.capture and eng.graphs.max_entries == 3 and eng.batch == 2
    assert evaluate.make_forward(model, ITERS).graphs is None


# ------------------------------------------------ GraphCache's bookkeeping


class _FakeGraph:
    def __init__(self):
        self.replays = 0
        self.reset_called = False

    def replay(self):
        self.replays += 1

    def reset(self):
        self.reset_called = True


def test_graph_cache_lru_counts_and_launches(monkeypatch):
    cache = GraphCache(max_entries=2)
    captured = []

    def fake_capture(fn, inputs):
        captured.append(fn)
        out = torch.zeros(1)
        cache.captures += 1
        return CapturedForward(_FakeGraph(), tuple(x.clone() for x in inputs), out,
                               {"alt_corr": 3, "fused_update": 0, "packed_conv": 1})

    monkeypatch.setattr(cache, "_capture", fake_capture)
    x = (torch.ones(2),)
    cache.run("a", "fa", x)
    cache.run("a", "fa", (torch.full((2,), 5.0),))
    assert torch.equal(cache.entry("a").inputs[0], torch.full((2,), 5.0))  # copied in
    cache.run("b", "fb", x)
    ea = cache.entry("a")
    cache.run("a", "fa", x)  # "a" is now the most recent
    cache.run("c", "fc", x)  # evicts "b"
    assert len(cache) == 2 and "b" not in cache and "a" in cache and "c" in cache
    assert cache.evictions == 1 and captured == ["fa", "fb", "fc"]
    assert (cache.captures, cache.hits, cache.replays) == (3, 2, 5)
    assert ea.replays == 3 and ea.graph.replays == 3
    assert cache.replayed_launches == {"alt_corr": 15, "fused_update": 0, "packed_conv": 5}


# ------------------------------------------------------------- CLI options

FLAGS = ("infer_batch", "per_image", "infer_prefetch", "infer_timeout", "infer_retries",
         "max_failed_frac", "telemetry_dir")


def test_infer_flags_keep_the_jax_defaults():
    p, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    infer.add_infer_args(p)
    jax_infer.add_infer_args(jp)
    args, jargs = p.parse_args([]), jp.parse_args([])
    assert {f: getattr(args, f) for f in FLAGS} == {f: getattr(jargs, f) for f in FLAGS}
    opts, jopts = infer.options_from_args(args), jax_infer.options_from_args(jargs)
    for f in ("batch", "prefetch", "max_executables", "deadline_s", "retries"):
        assert getattr(opts, f) == getattr(jopts, f)
    assert infer.options_from_args(p.parse_args(["--per_image"])) is None
    assert infer.options_from_args(p.parse_args(["--infer_timeout", "0"])).deadline_s is None
    assert infer.options_from_args(p.parse_args(["--infer_batch", "2"])).batch == 2


def test_failure_budget():
    infer.reset_summary()
    infer.enforce_failure_budget(0.0)  # nothing published: nothing to enforce
    stats = infer.InferStats(images=3, failed=1)
    s = infer.publish_summary(stats, label="t")
    assert (s.completed, s.failed, s.total) == (3, 1, 4) and s.failed_frac == 0.25
    assert infer.last_summary() == s
    with pytest.raises(SystemExit, match="1/4 requests failed"):
        infer.enforce_failure_budget(0.2)
    infer.enforce_failure_budget(0.25)
    infer.reset_summary()
    assert infer.last_summary() is None

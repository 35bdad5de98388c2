"""The engine's host stager (``runtime/infer.py``, ``ops/pad.py``) on the
CPU: each slot edge-padded straight into its batch buffer, one host copy a
pixel, gives bitwise the batch that ``np.pad(mode="edge")`` and
``np.stack`` give (odd shapes, 1- and 3-channel slots, filler slots,
``divis_h``, /32 and /128 buckets, mixed dtypes, bands on several
threads); the engine's outputs are bitwise those of the model on that
batch, for RAFT-Stereo and MADNet2Fusion at a small size; and the ring of
page-locked buffers reuses what comes back, allocates a slot's ring only
when a batch outgrows it, and stays bounded however many buckets a stream
visits (a stand-in allocator on the CPU). The page-locked buffers
themselves are ``tests/test_torch_port_cuda.py``'s.
"""

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch import evaluate, evaluate_mad
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
from raft_stereo_tpu_torch.ops.pad import BatchPadder, bucket_shape, edge_pad_rows
from raft_stereo_tpu_torch.runtime import infer
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferOptions, InferRequest


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pad_stack(padder, items):
    """The stager's bytes before one host copy: pad each, then stack."""
    return np.stack([np.pad(np.asarray(x), ((t, b), (l, r), (0, 0)), mode="edge")
                     for x, (l, r, t, b) in zip(items, padder._pads)])


def _items(shapes, channels, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, channels)) * 255).astype(dtype) for h, w in shapes]


CASES = {
    "odd_div32": ([(23, 47), (31, 61), (17, 33)], 32, None),
    "odd_div128": ([(129, 250), (200, 131)], 128, None),
    "exact_fit": ([(64, 96), (64, 96)], 32, None),
    "divis_h": ([(100, 200), (110, 195)], 32, 96),
    "one_row_one_col": ([(1, 1)], 8, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("per_item", [1, 3, 1000])
def test_bands_are_pad_and_stack_bitwise(case, channels, per_item):
    shapes, divis, divis_h = CASES[case]
    # a filler slot: the last item again, as the stager fills a partial batch
    shapes = shapes + shapes[-1:]
    padder = BatchPadder(shapes, divis_by=divis, divis_h=divis_h)
    items = _items(shapes[:-1], channels)
    items = items + items[-1:]
    want = _pad_stack(padder, items)
    out = np.full(padder.slot_shape(items), np.nan, np.float32)
    for band in padder.bands(out, items, per_item):
        band()
    assert out.tobytes() == want.tobytes()
    assert padder.pad(items).tobytes() == want.tobytes()


def test_bands_cover_every_row_once():
    """Each band writes its own rows: run them in reverse order, then on
    the stage threads, and the batch is the same."""
    shapes = [(37, 70), (40, 65)]
    padder = BatchPadder(shapes, divis_by=32)
    items = _items(shapes, 3, seed=1)
    want = _pad_stack(padder, items)
    out = np.zeros_like(want)
    tasks = padder.bands(out, items, 5)
    assert len(tasks) == 2 * 5
    for task in reversed(tasks):
        task()
    assert out.tobytes() == want.tobytes()
    out = np.zeros_like(want)
    infer._run_bands(padder.bands(out, items, 4))
    assert out.tobytes() == want.tobytes()


def test_mixed_dtypes_take_stacks_result_type():
    shapes = [(20, 30), (20, 30)]
    padder = BatchPadder(shapes, divis_by=32)
    items = [_items(shapes[:1], 3)[0], _items(shapes[:1], 3, dtype=np.uint8)[0]]
    want = _pad_stack(padder, items)
    got = padder.pad(items)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_edge_pad_rows_of_a_band_only():
    x = np.arange(2 * 3 * 1, dtype=np.float32).reshape(2, 3, 1)
    dst = np.zeros((6, 7, 1), np.float32)
    edge_pad_rows(dst, x, (2, 2, 1, 3), rows=(4, 6))
    want = np.pad(x, ((1, 3), (2, 2), (0, 0)), mode="edge")
    assert np.array_equal(dst[4:6], want[4:6]) and not dst[:4].any()


def test_pad_refuses_items_that_are_not_hwc():
    padder = BatchPadder([(20, 30)], divis_by=32)
    with pytest.raises(ValueError):
        padder.pad([np.zeros((20, 30), np.float32)])


# ----------------------------------------------------------- the engine's batch


def _staged_by_the_stager(monkeypatch, threads):
    """Every batch the engine stages, recorded (its arrays copied before a
    buffer could be refilled), its slots cut into bands for ``threads``
    stage threads."""
    monkeypatch.setattr(infer, "STAGE_THREADS", threads)
    seen = []
    real = InferenceEngine._stage

    def stage(self, items, bucket):
        staged = real(self, items, bucket)
        seen.append((items, [a.copy() for a in staged.arrays]))
        return staged

    monkeypatch.setattr(InferenceEngine, "_stage", stage)
    return seen


def _requests(shapes, slots, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate(shapes):
        inputs = tuple((rng.random((h, w, c)) * 255).astype(np.float32) for c in slots)
        out.append(InferRequest(payload=i, inputs=inputs))
    return out


def _held_to_pad_and_stack(engine, requests, seen, model_fn):
    """Each staged batch equals pad + stack of its members (filler
    included), and each result is the model on that batch, unpadded."""
    results = {r.payload: r for r in engine.stream(iter(requests))}
    assert all(r.ok for r in results.values()) and len(results) == len(requests)
    assert seen
    for items, arrays in seen:
        padded = list(items) + [items[-1]] * (engine.batch - len(items))
        padder = BatchPadder([x.arrays[0].shape[:2] for x in padded], divis_by=engine.divis_by)
        want = [_pad_stack(padder, [x.arrays[k] for x in padded]) for k in range(len(arrays))]
        assert [a.tobytes() for a in arrays] == [w.tobytes() for w in want]
        with torch.no_grad():
            out = model_fn(*(torch.from_numpy(w) for w in want)).numpy()
        for i, x in enumerate(items):
            got = results[x.payload].output
            assert got.tobytes() == padder.unpad(out, i).tobytes(), x.payload


@pytest.mark.parametrize("threads", [1, 8], ids=["one_thread", "threads"])
def test_raft_engine_outputs_are_the_models_on_pad_and_stack(monkeypatch, threads):
    seen = _staged_by_the_stager(monkeypatch, threads)
    cfg = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                           corr_radius=2)
    model = evaluate.load_model(cfg, device="cpu", seed=3)
    engine = evaluate.make_engine(model, 2, InferOptions(batch=2))
    shapes = [(30, 62), (32, 64), (27, 50)]  # one bucket, a partial batch with a filler
    assert len({bucket_shape(h, w) for h, w in shapes}) == 1

    def fwd(a, b):
        return model(a, b, iters=2)[1]

    _held_to_pad_and_stack(engine, _requests(shapes, (3, 3)), seen, fwd)


@pytest.mark.parametrize("threads", [1, 8], ids=["one_thread", "threads"])
def test_fusion_engine_outputs_are_the_models_on_pad_and_stack(monkeypatch, threads):
    seen = _staged_by_the_stager(monkeypatch, threads)
    model = make_madnet2(fusion=True, seed=4)
    engine = evaluate_mad.make_mad_engine(model, fusion=True, infer=InferOptions(batch=2))
    shapes = [(120, 250), (128, 256), (101, 131)]

    def fwd(a, b, g):
        from raft_stereo_tpu_torch.ops.sampling import bilinear_upsample

        return bilinear_upsample(model(a, b, g)[0], 4) * -20.0

    _held_to_pad_and_stack(engine, _requests(shapes, (3, 3, 1), seed=2), seen, fwd)


# ------------------------------------------------------------ the buffer ring


class _Ring(infer._HostBuffers):
    """The ring over a stand-in allocator (pageable tensors) that counts
    what it made and sees what is still alive."""

    def __init__(self, depth):
        super().__init__(depth)
        self.made, self._refs = 0, []

    def _alloc(self, nbytes):
        import weakref

        self.made += 1
        t = torch.empty(nbytes, dtype=torch.uint8)
        self._refs.append(weakref.ref(t))
        return t

    def alive(self):
        import gc

        gc.collect()
        return sum(r() is not None for r in self._refs)


def test_ring_is_allocated_once_a_slot_and_reused():
    ring = _Ring(3)
    a = ring.take(0, 96)
    assert ring.made == 3 and a.numel() == 96  # the whole ring at the slot's first take
    b, c = ring.take(0, 96), ring.take(0, 40)  # a smaller batch takes a ring buffer
    assert ring.made == 3 and len({id(a), id(b), id(c)}) == 3 and c.numel() == 96
    d = ring.take(0, 96)  # an empty ring allocates
    assert ring.made == 4
    ring.give((a,))
    assert ring.take(0, 96) is a and ring.made == 4
    ring.give((b,))
    ring.give((c,))
    ring.give((d,))
    ring.give((a,))  # the ring is full: one more is dropped
    assert len(ring._free[0]) == 3


def test_ring_keeps_slots_and_shapes_apart():
    ring = _Ring(2)
    left, guide = ring.take(0, 8 * 8 * 3 * 4), ring.take(1, 8 * 8 * 4)
    assert ring.made == 4
    ring.give((left, guide))
    assert ring.take(1, 8 * 8 * 4) is guide
    assert ring.take(0, 8 * 8 * 3 * 4) is left
    big = ring.take(0, 16 * 8 * 3 * 4)  # a larger bucket: slot 0's ring replaced
    assert ring.made == 6 and big.numel() == 16 * 8 * 3 * 4
    ring.give((left, guide))  # smaller than slot 0's ring now: dropped
    assert id(left) not in map(id, ring._free[0]) and id(guide) in map(id, ring._free[1])
    assert ring.take(0, 8 * 8 * 3 * 4).numel() == 16 * 8 * 3 * 4 and ring.made == 6


def test_engine_ring_depth_covers_the_pipeline():
    """Queued (prefetch) batches, the one being staged, the dispatched one
    and the one held for finalize, and one spare."""
    engine = InferenceEngine(lambda a: a, device="cpu", batch=2, prefetch_depth=3)
    assert engine._host_buffers.depth == 3 + 3


def test_ring_stays_bounded_over_many_buckets(monkeypatch):
    """A stream through many buckets (one a pair, as a full-resolution
    evaluation set gives), sizes rising and falling, staged through the
    ring on the CPU: a slot never holds more than its ring and the batches
    in flight, what is alive at the end is one ring a slot, and every
    batch is still pad + stack of its members."""
    seen = _staged_by_the_stager(monkeypatch, 2)
    engine = InferenceEngine(lambda a, b: a[..., :1] - b[..., :1], device="cpu", batch=2,
                             prefetch_depth=2, divis_by=32)
    ring = engine._host_buffers = _Ring(engine.prefetch_depth + 3)
    engine._stage_locked = True
    peak = []
    real_take = ring.take

    def take(slot, nbytes):
        peak.append(ring.alive())
        return real_take(slot, nbytes)

    ring.take = take
    rng = np.random.default_rng(7)
    shapes = [(int(h), int(w)) for h, w in rng.integers(20, 300, size=(24, 2))]
    assert len({bucket_shape(h, w) for h, w in shapes}) > 12
    requests = [r for shape in shapes for r in _requests([shape] * 2, (3, 3), seed=len(seen))]
    for i, r in enumerate(requests):
        r.payload = i
    _held_to_pad_and_stack(engine, requests, seen, lambda a, b: a[..., :1] - b[..., :1])
    depth = ring.depth
    assert max(peak) <= 2 * 2 * depth  # two slots: each ring, and at most a ring lent out
    assert ring.alive() == 2 * depth
    assert ring.made < len(seen) * 2  # buffers are reused, not made a batch


def test_ring_never_hands_one_buffer_to_two_holders():
    """Stress: more threads than cores take and give back at once (the
    stager and the consumer do so on two threads); no buffer is ever held
    twice, and the ring ends full."""
    import sys
    import threading

    ring = _Ring(4)
    held, lock, errors = set(), threading.Lock(), []

    def worker():
        for _ in range(300):
            t = ring.take(0, 16)
            with lock:
                if id(t) in held:
                    errors.append("held twice")
                held.add(id(t))
            with lock:
                held.discard(id(t))
            ring.give((t,))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(ring._free[0]) == 4


class _CopyEvent:
    """An input copy that completes after ``polls`` queries, or never."""

    def __init__(self, polls=None):
        self.polls, self.queries = polls, 0

    def query(self):
        self.queries += 1
        return self.polls is not None and self.queries > self.polls


def test_the_stager_lets_the_last_input_copy_finish_first():
    engine = InferenceEngine(lambda a: a, device="cpu", batch=1)
    engine._inputs_copied = copied = _CopyEvent(polls=3)
    items = [infer._Decoded(payload=0, arrays=(np.ones((8, 8, 3), np.float32),))]
    staged = engine._stage(items, (32, 32))
    assert copied.queries == 4 and staged.arrays[0].shape == (1, 32, 32, 3)


def test_the_stagers_wait_is_bounded(monkeypatch):
    """A copy that never reports done (a wedged card) holds the stager
    ``STAGE_YIELD_S`` at most; the dispatch's own watchdog reports it."""
    import time

    monkeypatch.setattr(infer, "STAGE_YIELD_S", 0.05)
    engine = InferenceEngine(lambda a: a, device="cpu", batch=1)
    engine._inputs_copied = _CopyEvent(polls=None)
    t0 = time.perf_counter()
    engine._yield_to_input_copy()
    assert 0.05 <= time.perf_counter() - t0 < 1.0

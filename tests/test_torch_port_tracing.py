"""The port's tracing on the CPU: spans on the profiler's clock, the batch
number and the parent each span carries across the engine's threads, the
model's stage marks, the engine's stage, pin and graph counters, and the
join of idle device time with the spans (``runtime/telemetry.py``,
``runtime/infer.py``, ``models/raft_stereo.py``).

The card's side (stage marks as event-record nodes of a captured graph,
re-pointed per replay) is ``tests/test_torch_port_cuda.py``'s."""

import json
import random
import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.runtime import faultinject, infer, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    CapturedForward,
    GraphCache,
    InferenceEngine,
    InferRequest,
)

TINY = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2)
ITERS = 3
STAGES = ["encode", "refine", "final"]


@pytest.fixture(autouse=True)
def _clean():
    faultinject.reset()
    telemetry.install(None)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    telemetry.install(None)
    faultinject.reset()


@pytest.fixture()
def sink(tmp_path):
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path)))
    yield tel
    telemetry.uninstall(tel)


def _requests(n, shape=(24, 48), seed=0):
    rng = np.random.RandomState(seed)
    return [InferRequest(payload=i, inputs=(rng.rand(*shape, 3).astype(np.float32) * 255,
                                            rng.rand(*shape, 3).astype(np.float32) * 255))
            for i in range(n)]


def _linear_fn(a, b):
    return (a * 2.0 - b).sum(-1, keepdim=True)


# ------------------------------------------------------ the profiler's clock


def test_a_span_contains_its_torch_op_on_the_profiler_clock(sink):
    """A span around a matmul holds the profiler's event of that matmul,
    within 50 µs at each end, once converted through the sink's anchor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with telemetry.span("matmul"):
                torch.mm(a, a)
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm" and e.device_type() == DeviceType.CPU)
    spans = sorted((s["start_ns"], s["end_ns"]) for s in sink.spans() if s["name"] == "matmul")
    assert len(ops) == len(spans) == 3
    for (s0, s1), (o0, o1) in zip(spans, ops):
        assert o0 >= s0 - 50_000 and o1 <= s1 + 50_000, (s0, s1, o0, o1)


def test_trace_host_json_is_written_on_the_profiler_clock(sink, tmp_path):
    with telemetry.span("outer", batch=3):
        with telemetry.span("inner"):
            pass
    sink.flush_trace()
    doc = json.loads((tmp_path / telemetry.TRACE_NAME).read_text())
    assert doc["otherData"]["clock"] == "unix_epoch"
    assert doc["otherData"]["anchor_ns"] == list(sink.anchor)
    got = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    spans = {s["name"]: s for s in sink.spans()}
    for name in ("outer", "inner"):
        assert got[name]["ts"] == spans[name]["start_ns"] / 1e3
        assert got[name]["args"]["span_id"] == spans[name]["id"]
    assert got["inner"]["args"]["parent_id"] == spans["outer"]["id"]
    assert got["outer"]["args"] == {"batch": 3, "span_id": spans["outer"]["id"], "parent_id": 0}
    # within a few ms of the wall clock: the epoch, not the monotonic clock
    assert abs(spans["outer"]["start_ns"] - time.time_ns()) < 5e9


def test_the_sink_bounds_a_spans_trace_ids(sink):
    ids = [f"t{i}" for i in range(20)]
    with telemetry.span("batch", trace_ids=ids):
        pass
    with telemetry.span("few", trace_ids=ids[:3]):
        pass
    got = {s["name"]: s["args"]["trace_ids"] for s in sink.spans()}
    assert got["batch"] == ids[:telemetry.SPAN_TRACE_IDS] + ["+12 more"]
    assert got["few"] == ids[:3]
    assert len(ids) == 20  # the caller's list is left whole


def test_no_sink_spans_are_one_shared_null_context():
    assert telemetry.span("a", batch=1) is telemetry.span("b")


# ------------------------------------------ batch numbers across two threads


def test_batch_spans_join_across_the_stager_and_the_consumer(sink):
    """Every span on a batch's path carries its number: the stager's
    ``h2d_stage``, the consumer's ``dispatch`` (its ``bucket_compile`` the
    first time), ``device_batch`` and ``device_wait``. Each span's parent is
    the innermost span open on its own thread."""
    eng = InferenceEngine(_linear_fn, device="cpu", batch=2)
    reqs = _requests(6)
    results = list(eng.stream(iter(reqs)))
    assert all(r.ok for r in results)
    spans = sink.spans()
    by_id = {s["id"]: s for s in spans}
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)

    def batches(name):
        return sorted(s["args"]["batch"] for s in by_name[name])

    for name in ("h2d_stage", "dispatch", "device_batch", "device_wait"):
        assert batches(name) == [0, 1, 2], name
    assert batches("bucket_compile") == [0]
    stager = {s["thread"] for s in by_name["h2d_stage"] + by_name["request_source"]}
    consumer = {s["thread"] for s in by_name["dispatch"] + by_name["device_batch"]}
    assert stager == {"infer-stager"} and len(consumer) == 1 and stager != consumer
    for s in by_name["h2d_stage"] + by_name["request_source"] + by_name["dispatch"]:
        assert s["parent"] == 0, s
    for s in by_name["bucket_compile"]:
        assert by_id[s["parent"]]["name"] == "dispatch"
        assert by_id[s["parent"]]["args"]["batch"] == s["args"]["batch"]
    for s in by_name["device_wait"]:  # no deadline: the wait runs on the consumer
        parent = by_id[s["parent"]]
        assert parent["name"] == "device_batch"
        assert parent["args"]["batch"] == s["args"]["batch"]
    # one request's trace id rides its batch's spans on both threads
    for r in results:
        n = r.payload // 2
        for name in ("h2d_stage", "dispatch", "device_batch"):
            (s,) = [x for x in by_name[name] if x["args"]["batch"] == n]
            assert r.trace_id in s["args"]["trace_ids"], (name, n)


def test_the_request_source_span_wraps_the_callers_iterator(sink):
    def slow_source():
        for req in _requests(2):
            time.sleep(0.05)
            yield req

    eng = InferenceEngine(_linear_fn, device="cpu", batch=2)
    assert all(r.ok for r in eng.stream(slow_source()))
    waits = [s for s in sink.spans() if s["name"] == "request_source"]
    assert len(waits) == 3  # two requests and the end of the source
    assert sum(s["end_ns"] - s["start_ns"] for s in waits) >= 0.09e9


# ------------------------------------------------------------- stage marks


class _FakeEvent:
    clock = 0

    def __init__(self):
        self.at = None

    def record(self):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def elapsed_time(self, end):
        return float(end.at - self.at)


def _tiny_model():
    return evaluate.load_model(TINY, device="cpu", seed=3)


def _pair(h=32, w=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((1, h, w, 3), generator=g) * 255,
            torch.rand((1, h, w, 3), generator=g) * 255)


def test_the_test_forward_records_four_marks_in_order(sink):
    model = _tiny_model()
    made = []

    def factory():
        made.append(_FakeEvent())
        return made[-1]

    with telemetry.stage_marks(factory) as marks:
        model(*_pair(), iters=ITERS)
    assert [stage for stage, _ in marks] == ["start"] + STAGES
    assert [ev.at for _, ev in marks] == sorted(ev.at for _, ev in marks)
    assert [ev for _, ev in marks] == made
    assert telemetry.stage_ms(marks) == {"encode": 1.0, "refine": 1.0, "final": 1.0}
    # outside a stage_marks block nothing records, sink or not
    model(*_pair(), iters=ITERS)
    assert len(made) == 4


def test_no_sink_no_marks():
    model = _tiny_model()
    made = []
    with telemetry.stage_marks(lambda: made.append(_FakeEvent()) or made[-1]) as marks:
        model(*_pair(), iters=ITERS)
    assert marks is None and made == []


def test_marks_are_stage_boundaries_of_the_same_output(sink):
    """The marks change nothing in what the forward computes."""
    model = _tiny_model()
    a, b = _pair(seed=4)
    plain = model(a, b, iters=ITERS)[1]
    with telemetry.stage_marks(telemetry.HostMark) as marks:
        marked = model(a, b, iters=ITERS)[1]
    assert torch.equal(plain, marked)
    assert all(ms >= 0 for ms in telemetry.stage_ms(marks).values())


# ------------------------------------------------------- the engine's counters


def _with_device_time(monkeypatch):
    """The CPU launch with a device time, as the card's CUDA events give
    one: the batch then enters ``batch_ms`` and, aligned, ``stage_ms``."""
    real = InferenceEngine._launch

    def launch(self, *a, **kw):
        out = real(self, *a, **kw)
        out.ms = 1.0
        return out

    monkeypatch.setattr(InferenceEngine, "_launch", launch)


def test_stage_ms_is_aligned_with_batch_ms_and_observed(sink, monkeypatch):
    _with_device_time(monkeypatch)
    eng = evaluate.make_engine(_tiny_model(), ITERS, infer.InferOptions(batch=2))
    results = list(eng.stream(iter(_requests(5, shape=(32, 64)))))
    assert all(r.ok for r in results)
    s = eng.stats
    assert len(s.stage_ms) == len(s.batch_ms) == len(s.batch_valid) == 3
    assert s.batch_valid == [2, 2, 1]
    for stages in s.stage_ms:
        assert list(stages) == STAGES and all(ms >= 0 for ms in stages.values())
    hists = sink.metrics.latency_snapshot()["infer_stage_device_seconds"]
    assert {k: v["count"] for k, v in hists.items()} == {
        f"bucket=32x64,stage={stage}": 3 for stage in STAGES}
    assert s.pin_s == 0.0  # no pinned copy on the CPU


def test_no_sink_leaves_stage_ms_empty_but_aligned(monkeypatch):
    _with_device_time(monkeypatch)
    eng = evaluate.make_engine(_tiny_model(), ITERS, infer.InferOptions(batch=2))
    assert all(r.ok for r in eng.stream(iter(_requests(4, shape=(32, 64)))))
    assert eng.stats.stage_ms == [{}, {}] and len(eng.stats.batch_ms) == 2


def test_a_forward_without_marks_reports_none(sink, monkeypatch):
    _with_device_time(monkeypatch)
    eng = InferenceEngine(_linear_fn, device="cpu", batch=2)
    assert all(r.ok for r in eng.stream(iter(_requests(2))))
    assert eng.stats.stage_ms == [{}]


def test_combined_stats_carry_pin_and_stages():
    from raft_stereo_tpu_torch.runtime.tiers import TierSet

    class _E:
        def __init__(self, pin, stages):
            self.stats = infer.InferStats(pin_s=pin, batch_ms=[1.0], batch_valid=[1],
                                          stage_ms=[stages])

    ts = TierSet.__new__(TierSet)
    ts.engines = {"a": _E(0.5, {"encode": 1.0}), "b": _E(0.25, {})}
    out = ts.combined_stats()
    assert out.pin_s == 0.75 and out.stage_ms == [{"encode": 1.0}, {}]


class _FakeGraph:
    def replay(self):
        pass

    def reset(self):
        pass


def test_graph_cache_splits_warm_up_from_capture(sink):
    """``warmup_s`` is the warm-up alone, ``capture_s`` the warm-up and the
    capture; ``graph.warmup`` and ``graph.capture`` are children of the
    compile around them, and the capture is handed the marks list a sink
    arms."""
    cache = GraphCache()
    seen = {}

    def warm_up(fn, inputs):
        time.sleep(0.06)
        return tuple(x.clone() for x in inputs)

    def record(fn, static, marks):
        seen["marks"] = marks
        time.sleep(0.03)
        return CapturedForward(_FakeGraph(), static, torch.zeros(1), {})

    cache._warm_up, cache._record = warm_up, record
    with telemetry.span("bucket_compile", batch=0):
        cache.get("k", None, (torch.ones(2),))
    assert cache.captures == 1 and seen["marks"] == []
    assert 0.06 <= cache.warmup_s < cache.capture_s
    assert cache.capture_s - cache.warmup_s >= 0.03
    spans = {s["name"]: s for s in sink.spans()}
    for name in ("graph.warmup", "graph.capture"):
        assert spans[name]["parent"] == spans["bucket_compile"]["id"]
    warm, cap = spans["graph.warmup"], spans["graph.capture"]
    assert warm["end_ns"] <= cap["start_ns"]
    assert cache.arm_marks(cache.entry("k")) is None  # captured without mark nodes


def test_graph_cache_with_no_sink_captures_without_marks():
    cache = GraphCache()
    seen = {}
    cache._warm_up = lambda fn, inputs: inputs
    cache._record = lambda fn, static, marks: (
        seen.setdefault("marks", marks),
        CapturedForward(_FakeGraph(), static, torch.zeros(1), {}))[1]
    cache.get("k", None, (torch.ones(2),))
    assert seen["marks"] is None and cache.warmup_s > 0 and cache.capture_s >= cache.warmup_s


def test_a_failed_warm_up_counts_nothing():
    cache = GraphCache()

    def warm_up(fn, inputs):
        raise RuntimeError("warm-up failed")

    cache._warm_up = warm_up
    with pytest.raises(RuntimeError):
        cache.get("k", None, (torch.ones(2),))
    assert (cache.captures, cache.warmup_s, cache.capture_s, len(cache)) == (0, 0.0, 0.0, 0)


# ------------------------------------------------- idle device time by span


def test_idle_by_span_on_synthetic_intervals():
    # window [0, 100); the device runs [10, 30) and [50, 60) and [90, 120)
    busy = [(10, 30), (50, 60), (90, 120)]
    consumer = [(0, 40, "decode_wait"), (40, 100, "device_batch"), (45, 70, "device_wait")]
    stager = [(0, 20, "h2d_stage"), (5, 8, "pad"), (60, 95, "request_source")]
    got = telemetry.idle_by_span(busy, (0, 100), [consumer, stager])
    o = telemetry.OUTSIDE
    assert got == {
        ("decode_wait", "h2d_stage"): 7,   # [0, 5) and [8, 10)
        ("decode_wait", "pad"): 3,         # [5, 8)
        ("decode_wait", o): 10,            # [30, 40)
        ("device_batch", o): 5,            # [40, 45)
        ("device_wait", o): 5,             # [45, 50)
        ("device_wait", "request_source"): 10,  # [60, 70)
        ("device_batch", "request_source"): 20,  # [70, 90)
    }
    assert sum(got.values()) == 100 - 20 - 10 - 10


def _brute(busy, window, lanes):
    out = {}
    for t in range(*window):
        if any(s <= t < e for s, e in busy):
            continue
        key = []
        for lane in lanes:
            open_ = [(s, -e, n) for s, e, n in lane if s <= t < e]
            key.append(max(open_)[2] if open_ else telemetry.OUTSIDE)
        out[tuple(key)] = out.get(tuple(key), 0) + 1
    return out


def _nested(rng, lo, hi, depth, prefix):
    spans, t = [], lo
    while t < hi - 2 and rng.random() < 0.8:
        s = rng.randrange(t, hi - 1)
        e = rng.randrange(s + 1, min(hi, s + 40) + 1)
        name = f"{prefix}{len(spans)}"
        spans.append((s, e, name))
        if depth and e - s > 2:
            spans += _nested(rng, s, e, depth - 1, name + ".")
        t = e
    return spans


@pytest.mark.parametrize("seed", range(8))
def test_idle_by_span_attributes_every_idle_unit_once(seed):
    rng = random.Random(seed)
    busy = []
    for _ in range(rng.randrange(0, 12)):
        s = rng.randrange(-10, 200)
        busy.append((s, s + rng.randrange(1, 30)))
    lanes = [_nested(rng, 0, 200, 2, "c"), _nested(rng, 0, 200, 2, "s")]
    window = (5, 190)
    got = telemetry.idle_by_span(busy, window, lanes)
    assert got == _brute(busy, window, lanes)
    idle = sum(1 for t in range(*window) if not any(s <= t < e for s, e in busy))
    assert sum(got.values()) == idle


def _trace_cell():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "trace_cell.py"
    spec = importlib.util.spec_from_file_location("trace_cell_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# device operation names as torch.profiler reports them on an H100
_TRACED_OPS = {
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
    "at::native::CUDAFunctor_add<c10::BFloat16> >(at::TensorIteratorBase&, "
    "at::native::CUDAFunctor_add<c10::BFloat16> const&)::{lambda(int)#1}>(int, "
    "at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16> >"
    "(at::TensorIteratorBase&, at::native::CUDAFunctor_add<c10::BFloat16> const&)"
    "::{lambda(int)#1})": {"count": 10, "seconds": 0.5},
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<"
    "at::native::sigmoid_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::operator()"
    "() const>(int)": {"count": 2, "seconds": 0.25},
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<"
    "c10::BFloat16>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<"
    "c10::BFloat16>, std::array<char*, 3ul>)": {"count": 40, "seconds": 1.0},
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda()#3}>(int)": {"count": 4, "seconds": 0.125},
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float, float, float>, unsigned int, float, 4> >"
    "(at::native::ReduceOp<float>)": {"count": 1, "seconds": 0.75},
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, "
    "float, false, true, (cudnnKernelDataType_t)0>(cudnn::engines_precompiled::"
    "nchw2nhwc_params_t<float>, __nv_bfloat16 const*, __nv_bfloat16*)":
        {"count": 8, "seconds": 0.0625},
    "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, "
    "float, true, false, (cudnnKernelDataType_t)0>(cudnn::engines_precompiled::"
    "nhwc2nchw_params_t<float>, __nv_bfloat16 const*, __nv_bfloat16*)":
        {"count": 8, "seconds": 0.03125},
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64"
    "_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn":
        {"count": 16, "seconds": 2.0},
}


def test_trace_cell_sums_layout_and_strided_kernels_a_pair():
    got = _trace_cell().kernel_family_ms(_TRACED_OPS, pairs=4)
    assert got == {"layout_convert_ms_per_pair": 1e3 * 0.09375 / 4,
                   "strided_elementwise_ms_per_pair": 1e3 * 0.75 / 4}
    assert _trace_cell().kernel_family_ms({}, pairs=4) == {
        "layout_convert_ms_per_pair": 0.0, "strided_elementwise_ms_per_pair": 0.0}


# ------------------------------------------------- the MADNet2 family's marks

MAD_LEVELS = (6, 5, 4, 3, 2)
MAD_STAGES = ["pyramid"] + [f"{s}{k}" for k in MAD_LEVELS for s in ("corr", "decode")]
FUSION_STAGES = ["pyramid", "guidance"] + [f"{s}{k}" for k in MAD_LEVELS
                                          for s in ("corr", "xattn", "decode")]


def _mad_pair(seed=0, guide=False):
    g = torch.Generator().manual_seed(seed)
    out = [torch.rand((1, 128, 256, 3), generator=g) * 255 for _ in range(2)]
    return out + ([torch.rand((1, 128, 256, 1), generator=g) * -20] if guide else [])


@pytest.mark.parametrize("fusion", [False, True], ids=["madnet2", "fusion"])
def test_madnet2_marks_are_free_without_a_sink(fusion):
    """No sink: the forward records no event and computes what a marked
    forward computes."""
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2

    model = make_madnet2(fusion=fusion, seed=1)
    inputs = _mad_pair(guide=fusion)
    made = []
    with torch.no_grad():
        plain = model(*inputs)
        with telemetry.stage_marks(lambda: made.append(_FakeEvent()) or made[-1]) as marks:
            again = model(*inputs)
    assert marks is None and made == []
    assert all(torch.equal(a, b) for a, b in zip(plain, again))


@pytest.mark.parametrize("fusion", [False, True], ids=["madnet2", "fusion"])
def test_madnet2_forward_marks_its_stages_in_order(sink, fusion):
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2

    model = make_madnet2(fusion=fusion, seed=1)
    inputs = _mad_pair(guide=fusion)
    with torch.no_grad():
        plain = model(*inputs)
        with telemetry.stage_marks(_FakeEvent) as marks:
            marked = model(*inputs)
    assert [stage for stage, _ in marks] == ["start"] + (FUSION_STAGES if fusion else MAD_STAGES)
    assert list(telemetry.stage_ms(marks)) == (FUSION_STAGES if fusion else MAD_STAGES)
    assert all(torch.equal(a, b) for a, b in zip(plain, marked))


def test_fusion_engine_splits_each_batch_into_named_stages(sink, monkeypatch):
    """Through ``evaluate_mad``'s engine each full batch's device time
    splits into the named stages, the five levels' cross-attention apart
    from their correlation and decoder, and the upsampled output last."""
    from raft_stereo_tpu_torch import evaluate_mad
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2

    _with_device_time(monkeypatch)
    engine = evaluate_mad.make_mad_engine(make_madnet2(fusion=True, seed=2), fusion=True,
                                          infer=infer.InferOptions(batch=2))
    rng = np.random.RandomState(3)
    reqs = [InferRequest(payload=i, inputs=(rng.rand(120, 250, 3).astype(np.float32) * 255,
                                            rng.rand(120, 250, 3).astype(np.float32) * 255,
                                            rng.rand(120, 250, 1).astype(np.float32) * -20))
            for i in range(4)]
    assert all(r.ok for r in engine.stream(iter(reqs)))
    s = engine.stats
    assert len(s.stage_ms) == len(s.batch_ms) == 2
    for stages in s.stage_ms:
        assert list(stages) == FUSION_STAGES + ["output"]
        assert all(ms >= 0 for ms in stages.values())

"""The MADNet2-family pieces of the benchmark on the CPU at a tiny size:
the cell ``madnet2-fusion.middlebury-f`` through ``drivers/mad_engine.py``
(``correct``, the end-to-end metrics, and the new per-layer metrics under
trace), the two controls of its comparison against the cell's limit, the
readers on an engine whose forward marks nothing, and the cross-attention's
count against a hand count."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import calibrate_mad, guided, harness, mad_readers, mad_serving, serving
from portbench.counts import fusion, peaks, xattn
from portbench.run import metrics_for

MAN = harness.manifest()
CELL = "madnet2-fusion.middlebury-f"
TINY = dict(sizes=[[250, 380], [256, 384]], pool_pairs=4, batch=2, disparity_px=[4, 32],
            reference_block_rows=16, check={"pairs": 2})
NEW = {"fusion_mfu.batch", "xattn_ms_per_pair.batch", "xattn_roofline.batch"}


def tiny_run(seed=2 ** 31 + 7, trace=False, seconds=1.0, **over):
    _, cell, _, config = harness.cell_files(MAN, CELL)
    return harness.Run(cell={**cell, **TINY, **over}, config=config, seconds=seconds, seed=seed,
                       trace=trace, device=torch.device("cpu"))


@pytest.fixture
def device_time(monkeypatch):
    """The CPU launch with a device time, as the card's CUDA events give
    one: full batches then enter ``batch_ms`` and, aligned, their stage
    marks ``stage_ms`` (host marks on the CPU)."""
    from raft_stereo_tpu_torch.runtime.infer import InferenceEngine

    real = InferenceEngine._launch

    def launch(self, *a, **kw):
        out = real(self, *a, **kw)
        out.ms = 1.0
        return out

    monkeypatch.setattr(InferenceEngine, "_launch", launch)


def test_rehearsal(run_driver):
    run = run_driver(tiny_run())
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert run.notes["engine"]["degraded"] == 0 and run.notes["engine"]["batch_caps"] == {}
    e2e = metrics_for(MAN, run, CELL)
    assert set(e2e) == {"pairs_per_s", "peak_mem_gib", "setup_s"}
    assert e2e["pairs_per_s"]["value"] > 0 and e2e["setup_s"]["value"] > 0


def test_traced_rehearsal_reads_the_new_layer_metrics(run_driver, device_time):
    run = run_driver(tiny_run(trace=True))
    assert run.correct and run.trace_summary is not None
    layer = metrics_for(MAN, run, CELL)
    wanted = {m["name"] for m in MAN["per_layer"] if CELL in m["workloads"]}
    assert NEW <= set(layer) == wanted
    assert all(v["value"] is not None and math.isfinite(v["value"]) for v in layer.values())
    assert 0 < layer["xattn_roofline.batch"]["value"] and 0 < layer["fusion_mfu.batch"]["value"]
    assert layer["pin_ms_per_pair.batch"]["value"] == 0.0  # no pinned copy on the CPU


def test_untraced_run_installs_no_sink(run_driver, device_time):
    """The sink, and so the stage marks, only under ``--trace 1``."""
    run = run_driver(tiny_run())
    assert run.sources["engine_stats"].stage_ms and not any(run.sources["engine_stats"].stage_ms)
    assert mad_readers.xattn_ms_per_pair(run) is None
    assert mad_readers.xattn_roofline(run) is None
    assert mad_readers.fusion_mfu(run) > 0


def _ratio(run, pool, idx, **precision):
    want = mad_serving.reference_outputs(run, pool, [idx])[idx]
    own = mad_serving.reference_outputs(run, pool, [idx], **mad_serving.configured(run))[idx]
    got = mad_serving.reference_outputs(run, pool, [idx], **precision)[idx]
    stat = mad_serving.STAT
    return (mad_serving.gap_stats(got, want)[stat] / mad_serving.gap_stats(own, want)[stat])


@pytest.mark.parametrize("control", sorted(mad_serving.CONTROLS))
@pytest.mark.parametrize("seed", [2 ** 31 + 9, 7])
def test_controls_are_not_correct(control, seed):
    """The reference one step below the stated precision (bf16
    convolutions, correlation and attention), and with each level's
    cross-attention bypassed, put in the program's place, read above the
    cell's limit."""
    run = tiny_run(seed=seed)
    pool = guided.guided_pool(run.cell, seed, "cpu")
    ratio = _ratio(run, pool, 0, **mad_serving.CONTROLS[control])
    assert ratio > run.cell["limits"][mad_serving.CHECK], ratio


def test_the_programs_bypassed_attention_is_not_correct(run_driver):
    """The program with its own cross-attention replaced by its input."""
    undo = calibrate_mad.bypassed_attention()
    try:
        run = run_driver(tiny_run())
    finally:
        undo()
    assert not run.correct
    assert run.checks[mad_serving.CHECK][0] > run.checks[mad_serving.CHECK][1]


def test_tf32_products_round_only_the_operands_of_the_products():
    """The TF32-products yardstick rounds the correlation's and the
    attention's operands, not their float32 results: it moves the
    reference, by less than bf16 products do."""
    run = tiny_run(seed=5)
    pool = guided.guided_pool(run.cell, 5, "cpu")
    want = mad_serving.reference_outputs(run, pool, [0])[0]
    tf32 = mad_serving.reference_outputs(run, pool, [0], **mad_serving.TF32_PRODUCTS)[0]
    bf16 = mad_serving.reference_outputs(run, pool, [0], corr="bf16", attn="bf16")[0]
    assert 0 < serving.mean_gap(tf32, want) < serving.mean_gap(bf16, want)


def test_the_guide_is_each_pairs_noisy_x_flow():
    run = tiny_run(seed=3)
    pool = guided.guided_pool(run.cell, 3, "cpu")
    disp = guided.disparities(run.cell, 3)
    assert sorted(disp) == sorted(int(round(d)) for d in
                                  torch.linspace(4, 32, 4).tolist())
    for (left, right, guide), d in zip(pool, disp):
        assert guide.shape == left.shape[:2] + (1,) and guide.dtype == left.dtype
        noise = guide[..., 0] + d
        assert abs(float(noise.mean())) < 0.05 and abs(float(noise.std()) - 1.0) < 0.05
        # the right view is the left shifted by the pair's disparity
        assert (right[:, : left.shape[1] - d] == left[:, d:]).all()


def test_counts_of_the_cross_attention_by_hand():
    """At a 256x384 input the levels are 64x96 .. 4x6: q k^T and the
    weighted sum, 2·5·W² a row each; the window, the guidance and the
    output once each in float32, and the parameters."""
    shapes = [(64, 96), (32, 48), (16, 24), (8, 12), (4, 6)]
    assert list(xattn.level_shapes(256, 384)) == shapes
    ops = sum(2 * (2 * 5 * w * w * h) for h, w in shapes)
    assert xattn.forward_flops(1, 256, 384) == ops
    assert xattn.forward_flops(3, 256, 384) == 3 * ops
    params = 2 * 10 + 15 * 5 + 15 + 5 * 5 + 5
    assert xattn.PARAMS == params
    h, w = shapes[0]
    assert xattn.call_bytes(2, h, w) == 4 * (3 * 2 * h * w * 5 + params)
    bound = max(xattn.call_flops(2, h, w) / peaks.FP32_FLOPS,
                xattn.call_bytes(2, h, w) / peaks.HBM_BYTES_PER_S)
    assert xattn.call_bound_s(2, h, w) == bound
    assert xattn.call_flops(2, h, w) / peaks.FP32_FLOPS > xattn.call_bytes(2, h, w) / peaks.HBM_BYTES_PER_S


def test_counts_of_the_forward_by_hand():
    """The Fusion forward's count less MADNet2's is the guidance encoder's
    convolutions and the cross-attention; the correlation is 2·D·W²·H a
    level."""
    h, w = 256, 384

    def conv(cin, cout, k, px):
        return 2 * cin * cout * k * k * px

    guide = (conv(1, 64, 3, 128 * 192) + conv(64, 64, 3, 128 * 192)
             + conv(64, 128, 3, 64 * 96) + conv(128, 128, 3, 64 * 96)
             + sum(conv(128, 5, 1, (64 >> i) * (96 >> i)) for i in range(5)))
    assert fusion.conv_flops(True, h, w) - fusion.conv_flops(False, h, w) == guide
    corr = sum(2 * d * (w >> k) ** 2 * (h >> k)
               for d, k in zip((32, 64, 96, 128, 192), (2, 3, 4, 5, 6)))
    assert fusion.corr_flops(h, w) == corr
    assert (fusion.forward_flops(True, h, w) - fusion.forward_flops(False, h, w)
            == guide + xattn.forward_flops(1, h, w))
    assert fusion.forward_flops(True, h, w, batch=2) == 2 * fusion.forward_flops(True, h, w)


def test_the_probe_tells_a_tf32_convolution_from_a_float32_one(monkeypatch):
    """``mad_serving.conv_precisions`` on the CPU, where every convolution
    runs in float32, one of them made to round its inputs and weights to
    TF32 as cuDNN's tensor cores do: that one alone is found TF32, and
    every convolution of the forward is read, under the names the
    reference's convolutions have."""
    import torch.nn.functional as F

    from portbench.reference import madnet2_fusion as mref

    run = tiny_run(seed=11)
    pool = guided.guided_pool(run.cell, run.seed, "cpu")
    model = mad_serving.build_model(run)
    engine = mad_serving.build_engine(model, run)
    conv = model.get_submodule("decoder2.decoder.0.0")

    def tf32(x):
        return F.conv2d(mref.round_tf32(x), mref.round_tf32(conv.weight), conv.bias, conv.stride,
                        conv.padding, conv.dilation, conv.groups)

    monkeypatch.setattr(conv, "forward", tf32)
    found = mad_serving.conv_precisions(engine, model, pool, engine.batch)
    with torch.device("meta"):
        names = {n for n, m in mref.MADNet2FusionReference().named_modules()
                 if isinstance(m, mref.Conv)}
    assert set(found) == names
    assert [n for n, t in found.items() if t] == ["decoder2.decoder.0.0"]
    assert mad_serving.tf32_convs(engine, model, pool, engine.batch) is None  # off the card


@pytest.mark.parametrize("stage_ms,pin_ms,device_ms,host_bound", [
    (181.7, 10.3, 26.55, True),   # one-thread np.pad + np.stack and a pinned copy
    (13.9, 0.0, 25.8, False),     # the engine's stager, page-locked
    (51.0, 0.0, 25.5, False),     # at the limit, not over it
])
def test_a_run_the_host_holds_back_ends_with_no_result(stage_ms, pin_ms, device_ms, host_bound):
    """``drivers/mad_engine.host_bound``: host ms a pair (stage and pin)
    over device ms a pair against the cell's ``max_host_to_device``."""
    from raft_stereo_tpu_torch.runtime.infer import InferStats

    driver = harness.load_file_module(harness.BENCH_DIR / "drivers" / "mad_engine.py",
                                      "portbench_mad_engine_gate")
    limit = float(harness.cell_files(MAN, CELL)[1]["max_host_to_device"])
    assert limit == 2.0
    pairs, batch = 400, 4
    stats = InferStats(images=pairs, h2d_stage_s=stage_ms * pairs / 1e3,
                       pin_s=pin_ms * pairs / 1e3,
                       batch_ms=[device_ms * batch] * (pairs // batch),
                       batch_valid=[batch] * (pairs // batch))
    why = driver.host_bound(stats, limit)
    assert (why is not None) == host_bound, why
    assert driver.host_bound(InferStats(images=pairs, h2d_stage_s=1.0), limit) is None

"""Closed-loop evaluation of MADNet2Fusion through the engine
``evaluate_mad --fusion`` serves on (``evaluate_mad.make_mad_engine`` →
``InferenceEngine.stream``, buckets at /128, the x4 upsampling inside the
captured forward), the guidance as the third input slot.

As ``drivers/engine.py``: the request source yields pool entries in the
seed's order until ``--seconds`` have passed, ending on a whole
micro-batch; ``pairs_per_s`` is every pair served over the time from the
window's start to the last result. Under ``--trace 1`` the program's
telemetry sink is installed before the warm-up, so the captured forward
records its stage marks (``InferStats.stage_ms``).

The cell measures the card. A run on the card whose host work a pair (the
stager's pad and the consumer's pinned copy, ``InferStats.h2d_stage_s`` +
``pin_s``) exceeds the cell's ``max_host_to_device`` times the device time
a pair (``InferStats.batch_ms``) served at the host's rate, not the card's:
it ends with no result (exit 3) before the comparison, rather than report
a rate of ``np.pad``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from portbench import guided, harness, mad_serving, serving, traffic


def _sink(run: harness.Run):
    from raft_stereo_tpu_torch.runtime import telemetry

    path = harness.ROOT / "build" / "portbench" / "telemetry" / f"mad-{run.seed}-{os.getpid()}"
    return telemetry.install(telemetry.Telemetry(str(path)))


def host_bound(stats, limit: float) -> Optional[str]:
    """Why the window's rate was the host's, or None: the host ms a served
    pair over the device ms a pair of the full batches, against ``limit``.
    None where no batch has a device time (no CUDA events)."""
    if not stats.batch_ms or not sum(stats.batch_valid) or not stats.images:
        return None
    device = sum(stats.batch_ms) / sum(stats.batch_valid)
    host = (stats.h2d_stage_s + stats.pin_s) / stats.images * 1e3
    if host <= limit * device:
        return None
    return (f"the host held the card back: {host:.2f} host ms a pair (stage and pin) against "
            f"{device:.2f} device ms, over {limit:g} times; the cell measures the card")


def run(run: harness.Run, clock: harness.SetupClock) -> None:
    from raft_stereo_tpu_torch.runtime import telemetry

    cell = run.cell
    cuda = run.device.type == "cuda"
    pool = guided.guided_pool(cell, run.seed, run.device)
    clock.mark("inputs")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = mad_serving.build_model(run)
    clock.mark("weights")
    tel = _sink(run) if run.trace else None
    try:
        engine = mad_serving.build_engine(model, run)
        batch = engine.batch
        mad_serving.warm_up(engine.stream, pool, batch, engine.divis_by)
        clock.mark("warm_up")
        from raft_stereo_tpu_torch.runtime.infer import InferRequest, InferStats

        engine.stats = InferStats()
        run.setup_s = clock.stop()

        sampler = serving.Sampler(cell["check"]["pairs"], len(pool), run.seed)
        failed = ok = 0
        t_last = 0.0
        picks = traffic.order(len(pool), run.seed)
        sent = {}

        def source(t0):
            k = 0
            while not (k % batch == 0 and time.perf_counter() - t0 >= run.window_seconds):
                idx = next(picks)
                sent[k] = idx
                yield InferRequest(payload=k, inputs=pool[idx])
                k += 1

        with harness.traced(run):
            t0 = time.perf_counter()
            for res in engine.stream(source(t0)):
                t_last = time.perf_counter()
                if res.ok:
                    ok += 1
                    sampler.offer(sent[res.payload], res.output[:, :, 0])
                else:
                    failed += 1
    finally:
        telemetry.uninstall(tel)
    run.attempted, run.failed = len(sent), failed
    why = host_bound(engine.stats, float(cell["max_host_to_device"])) if cuda else None
    if why is not None:
        raise harness.NoResult(why)
    rate = ok / (t_last - t0)
    run.end_to_end["pairs_per_s"] = rate
    run.memory_peak_bytes = harness.read_peak(run.device) if cuda else 0
    run.end_to_end["peak_mem_gib"] = run.memory_peak_bytes / 2 ** 30
    run.sources.update(engine_stats=engine.stats, batch=batch, pairs_per_s=rate)
    run.notes["engine"] = {"pairs": ok, "failed": failed,
                           "batch_caps": {str(k): v for k, v in engine._bucket_cap.items()},
                           "degraded": engine.stats.degraded}
    run.notes["tf32_convs"] = mad_serving.tf32_convs(engine, model, pool, batch)
    del engine, model
    serving.free()
    mad_serving.check_outputs(run, pool, sampler.items)

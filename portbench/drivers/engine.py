"""Closed-loop evaluation through the validators' engine
(``evaluate.make_engine`` → ``InferenceEngine.stream``), the path
``evaluate.py`` serves its datasets on.

The request source yields pairs of the cell's pool in the seed's order
until ``--seconds`` have passed, ending on a whole micro-batch; the
engine's stager pulls ahead of the card (``prefetch`` batches), so work is
dispatched ahead and no request waits on a client. The rate,
``pairs_per_s``, is every pair served over the time from the window's
start to the last result.
"""

from __future__ import annotations

import time

import torch

from portbench import harness, serving, traffic


def run(run: harness.Run, clock: harness.SetupClock) -> None:
    cell = run.cell
    cuda = run.device.type == "cuda"
    pool = traffic.image_pool(cell, run.seed, run.device)
    clock.mark("inputs")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = serving.build_model(run)
    clock.mark("weights")
    engine = serving.build_engine(model, run)
    batch = engine.batch
    serving.warm_up(engine.stream, pool, batch)
    clock.mark("warm_up")
    from raft_stereo_tpu_torch.runtime.infer import InferRequest, InferStats

    engine.stats = InferStats()
    run.setup_s = clock.stop()

    sampler = serving.Sampler(cell["check"]["pairs"], len(pool), run.seed)
    ok = failed = 0
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
    run.attempted, run.failed = len(sent), failed
    rate = ok / (t_last - t0)
    run.end_to_end["pairs_per_s"] = rate
    run.memory_peak_bytes = harness.read_peak(run.device) if cuda else 0
    run.end_to_end["peak_mem_gib"] = run.memory_peak_bytes / 2 ** 30
    run.sources.update(engine_stats=engine.stats, batch=batch, pairs_per_s=rate)
    run.notes["engine"] = {"pairs": ok, "failed": failed,
                           "batch_caps": {str(k): v for k, v in engine._bucket_cap.items()},
                           "degraded": engine.stats.degraded}
    del engine, model
    serving.free()
    serving.check_outputs(run, pool, sampler.items)

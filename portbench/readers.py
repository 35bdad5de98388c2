"""What the per-layer metrics read, shared by the readers in
``metrics/<metric>.py`` (one file a metric, found by its name): each
function takes a finished :class:`harness.Run` and returns the metric, or
None where the run holds nothing to read (never 0 for a share of a peak)."""

from __future__ import annotations

from portbench import harness
from portbench.counts import flops, k1, peaks
from portbench.serving import model_dims

K1_KERNEL = "alt_corr_kernel"


def _engine(run):
    return run.sources.get("engine_stats")


def stage_ms_per_pair(run):
    """The engine's host stager, ms a served pair: the pad and stack of
    each micro-batch (``InferStats.h2d_stage_s``, host clock)."""
    stats = _engine(run)
    return None if stats is None or not stats.images else stats.h2d_stage_s / stats.images * 1e3


def device_ms_per_pair(run):
    """Device ms a served pair, from the engine's CUDA events around each
    full batch (``InferStats.batch_ms``: input copy, the captured forward
    and the output copy) over the pairs those batches held."""
    stats = _engine(run)
    if stats is None or not stats.batch_ms or not sum(stats.batch_valid):
        return None
    return sum(stats.batch_ms) / sum(stats.batch_valid)


def forward_mfu(run):
    """The whole forward's share of the bf16 dense peak, %: the benchmark's
    count of a test-mode forward at each served bucket times the pairs
    served a second."""
    stats, rate = _engine(run), run.sources.get("pairs_per_s")
    if stats is None or not rate or not stats.buckets:
        return None
    served = sum(stats.buckets.values())
    per_pair = sum(n * flops.forward_flops(model_dims(run), run.cell["corr_implementation"],
                                           int(run.cell["iters"]), h, w)
                   for (h, w), n in stats.buckets.items()) / served
    return 100.0 * per_pair * rate / peaks.BF16_FLOPS


def k1_roofline(run):
    """K1's share of its roofline, %: the least time the card could take
    for the traced K1 launches (``counts/k1.py``, each launch reading
    [batch, H/f, W/f, D] features of the one served bucket) over their
    device time in the trace."""
    seen, stats = harness.device_seconds(run, K1_KERNEL), _engine(run)
    if seen is None or stats is None or len(stats.buckets) != 1:
        return None
    launches, seconds = seen
    (h, w), = stats.buckets
    dims = run.config["model"]
    f = 2 ** int(dims["n_downsample"])
    bound = k1.call_bound_s(int(run.sources["batch"]), h // f, w // f, int(dims["fnet_dim"]),
                            int(dims["corr_levels"]), int(dims["corr_radius"]))
    return 100.0 * launches * bound / seconds


def device_idle_pct(run):
    """The share of the traced window with no kernel, copy or set running
    on the card (``torch.profiler``'s device activity), %."""
    t = run.trace_summary
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


"""What the MADNet2Fusion per-layer metrics read (one file a metric in
``metrics/``, as ``readers.py``'s): each function takes a finished
:class:`harness.Run` and returns the metric, or None where the run holds
nothing to read (an engine whose forward marks no cross-attention stage
reads None, never 0)."""

from __future__ import annotations

from portbench.counts import fusion, xattn

XATTN_STAGE = "xattn"


def _engine(run):
    return run.sources.get("engine_stats")


def fusion_mfu(run):
    """The forward's share of the dense TF32 peak, %: ``counts/fusion.py``'s
    count of a forward at each served bucket times the pairs served a
    second."""
    stats, rate = _engine(run), run.sources.get("pairs_per_s")
    if stats is None or not rate or not stats.buckets:
        return None
    served = sum(stats.buckets.values())
    per_pair = sum(n * fusion.forward_flops(True, h, w)
                   for (h, w), n in stats.buckets.items()) / served
    return 100.0 * per_pair * rate / fusion.TF32_FLOPS


def _xattn_batches(run):
    """(valid pairs, cross-attention ms) of each full batch whose forward
    marked its five cross-attention stages."""
    stats = _engine(run)
    if stats is None:
        return []
    out = []
    for stages, valid in zip(getattr(stats, "stage_ms", []), stats.batch_valid):
        ms = [v for k, v in stages.items() if k.startswith(XATTN_STAGE)]
        if len(ms) == len(xattn.LEVELS):
            out.append((valid, sum(ms)))
    return out


def xattn_ms_per_pair(run):
    """Device ms a served pair between the cross-attention's marks
    (``xattn2`` .. ``xattn6``, each from the end of its level's
    correlation), over the batches whose forward marked them."""
    got = _xattn_batches(run)
    pairs = sum(v for v, _ in got)
    return None if not pairs else sum(ms for _, ms in got) / pairs


def xattn_roofline(run):
    """The cross-attention's share of its roofline, %: the least time the
    card could take for the five layers of a batch (``counts/xattn.py``, at
    the one served bucket and the engine's batch) over their marked device
    time."""
    got, stats = _xattn_batches(run), _engine(run)
    if not got or len(stats.buckets) != 1:
        return None
    (h, w), = stats.buckets
    bound = xattn.forward_bound_s(int(run.sources["batch"]), h, w)
    return 100.0 * len(got) * bound / (sum(ms for _, ms in got) / 1e3)

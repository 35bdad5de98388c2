"""pin_ms_per_pair.batch: the engine's copy of each batch's host inputs
into pinned memory, on the consumer thread before the dispatch, in ms a
served pair (``InferStats.pin_s``, host clock). None where the engine has
no such counter or served nothing."""


def read(run):
    stats = run.sources.get("engine_stats")
    pin_s = getattr(stats, "pin_s", None)
    if pin_s is None or not stats.images:
        return None
    return pin_s / stats.images * 1e3

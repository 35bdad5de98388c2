"""Engine pairs/s of the ``engine_path_realtime_packed`` cell with and without
a telemetry sink, and against another checkout's engine, to read what the
engine's telemetry costs.

    git archive <commit> | tar -x -C build/parent
    python3 tools/engine_overhead.py --compare build/parent

The cell: the raftstereo-realtime preset with the packed encoder stage (bf16,
7 iterations, seeded random weights), the batched engine at batch 4 with
each (bucket, batch) captured as a CUDA graph, over the 9 pairs of
``chip_smoke.py``'s engine phases (6 at 540x960, 3 at 480x640, decoded from
its seeded PNGs), in memory. A timed stream is those pairs ``--repeat``
times over (270 pairs by default), so the stream's start and end are a small
part of it.

Everything runs in one process, in turns, because the host's speed drifts
between processes by more than the effect (a stream's rate spans 100-200
pairs/s across processes on one machine): this engine with no sink
(``none``), the same engine with a sink installed (``sink``) and, with
``--compare``, the other checkout's engine (``other``: its
``runtime/infer.py`` loaded as a module of its own), all on this checkout's
model and kernels and on the same pairs. So ``--compare`` measures the
engine module alone; it suits a parent whose model and kernels on this
path equal this checkout's. Each round runs other, none, sink, sink, none,
other; the line printed holds every stream's pairs/s, medians and
quartiles, and each round's ratios none/other and sink/none, then the
card's name and power limit as nvidia-smi gives them. ``stream_rates``
is also what ``chip_smoke.py``'s ``telemetry_cost`` phase calls. Needs a
CUDA card; prints no result without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BATCH, ITERS, SEED = 4, 7, 0
STREAM_REPEAT = 30
ROUND = ("other", "none", "sink", "sink", "none", "other")


def cell_pairs(tmp: Path):
    """The cell's 9 pairs, as ``chip_smoke.py`` makes and decodes them."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke._engine_pairs(tmp)


def stream_rates(runs: dict, order, rounds: int, sink_dir: str) -> dict:
    """``{name: [pairs/s of each stream]}``. ``runs`` maps a name to
    ``(engine, requests, sink)``: a stream pushes ``requests`` through
    ``engine`` (captured already), with a telemetry sink installed when
    ``sink``. Streams run in ``order``, ``rounds`` times. Raises if a
    request fails."""
    import torch

    from raft_stereo_tpu_torch.runtime import telemetry

    rates = {name: [] for name in order}
    for _ in range(rounds):
        for name in order:
            engine, requests, sink = runs[name]
            tel = telemetry.install(telemetry.Telemetry(sink_dir)) if sink else None
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = sum(r.ok for r in engine.stream(iter(requests)))
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                if tel is not None:
                    telemetry.uninstall(tel)
            if n != len(requests):
                raise AssertionError(f"{name}: {len(requests) - n} request(s) failed")
            rates[name].append(n / dt)
    return rates


def spread(values) -> dict:
    """Median and quartiles of a list of numbers."""
    q = statistics.quantiles(values, n=4) if len(values) > 1 else [values[0]] * 3
    return {"median": statistics.median(values), "q1": q[0], "q3": q[2], "n": len(values)}


def _round_ratios(rates: dict, num: str, den: str, per_round: int) -> list:
    """Each round's mean rate of ``num`` over that of ``den``."""
    a, b = rates[num], rates[den]
    return [statistics.fmean(a[i:i + per_round]) / statistics.fmean(b[i:i + per_round])
            for i in range(0, len(a), per_round)]


def _load_engine_module(root: Path):
    """``root``'s ``runtime/infer.py`` as a module of its own name; its
    imports resolve to this checkout's package."""
    spec = importlib.util.spec_from_file_location(
        "other_infer", root / "raft_stereo_tpu_torch" / "runtime" / "infer.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", default=None, metavar="OTHER_ROOT",
                    help="also time OTHER_ROOT's engine, in turns with this one's")
    ap.add_argument("--rounds", type=int, default=8, help="rounds of the turns")
    ap.add_argument("--repeat", type=int, default=STREAM_REPEAT,
                    help="times the 9 pairs repeat in one stream")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("engine_overhead: no CUDA device")
    from raft_stereo_tpu_torch.config import PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model, make_engine
    from raft_stereo_tpu_torch.models import extractor
    from raft_stereo_tpu_torch.runtime import infer

    extractor._ENABLE_PACKED = True
    model = load_model(PRESETS["raftstereo-realtime"], seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        pairs = cell_pairs(Path(tmp))
        engine = make_engine(model, ITERS, infer.InferOptions(batch=BATCH))
        requests = [infer.InferRequest(payload=k, inputs=p)
                    for k, p in enumerate(pairs * args.repeat)]
        runs = {"none": (engine, requests, False), "sink": (engine, requests, True)}
        if args.compare is not None:
            other = _load_engine_module(Path(args.compare).resolve())
            opts = other.InferOptions(batch=BATCH)
            other_engine = other.InferenceEngine(
                lambda a, b: model(a, b, iters=ITERS)[1], device="cuda", batch=BATCH,
                prefetch_depth=opts.prefetch, max_executables=opts.max_executables,
                deadline_s=opts.deadline_s, graph_key=(id(model), repr(model.config), ITERS))
            runs["other"] = (other_engine, [other.InferRequest(payload=k, inputs=p)
                                            for k, p in enumerate(pairs * args.repeat)], False)
        order = ROUND if args.compare is not None else ROUND[1:-1]
        for eng, reqs, _ in {id(r[0]): r for r in runs.values()}.values():
            list(eng.stream(iter(reqs[:len(pairs)])))  # captures both buckets
        rates = stream_rates(runs, order, args.rounds, tmp)
    out = {"pairs_a_stream": len(requests), "rounds": args.rounds, "order": list(order),
           "pairs_per_s": rates, "spread": {m: spread(v) for m, v in rates.items()},
           "round_ratio": {"sink/none": spread(_round_ratios(rates, "sink", "none", 2))}}
    if args.compare is not None:
        out["round_ratio"]["none/other"] = spread(_round_ratios(rates, "none", "other", 2))
        out["other_root"] = str(Path(args.compare).resolve())
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

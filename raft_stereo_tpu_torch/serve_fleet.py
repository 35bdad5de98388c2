"""Replica-fleet serving entry point (PyTorch port of
``raft_stereo_tpu/serve_fleet.py``).

Serves a stream of stereo pairs through N single-host engine worker
processes behind one health-checked ``FleetRouter`` (``runtime/fleet.py``:
the routing, circuit-breaker and exactly-once failover contracts):

    python -m raft_stereo_tpu_torch.serve_fleet \\
        --name serve-fleet --n_hosts 2 --source synthetic \\
        --num_requests 64 --infer_batch 2

Every worker builds its engine on the CUDA card (several workers share
one card), each capturing its own graphs; the router process holds no
model and never initialises CUDA. The workers share one ``--aot_dir``
(the graph store, ``runtime/aot_store.py``): a key one worker captured is
captured by every worker of a later fleet while its engine is built,
before the worker reports healthy.

Sources:

  * ``--source synthetic`` streams self-contained synthetic stereo frames
    (the ``serve_adaptive`` generator: a real matching signal, no dataset
    on disk).
  * ``--source video`` streams ``--video_sessions`` temporally coherent
    session-tagged streams; the router pins each session to one replica
    (cross-host affinity) and a replica loss migrates its sessions with
    the typed cold-start reset on the new host.

``--model toy`` swaps the MADNet2 forward for a tiny arithmetic engine
(``(a * 2 - b)`` summed over channels): zero weights, fast start-up, the
same router, worker and wire path. MADNet2's weights are made from seed
0 in every worker, as the JAX factory's ``PRNGKey(0)``, or read from
``--restore_ckpt``; ``--seed`` seeds the request stream only.

Telemetry is on by default (``runs/<name>/``): the router's
``fleet_route`` / ``fleet_host_down`` / ``fleet_failover`` /
``fleet_circuit_open`` / ``fleet_drain`` events land in the front-end
log, each worker's single-host event set under
``runs/<name>/fleet/host<i>/``. The last line on stdout is one JSON
summary: the router's snapshot, the counts served and failed, and the
serve's wall seconds and pairs/s (workers already up).

**Signal contract**: the first SIGTERM/SIGINT begins a fleet-wide
graceful drain — admission stops, every worker drains its own scheduler,
requests the bound cuts off resolve as typed ``drained`` error results,
never silent drops — and the process exits 0 within ``--drain_timeout``.
A second signal is immediate. ``--rolling_restart_after K`` exercises the
zero-downtime path live: after K results, every host is drained and
respawned one at a time while the stream keeps serving on the N-1
survivors.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from typing import Iterator

from raft_stereo_tpu_torch.runtime import infer as infer_mod
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.runtime.fleet import FleetRouter
from raft_stereo_tpu_torch.runtime.infer import InferRequest, add_infer_args

logger = logging.getLogger(__name__)

FACTORY = "raft_stereo_tpu_torch.serve_fleet:build_engine"

# ------------------------------------------------- worker engine factory


def _device(kw):
    """``factory_kw["device"]``, the CUDA card by default; asking for a
    card that is not there raises (no fallback to the CPU)."""
    import torch

    dev = torch.device(kw.get("device") or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the fleet worker was asked for the card; pass "
                           "device='cpu' in factory_kw to serve on the CPU explicitly")
    return dev


def build_engine(kw):
    """Worker-side engine factory, imported over the spawn boundary as
    ``"raft_stereo_tpu_torch.serve_fleet:build_engine"``: each replica
    process calls it once with the router's ``factory_kw``.

    Both variants finalise eagerly and disable the stager-idle watchdog:
    a replica's feed is a long-lived server socket, where an empty queue
    means "no clients right now"; liveness is the router's health poll,
    and every device wait keeps its deadline.
    """
    from raft_stereo_tpu_torch.runtime.infer import InferenceEngine

    dev = _device(kw)
    if kw.get("model") == "toy":
        if kw.get("warm"):
            # the SessionServer always appends its warm slot
            def fn(a, b, warm):
                return (a * 2.0 - b).sum(-1, keepdim=True)
        else:
            def fn(a, b):
                return (a * 2.0 - b).sum(-1, keepdim=True)
        return InferenceEngine(
            fn, device=dev, batch=int(kw.get("batch", 2)), divis_by=32,
            deadline_s=float(kw.get("infer_timeout", 30.0)),
            retries=int(kw.get("retries", 1)),
            eager_finalize=True, idle_watchdog=False,
            aot_dir=kw.get("aot_dir"),
        )

    import torch

    from raft_stereo_tpu_torch.evaluate_mad import load_mad_weights, make_mad_engine
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.runtime.infer import InferOptions

    # every replica must pick the same cuDNN algorithms as a single host
    # for its outputs to be bitwise one host's: heuristics, never timing
    torch.backends.cudnn.benchmark = False
    # seed 0, as the JAX factory's PRNGKey(0): --seed seeds the stream only
    model = make_madnet2(mixed_precision=bool(kw.get("mixed_precision")), seed=0, device=dev)
    if kw.get("restore_ckpt"):
        load_mad_weights(model, str(kw["restore_ckpt"]))  # a .pth or a port checkpoint
    engine = make_mad_engine(
        model, fusion=False,
        infer=InferOptions(
            batch=int(kw.get("batch", 2)),
            deadline_s=float(kw.get("infer_timeout", 300.0)),
            retries=int(kw.get("retries", 2)),
            aot_dir=kw.get("aot_dir"),
        ),
    )
    engine.eager_finalize = True
    engine.idle_watchdog = False
    return engine


# -------------------------------------------------------- request stream


def request_stream(args) -> Iterator[InferRequest]:
    """``--num_requests`` requests from the configured source; video
    requests carry session tags so the router's affinity map engages."""
    import numpy as np

    from raft_stereo_tpu_torch.serve_adaptive import synthetic_frame, synthetic_video_frame

    h, w = args.synthetic_size
    n_sessions = max(int(args.video_sessions), 1)
    for i in range(args.num_requests):
        if args.source == "video":
            pair = synthetic_video_frame(
                args.seed + (i % n_sessions), 0.08 * (i // n_sessions), h, w)
        else:
            pair = synthetic_frame(args.seed + i, h, w)
        req = InferRequest(payload=i, inputs=tuple(np.asarray(x, np.float32) for x in pair))
        if args.source == "video":
            from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

            yield SchedRequest(req, session=f"video{i % n_sessions}")
        else:
            yield req
        if args.pace_s:
            time.sleep(args.pace_s)


# ------------------------------------------------------------------ entry


def _cuda_initialized() -> bool:
    """Whether this process (the router) holds a CUDA context; it should
    not, since the model lives in the workers."""
    import sys

    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve stereo pairs through a health-checked replica fleet with "
        "exactly-once failover.")
    parser.add_argument("--name", default="serve-fleet")
    parser.add_argument("--n_hosts", type=int, default=2,
                        help="replica worker processes behind the router")
    parser.add_argument("--model", default="madnet2", choices=["madnet2", "toy"],
                        help="worker engine: the MADNet2 serving forward, or the toy "
                        "arithmetic engine (CPU smokes: same router/worker/wire path)")
    parser.add_argument("--restore_ckpt", default=None,
                        help="a reference .pth or a port checkpoint (every replica restores "
                        "the same weights)")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--source", default="synthetic", choices=["synthetic", "video"],
                        help="independent synthetic frames, or --video_sessions "
                        "session-tagged coherent streams (cross-host session affinity)")
    parser.add_argument("--video_sessions", type=int, default=2,
                        help="parallel video streams of --source video; request i is frame "
                        "i//S of stream i%%S")
    parser.add_argument("--synthetic_size", type=int, nargs=2, default=[128, 256],
                        metavar=("H", "W"))
    parser.add_argument("--num_requests", type=int, default=64)
    parser.add_argument("--pace_s", type=float, default=0.0,
                        help="sleep between source requests (a paced open-loop client; "
                        "0 = flood)")
    parser.add_argument("--rolling_restart_after", type=int, default=0,
                        help="after K results, rolling-restart every host one at a time "
                        "mid-stream (capacity >= N-1, zero failed requests; 0 = off)")
    # router health/failover knobs (runtime/fleet.py defaults suit a real
    # deployment; the smokes tighten them)
    parser.add_argument("--poll_interval", type=float, default=0.25,
                        help="seconds between /healthz + /debug/queues polls of each host")
    parser.add_argument("--fail_threshold", type=int, default=3,
                        help="consecutive health failures that open a host's circuit")
    parser.add_argument("--down_after", type=float, default=2.5,
                        help="seconds of continuous health failure before a host is "
                        "declared down (in-flight fails over)")
    parser.add_argument("--max_failovers", type=int, default=2,
                        help="re-dispatch attempts per request before it resolves as a "
                        "typed FleetHostError")
    add_infer_args(parser, default_batch=2)
    return parser


def refuse(args) -> None:
    """The JAX CLI's refusals, and a spatial tier the workers do not have."""
    for flag, val in (("--cascade", args.cascade),
                      ("--adaptive_iters", args.adaptive_iters),
                      ("--tier", args.tier)):
        if val:
            raise SystemExit(
                f"serve_fleet replicates ONE single-host serving configuration across "
                f"hosts — {flag} composes inside a worker, not across the fleet")
    if args.spatial_threshold is not None:
        raise SystemExit("serve_fleet's workers serve MADNet2 (no spatial tier): "
                         "--spatial_threshold is a RAFT-Stereo serving knob (evaluate builds "
                         "the pixel-routed spatial tier)")


def main(argv=None, device=None):
    """Serve; returns the summary (also printed as the last stdout line).
    ``device`` is the workers' (the CUDA card when None); the router
    itself never touches it."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    refuse(args)
    if args.telemetry_dir is None:
        args.telemetry_dir = f"runs/{args.name}"
    # SIGUSR2 blackbox dump + optional --debug_port, installed before
    # anything slow; the model lives in the workers
    end_introspection = infer_mod.install_cli_introspection(args)
    tel = telemetry.install(telemetry.Telemetry(args.telemetry_dir))
    if args.slo_p95_ms:
        tel.configure_slo(args.slo_p95_ms, args.slo_budget)

    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain

    factory_kw = {
        "model": args.model,
        "device": str(device) if device is not None else "cuda",
        "batch": args.infer_batch,
        "infer_timeout": args.infer_timeout,
        "retries": args.infer_retries,
        "mixed_precision": args.mixed_precision,
        "restore_ckpt": args.restore_ckpt,
        "aot_dir": args.aot_dir,
    }
    # Worker-side SessionServer (warm slots + the typed cold-start reset
    # on migration) needs a warm-aware forward: the toy engine has one;
    # the MADNet2 forward has no warm input, so its session affinity is
    # router-level only (requests still pin to a host by session tag).
    sessions = args.model == "toy" and args.source == "video"
    if sessions:
        factory_kw["warm"] = True
    router = FleetRouter(
        FACTORY, args.n_hosts,
        factory_kw=factory_kw,
        workdir=f"{args.telemetry_dir}/fleet",
        max_wait_s=args.sched_max_wait,
        max_pending=args.max_pending,
        drain_timeout=args.drain_timeout,
        sessions=sessions,
        poll_interval_s=args.poll_interval,
        fail_threshold=args.fail_threshold,
        down_after_s=args.down_after,
        max_failovers=args.max_failovers,
    )
    served = failed = 0
    restarter = None
    try:
        router.start()
        t0 = time.monotonic()
        with GracefulShutdown() as shutdown:
            drain = ServeDrain(shutdown, timeout_s=args.drain_timeout, label="serve_fleet")
            drain.attach(router)
            telemetry.emit(
                "run_start", name=args.name, mode="serve_fleet",
                num_hosts=args.n_hosts, num_requests=args.num_requests,
            )
            for res in router.serve(drain.wrap_source(request_stream(args))):
                drain.note_result(res)
                served += 1
                if not res.ok:
                    failed += 1
                    logger.warning("request %s failed (%s): isolated, the stream continues",
                                   res.payload, res.error)
                if (args.rolling_restart_after
                        and served == args.rolling_restart_after
                        and restarter is None):
                    restarter = threading.Thread(
                        target=router.rolling_restart, name="fleet-restarter", daemon=True)
                    restarter.start()
            wall = time.monotonic() - t0
            if restarter is not None:
                restarter.join(timeout=120.0)
            drain.finish()
            telemetry.emit("run_end", outcome="completed", served=served, failed=failed,
                           wall_s=round(wall, 3))
            summary = dict(router.summary(), served=served, failed=failed, wall_s=wall,
                           pairs_per_s=served / wall if wall > 0 else None,
                           router_cuda_initialized=_cuda_initialized())
            print(json.dumps({"serve_fleet": summary}), flush=True)
            max_frac = args.max_failed_frac
            if served and max_frac is not None and failed > max_frac * served:
                raise SystemExit(
                    f"serve_fleet: {failed}/{served} requests failed — over the "
                    f"--max_failed_frac {max_frac:g} budget")
            return summary
    finally:
        router.close()
        end_introspection()
        if tel is not None:
            telemetry.uninstall(tel)


if __name__ == "__main__":
    main()

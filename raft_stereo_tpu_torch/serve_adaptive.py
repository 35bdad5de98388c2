"""Long-running adaptive serving: MADNet2 served through the captured
engine while it adapts online on the frames it serves (PyTorch port of
``raft_stereo_tpu/serve_adaptive.py``; the orchestration and its rails are
``runtime/adapt.py``'s).

    python -m raft_stereo_tpu_torch.serve_adaptive --source synthetic \\
        --adapt_mode mad --adapt_every 4 --infer_batch 2

Sources: ``dataset`` streams ``--train_datasets`` frames in order,
unaugmented, wrapping around; ``synthetic`` streams self-contained stereo
frames with a real matching signal (a textured right image, a smooth
disparity field, the left rendered by a bilinear warp); ``video`` streams
``--video_sessions`` temporally coherent synthetic videos, session-tagged.
``--domain_shift GAMMA:GAIN:OFFSET`` shifts both images of every frame
photometrically, an unseen domain for adaptation to close.

Telemetry is on (``runs/<name>/``): the ``adapt_*`` events, the engine's
events and a heartbeat with the adaptation's health; the last stdout line
is ``{"serve_adaptive": summary}``. The first SIGTERM/SIGINT drains:
admission stops, in-flight batches complete, no further adaptation runs,
and the run exits 0 within ``--drain_timeout``; a second is immediate.

The served module and the adapting one are separate: steps that pass the
rails reach the captured graphs through ``update_variables`` between
chunks. ``--cascade`` serves the adapted MADNet2 as the fast tier of a
``CascadeServer`` whose quality tier is a frozen default RAFT-Stereo at
``--quality_iters`` (``--quality_ckpt``); ``--controller`` arms the
overload controller over the cascade bar, the adaptation cadence and the
admission cap, with ``--slo_p95_ms``/``--slo_budget`` its burn sensor;
``--debug_port`` serves the introspection endpoints. Flags of serving
layers the port does not have yet are refused, each naming its ROADMAP
item; ``--spatial_threshold`` is refused as the JAX CLI refuses it (MADNet2
has no spatial tier). Everything runs on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
from typing import TYPE_CHECKING, Iterator, Optional, Tuple

import numpy as np

from raft_stereo_tpu_torch.runtime import infer as infer_mod
from raft_stereo_tpu_torch.runtime import quality, telemetry
from raft_stereo_tpu_torch.runtime.adapt import AdaptConfig, AdaptiveServer, AdaptPolicy
from raft_stereo_tpu_torch.runtime.infer import (
    InferOptions,
    InferRequest,
    add_infer_args,
    options_from_args,
)

logger = logging.getLogger(__name__)

if TYPE_CHECKING:
    from raft_stereo_tpu_torch.runtime.tiers import CascadeServer

# The last run's server (its engine, adaptation history and step times)
# and, under ``--cascade``, the cascade it serves through (its ``tiers``),
# for the caller of ``main``.
_last_server: Optional[AdaptiveServer] = None
_last_cascade: Optional["CascadeServer"] = None


def last_server() -> Optional[AdaptiveServer]:
    return _last_server


def last_cascade() -> Optional["CascadeServer"]:
    return _last_cascade


# ------------------------------------------------------- synthetic source


def _smooth(r, h, w, passes=2, width=7):
    x = r.rand(h, w, 3).astype(np.float32)
    for _ in range(passes):
        k = np.ones(width, np.float32) / width
        x = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 0, x)
        x = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 1, x)
    return x


def synthetic_frame(seed: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic stereo pair with a real matching signal: frame t = 0
    of ``synthetic_video_frame``."""
    return synthetic_video_frame(seed, 0.0, h, w)


def synthetic_video_frame(seed: int, t: float, h: int, w: int,
                          return_disp: bool = False, scale: float = 1.0):
    """Frame ``t`` of a synthetic stereo video: the seed fixes the scene
    (texture and disparity field), ``t`` moves the disparity's phases
    smoothly. The left image is the right one warped by the disparity,
    left(x) = right(x − d); ``return_disp`` adds that disparity, ``scale``
    multiplies it."""
    r = np.random.RandomState(seed)
    right = (255.0 * (0.6 * _smooth(r, h, w) + 0.4 * r.rand(h, w, 3))).astype(np.float32)
    d0 = r.uniform(5.0, 9.0)
    amp = r.uniform(1.5, 3.5)
    ph1, ph2 = r.uniform(0, 2 * np.pi, 2)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    disp = scale * (d0 + amp * np.sin(2 * np.pi * xx / w + ph1 + t)
                    * np.sin(2 * np.pi * yy / h + ph2 + 0.5 * t))
    xi = np.clip(xx.astype(np.float32) - disp.astype(np.float32), 0, w - 1)
    i0 = np.floor(xi).astype(np.int64)
    i1 = np.minimum(i0 + 1, w - 1)
    wgt = (xi - i0)[..., None]
    rows = np.arange(h)[:, None]
    left = right[rows, i0] * (1 - wgt) + right[rows, i1] * wgt
    if return_disp:
        return left.astype(np.float32), right, disp.astype(np.float32)
    return left.astype(np.float32), right


def photometric_shift(img: np.ndarray, gamma: float, gain: float, offset: float) -> np.ndarray:
    """out = 255·(in/255)^gamma·gain + offset, applied to both images (so
    the self-supervised objective stays well posed)."""
    return (255.0 * (img / 255.0) ** gamma * gain + offset).astype(np.float32)


def parse_domain_shift(spec: Optional[str]):
    """``GAMMA:GAIN:OFFSET`` → (gamma, gain, offset), or None."""
    if not spec:
        return None
    try:
        gamma_s, gain_s, off_s = spec.split(":")
        return float(gamma_s), float(gain_s), float(off_s)
    except ValueError:
        raise ValueError(f"--domain_shift expects GAMMA:GAIN:OFFSET, got {spec!r}") from None


def request_stream(args) -> Iterator[InferRequest]:
    """``--num_requests`` lazy-decode requests from the configured source;
    each decode runs on the engine's stager thread, so a corrupt frame
    becomes an error result, not a dead stream."""
    shift = parse_domain_shift(args.domain_shift)

    def shifted(pair):
        if shift is None:
            return pair
        return tuple(photometric_shift(x, *shift) for x in pair)

    n_sessions = max(int(args.video_sessions), 1)
    if args.source == "synthetic":
        h, w = args.synthetic_size

        def decode(i):
            return shifted(synthetic_frame(args.seed + i, h, w))

    elif args.source == "video":
        # request i is frame i // S of session i % S
        h, w = args.synthetic_size

        def decode(i):
            return shifted(synthetic_video_frame(args.seed + (i % n_sessions),
                                                 0.08 * (i // n_sessions), h, w))

    else:
        from raft_stereo_tpu_torch.data.datasets import build_train_dataset

        dataset = build_train_dataset(args, aug_params=None)
        if len(dataset) == 0:
            raise ValueError("serve_adaptive: dataset is empty: check --train_datasets and "
                             "the dataset root paths")

        def decode(i):
            img1, img2, _flow, _valid = dataset[i % len(dataset)]
            return shifted((np.asarray(img1), np.asarray(img2)))

    for i in range(args.num_requests):
        req = InferRequest(payload=i, inputs=lambda i=i: decode(i))
        if args.source == "video":
            from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

            yield SchedRequest(req, session=f"video{i % n_sessions}")
        else:
            yield req


# ----------------------------------------------------------- refused flags


def refuse(args) -> None:
    """The JAX CLI's refusal of a tier other than the fast one."""
    if args.tier not in (None, "fast"):
        raise SystemExit("serve_adaptive serves the adapted MADNet2 fast tier; --tier accepts "
                         "only 'fast' here: use --cascade for two-tier serving")


# ------------------------------------------------------------------ entry


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve stereo pairs with online MAD adaptation (behind rails).")
    parser.add_argument("--name", default="serve-mad")
    parser.add_argument("--restore_ckpt", default=None,
                        help="a reference .pth, a JAX npz variables checkpoint or a "
                        "port checkpoint")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--source", default="dataset", choices=["dataset", "synthetic", "video"],
                        help="request stream: a dataset, independent synthetic frames, or "
                        "--video_sessions temporally coherent synthetic videos")
    parser.add_argument("--video_sessions", type=int, default=1,
                        help="parallel video streams of --source video; request i is frame "
                        "i//S of stream i%%S")
    parser.add_argument("--train_datasets", nargs="+", default=["kitti"])
    parser.add_argument("--synthetic_size", type=int, nargs=2, default=[128, 256],
                        metavar=("H", "W"))
    parser.add_argument("--num_requests", type=int, default=64)
    parser.add_argument("--domain_shift", default=None, metavar="GAMMA:GAIN:OFFSET",
                        help="photometric shift applied to every served pair (e.g. "
                        "1.8:0.65:8): an unseen domain")
    parser.add_argument("--adapt_mode", default="mad", choices=["mad", "full"])
    parser.add_argument("--no_adapt", action="store_true",
                        help="frozen serving (the proxy loss is still evaluated, so health "
                        "trajectories stay comparable)")
    parser.add_argument("--policy", default="every_n", choices=["every_n", "on_degrade"])
    parser.add_argument("--adapt_every", type=int, default=4,
                        help="served requests per adaptation opportunity (rounded up to a "
                        "multiple of --infer_batch so chunks fill whole micro-batches)")
    parser.add_argument("--adapt_steps_per_round", type=int, default=1)
    parser.add_argument("--degrade_factor", type=float, default=1.2,
                        help="on_degrade: adapt when the fast proxy EMA exceeds this x the "
                        "best seen")
    parser.add_argument("--adapt_lr", type=float, default=1e-5,
                        help="online-adaptation learning rate (an order below training's)")
    parser.add_argument("--wdecay", type=float, default=0.0)
    parser.add_argument("--snapshot_every", type=int, default=4,
                        help="healthy adaptation steps between good snapshots (the rollback "
                        "targets)")
    parser.add_argument("--keep_snapshots", type=int, default=2)
    parser.add_argument("--snapshot_dir", default=None, help="default checkpoints/<name>_serve")
    parser.add_argument("--max_adapt_skips", type=int, default=3,
                        help="consecutive NaN-guard skips before a rollback")
    parser.add_argument("--max_rollbacks", type=int, default=3,
                        help="rollbacks before adaptation freezes for good")
    parser.add_argument("--regress_factor", type=float, default=2.0,
                        help="fast-EMA / slow-EMA ratio that declares a quality regression "
                        "(then: rollback)")
    parser.add_argument("--regress_warmup", type=int, default=2)
    # --cascade escalates low-confidence pairs from the adapted MADNet2 (the
    # fast tier) to a frozen RAFT-Stereo quality tier on the same card
    parser.add_argument("--quality_iters", type=int, default=8,
                        help="refinement iterations of the RAFT-Stereo quality tier built by "
                        "--cascade")
    parser.add_argument("--quality_ckpt", default=None,
                        help="the RAFT-Stereo quality tier of --cascade: a reference .pth, a "
                        "JAX npz variables checkpoint or a port checkpoint (default: "
                        "seeded weights)")
    add_infer_args(parser, default_batch=2)
    return parser


def _cascade_tiers(args, served, infer: InferOptions, dev):
    """The cascade's ``TierSet``: the adapted MADNet2 (``served``, which
    adaptation keeps pushing into) is the fast tier, a frozen default
    RAFT-Stereo at ``--quality_iters`` the quality tier, seeded or read from
    ``--quality_ckpt``."""
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.evaluate_mad import load_mad_weights
    from raft_stereo_tpu_torch.runtime import tiers as tiers_mod

    qmodel = load_model(RAFTStereoConfig(mixed_precision=args.mixed_precision), device=dev,
                        seed=0)
    if args.quality_ckpt:
        load_mad_weights(qmodel, args.quality_ckpt)  # .pth, JAX npz or port checkpoint
    return tiers_mod.TierSet([tiers_mod.madnet2_tier(served),
                              tiers_mod.raft_stereo_tier(qmodel, args.quality_iters)], infer)


def main(argv=None, device=None):
    """Serve; returns the summary (also printed as the last stdout line)."""
    global _last_server, _last_cascade
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    refuse(args)
    if args.adaptive_iters:
        raise SystemExit("serve_adaptive serves MADNet2, which has no refinement iterations: "
                         "--adaptive_iters is a RAFT-Stereo serving knob (evaluate, demo)")
    if args.spatial_threshold is not None:
        raise SystemExit("serve_adaptive's served model is MADNet2 (no spatial tier): "
                         "--spatial_threshold is a RAFT-Stereo serving knob (evaluate builds "
                         "the pixel-routed spatial tier)")
    if args.telemetry_dir is None:
        args.telemetry_dir = f"runs/{args.name}"
    if args.snapshot_dir is None:
        args.snapshot_dir = f"checkpoints/{args.name}_serve"
    # the blackbox first, so every engine built later registers with it
    end_introspection = infer_mod.install_cli_introspection(args)
    tel = None
    try:
        from raft_stereo_tpu_torch.evaluate import resolve_device
        from raft_stereo_tpu_torch.evaluate_mad import make_mad_engine
        from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
        from raft_stereo_tpu_torch.runtime.scheduler import make_scheduler, make_stream
        from raft_stereo_tpu_torch.runtime.tiers import CascadeServer
        from raft_stereo_tpu_torch.train_mad import _init_model_state

        dev = resolve_device(device)
        # the MAD objective at the (much lower) adaptation learning rate
        args.variant = "mad"
        args.lr = args.adapt_lr
        state, _ = _init_model_state(args, device=dev)
        # the served module: a copy the captured graphs read by address
        served = copy.deepcopy(state.model).eval().requires_grad_(False)
        tel = telemetry.install(telemetry.Telemetry(args.telemetry_dir))
        if args.slo_p95_ms:
            tel.configure_slo(args.slo_p95_ms, args.slo_budget)
        infer_mod.reset_summary()
        infer = options_from_args(args) or InferOptions(batch=args.infer_batch)
        tier_set = None
        if args.cascade:
            tier_set = _cascade_tiers(args, served, infer, dev)
            engine = tier_set.engine("fast")
        else:
            engine = make_mad_engine(served, fusion=False, infer=infer)
        config = AdaptConfig(
            adapt_mode=args.adapt_mode, adapt=not args.no_adapt,
            policy=AdaptPolicy(mode=args.policy, every=args.adapt_every,
                               degrade_factor=args.degrade_factor),
            steps_per_opportunity=args.adapt_steps_per_round,
            snapshot_every=args.snapshot_every, keep_snapshots=args.keep_snapshots,
            max_adapt_skips=args.max_adapt_skips, max_rollbacks=args.max_rollbacks,
            regress_factor=args.regress_factor, regress_warmup=args.regress_warmup,
            seed=args.seed)
        with GracefulShutdown() as shutdown:
            drain = ServeDrain(shutdown, timeout_s=args.drain_timeout, label="serve_adaptive")
            cascade = None
            if tier_set is not None:
                drain.attach(tier_set)
                cascade = CascadeServer(tier_set, threshold=args.cascade_threshold)
                stream_fn, schedulers = cascade.serve, list(tier_set.schedulers.values())
            else:
                sched = make_scheduler(engine, infer)
                drain.attach(sched)
                stream_fn, schedulers = make_stream(engine, infer, scheduler=sched), [sched]
            server = AdaptiveServer(engine, state, args.snapshot_dir, config, name=args.name,
                                    stream_fn=stream_fn,
                                    should_stop=lambda: shutdown.should_stop)
            _last_server, _last_cascade = server, cascade
            # the quality observatory: bit-exact goldens only on the frozen
            # fp32 path (adaptation and bf16 move bits)
            qh, qw = args.synthetic_size
            qmon = quality.monitor_from_options(
                infer, int(qh), int(qw), exact=args.no_adapt and not args.mixed_precision)
            if qmon is not None:
                quality.install(qmon)
                # a latched canary freezes adaptation through the same rail
                qmon.add_latch_action(server.freeze)
            # the overload controller (--controller; off by default): the SLO
            # burn and the scheduler depths move the cascade bar, the
            # adaptation cadence and the admission cap
            ctrl = None
            if infer.controller:
                from raft_stereo_tpu_torch.runtime.controller import maybe_controller

                ctrl = maybe_controller(infer, schedulers=schedulers, cascade=cascade,
                                        adaptive=server)
            telemetry.emit("run_start", name=args.name, mode="serve_adaptive",
                           adapt=config.adapt, adapt_mode=config.adapt_mode,
                           policy=config.policy.mode, num_requests=args.num_requests)
            if ctrl is not None:
                ctrl.start()
            try:
                for res in server.serve(drain.wrap_source(
                        quality.weave_canaries(request_stream(args), qmon))):
                    drain.note_result(res)
                    if not res.ok:
                        logger.warning("request %s failed (%s): isolated, the stream goes on",
                                       res.payload, res.error)
            finally:
                if ctrl is not None:
                    ctrl.close()
            drain.finish()
            # the server owns this run's heartbeat (its adaptation fields)
            infer_mod.publish_summary(engine.stats, label="serve_adaptive", heartbeat=False)
            summary = server.summary()
            # summary()'s scalar fields are exactly run_end's declared
            # payload keys (EVENT_SCHEMA): the comprehension strips the one
            # non-scalar field, so the dynamic ** stays schema-conformant
            telemetry.emit("run_end", outcome="completed", **{  # graftcheck: disable=GC05
                k: v for k, v in summary.items() if k != "controller_distribution"})
            if cascade is not None:
                # the cascade's ledger rides the printed summary only
                summary = dict(summary, cascade=cascade.summary())
            if qmon is not None:
                if qmon.cfg.golden_dir and qmon.canaries.captured:
                    path = qmon.canaries.save(qmon.cfg.golden_dir)
                    logger.info("quality: saved %d canary golden(s) to %s",
                                qmon.canaries.captured, path)
                summary = dict(summary, quality=qmon.snapshot())
            print(json.dumps({"serve_adaptive": summary}), flush=True)
            infer_mod.enforce_failure_budget(args.max_failed_frac)
            return summary
    finally:
        # the blackbox first: a pending dump lands while the sink lives
        end_introspection()
        quality.uninstall()
        if tel is not None:
            telemetry.uninstall(tel)


if __name__ == "__main__":
    main()

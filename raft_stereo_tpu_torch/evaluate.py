"""Evaluation harness: model construction, the test-mode forward, the
batched serving engine, the four validators and the CLI (PyTorch port of
``raft_stereo_tpu/evaluate.py``).

    python -m raft_stereo_tpu_torch.evaluate --dataset eth3d [--preset P]

The validators keep the reference's metrics, thresholds and masks:

  * ETH3D: bad-1.0 over valid pixels;
  * KITTI: bad-3.0 (D1), and a frames-per-second figure;
  * FlyingThings3D: bad-1.0 under the |disp| < 192 mask, pooled per pixel;
  * Middlebury: bad-2.0 where valid >= -0.5 and the GT > -1000.

By default every validator streams through the batched engine
(``runtime.infer.InferenceEngine``): shape buckets, fixed micro-batches and,
on the card, one CUDA graph per (bucket, batch). ``--per_image`` keeps the
reference's one-pair-at-a-time protocol, whose forward (``make_forward``) is
captured once per input shape on the card. Per-image metrics fold in
dataset index order on both paths. KITTI's per-pair FPS is defined on the
per-image path; the engine reports its throughput with capture time
excluded instead. ``--telemetry_dir`` writes the engine's events, spans,
heartbeat and latency metrics there (``runtime/telemetry.py``) and arms the
blackbox (SIGUSR2 dumps ``blackbox.json`` there).

Serving options (``runtime/infer.py::add_infer_args``): ``--sched`` puts
the continuous-batching scheduler in front of the engine
(``runtime/scheduler.py``; ``--max_pending`` sheds); the first SIGTERM or
SIGINT drains the run within ``--drain_timeout`` and it exits 0 with the
metrics of the completed pairs; ``--adaptive_iters --converge_eps`` serves
with the convergence exit, and ``--iter_tiers 7,32`` with several
iteration counts behind the tiered dispatcher; ``--tier`` serves through
one named tier and ``--cascade`` through the MADNet2 -> RAFT-Stereo cascade
(``runtime/tiers.py``; ``--fast_ckpt``); ``--spatial_threshold N`` routes
buckets of more than N padded pixels to the spatial tier, which splits each
request's rows over the visible cards; ``--controller`` arms the overload
controller over them (``--slo_p95_ms``, ``--slo_budget``) and
``--debug_port`` the introspection server; the quality observatory watches
every user result (``--no_quality`` turns it off) and ``--canary_every``
weaves golden canaries into the stream, checked against ``--golden_dir``'s
goldens (a run that captured goldens saves them there).

Everything here runs on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request it raises. On
the CPU both paths run the forward eagerly.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from raft_stereo_tpu_torch.config import (
    CORR_IMPLEMENTATIONS,
    PRESET_FLAGS,
    RAFTStereoConfig,
    apply_preset_defaults,
    config_from_args,
)
from raft_stereo_tpu_torch.data import datasets
from raft_stereo_tpu_torch.models.layers import init_weights
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.pad import InputPadder
from raft_stereo_tpu_torch.ops.sampling import interp_bilinear
from raft_stereo_tpu_torch.runtime import infer as infer_mod
from raft_stereo_tpu_torch.runtime import quality, telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    GraphCache,
    InferenceEngine,
    InferOptions,
    InferRequest,
    add_infer_args,
    options_from_args,
)
from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
from raft_stereo_tpu_torch.runtime.scheduler import SessionServer, make_scheduler, make_stream
from raft_stereo_tpu_torch.utils.checkpoints import restore_weights

logger = logging.getLogger(__name__)

def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the CUDA card, which must then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run on the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


def load_model(args_or_config, device=None, seed: int = 0,
               restore_ckpt: Optional[str] = None) -> RAFTStereo:
    """Build the model from a config or CLI args, initialised from a seeded
    ``torch.Generator``, optionally restoring a checkpoint (a reference
    ``.pth``, a JAX npz variables checkpoint or a port checkpoint), in eval
    mode on ``device``."""
    dev = resolve_device(device)
    if isinstance(args_or_config, RAFTStereoConfig):
        cfg = args_or_config
    else:
        if getattr(args_or_config, "adaptive_iters", False) and args_or_config.per_image:
            # the per-image path is the reference's protocol: no engine, no
            # sessions, and a forward that returns two outputs
            raise SystemExit("--adaptive_iters needs the batched serving path: drop "
                             "--per_image")
        cfg = config_from_args(args_or_config)
        restore_ckpt = restore_ckpt or getattr(args_or_config, "restore_ckpt", None)
    model = RAFTStereo(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    if restore_ckpt:
        restore_weights(model, restore_ckpt)
    logger.info("Parameter Count: %d", sum(p.numel() for p in model.parameters()))
    return model.to(dev).eval()


def make_forward(model: RAFTStereo, iters: int) -> Callable:
    """Test-mode forward: (img1, img2) [B, H, W, 3] numpy or tensors →
    disp_up [B, f·H, f·W, 1] on the model's device.

    On the card, with ``converge_eps == 0``, the forward is captured once
    per input shape as a CUDA graph and replayed (``forward.graphs`` is its
    ``GraphCache``; each call returns a fresh tensor). The ``converge_eps``
    exit reads a scalar back each step, so that forward runs eagerly, as
    does every forward on the CPU (``forward.graphs`` is then None)."""
    dev = next(model.parameters()).device

    def eager(a, b) -> torch.Tensor:
        # the forward returns (lowres, disp_up) or, with converge_eps,
        # (lowres, disp_up, iters_executed)
        return model(a, b, iters=iters)[1]

    graphs = (GraphCache() if dev.type == "cuda" and model.config.converge_eps == 0
              else None)

    def forward(img1, img2) -> torch.Tensor:
        if graphs is None:
            return eager(torch.as_tensor(img1, dtype=torch.float32, device=dev),
                         torch.as_tensor(img2, dtype=torch.float32, device=dev))
        a = torch.as_tensor(img1, dtype=torch.float32)
        b = torch.as_tensor(img2, dtype=torch.float32)
        key = (tuple(a.shape), tuple(b.shape), iters)
        return graphs.run(key, eager, (a, b)).clone()

    forward.graphs = graphs
    return forward


def make_engine(model: RAFTStereo, iters: int, infer: InferOptions) -> InferenceEngine:
    """The batched serving engine for the model's test-mode forward, on the
    model's device: captured per (bucket, batch) on the card unless the
    model's ``converge_eps`` exit needs the eager forward."""

    def fwd(a, b) -> torch.Tensor:
        return model(a, b, iters=iters)[1]

    return InferenceEngine(
        fwd, device=next(model.parameters()).device, batch=infer.batch,
        prefetch_depth=infer.prefetch, max_executables=infer.max_executables,
        deadline_s=infer.deadline_s, retries=infer.retries,
        capture=model.config.converge_eps == 0,
        # what a graph bakes in besides its shapes: the model (its weights'
        # addresses) and the iteration count
        graph_key=(id(model), repr(model.config), int(iters)), module=model,
        # the store key's: the same, stable across processes (no id())
        aot_dir=infer.aot_dir, aot_key_extra={"model": repr(model.config), "iters": int(iters)})


def make_adaptive_forward(model: RAFTStereo, iters: int, video: bool = False) -> Callable:
    """The adaptive-compute serving forward (``--adaptive_iters``), on
    channel-last tensors:

      * with ``model.config.converge_eps > 0`` the refinement loop exits on
        convergence and the output grows ``ADAPTIVE_AUX_CHANNELS`` channels
        after the disparity, ``[iters_done, iters_total]``
        (``wrap_adaptive_stream`` strips them into telemetry);
      * with ``video`` it takes a third input, the previous frame's
        full-resolution warm-start field [B, H, W, 2] (the
        ``SessionServer``'s slot: the forward-interpolated previous
        disparity, zeros when cold), resized to the model's 1/f grid into
        ``flow_init`` (the full-resolution flow divided by f, the convex
        upsampling's scale inverted)."""
    factor = model.config.downsample_factor
    eps_on = model.config.converge_eps > 0

    def fwd(*inputs) -> torch.Tensor:
        a, b = inputs[0], inputs[1]
        flow_init = None
        if video:
            full = inputs[2].float().permute(0, 3, 1, 2)
            size = (a.shape[1] // factor, a.shape[2] // factor)
            flow_init = (interp_bilinear(full, size) / float(factor)).permute(0, 2, 3, 1)
        out = model(a, b, iters=iters, flow_init=flow_init)
        if not eps_on:
            return out[1]
        _, disp, ran = out
        aux = torch.tensor([float(ran), float(iters)], dtype=disp.dtype, device=disp.device)
        return torch.cat([disp, aux.expand(*disp.shape[:3], 2)], dim=-1)

    return fwd


def _maybe_controlled(stream, infer: InferOptions, *, schedulers=(), cascade=None,
                      tiered=None, adaptive=None):
    """Arm the overload controller around one serve when ``--controller``
    asks for it; without it the stream is returned untouched and no
    controller code runs."""
    if not infer.controller:
        return stream
    from raft_stereo_tpu_torch.runtime.controller import maybe_controller

    ctrl = maybe_controller(infer, schedulers=schedulers, cascade=cascade, tiered=tiered,
                            adaptive=adaptive)
    return ctrl.wrap(stream)


def _adaptive_serving(model: RAFTStereo, iters: int, infer: InferOptions, drain=None):
    """The ``--adaptive_iters`` assembly: one engine over
    ``make_adaptive_forward`` (captured unless the convergence exit reads a
    scalar each step) with the scheduler the options ask for, or, for
    several iteration counts, a ``TierSet`` of one tier a count behind a
    ``TieredServer`` and ``IterTierPolicy``; the early-exit telemetry
    wrapper when ``converge_eps > 0``; the ``SessionServer`` warm-start
    layer in video mode; the overload controller outermost."""
    from raft_stereo_tpu_torch.runtime import tiers as tiers_mod

    if float(model.config.converge_eps) != float(infer.converge_eps):
        raise ValueError(
            f"adaptive serving: the model was built with converge_eps="
            f"{model.config.converge_eps} but the serving options carry {infer.converge_eps}; "
            f"build the model through load_model so the two agree")
    counts = tuple(sorted(set(infer.iter_tiers or ()) | {int(iters)}))
    video = bool(infer.video)
    capture = model.config.converge_eps == 0
    if len(counts) == 1:
        engine = InferenceEngine(
            make_adaptive_forward(model, counts[0], video),
            device=next(model.parameters()).device,
            batch=infer.batch, prefetch_depth=infer.prefetch,
            max_executables=infer.max_executables, deadline_s=infer.deadline_s,
            retries=infer.retries, capture=capture,
            graph_key=(id(model), repr(model.config), counts[0], video),
            # frame t+1 cannot exist before result t: the held dispatch must
            # finalise on an empty stager queue, or the session deadlocks
            eager_finalize=video, module=model, aot_dir=infer.aot_dir,
            aot_key_extra={"model": repr(model.config), "iters": counts[0], "video": video})
        sched = make_scheduler(engine, infer)
        stream = make_stream(engine, infer, scheduler=sched)
        if drain is not None:
            drain.attach(sched)
        serving, ctrl_scheds, ctrl_tiered = engine, [sched], None
    else:
        ts = tiers_mod.TierSet(
            [tiers_mod.ModelTier(
                name=tiers_mod.iter_tier_name(it), model=model,
                make_forward=lambda m, it=it: make_adaptive_forward(m, it, video),
                capture=capture,
                graph_key=(id(model), repr(model.config), int(it), video),
                # with the tier's name, iteration tiers sharing one
                # --aot_dir get disjoint store keys
                aot_extra={"model": repr(model.config), "iters": int(it), "video": video})
             for it in counts], infer)
        if drain is not None:
            drain.attach(ts)
        server = tiers_mod.TieredServer(ts, tiers_mod.IterTierPolicy(counts))
        serving, stream = _TieredServing(ts), server.serve
        ctrl_scheds, ctrl_tiered = list(ts.schedulers.values()), server
    if infer.converge_eps > 0:
        stream = infer_mod.wrap_adaptive_stream(stream)
    if video:
        # the inner stream keeps the SchedRequest where something reads it
        # (a scheduler's urgency, the iteration-tier router); bucket
        # flushes chase every gated frame whenever the terminal engines are
        # plain streams (the TieredServer passes the token to its plain
        # tiers); with --sched the schedulers' anti-starvation bound flushes
        stream = SessionServer(stream, forward_sched=bool(infer.sched or len(counts) > 1),
                               flush_buckets=not infer.sched).serve
    # outermost: the control thread spans the whole serve
    stream = _maybe_controlled(stream, infer, schedulers=ctrl_scheds, tiered=ctrl_tiered)
    return serving, stream


class _TieredServing:
    """The engine's stand-in in tiered and cascade runs: ``stats`` is the
    merged view over every tier's engine. ``request_tier`` (cascade runs)
    names the tier every request passes once, the fast tier: its completed
    and failed counts are the request-level ledger the summary and
    ``--max_failed_frac`` see (an escalation is re-work, not a second
    request, and a failed escalation served as a fallback reached the
    consumer as a success); batches, captures and latencies cover both."""

    def __init__(self, tier_set, request_tier: Optional[str] = None):
        self.tier_set = tier_set
        self.request_tier = request_tier

    @property
    def stats(self):
        merged = self.tier_set.combined_stats()
        if self.request_tier is not None:
            per_request = self.tier_set.engine(self.request_tier).stats
            merged.images = per_request.images
            merged.failed = per_request.failed
        return merged


def _spatial_serving(model: RAFTStereo, iters: int, infer: InferOptions, drain=None):
    """The ``--spatial_threshold`` assembly: the quality tier (this model)
    and a spatial tier on ``infer.spatial_shards`` of the model's devices
    (every visible card for 0; the CPU when the model is there) under the
    pixel-aware ``SpatialServer``, whose routing lives in the base tier's
    scheduler (so the run is scheduler-backed, ``--sched`` or not); the
    controller, when armed, takes both schedulers."""
    import dataclasses

    from raft_stereo_tpu_torch.runtime import tiers as tiers_mod

    if not infer.sched:
        logger.info("--spatial_threshold routes in the admission layer: enabling the "
                    "continuous-batching scheduler for this serve")
        infer = dataclasses.replace(infer, sched=True)
    dev = next(model.parameters()).device
    ts = tiers_mod.TierSet(
        [tiers_mod.raft_stereo_tier(model, iters),
         tiers_mod.spatial_tier(model, iters, num_spatial=infer.spatial_shards,
                                devices=[dev] if dev.type == "cpu" else None)],
        infer)
    if drain is not None:
        drain.attach(ts)
    server = tiers_mod.SpatialServer(ts, base="quality", spatial="spatial",
                                     threshold=int(infer.spatial_threshold))
    stream = _maybe_controlled(server.serve, infer, schedulers=list(ts.schedulers.values()))
    return _TieredServing(ts), stream


def _load_fast_tier(infer: InferOptions, mixed_precision: bool = False, device=None):
    """The MADNet2 fast tier of ``--tier fast`` / ``--cascade``: seeded, or
    restored from ``--fast_ckpt`` (a reference ``.pth``, a JAX npz
    variables checkpoint or a port checkpoint), on ``device``."""
    from raft_stereo_tpu_torch.evaluate_mad import load_mad_weights
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.runtime.tiers import madnet2_tier

    model = make_madnet2(mixed_precision=mixed_precision, seed=0)
    if infer.fast_ckpt:
        load_mad_weights(model, infer.fast_ckpt)
    return madnet2_tier(model.to(device))


def make_serving(model: RAFTStereo, iters: int, infer: InferOptions, drain=None):
    """``(serving, stream_fn)`` for the configured serving mode.

    Untiered (the default): the plain engine, or its scheduler's ``serve``
    with ``--sched``. ``--tier NAME``: the tiered dispatcher over a
    ``TierSet`` routing every request to NAME (``quality`` is this model,
    bitwise the untiered engine; ``fast`` adds a MADNet2 tier).
    ``--cascade``: both tiers under the ``CascadeServer``.
    ``--adaptive_iters``: the adaptive assembly. ``--spatial_threshold``:
    the quality tier and the spatial tier under the ``SpatialServer``.
    ``serving.stats`` is the accounting either way; ``drain`` (a
    ``ServeDrain``) is attached to whatever can drain."""
    if infer.spatial_threshold is not None:
        # the pixel router extends the default path: in series with the
        # multi-model or iteration-tier routers it would have no defined
        # policy
        if infer.tier or infer.cascade or infer.adaptive_iters:
            raise SystemExit("--spatial_threshold adds a pixel-routed spatial tier to the "
                             "default serving path; it is mutually exclusive with "
                             "--tier/--cascade/--adaptive_iters")
        return _spatial_serving(model, iters, infer, drain=drain)
    if infer.adaptive_iters:
        # iteration tiers of one model are another axis than the multi-model
        # tiers: two routers in series would have no defined policy
        if infer.tier or infer.cascade:
            raise SystemExit("--adaptive_iters serves iteration tiers of one model; it is "
                             "mutually exclusive with --tier/--cascade")
        return _adaptive_serving(model, iters, infer, drain=drain)
    if not (infer.tier or infer.cascade):
        engine = make_engine(model, iters, infer)
        sched = make_scheduler(engine, infer)
        if drain is not None:
            drain.attach(sched)
        stream = make_stream(engine, infer, scheduler=sched)
        return engine, _maybe_controlled(stream, infer, schedulers=[sched])

    from raft_stereo_tpu_torch.runtime import tiers as tiers_mod

    tier_list = [tiers_mod.raft_stereo_tier(model, iters)]
    if infer.cascade or infer.tier == "fast":
        # the fast tier follows the quality model's precision
        tier_list.insert(0, _load_fast_tier(infer, model.config.mixed_precision,
                                            device=next(model.parameters()).device))
    ts = tiers_mod.TierSet(tier_list, infer)
    if drain is not None:
        drain.attach(ts)
    if infer.cascade:
        server = tiers_mod.CascadeServer(ts, threshold=infer.cascade_threshold)
        stream = _maybe_controlled(server.serve, infer, schedulers=list(ts.schedulers.values()),
                                   cascade=server)
        return _TieredServing(ts, request_tier=server.fast), stream
    tier = infer.tier
    if tier not in ts.tiers:
        raise SystemExit(f"--tier {tier!r}: unknown tier (this CLI builds {ts.names})")
    server = tiers_mod.TieredServer(ts, tiers_mod.TierPolicy.single(tier))
    stream = _maybe_controlled(server.serve, infer, schedulers=list(ts.schedulers.values()),
                               tiered=server)
    return _TieredServing(ts), stream


# The last engine run's quality-observatory snapshot (None: the observatory
# was off or nothing ran): the validators own the monitor, the caller reads
# this after ``main``. ``main`` resets it on entry.
_last_quality: Optional[dict] = None


def last_quality() -> Optional[dict]:
    return _last_quality


def _quality_monitor(model: RAFTStereo, ds, infer: InferOptions):
    """The quality monitor the options ask for (None with ``--no_quality``):
    the canaries take the first sample's shape, and their goldens are
    bit-exact only on the fp32 path without the convergence exit."""
    hw = tuple(ds[0][0].shape[:2]) if infer.canary_every > 0 and len(ds) else (0, 0)
    return quality.monitor_from_options(
        infer, *hw, exact=not model.config.mixed_precision and model.config.converge_eps == 0)


def _epe_image(forward, img1, img2) -> np.ndarray:
    """Run one padded forward; return the unpadded disparity [H, W]."""
    padder = InputPadder(img1[None].shape, divis_by=32)
    p1, p2 = padder.pad(img1[None], img2[None])
    disp = padder.unpad(forward(p1, p2))
    return disp[0, :, :, 0].cpu().numpy()


def _engine_predictions(model, iters: int, ds, infer: InferOptions, drain=None
                        ) -> Tuple[InferenceEngine, Iterator[Tuple[int, np.ndarray, tuple]]]:
    """The batched path: ``(engine, iterator of (index, pred, (flow_gt,
    valid_gt)))``; the engine is returned so callers can read its stats.
    The dataset read is each request's lazy decode on the stager (or the
    scheduler's admission) thread: a sample that fails to read becomes an
    error result, is logged and left out of the metrics, and the published
    summary counts it. The quality monitor is installed for the run, with
    its canaries woven into the source and their results kept out of the
    metrics. ``drain`` (a ``ServeDrain``) makes the run signal-drainable:
    the source stops, pending buckets flush, whatever the bound cuts off
    resolves as a drained error (left out of the metrics like a failure)."""
    monitor = _quality_monitor(model, ds, infer)
    engine, stream = make_serving(model, iters, infer, drain=drain)
    gts: Dict[int, tuple] = {}

    def requests():
        for i in range(len(ds)):
            def decode(i=i):
                img1, img2, flow_gt, valid_gt = ds[i]
                gts[i] = (flow_gt, valid_gt)
                return img1, img2

            yield InferRequest(payload=i, inputs=decode)

    def source():
        src = quality.weave_canaries(requests(), monitor)
        if not infer.sched:  # the plain engine takes bare requests
            src = (getattr(r, "request", r) for r in src)
        return src if drain is None else drain.wrap_source(src)

    def results():
        global _last_quality
        if monitor is not None:
            quality.install(monitor)
        try:
            for res in stream(source()):
                if drain is not None:
                    drain.note_result(res)
                if quality.is_canary(res.payload):
                    continue
                if not res.ok:
                    logger.warning("request %s failed (%s: %s): excluded from metrics",
                                   res.payload, type(res.error).__name__, res.error)
                    gts.pop(res.payload, None)
                    continue
                yield res.payload, res.output[:, :, 0], gts.pop(res.payload)
        finally:
            if drain is not None:
                drain.finish()
            infer_mod.publish_summary(engine.stats, label="evaluate")
            if monitor is not None:
                quality.uninstall()
                if monitor.cfg.golden_dir and monitor.canaries.captured:
                    # a run that captured goldens leaves them for the next
                    path = monitor.canaries.save(monitor.cfg.golden_dir)
                    logger.info("quality: saved %d canary golden(s) to %s",
                                len(monitor.canaries.goldens), path)
                _last_quality = monitor.snapshot()

    return engine, results()


def _iter_predictions(model, iters: int, ds, infer: Optional[InferOptions], drain=None
                      ) -> Iterator[Tuple[int, np.ndarray, tuple]]:
    """``(index, pred [H, W], (flow_gt, valid_gt))`` for every sample:
    ``infer=None`` runs the per-image path in index order (a drain stops it
    at the next pair), otherwise the engine streams in completion order
    (callers key on the index)."""
    if infer is None:
        forward = make_forward(model, iters)
        for i in range(len(ds)):
            if drain is not None and drain.draining:
                break
            img1, img2, flow_gt, valid_gt = ds[i]
            yield i, _epe_image(forward, img1, img2), (flow_gt, valid_gt)
        if drain is not None:
            drain.finish()
        return
    yield from _engine_predictions(model, iters, ds, infer, drain=drain)[1]


def validate_eth3d(model, iters: int = 32, infer: Optional[InferOptions] = None,
                   drain=None) -> Dict[str, float]:
    """ETH3D training split: EPE and bad-1.0."""
    ds = datasets.ETH3D(aug_params=None)
    by_index = {}
    for i, pred, (flow_gt, valid_gt) in _iter_predictions(model, iters, ds, infer, drain):
        epe = np.abs(pred - flow_gt[..., 0])
        val = valid_gt >= 0.5
        by_index[i] = (epe[val].mean(), (epe > 1.0)[val].mean())
        logger.info("ETH3D %d/%d EPE %.4f D1 %.4f", i + 1, len(ds), *by_index[i])
    if not by_index:
        return {"eth3d-epe": float("nan"), "eth3d-d1": float("nan")}
    epe_list = [by_index[i][0] for i in sorted(by_index)]
    out_list = [by_index[i][1] for i in sorted(by_index)]
    res = {"eth3d-epe": float(np.mean(epe_list)), "eth3d-d1": 100 * float(np.mean(out_list))}
    print("Validation ETH3D: EPE %f, D1 %f" % (res["eth3d-epe"], res["eth3d-d1"]))
    return res


def validate_kitti(model, iters: int = 32, infer: Optional[InferOptions] = None,
                   drain=None) -> Dict[str, float]:
    """KITTI-2015 training split: EPE, D1 (bad-3.0) and FPS. The per-image
    path's FPS is the reference's per-pair wall clock after a 50-image
    warm-up; the engine's is its throughput, capture time excluded."""
    ds = datasets.KITTI(aug_params=None)
    if infer is not None:
        by_index = {}
        t0 = time.perf_counter()
        engine, preds = _engine_predictions(model, iters, ds, infer, drain=drain)
        for i, pred, (flow_gt, valid_gt) in preds:
            epe = np.abs(pred - flow_gt[..., 0])
            val = valid_gt >= 0.5
            by_index[i] = (epe[val].mean(), (epe > 3.0)[val])
        wall = time.perf_counter() - t0
        if not by_index:
            return {"kitti-epe": float("nan"), "kitti-d1": float("nan")}
        res = {
            "kitti-epe": float(np.mean([by_index[i][0] for i in sorted(by_index)])),
            "kitti-d1": 100 * float(
                np.concatenate([by_index[i][1] for i in sorted(by_index)]).mean()),
        }
        serving = max(wall - engine.stats.compile_s, 1e-9)
        res["kitti-fps"] = len(by_index) / serving
        print(f"Validation KITTI: EPE {res['kitti-epe']}, D1 {res['kitti-d1']}, "
              f"{res['kitti-fps']:.2f}-FPS engine throughput ({len(by_index)} images in "
              f"{serving:.3f}s, capture excluded)")
        return res

    forward = make_forward(model, iters)
    epe_list, out_list, elapsed = [], [], []
    for i in range(len(ds)):
        if drain is not None and drain.draining:
            break
        img1, img2, flow_gt, valid_gt = ds[i]
        padder = InputPadder(img1[None].shape, divis_by=32)
        p1, p2 = padder.pad(img1[None], img2[None])
        start = time.time()
        disp = forward(p1, p2)
        if disp.is_cuda:
            torch.cuda.synchronize()
        end = time.time()
        if i > 50:
            elapsed.append(end - start)
        pred = padder.unpad(disp)[0, :, :, 0].cpu().numpy()
        epe = np.abs(pred - flow_gt[..., 0])
        val = valid_gt >= 0.5
        epe_list.append(epe[val].mean())
        out_list.append((epe > 3.0)[val])
    if drain is not None:
        drain.finish()
    if not epe_list:
        return {"kitti-epe": float("nan"), "kitti-d1": float("nan")}
    res = {
        "kitti-epe": float(np.mean(epe_list)),
        "kitti-d1": 100 * float(np.concatenate(out_list).mean()),
    }
    if elapsed:
        rt = float(np.mean(elapsed))
        res["kitti-fps"] = 1.0 / rt
        print(f"Validation KITTI: EPE {res['kitti-epe']}, D1 {res['kitti-d1']}, "
              f"{1 / rt:.2f}-FPS ({rt:.3f}s)")
    return res


def validate_things(model, iters: int = 32, infer: Optional[InferOptions] = None,
                    drain=None) -> Dict[str, float]:
    """FlyingThings3D TEST split: EPE and bad-1.0 under the |disp| < 192 mask."""
    ds = datasets.SceneFlowDatasets(dstype="frames_finalpass", things_test=True)
    by_index = {}
    for i, pred, (flow_gt, valid_gt) in _iter_predictions(model, iters, ds, infer, drain):
        epe = np.abs(pred - flow_gt[..., 0])
        val = (valid_gt >= 0.5) & (np.abs(flow_gt[..., 0]) < 192)
        by_index[i] = (epe[val].mean(), (epe > 1.0)[val])
    if not by_index:
        return {"things-epe": float("nan"), "things-d1": float("nan")}
    res = {
        "things-epe": float(np.mean([by_index[i][0] for i in sorted(by_index)])),
        "things-d1": 100 * float(
            np.concatenate([by_index[i][1] for i in sorted(by_index)]).mean()),
    }
    print("Validation FlyingThings: %f, %f" % (res["things-epe"], res["things-d1"]))
    return res


def validate_middlebury(model, iters: int = 32, split: str = "F",
                        infer: Optional[InferOptions] = None, drain=None) -> Dict[str, float]:
    """Middlebury-V3: EPE and bad-2.0."""
    ds = datasets.Middlebury(aug_params=None, split=split)
    by_index = {}
    for i, pred, (flow_gt, valid_gt) in _iter_predictions(model, iters, ds, infer, drain):
        epe = np.abs(pred - flow_gt[..., 0])
        val = (valid_gt.reshape(-1) >= -0.5) & (flow_gt[..., 0].reshape(-1) > -1000)
        epe_f = epe.reshape(-1)
        by_index[i] = (epe_f[val].mean(), (epe_f > 2.0)[val].mean())
        logger.info("Middlebury %d/%d EPE %.4f D1 %.4f", i + 1, len(ds), *by_index[i])
    if not by_index:
        return {f"middlebury{split}-epe": float("nan"), f"middlebury{split}-d1": float("nan")}
    res = {
        f"middlebury{split}-epe": float(np.mean([by_index[i][0] for i in sorted(by_index)])),
        f"middlebury{split}-d1": 100 * float(
            np.mean([by_index[i][1] for i in sorted(by_index)])),
    }
    print(f"Validation Middlebury{split}: EPE {res[f'middlebury{split}-epe']}, "
          f"D1 {res[f'middlebury{split}-d1']}")
    return res


VALIDATORS = {
    "eth3d": validate_eth3d,
    "kitti": validate_kitti,
    "things": validate_things,
    "middlebury_F": lambda m, iters=32, infer=None, drain=None:
        validate_middlebury(m, iters, "F", infer, drain),
    "middlebury_H": lambda m, iters=32, infer=None, drain=None:
        validate_middlebury(m, iters, "H", infer, drain),
    "middlebury_Q": lambda m, iters=32, infer=None, drain=None:
        validate_middlebury(m, iters, "Q", infer, drain),
}


def add_model_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The architecture flags of the JAX package's ``add_model_args``."""
    parser.add_argument("--preset", choices=list(PRESET_FLAGS), default=None,
                        help="named model preset; explicit flags override")
    parser.add_argument("--restore_ckpt", default=None, help="a reference .pth, a JAX npz variables checkpoint or a port "
                        "checkpoint")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--valid_iters", type=int, default=32)
    parser.add_argument("--hidden_dims", nargs="+", type=int, default=[128] * 3)
    parser.add_argument("--corr_implementation", choices=list(CORR_IMPLEMENTATIONS), default="reg")
    parser.add_argument("--shared_backbone", action="store_true")
    parser.add_argument("--corr_levels", type=int, default=4)
    parser.add_argument("--corr_radius", type=int, default=4)
    parser.add_argument("--n_downsample", type=int, default=2)
    parser.add_argument("--context_norm", default="batch",
                        choices=["group", "batch", "instance", "none"])
    parser.add_argument("--slow_fast_gru", action="store_true")
    parser.add_argument("--n_gru_layers", type=int, default=3)
    parser.add_argument(
        "--fused_update", action="store_true",
        help="run each test-mode refinement step but the last as one fused step "
        "(correlation lookup, motion encoder, finest ConvGRU and flow head); on "
        "CUDA the hand-written kernel runs or the call raises, on the CPU its "
        "plain PyTorch version runs",
    )
    return parser


def main(argv=None, device=None) -> Dict[str, float]:
    global _last_quality
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    add_infer_args(parser)
    parser.add_argument("--dataset", required=True, choices=list(VALIDATORS),
                        help="validation set")
    parser.add_argument("--fast_ckpt", default=None, metavar="CKPT",
                        help="the MADNet2 fast tier of --tier fast / --cascade: a reference "
                        ".pth, a JAX npz variables checkpoint or a port checkpoint "
                        "(default: seeded weights)")
    apply_preset_defaults(parser, argv)
    args = parser.parse_args(argv)
    # The reference eval autocasts iff the corr implementation is spelled
    # *_cuda: those command lines run the whole forward in half precision.
    args.mixed_precision = args.mixed_precision or args.corr_implementation.endswith("_cuda")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s")
    infer_mod.reset_summary()
    _last_quality = None
    tel = infer_mod.install_cli_telemetry(args)
    # the blackbox before the engines, so their snapshot hooks register
    end_introspection = infer_mod.install_cli_introspection(args)
    try:
        model = load_model(args, device=device)
        # the first SIGTERM/SIGINT drains the run: admission stops, pending
        # buckets flush, and the metrics cover the completed pairs; a second
        # signal is immediate
        with GracefulShutdown() as shutdown:
            drain = ServeDrain(shutdown, timeout_s=args.drain_timeout, label="evaluate")
            res = VALIDATORS[args.dataset](model, iters=args.valid_iters,
                                           infer=options_from_args(args), drain=drain)
    finally:
        # the blackbox first: a pending dump lands while the sink lives
        end_introspection()
        telemetry.uninstall(tel)
    # metrics cover completed pairs only; exit non-zero past the budget
    infer_mod.enforce_failure_budget(args.max_failed_frac)
    return res


if __name__ == "__main__":
    main()

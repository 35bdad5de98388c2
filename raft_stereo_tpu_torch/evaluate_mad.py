"""MADNet2-family evaluation on FlyingThings3D (PyTorch port of
``raft_stereo_tpu/evaluate_mad.py``; the reference's evaluate_mad.py and
evaluate_mad_fusion.py).

    python -m raft_stereo_tpu_torch.evaluate_mad [--fusion] [--mixed_precision]

``validate_things_mad`` keeps the MADNet2 conventions: pad to ÷128, the
finest prediction upsampled bilinearly ×4 (align_corners=False) and scaled
×−20, NaN images counted and averaged in with a zero EPE (their outlier
masks still pooled), and a plain-text line appended to ``runs/log.txt``.
The Fusion variant takes the GT disparity as its guidance proxy, as the
reference does.

The forward, post-processing included, runs through the shared
``InferenceEngine`` at ``divis_by=128``: on the card one CUDA graph per
(bucket, batch). ``--per_image`` streams one pair at a time through an
engine at batch 1 (the reference's per-pair timing, decode outside the
timed window); ``--sched`` puts the continuous-batching scheduler in front
of the batched engine. ``--restore_ckpt`` loads a reference ``.pth``, a JAX
npz variables checkpoint or a port checkpoint (``train_mad``'s). Everything runs on the CUDA card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from raft_stereo_tpu_torch.data import datasets
from raft_stereo_tpu_torch.evaluate import resolve_device
from raft_stereo_tpu_torch.models.madnet2 import DIVIS_BY, make_madnet2
from raft_stereo_tpu_torch.ops.sampling import bilinear_upsample
from raft_stereo_tpu_torch.runtime import infer as infer_mod
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.runtime.infer import (
    InferenceEngine,
    InferOptions,
    InferRequest,
    add_infer_args,
    options_from_args,
)
from raft_stereo_tpu_torch.runtime.scheduler import make_stream
from raft_stereo_tpu_torch.utils.checkpoints import restore_weights

logger = logging.getLogger(__name__)

# The last validation's engine (its stats and graphs), for the caller of ``main``.
_last_engine: Optional[InferenceEngine] = None


def last_engine() -> Optional[InferenceEngine]:
    return _last_engine


def load_mad_weights(model: torch.nn.Module, path: str) -> None:
    """Load ``path`` into ``model``, strictly: a reference ``.pth`` (its
    ``module.`` prefix stripped), a JAX npz variables checkpoint, or a port
    checkpoint, whose state is a train state (its ``model``) or a bare state
    dict (``utils/checkpoints.py::restore_weights``)."""
    restore_weights(model, path)


def make_mad_engine(model: torch.nn.Module, fusion: bool = False,
                    infer: Optional[InferOptions] = None) -> InferenceEngine:
    """The MADNet2 serving engine on the model's device: ÷128 buckets, the
    finest prediction upsampled bilinearly ×4 and scaled ×−20 inside the
    captured forward, marked ``output`` after the model's own stage marks.
    The Fusion variant takes the guidance as a third input slot, padded with
    the images' offsets. A replay's input copy overlaps the replay before
    (``copy_ahead``): a 2048x2944 Fusion batch copies 675 MB in, ~13% of
    its device time."""
    infer = infer or InferOptions(batch=1)

    def fwd(*inputs) -> torch.Tensor:
        with torch.no_grad():
            out = bilinear_upsample(model(*inputs)[0], 4) * -20.0
        telemetry.mark("output")
        return out

    return InferenceEngine(
        fwd, device=next(model.parameters()).device, batch=infer.batch,
        prefetch_depth=infer.prefetch, max_executables=infer.max_executables,
        deadline_s=infer.deadline_s, retries=infer.retries, divis_by=DIVIS_BY,
        # what a graph bakes in besides its shapes: the model (its weights'
        # addresses) and the variant
        graph_key=(id(model), "model", type(model).__name__,
                   model.mixed_precision, "fusion", bool(fusion)),
        module=model, aot_dir=infer.aot_dir,
        # the store key's: the same, stable across processes (no id())
        aot_key_extra={"model": type(model).__name__,
                       "mixed_precision": bool(model.mixed_precision), "fusion": bool(fusion)},
        copy_ahead=True)


def validate_things_mad(model: torch.nn.Module, fusion: bool = False, log_dir: str = "runs",
                        max_images: Optional[int] = None,
                        infer: Optional[InferOptions] = None) -> Dict[str, float]:
    """FlyingThings3D TEST split, MADNet2 conventions. ``infer=None`` is the
    per-image mode (one synchronous single-request stream a pair, timed
    without the decode); otherwise the batched stream, whose s/img is the
    wall time less the engine's captures, over the completed pairs."""
    global _last_engine
    ds = datasets.SceneFlowDatasets(dstype="frames_finalpass", things_test=True)
    n = len(ds) if max_images is None else min(max_images, len(ds))
    per_image = infer is None
    engine = make_mad_engine(model, fusion, infer or InferOptions(batch=1, prefetch=1))
    gts: Dict[int, tuple] = {}

    def decode(i):
        img1, img2, flow_gt, valid_gt = ds[i]
        gts[i] = (flow_gt, valid_gt)
        return (img1, img2) + ((flow_gt,) if fusion else ())

    by_index = {}

    def fold(res):
        i = res.payload
        if not res.ok:
            logger.warning("pair %s failed (%s: %s): excluded from metrics", i,
                           type(res.error).__name__, res.error)
            gts.pop(i, None)
            return
        flow_gt, valid_gt = gts.pop(i)
        disp = res.output[:, :, 0]
        epe = np.abs(disp - flow_gt[..., 0])
        val = (valid_gt >= 0.5) & (np.abs(flow_gt[..., 0]) < 192)
        if np.isnan(disp).any():
            # the reference counts a NaN image, averages in a zero EPE and
            # still pools its outlier mask (evaluate_mad.py:152-158)
            by_index[i] = (0.0, (epe > 1.0)[val], True)
        else:
            by_index[i] = (epe[val].mean(), (epe > 1.0)[val], False)

    if per_image:
        elapsed = []
        for i in range(n):
            try:
                inputs = decode(i)  # outside the timed window, as the reference
            except Exception as e:  # noqa: BLE001 — counted, the run goes on
                logger.warning("pair %d decode failed (%s): skipped", i, e)
                engine.stats.failed += 1
                telemetry.emit("request_failed", stage="decode", error=str(e)[:200])
                continue
            start = time.perf_counter()
            (res,) = engine.stream(iter([InferRequest(payload=i, inputs=inputs)]))
            elapsed.append(time.perf_counter() - start)
            fold(res)
        per_image_s = float(np.mean(elapsed)) if elapsed else float("nan")
    else:
        stream = make_stream(engine, infer)
        t0 = time.perf_counter()
        for res in stream(InferRequest(payload=i, inputs=lambda i=i: decode(i))
                          for i in range(n)):
            fold(res)
        serving_s = max(time.perf_counter() - t0 - engine.stats.compile_s, 0.0)
        per_image_s = serving_s / len(by_index) if by_index else float("nan")

    infer_mod.publish_summary(engine.stats, label="evaluate_mad")
    epe_list = [by_index[i][0] for i in sorted(by_index)]
    out_list = [by_index[i][1] for i in sorted(by_index)]
    res = {
        "things-epe": float(np.mean(epe_list)) if epe_list else float("nan"),
        "things-d1": 100 * float(np.concatenate(out_list).mean()) if out_list else float("nan"),
        "things-nans": sum(1 for i in by_index if by_index[i][2]),
    }
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "log.txt"), "a") as f:  # reference :171-173
        f.write(f"validate_things_mad: {res} ({per_image_s:.3f}s/img)\n")
    print(f"Validation FlyingThings (MAD): {res}")
    _last_engine = engine
    return res


def main(argv=None, device=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_ckpt", default=None,
                        help="a reference .pth, a JAX npz variables checkpoint or a "
                        "port checkpoint")
    parser.add_argument("--fusion", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--max_images", type=int, default=None)
    add_infer_args(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.cascade or args.tier is not None:
        raise SystemExit("evaluate_mad serves the MADNet2 model directly: it is the fast tier; "
                         "tiered and cascade serving (--tier/--cascade) are wired in evaluate, "
                         "demo and serve_adaptive")
    if args.adaptive_iters:
        raise SystemExit("evaluate_mad serves MADNet2, which has no refinement iterations to "
                         "adapt: --adaptive_iters is a RAFT-Stereo serving knob (evaluate, demo)")
    dev = resolve_device(device)
    # as the JAX CLI: the Fusion variant is built in fp32
    model = make_madnet2(mixed_precision=args.mixed_precision and not args.fusion,
                         fusion=args.fusion, seed=0)
    if args.restore_ckpt:
        load_mad_weights(model, args.restore_ckpt)
    model = model.to(dev)
    tel = infer_mod.install_cli_telemetry(args)
    end_introspection = infer_mod.install_cli_introspection(args)
    infer_mod.reset_summary()
    try:
        res = validate_things_mad(model, args.fusion, max_images=args.max_images,
                                  infer=options_from_args(args))
    finally:
        end_introspection()
        telemetry.uninstall(tel)
    infer_mod.enforce_failure_budget(args.max_failed_frac)
    return res


if __name__ == "__main__":
    main()

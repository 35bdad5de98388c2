"""Inference demo: glob left/right pairs → disparity PNG (jet) / .npy
(PyTorch port of ``raft_stereo_tpu/demo.py``).

    python -m raft_stereo_tpu_torch.demo -l 'left/*/im0.png' -r 'right/*/im1.png'

Runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
Pairs stream through the batched inference engine (``runtime.infer``):
shape-bucketed micro-batches, one CUDA graph per (bucket, batch) on the
card, each pair's decode on the engine's stager thread, where a pair that
fails to load fails alone and is logged and skipped. ``--per_image`` keeps
the synchronous one-pair loop (its forward captured once per shape on the
card). Each pair is padded to /32 and unpadded; outputs are named after the
left image's directory. ``--telemetry_dir`` writes the engine's events,
spans, heartbeat and latency metrics there (``runtime/telemetry.py``) and
arms the blackbox (SIGUSR2 dumps ``blackbox.json`` there).

``--tier``, ``--cascade`` (with ``--fast_ckpt``) and ``--controller`` serve
through the tiers of ``runtime/tiers.py`` and the overload controller, as
``evaluate.make_serving`` assembles them.

``--serve_video`` (with ``--adaptive_iters``) serves the sorted pairs as the
frames of one stereo video: one session of the ``SessionServer``, each
frame warm-started from the previous frame's disparity; with
``--converge_eps`` warm frames can leave the refinement loop early.
"""

from __future__ import annotations

import argparse
import glob
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional

import numpy as np

from raft_stereo_tpu_torch.config import apply_preset_defaults
from raft_stereo_tpu_torch.evaluate import add_model_args, load_model, make_forward, make_serving
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.pad import InputPadder
from raft_stereo_tpu_torch.runtime import infer as infer_mod
from raft_stereo_tpu_torch.runtime.infer import (
    GraphCache,
    InferenceEngine,
    InferRequest,
    add_infer_args,
    install_cli_telemetry,
    options_from_args,
)
from raft_stereo_tpu_torch.runtime import telemetry
from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

logger = logging.getLogger(__name__)


def load_image(path: str) -> np.ndarray:
    from PIL import Image  # image files go through Pillow, as in the JAX demo

    img = np.asarray(Image.open(path)).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[..., :3].astype(np.float32)[None]  # [1, H, W, 3]


def _colormap_jet(x: np.ndarray) -> np.ndarray:
    """Jet colormap without matplotlib: x in [0, 1] → RGB uint8."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def save_disparity_png(path: str, disp: np.ndarray) -> None:
    from PIL import Image

    lo, hi = np.nanmin(disp), np.nanmax(disp)
    scaled = (disp - lo) / max(hi - lo, 1e-6)
    Image.fromarray(_colormap_jet(scaled)).save(path)


@dataclass
class DemoRun:
    """What a demo run did: the model it ran, the pairs it saved; on the
    per-image path each pair's forward seconds (host clock, until the
    disparity reached the host), on the engine path each result's seconds
    since the previous one (the first: since the stream started) and each
    saved output's shape; the engine, on the engine path (in tiered and
    cascade runs the stand-in whose ``stats`` merge the tiers'); and the
    plain engine's or the per-image path's captured forwards (None where the
    forward ran eagerly, or several engines served)."""

    model: RAFTStereo
    saved: int = 0
    seconds: List[float] = field(default_factory=list)
    shapes: List[tuple] = field(default_factory=list)
    engine: Optional[Any] = None
    graphs: Optional[GraphCache] = None


def _save_result(out_dir: Path, imfile1: str, disp: np.ndarray, save_numpy: bool) -> None:
    stem = Path(imfile1).parent.name
    if save_numpy:
        np.save(out_dir / f"{stem}.npy", disp)
    save_disparity_png(str(out_dir / f"{stem}.png"), -disp)  # -flow under jet
    logger.info("%s -> %s.png  range [%.1f, %.1f]", imfile1, stem, disp.min(), disp.max())


def demo(args, device=None) -> DemoRun:
    model = load_model(args, device=device)
    out_dir = Path(args.output_directory)
    out_dir.mkdir(exist_ok=True, parents=True)
    left_images = sorted(glob.glob(args.left_imgs, recursive=True))
    right_images = sorted(glob.glob(args.right_imgs, recursive=True))
    print(f"Found {len(left_images)} images. Saving files to {out_dir}/")

    infer = options_from_args(args)
    if infer is None:
        forward = make_forward(model, args.valid_iters)
        run = DemoRun(model, graphs=forward.graphs)
        for imfile1, imfile2 in zip(left_images, right_images):
            image1, image2 = load_image(imfile1), load_image(imfile2)
            padder = InputPadder(image1.shape, divis_by=32)
            p1, p2 = padder.pad(image1, image2)
            t0 = time.perf_counter()
            disp = padder.unpad(forward(p1, p2))[0, :, :, 0].cpu().numpy()
            run.seconds.append(time.perf_counter() - t0)
            _save_result(out_dir, imfile1, disp, args.save_numpy)
            run.saved += 1
        return run

    # the plain engine, the --tier dispatcher, the --cascade server or the
    # --adaptive_iters assembly; ``serving.stats`` is the merged view
    serving, stream = make_serving(model, args.valid_iters, infer)
    plain = isinstance(serving, InferenceEngine)
    run = DemoRun(model, engine=serving, graphs=serving.graphs if plain and serving.capture
                  else None)

    def requests():
        for imfile1, imfile2 in zip(left_images, right_images):
            # decoded on the stager thread; a pair that fails to load fails alone
            req = InferRequest(payload=imfile1, inputs=lambda f1=imfile1, f2=imfile2: (
                load_image(f1)[0], load_image(f2)[0]))
            # --serve_video: the sorted pairs are one video, one session
            yield SchedRequest(req, session="video") if infer.video else req

    t_last = time.perf_counter()
    for res in stream(requests()):
        now = time.perf_counter()
        run.seconds.append(now - t_last)
        t_last = now
        if not res.ok:
            logger.error("FAILED %s: %s: %s", res.payload, type(res.error).__name__, res.error)
            continue
        _save_result(out_dir, res.payload, res.output[:, :, 0], args.save_numpy)
        run.shapes.append(tuple(res.output.shape))
        run.saved += 1
    stats = serving.stats  # one snapshot (a tiered run merges on each access)
    infer_mod.publish_summary(stats, label="demo")
    logger.info("engine: %d images in %d micro-batches over %d shape bucket(s), %d "
                "executable(s) compiled in %.2fs", stats.images, stats.batches,
                len(stats.buckets), stats.compiles, stats.compile_s)
    return run


def main(argv=None, device=None) -> DemoRun:
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    add_infer_args(parser)
    parser.add_argument("--save_numpy", action="store_true")
    parser.add_argument(
        "--serve_video", action="store_true",
        help="adaptive video serving (needs --adaptive_iters): the sorted left/right pairs "
        "are one stereo video; its frames serve in order through a session, each "
        "warm-started from the previous frame's disparity (forward_interpolate into "
        "flow_init); with --converge_eps warm frames can leave the refinement loop early")
    parser.add_argument("-l", "--left_imgs",
                        default="datasets/Middlebury/MiddEval3/testH/*/im0.png")
    parser.add_argument("-r", "--right_imgs",
                        default="datasets/Middlebury/MiddEval3/testH/*/im1.png")
    parser.add_argument("--output_directory", default="demo_output")
    parser.add_argument("--fast_ckpt", default=None, metavar="CKPT",
                        help="the MADNet2 fast tier of --tier fast / --cascade: a reference "
                        ".pth, a JAX npz variables checkpoint or a port checkpoint "
                        "(default: seeded weights)")
    apply_preset_defaults(parser, argv)
    args = parser.parse_args(argv)
    if args.serve_video and (not args.adaptive_iters or args.per_image):
        raise SystemExit("--serve_video needs the batched adaptive path: pass "
                         "--adaptive_iters (and drop --per_image)")
    logging.basicConfig(level=logging.INFO)
    infer_mod.reset_summary()
    tel = install_cli_telemetry(args)
    end_introspection = infer_mod.install_cli_introspection(args)
    try:
        run = demo(args, device=device)
    finally:
        end_introspection()
        telemetry.uninstall(tel)
    infer_mod.enforce_failure_budget(args.max_failed_frac)
    return run


if __name__ == "__main__":
    main()

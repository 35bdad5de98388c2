"""Inference demo: glob left/right pairs → disparity PNG (jet) / .npy
(PyTorch port of ``raft_stereo_tpu/demo.py``'s one-pair-at-a-time loop).

    python -m raft_stereo_tpu_torch.demo -l 'left/*/im0.png' -r 'right/*/im1.png'

Runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
Each pair is padded to /32, run through the test-mode forward and unpadded;
outputs are named after the left image's directory.
"""

from __future__ import annotations

import argparse
import glob
import logging
import time
from pathlib import Path
from typing import List

import numpy as np

from raft_stereo_tpu_torch.config import apply_preset_defaults
from raft_stereo_tpu_torch.evaluate import add_model_args, load_model, make_forward
from raft_stereo_tpu_torch.ops.pad import InputPadder

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


def demo(args, device=None) -> List[float]:
    """Runs every pair; returns each pair's forward seconds (host clock,
    ending when the disparity has reached the host)."""
    model = load_model(args, device=device)
    forward = make_forward(model, args.valid_iters)
    out_dir = Path(args.output_directory)
    out_dir.mkdir(exist_ok=True, parents=True)
    left_images = sorted(glob.glob(args.left_imgs, recursive=True))
    right_images = sorted(glob.glob(args.right_imgs, recursive=True))
    print(f"Found {len(left_images)} images. Saving files to {out_dir}/")

    seconds = []
    for imfile1, imfile2 in zip(left_images, right_images):
        image1, image2 = load_image(imfile1), load_image(imfile2)
        padder = InputPadder(image1.shape, divis_by=32)
        p1, p2 = padder.pad(image1, image2)
        t0 = time.perf_counter()
        disp = forward(p1, p2)
        disp = padder.unpad(disp)[0, :, :, 0].cpu().numpy()
        seconds.append(time.perf_counter() - t0)
        stem = Path(imfile1).parent.name
        if args.save_numpy:
            np.save(out_dir / f"{stem}.npy", disp)
        save_disparity_png(str(out_dir / f"{stem}.png"), -disp)  # -flow under jet
        logger.info("%s -> %s.png  range [%.1f, %.1f]", imfile1, stem, disp.min(), disp.max())
    return seconds


def main(argv=None, device=None) -> List[float]:
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.add_argument("--save_numpy", action="store_true")
    parser.add_argument("-l", "--left_imgs",
                        default="datasets/Middlebury/MiddEval3/testH/*/im0.png")
    parser.add_argument("-r", "--right_imgs",
                        default="datasets/Middlebury/MiddEval3/testH/*/im1.png")
    parser.add_argument("--output_directory", default="demo_output")
    apply_preset_defaults(parser, argv)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return demo(args, device=device)


if __name__ == "__main__":
    main()

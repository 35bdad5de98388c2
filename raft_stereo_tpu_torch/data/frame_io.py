"""Image, disparity and flow file IO on the host, in numpy (the port's own
copy of the readers of ``raft_stereo_tpu/data/frame_io.py`` that the
evaluation and training sets use, Middlebury's ``.flo`` flow, and the
writers its tests and smoke run need).

Disparities come back as float32 [H, W], valid masks as bool [H, W], flow as
float32 [H, W, 2]. PNGs,
16-bit ones included, go through Pillow. A transient storage error (an
``OSError``) is retried ``RAFT_IO_RETRIES`` times (default ``IO_RETRIES``)
after ``RAFT_IO_BACKOFF`` seconds (default ``IO_BACKOFF_S``), doubled at
each attempt, with an ``io_retry`` event each time;
``RAFT_FI_IO_FAIL_READS`` plants such errors (``runtime/faultinject.py``).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import re
import time
from typing import Tuple

import numpy as np
from PIL import Image, UnidentifiedImageError

from raft_stereo_tpu_torch.runtime import faultinject, telemetry

logger = logging.getLogger(__name__)

# A Middlebury .flo file's first four bytes, as a little-endian float32.
FLO_MAGIC = 202021.25

# The defaults of RAFT_IO_RETRIES and RAFT_IO_BACKOFF.
IO_RETRIES = 2
IO_BACKOFF_S = 0.05


def _io_retries() -> int:
    return int(os.environ.get("RAFT_IO_RETRIES", IO_RETRIES))


def _io_backoff() -> float:
    return float(os.environ.get("RAFT_IO_BACKOFF", IO_BACKOFF_S))


def with_io_retry(fn):
    """Retry ``fn(path, ...)`` on OSError with exponential backoff. A
    missing file or content Pillow cannot parse fails at once: retrying
    would not heal it."""

    @functools.wraps(fn)
    def wrapper(path, *args, **kwargs):
        retries = _io_retries()
        for attempt in range(retries + 1):
            try:
                faultinject.maybe_fail_io(path)
                return fn(path, *args, **kwargs)
            except (FileNotFoundError, UnidentifiedImageError):
                raise
            except OSError as e:
                if attempt == retries:
                    raise
                delay = _io_backoff() * 2 ** attempt
                logger.warning("transient IO error reading %s (attempt %d/%d): %s; "
                               "retrying in %.2fs", path, attempt + 1, retries + 1, e, delay)
                telemetry.emit("io_retry", path=str(path), attempt=attempt + 1,
                               error=f"{type(e).__name__}: {e}")
                time.sleep(delay)

    return wrapper


@with_io_retry
def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo optical flow → [H, W, 2] float32 (little-endian); a
    file without the magic raises ``ValueError``."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """[H, W, 2] flow as a Middlebury .flo file."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"write_flo writes [H, W, 2] flow, got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


@with_io_retry
def read_pfm(path: str) -> np.ndarray:
    """PFM → [H, W] or [H, W, 3] float32, flipped from bottom-up to top-down."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims {dims!r}")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape))


def write_pfm(path: str, array: np.ndarray) -> None:
    """A grayscale [H, W] array as little-endian PFM."""
    if array.ndim != 2:
        raise ValueError(f"write_pfm writes [H, W] arrays, got {array.shape}")
    h, w = array.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n%d %d\n-1\n" % (w, h))
        f.write(np.flipud(array).astype("<f4").tobytes())


@with_io_retry
def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit disparity PNG: disp = png / 256, valid where > 0."""
    disp = np.array(Image.open(path)).astype(np.float32) / 256.0
    return disp, disp > 0.0


def write_disp_kitti(path: str, disp: np.ndarray) -> None:
    """[H, W] disparity as a KITTI 16-bit PNG (round(disp * 256))."""
    Image.fromarray(np.round(np.asarray(disp) * 256.0).astype(np.uint16)).save(path)


@with_io_retry
def read_disp_sintel(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel packed-RGB disparity; valid from the paired occlusion mask."""
    a = np.array(Image.open(path)).astype(np.float64)
    disp = a[..., 0] * 4 + a[..., 1] / 2 ** 6 + a[..., 2] / 2 ** 14
    mask = np.array(Image.open(path.replace("disparities", "occlusions")))
    return disp.astype(np.float32), (mask == 0) & (disp > 0)


@with_io_retry
def read_disp_falling_things(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """FallingThings depth PNG → disparity via fx from _camera_settings.json."""
    a = np.array(Image.open(path))
    with open(os.path.join(os.path.dirname(path), "_camera_settings.json")) as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / a.astype(np.float32)
    return disp, disp > 0


@with_io_retry
def read_disp_tartanair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TartanAir .npy depth → disparity = 80/depth."""
    disp = 80.0 / np.load(path)
    return disp.astype(np.float32), disp > 0


@with_io_retry
def read_disp_middlebury(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Middlebury ground truth (disp0GT.pfm beside mask0nocc.png, valid where
    the mask is 255) or an estimate (disp0.pfm, valid below 1e3)."""
    disp = read_pfm.__wrapped__(path).astype(np.float32)
    if os.path.basename(path) == "disp0GT.pfm":
        if disp.ndim != 2:
            raise ValueError(f"{path}: expected a grayscale PFM, got {disp.shape}")
        nocc = path.replace("disp0GT.pfm", "mask0nocc.png")
        return disp, np.array(Image.open(nocc)) == 255
    return disp, disp < 1e3


@with_io_retry
def read_gen(path: str):
    """Reader by extension: images as PIL images, ``.npy``/``.bin``/``.raw``
    as arrays, ``.flo`` as float32 [H, W, 2], PFM as float32 (the first two
    channels of a colour one)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return Image.open(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flo.__wrapped__(path).astype(np.float32)
    if ext == ".pfm":
        data = read_pfm.__wrapped__(path).astype(np.float32)
        return data if data.ndim == 2 else data[:, :, :-1]
    return []

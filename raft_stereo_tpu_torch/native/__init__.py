"""ctypes binding of the host kernels in ``native/augment.cpp``: the fused
photometric chain and the eraser fill of the training augmentor.

The library is built at first use with the host C++ compiler into
``build/raft_stereo_tpu_torch/`` at the root of the checkout, under a name
that carries the hash of the source, the flags (the JAX package's flags,
so both compile the same code the same way), the compiler's path and
version and the host's machine and C library. A library under that name
that does not load is built anew, once. Without a compiler the first use
raises: there is no numpy fallback, whose rounding differs. Nothing is
built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from raft_stereo_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (g++, c++ or clang++, or $CXX): the "
                       "augmentor's native photometric kernels need one")


def lib_path(cxx: Optional[str] = None) -> Path:
    """The library's name for compiler ``cxx`` (default: the one found)."""
    cxx = cxx or _compiler()
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    version = (proc.stdout.splitlines() or [""])[0]
    host = "\0".join((cxx, version, platform.machine(), *platform.libc_ver()))
    h = hashlib.sha256("\0".join((host, " ".join(CXX_FLAGS))).encode() + b"\0"
                       + SOURCE.read_bytes())
    return BUILD_DIR / f"augment-{h.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _compiler()
        out = lib_path(cxx)
        if not out.exists():
            _build(cxx, out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _build(cxx, out)  # a library left by another host: build it anew, once
            lib = ctypes.CDLL(str(out))
        lib.fused_photometric.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.eraser_fill.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        _lib = lib
        return lib


def fused_photometric(img: np.ndarray, brightness: float, contrast: float, saturation: float,
                      hue_shift_deg: float, gamma: float = 1.0, gain: float = 1.0) -> np.ndarray:
    """Fused colour jitter on a contiguous [H, W, 3] u8 image, in place
    (returned)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"fused_photometric takes [H, W, 3] uint8, got {img.dtype} {img.shape}")
    lib = _load()
    img = np.ascontiguousarray(img)
    lib.fused_photometric(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          img.shape[0] * img.shape[1], brightness, contrast, saturation,
                          hue_shift_deg, gamma, gain)
    return img


def eraser_fill(img: np.ndarray, mean_color: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """In-place rectangle fill of a contiguous [H, W, 3] u8 image; rects
    [N, 4] int64 (x0, y0, dx, dy)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"eraser_fill takes [H, W, 3] uint8, got {img.dtype} {img.shape}")
    if not img.flags.c_contiguous:
        raise ValueError("eraser_fill fills in place: img must be C-contiguous")
    lib = _load()
    mc = np.ascontiguousarray(mean_color, np.float32)
    rc = np.ascontiguousarray(rects, np.int64)
    lib.eraser_fill(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.shape[0],
                    img.shape[1], mc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(rc))
    return img

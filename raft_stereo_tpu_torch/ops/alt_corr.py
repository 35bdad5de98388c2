"""Alt-correlation lookup through the hand-written CUDA kernel
``csrc/alt_corr.cu`` (the port of ``raft_stereo_tpu/ops/pallas_corr.py``).

``corr_lookup_alt`` takes the JAX layout: fmap1 [B, H, W1, D], the pooled
pyramid fmap2_pyramid[i] [B, H, W2_i, D], coords_x [B, H, W1], and returns
[B, H, W1, L·(2r+1)] level-major in fp32. On CPU tensors it computes the
plain version ``ops.corr.corr_lookup_alt_plain``; on CUDA tensors it
launches the kernel or raises. Inference only: there is no backward yet.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from raft_stereo_tpu_torch.ops import _build
from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

KERNEL = "alt_corr"
MAX_LEVELS = 8
RADII = (1, 2, 3, 4)
MAX_D = 512

# Kernel launches since the count was last set to 0.
LAUNCHES = 0

_fn = None


def _kernel():
    """The bound C entry point, built and loaded at first use."""
    global _fn
    if _fn is None:
        _fn = _bind(_build.load(KERNEL))
    return _fn


def _bind(lib: ctypes.CDLL):
    fn = lib.alt_corr_lookup
    fn.argtypes = [
        ctypes.c_void_p,  # f1
        ctypes.POINTER(ctypes.c_void_p),  # host array of level pointers
        ctypes.POINTER(ctypes.c_int),  # host array of level widths
        ctypes.c_int,  # levels
        ctypes.c_void_p,  # coords
        ctypes.c_void_p,  # out
        ctypes.c_int,  # rows = B*H
        ctypes.c_int,  # W1
        ctypes.c_int,  # D
        ctypes.c_int,  # radius
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(fmap1: torch.Tensor, pyramid: Sequence[torch.Tensor],
           coords_x: torch.Tensor, radius: int) -> None:
    if fmap1.dim() != 4:
        raise ValueError(f"fmap1 must be [B, H, W1, D], got {tuple(fmap1.shape)}")
    B, H, W1, D = fmap1.shape
    if fmap1.numel() == 0:
        raise ValueError(f"alt_corr got an empty fmap1 {tuple(fmap1.shape)}")
    if D % 4 or D > MAX_D:
        raise ValueError(f"alt_corr kernel needs D % 4 == 0 and D <= {MAX_D}, got D={D}")
    if radius not in RADII:
        raise ValueError(f"alt_corr kernel supports radius in {RADII}, got {radius}")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"alt_corr kernel takes 1..{MAX_LEVELS} levels, got {len(pyramid)}")
    if tuple(coords_x.shape) != (B, H, W1):
        raise ValueError(f"coords_x must be {(B, H, W1)}, got {tuple(coords_x.shape)}")
    for t in (fmap1, coords_x, *pyramid):
        if t.device != fmap1.device:
            raise ValueError(f"alt_corr inputs on different devices: {t.device} vs {fmap1.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"alt_corr kernel takes float32, got {t.dtype}")
    for i, f2 in enumerate(pyramid):
        if f2.dim() != 4 or tuple(f2.shape[:2]) != (B, H) or f2.shape[3] != D:
            raise ValueError(f"pyramid level {i} must be [{B}, {H}, W2, {D}], got {tuple(f2.shape)}")
        if f2.shape[2] < 1:
            raise ValueError(f"pyramid level {i} is empty")


def corr_lookup_alt(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                    coords_x: torch.Tensor, radius: int) -> torch.Tensor:
    """Streaming recompute-at-offsets lookup (see the module docstring)."""
    global LAUNCHES
    if fmap1.device.type == "cpu":
        return corr_lookup_alt_plain(fmap1, fmap2_pyramid, coords_x, radius)
    if fmap1.device.type != "cuda":
        raise ValueError(f"alt_corr runs on CPU or CUDA tensors, not {fmap1.device}")
    _check(fmap1, fmap2_pyramid, coords_x, radius)
    # Pooled levels and sliced coordinates may be strided views: the
    # kernel indexes dense rows.
    f1 = fmap1.contiguous()
    levels = [f.contiguous() for f in fmap2_pyramid]
    coords = coords_x.contiguous()
    for t in (f1, *levels):
        if t.data_ptr() % 16:
            raise ValueError("alt_corr kernel needs 16-byte aligned feature rows")
    B, H, W1, D = f1.shape
    L = len(levels)
    out = torch.empty((B, H, W1, L * (2 * radius + 1)), dtype=torch.float32, device=f1.device)
    fn = _kernel()
    ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in levels])
    widths = (ctypes.c_int * L)(*[t.shape[2] for t in levels])
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), ptrs, widths, L, coords.data_ptr(), out.data_ptr(),
                 B * H, W1, D, radius, stream)
    if err != 0:
        raise RuntimeError(f"alt_corr kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

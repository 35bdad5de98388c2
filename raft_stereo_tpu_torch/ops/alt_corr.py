"""Alt-correlation lookup through the hand-written CUDA kernel
``csrc/alt_corr.cu`` (the port of ``raft_stereo_tpu/ops/pallas_corr.py``).

``corr_lookup_alt`` takes the JAX layout: fmap1 [B, H, W1, D], the pooled
pyramid fmap2_pyramid[i] [B, H, W2_i, D], coords_x [B, H, W1], and returns
[B, H, W1, L·(2r+1)] level-major in fp32. On CPU tensors it computes the
plain version ``ops.corr.corr_lookup_alt_plain``; on CUDA tensors it
launches the kernel or raises.

Gradients follow the JAX custom VJP (``pallas_corr.py:174-198``): the
forward is the kernel, the backward (:func:`alt_lookup_vjp`) recomputes
through the plain version one level at a time and gives gradients to
fmap1 and to every pyramid level; the coordinate gradient is zero (the
model detaches the flow each iteration). On the CPU the plain version runs
with the coordinates detached, so both devices give that zero.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from raft_stereo_tpu_torch.ops import _build
from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

KERNEL = "alt_corr"
MAX_LEVELS = 8
RADII = (1, 2, 3, 4)
SEGMENT = 256  # most pixels of a row one block serves (one thread each)
# Channels staged a step, widest first: at 32 a staged row is one 128-byte
# line of the banks, which the kernel reads without bank conflicts.
CHUNKS = (32, 16, 8, 4)
SMEM = 227 * 1024  # the most dynamic shared memory a block may opt into

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
        ctypes.c_int,  # seg: pixels a segment
        ctypes.c_int,  # threads a block
        ctypes.c_int,  # dc: channels a chunk
        ctypes.c_int,  # dynamic shared memory a block, bytes
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


class Geometry(NamedTuple):
    """How the kernel covers a lookup: one block for each (image row, level,
    segment of a row), ``threads`` a block (one a pixel), channels staged
    ``dc`` at a time in ``chunks`` steps (the last partial where ``dc``
    does not divide D), ``smem`` bytes of dynamic shared memory a block
    (two stages of the segment's f1 rows and the widest level's row)."""

    segments: int
    seg: int
    threads: int
    dc: int
    chunks: int
    smem: int
    blocks: int


def launch_geometry(rows: int, W1: int, widths: Sequence[int], D: int) -> Geometry:
    """The launch of one lookup over ``rows`` = B·H image rows of W1 pixels,
    pyramid levels of ``widths`` positions and D channels: the widest chunk
    of CHUNKS no wider than D for which two stages of the widest level row
    and a segment of at least 32 pixels (or the whole row) fit in SMEM,
    with segments of at most SEGMENT pixels, as few and as even as fit.
    Raises ValueError where a level row is too wide for even that."""
    w2 = max(widths)
    for dc in CHUNKS:
        room = SMEM // (8 * dc) - w2  # f1 rows beside the level row, two stages
        if dc > D or room < min(W1, 32):
            continue
        segments = -(-W1 // min(SEGMENT, room))
        seg = -(-W1 // segments)
        return Geometry(segments, seg, -(-seg // 32) * 32, dc, -(-D // dc),
                        8 * dc * (seg + w2), rows * len(widths) * segments)
    raise ValueError(
        f"alt_corr kernel stages a whole level row of {w2} positions and at least "
        f"{min(W1, 32)} pixels of f1 in shared memory: at {CHUNKS[-1]} channels a step that "
        f"needs more than the {SMEM} bytes a block can have (level rows of up to "
        f"{SMEM // (8 * CHUNKS[-1]) - min(W1, 32)} positions)")


def _check(fmap1: torch.Tensor, pyramid: Sequence[torch.Tensor],
           coords_x: torch.Tensor, radius: int) -> None:
    if fmap1.dim() != 4:
        raise ValueError(f"fmap1 must be [B, H, W1, D], got {tuple(fmap1.shape)}")
    B, H, W1, D = fmap1.shape
    if fmap1.numel() == 0:
        raise ValueError(f"alt_corr got an empty fmap1 {tuple(fmap1.shape)}")
    if D % 4:
        raise ValueError(f"alt_corr kernel needs D % 4 == 0, got D={D}")
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


def alt_lookup_vjp(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                   coords_x: torch.Tensor, radius: int, grad: torch.Tensor):
    """The lookup's backward: ``(d fmap1, [d level_i], d coords_x = 0)``
    for the output gradient ``grad`` [B, H, W1, L·(2r+1)]. Each level is
    recomputed through the plain version at coordinates ``coords_x / 2^i``
    and differentiated on its own, so its gathered rows are freed before
    the next level's are built."""
    K = 2 * radius + 1
    coords = coords_x.detach()
    df1, dlevels = None, []
    for lvl, f2 in enumerate(fmap2_pyramid):
        with torch.enable_grad():
            a = fmap1.detach().requires_grad_(True)
            b = f2.detach().requires_grad_(True)
            out = corr_lookup_alt_plain(a, [b], coords / 2 ** lvl, radius)
            da, db = torch.autograd.grad(out, (a, b), grad[..., lvl * K:(lvl + 1) * K])
        df1 = da if df1 is None else df1 + da
        dlevels.append(db)
    return df1, dlevels, torch.zeros_like(coords_x)


class _AltLookup(torch.autograd.Function):
    """The kernel forward with :func:`alt_lookup_vjp` as its backward."""

    @staticmethod
    def forward(ctx, radius, coords_x, fmap1, *levels):
        ctx.radius = radius
        ctx.save_for_backward(coords_x, fmap1, *levels)
        return _launch(fmap1, levels, coords_x, radius)

    @staticmethod
    def backward(ctx, grad):
        coords_x, fmap1, *levels = ctx.saved_tensors
        df1, dlevels, dcoords = alt_lookup_vjp(fmap1, levels, coords_x, ctx.radius, grad)
        return (None, dcoords if ctx.needs_input_grad[1] else None, df1, *dlevels)


def corr_lookup_alt(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                    coords_x: torch.Tensor, radius: int) -> torch.Tensor:
    """Streaming recompute-at-offsets lookup (see the module docstring)."""
    if fmap1.device.type == "cpu":
        return corr_lookup_alt_plain(fmap1, fmap2_pyramid, coords_x.detach(), radius)
    if fmap1.device.type != "cuda":
        raise ValueError(f"alt_corr runs on CPU or CUDA tensors, not {fmap1.device}")
    _check(fmap1, fmap2_pyramid, coords_x, radius)
    return _AltLookup.apply(radius, coords_x, fmap1, *fmap2_pyramid)


def _launch(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
            coords_x: torch.Tensor, radius: int) -> torch.Tensor:
    """The Function's forward: one launch of the kernel on checked CUDA inputs."""
    global LAUNCHES
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
    widths = [t.shape[2] for t in levels]
    geo = launch_geometry(B * H, W1, widths, D)
    out = torch.empty((B, H, W1, L * (2 * radius + 1)), dtype=torch.float32, device=f1.device)
    fn = _kernel()
    ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in levels])
    c_widths = (ctypes.c_int * L)(*widths)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), ptrs, c_widths, L, coords.data_ptr(), out.data_ptr(),
                 B * H, W1, D, radius, geo.seg, geo.threads, geo.dc, geo.smem, stream)
    if err != 0:
        raise RuntimeError(f"alt_corr kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

"""The packed stage's 3x3x64 conv through the hand-written CUDA kernel
``csrc/packed_conv.cu`` (the port of
``raft_stereo_tpu/experiments/pallas_packed_conv.py``).

The public functions keep the JAX package's phase-packed layout: an
activation ``xp`` is [B, H, W/2, 128] with lane = (w parity, channel),
which is a free view of channels-last [B, 64, H, W] storage
(:func:`pack_x`, :func:`unpack_x`). :func:`packed_conv3x3` takes the conv's
own weight as HWIO [3, 3, 64, 64] in the input's dtype, the JAX conv
layout, not the TPU's packed one (:func:`pack_weight` makes it from a
torch [64, 64, 3, 3] weight, once a forward), and an optional prologue: a
per-(batch, lane) affine ``x·scale + shift``, then relu if asked, applied
before the SAME padding's zeros. ``scale``/``shift`` are [B, 128] in the
packed lane order, or [B, 64], which is tiled to both parities.

On CPU tensors it computes the plain version :func:`packed_conv3x3_plain`;
on CUDA tensors it launches the kernel or raises. Inference only: there is
no backward yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch.ops import _build

KERNEL = "packed_conv"
CHANNELS = 64
DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the count was last set to 0.
LAUNCHES = 0

_fn = None


def pack_x(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] → [B, H, W/2, 2C], a view (raises unless W is
    even and the storage is dense NHWC)."""
    B, H, W, C = x.shape
    if W % 2:
        raise ValueError(f"W must be even to phase-pack, got {W}")
    return x.view(B, H, W // 2, 2 * C)


def unpack_x(xp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_x`, a view: [B, H, W/2, 2C] → [B, H, W, C]."""
    B, H, W2, C2 = xp.shape
    return xp.view(B, H, 2 * W2, C2 // 2)


def choose_band(H: int, W2: int) -> int:
    """The TPU kernel's row band for an [*, H, W2, 128] activation (the
    port's copy of the JAX package's ``choose_band``). The port's kernel
    tiles its own way; the band decides only the gate of the packed stage
    (``experiments.packed_encoder.packable``)."""
    budget = 10000
    for th in (34, 32, 17, 16, 8, 4, 2):
        if H % th == 0 and th * W2 <= budget:
            return th
    return 1


def pack_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A torch conv weight [64, 64, 3, 3] (OIHW) → HWIO [3, 3, 64, 64] in
    ``dtype``, the layout the kernel reads as [9 taps][cin][cout] (one
    copy)."""
    w = weight.detach()
    out = torch.empty((3, 3, w.shape[1], w.shape[0]), dtype=dtype, device=w.device)
    return out.copy_(w.permute(2, 3, 1, 0))


def _lanes(v: torch.Tensor, B: int, name: str) -> torch.Tensor:
    """[B, 64] or [B, 128] → [B, 128] in the packed lane order."""
    if v.dim() != 2 or v.shape[0] != B or v.shape[1] not in (CHANNELS, 2 * CHANNELS):
        raise ValueError(f"{name} must be [{B}, 64] or [{B}, 128], got {tuple(v.shape)}")
    return torch.cat([v, v], dim=1) if v.shape[1] == CHANNELS else v


def _check(xp, weight, scale, shift, relu_prologue) -> None:
    if xp.dim() != 4 or xp.shape[-1] != 2 * CHANNELS:
        raise ValueError(f"packed_conv3x3 takes xp [B, H, W/2, 128] (C = 64), "
                         f"got {tuple(xp.shape)}")
    if xp.numel() == 0:
        raise ValueError(f"packed_conv3x3 got an empty xp {tuple(xp.shape)}")
    if xp.dtype not in DTYPES:
        raise TypeError(f"packed_conv3x3 computes in {DTYPES}, got {xp.dtype}")
    if tuple(weight.shape) != (3, 3, CHANNELS, CHANNELS):
        raise ValueError(f"weight must be HWIO [3, 3, 64, 64], got {tuple(weight.shape)}")
    if weight.dtype != xp.dtype:
        raise TypeError(f"weight is {weight.dtype}, xp {xp.dtype} (see pack_weight)")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if relu_prologue and scale is None:
        raise ValueError("relu_prologue needs scale and shift")
    for name, t in (("weight", weight), ("scale", scale), ("shift", shift)):
        if t is not None and t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")


def prologue(xp, scale, shift, relu_prologue):
    """The plain prologue: x·scale, + shift, relu, each in xp's dtype
    (two roundings in bf16)."""
    B = xp.shape[0]
    s = _lanes(scale, B, "scale").to(xp.dtype)[:, None, None, :]
    t = _lanes(shift, B, "shift").to(xp.dtype)[:, None, None, :]
    x = xp * s + t
    return torch.relu(x) if relu_prologue else x


def packed_conv3x3_plain(xp: torch.Tensor, weight: torch.Tensor,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         relu_prologue: bool = False) -> torch.Tensor:
    """The plain version of the kernel: the prologue at its rounding
    points, zero padding after it, the conv of the dtype's values summed in
    fp32 (TF32 off), one rounding to the dtype at the output."""
    _check(xp, weight, scale, shift, relu_prologue)
    dt = xp.dtype
    x = xp if scale is None else prologue(xp, scale, shift, relu_prologue)
    B, H, W2, _ = x.shape
    xn = unpack_x(x.contiguous()).permute(0, 3, 1, 2).float()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xn, weight.detach().permute(3, 2, 0, 1).float().contiguous(), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return y.to(dt).permute(0, 2, 3, 1).reshape(B, H, W2, 2 * CHANNELS)


def _kernel():
    """The bound C entry point, built and loaded at first use."""
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL).packed_conv3x3
        fn.argtypes = [
            ctypes.c_int,  # bf16
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # w [9][64][64]
            ctypes.c_void_p,  # scale [B][128] or null
            ctypes.c_void_p,  # shift
            ctypes.c_int,  # relu
            ctypes.c_void_p,  # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def packed_conv3x3(xp: torch.Tensor, weight: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   relu_prologue: bool = False) -> torch.Tensor:
    """3x3 stride-1 SAME conv without bias on the packed layout, with the
    optional prologue (see the module docstring): [B, H, W/2, 128] in xp's
    dtype."""
    global LAUNCHES
    if xp.device.type == "cpu":
        return packed_conv3x3_plain(xp, weight, scale, shift, relu_prologue)
    if xp.device.type != "cuda":
        raise ValueError(f"packed_conv3x3 runs on CPU or CUDA tensors, not {xp.device}")
    _check(xp, weight, scale, shift, relu_prologue)
    dt = xp.dtype
    B, H, W2, _ = xp.shape
    x = xp.contiguous()
    taps = weight.detach().contiguous()
    s = t = None
    if scale is not None:
        s = _lanes(scale, B, "scale").to(dt).contiguous()
        t = _lanes(shift, B, "shift").to(dt).contiguous()
    out = torch.empty_like(x)
    for name, v in (("xp", x), ("weight", taps), ("scale", s), ("shift", t)):
        if v is not None and v.data_ptr() % 16:
            raise ValueError(f"packed_conv3x3 kernel needs 16-byte aligned {name}")
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(int(dt == torch.bfloat16), x.data_ptr(), taps.data_ptr(),
                 None if s is None else s.data_ptr(), None if t is None else t.data_ptr(),
                 int(relu_prologue), out.data_ptr(), B, H, 2 * W2, stream)
    if err != 0:
        raise RuntimeError(f"packed_conv3x3 kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

"""K1, the alt correlation lookup (``csrc/alt_corr.cu``): bytes and
operations of one call from its shapes, and the least time the card could
take for it.

The arithmetic of the port's kernel table (its bound for K1): each input
read once and the output written once, in float32: fmap1 [B, H, W1, D],
the W-pooled pyramid of fmap2 (levels of W1/2^l columns), the coordinates
[B, H, W1] and the output [B, H, W1, L·(2r+1)]. Operations: 2r+2 dot
products of D a pixel and level and the interpolation's 4 a tap, every
tap counted as inside the image (the count the kernel's in-image share
bounds from above). At these shapes the bytes bound the call.
"""

from __future__ import annotations

from portbench.counts import peaks


def call_bytes(b: int, h: int, w1: int, d: int, levels: int, radius: int) -> int:
    pyr = sum(w1 // 2 ** lvl for lvl in range(levels))
    k = 2 * radius + 1
    return 4 * (b * h * w1 * d + b * h * pyr * d + b * h * w1 + b * h * w1 * levels * k)


def call_flops(b: int, h: int, w1: int, d: int, levels: int, radius: int) -> int:
    k = 2 * radius + 1
    return b * h * w1 * levels * (2 * d * (2 * radius + 2) + 4 * k)


def call_bound_s(b: int, h: int, w1: int, d: int, levels: int, radius: int) -> float:
    """The larger of bytes over the HBM rate and operations over the fp32
    rate (the kernel computes in fp32)."""
    return max(call_bytes(b, h, w1, d, levels, radius) / peaks.HBM_BYTES_PER_S,
               call_flops(b, h, w1, d, levels, radius) / peaks.FP32_FLOPS)

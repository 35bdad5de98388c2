"""The MADNet2Fusion cross-attention (``models/attention.py``, one layer
at each of levels 2..6): operations and bytes of one level's layer from its
shapes, and the least time the card could take for it, whatever
implements it.

Operations: the logits q k^T and the weighted sum of the values, 2·C·W²
each a row of H (C = 5, one head): 4·C·W²·H a pair and level. The
projections, the norms and the softmax are left out, so the count is a
floor of the work. Bytes: the layer's inputs (the window and the guidance
features, [H, W, C] each) and its output, float32, each moved once, and
its parameters once a call. At these shapes the operations bound it: a
materialised W x W implementation moves far more, and a fused one need
not.
"""

from __future__ import annotations

from typing import Iterator, Tuple

from portbench.counts import peaks

CHANNELS = 5  # the window's taps: the attention's width
LEVELS = (2, 3, 4, 5, 6)
# LayerNorm (2 x 2C, norm2 loaded beside norm1), in_proj (3C x C + 3C),
# out_proj (C x C + C)
PARAMS = 2 * 2 * CHANNELS + 3 * CHANNELS * CHANNELS + 3 * CHANNELS + CHANNELS * CHANNELS + CHANNELS


def level_shapes(h: int, w: int) -> Iterator[Tuple[int, int]]:
    """(H, W) of each level's layer for a padded (h, w) input."""
    for k in LEVELS:
        yield h >> k, w >> k


def call_flops(b: int, h: int, w: int) -> int:
    return 4 * CHANNELS * w * w * h * b


def call_bytes(b: int, h: int, w: int) -> int:
    return 4 * (3 * b * h * w * CHANNELS + PARAMS)


def call_bound_s(b: int, h: int, w: int) -> float:
    """The larger of operations over the fp32 rate (the products run in
    float32) and bytes over the HBM rate."""
    return max(call_flops(b, h, w) / peaks.FP32_FLOPS, call_bytes(b, h, w) / peaks.HBM_BYTES_PER_S)


def forward_bound_s(b: int, h: int, w: int) -> float:
    """The five layers of one forward over ``b`` pairs at the padded shape
    (h, w), one after another."""
    return sum(call_bound_s(b, hk, wk) for hk, wk in level_shapes(h, w))


def forward_flops(b: int, h: int, w: int) -> int:
    return sum(call_flops(b, hk, wk) for hk, wk in level_shapes(h, w))

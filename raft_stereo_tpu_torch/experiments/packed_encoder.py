"""The packed encoder stage: stem, norm1, relu and layer1 of an encoder
trunk with layer1's four 3x3x64 convs through the CUDA kernel K3
(``experiments/packed_conv.py``); the port of
``raft_stereo_tpu/experiments/packed_encoder.py``.

The stage runs the trunk's own modules, so the parameters and their names
are the stock ones: a ``state_dict`` loads the same with the stage on or
off. What differs from the stock stage is only where layer1's convs run
and the layout: from the stem's output to the end of layer1 the
activation stays channels-last, which the kernel reads as the packed
[B, H, W/2, 128] view without a copy. The JAX package's packed stem
(space-to-depth) and packed norms were layout tricks for the TPU's 128
lanes with no Pallas kernel: here the stem is the stock conv and the norms
are ``models/layers.py``'s, applied to the same values (the JAX package's
tests/test_packed_encoder.py shows both are the stock math).

Layout copies: none on the model's path, whose forward hands the encoders
the images as channels-last views (the stock stage runs channels-last
too). An NCHW-contiguous input costs one copy into the stage (the
3-channel image to channels-last, so the stem's conv writes
channels-last) and one out of it (layer1's output back to NCHW).
"""

from __future__ import annotations

import torch

from raft_stereo_tpu_torch.experiments import packed_conv

# The JAX package's measured crossover of its layer1 kernel (packed
# positions H·W/2): the stage engages only at or below it.
PACKED_LAYER1_MAX_M = 130_000
PACKED_NORMS = ("batch", "instance", "none")


def packable(x: torch.Tensor, norm_fn: str, stem_stride: int) -> bool:
    """The JAX package's gate (``models/extractor.py:69-85``) for an NCHW
    trunk input: ``packable_hw`` at its H and W."""
    return packable_hw(*x.shape[-2:], norm_fn, stem_stride)


def packable_hw(H: int, W: int, norm_fn: str, stem_stride: int) -> bool:
    """The gate at an H x W trunk input: a norm with a packed variant, H and
    W divisible by twice the stem stride, and layer1's geometry within the
    crossover and the TPU kernel's band rule. The spatial tier asks it at
    the whole image's H, as the JAX gate sees the global array."""
    h1 = H // stem_stride
    w2 = W // (2 * stem_stride)
    return (
        norm_fn in PACKED_NORMS
        and H % (2 * stem_stride) == 0
        and W % (2 * stem_stride) == 0
        and h1 * w2 <= PACKED_LAYER1_MAX_M
        and packed_conv.choose_band(h1, w2) >= 8
    )


def conv3x3(conv, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (3x3, 64 → 64) on channels-last NCHW-shaped ``x`` through
    K3, then the bias added in x's dtype, as the JAX package's
    ``PackedConv3x3`` adds it (a second rounding in bf16). Each conv runs
    once a forward, so its weight is packed here, as the stock conv casts
    its own."""
    taps = packed_conv.pack_weight(conv.weight, x.dtype)
    yp = packed_conv.packed_conv3x3(packed_conv.pack_x(x.permute(0, 2, 3, 1)), taps)
    y = packed_conv.unpack_x(yp).permute(0, 3, 1, 2)
    return y + conv.bias.to(x.dtype)[:, None, None]


def _block(block, x: torch.Tensor) -> torch.Tensor:
    """A stride-1 64 → 64 ``ResidualBlock`` (no shortcut conv) on the
    packed stage's layout."""
    y = block.relu(block.norm1(conv3x3(block.conv1, x)))
    y = block.relu(block.norm2(conv3x3(block.conv2, y)))
    return block.relu(x + y)


def packed_stage(trunk, x: torch.Tensor) -> torch.Tensor:
    """conv1, norm1, relu1 and layer1 of ``trunk`` (an encoder of
    ``models/extractor.py``) on the NCHW-shaped input ``x``; returns
    layer1's output in x's layout, as the stock stage would."""
    layout = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
    y = trunk.conv1(x.contiguous(memory_format=torch.channels_last))
    # channels-last already where the conv follows its input's layout (a
    # no-op then); elementwise ops keep the layout from here on
    y = trunk.relu1(trunk.norm1(y.contiguous(memory_format=torch.channels_last)))
    for block in trunk.layer1:
        y = _block(block, y)
    return y.contiguous(memory_format=layout)

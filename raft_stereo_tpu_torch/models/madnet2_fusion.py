"""MADNet2Fusion: MADNet2 with proxy-disparity guidance fused into every
level's correlation window by cross-attention (PyTorch port of
``raft_stereo_tpu/models/madnet2_fusion.py``; the reference's
core/madnet2/madnet2_fusion.py).

A guidance encoder turns a proxy disparity (SGM output, rasterised LiDAR,
or the GT as an oracle, as the reference trainer uses it) into 5-channel
features at 1/4 .. 1/64, each divided by its level's disparity scale; each
level's 5-tap window is fused with its guidance before decoding. NCHW
inside, channel-last at ``MADNet2Fusion.forward``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.models.attention import TransformerCrossAttnLayer
from raft_stereo_tpu_torch.models.layers import Conv2d
from raft_stereo_tpu_torch.models.madnet2 import (
    LEVELS,
    DisparityDecoder,
    FeatureExtraction,
    _leaky,
    conv2d,
    decoder_cascade,
    decoder_channels,
)
from raft_stereo_tpu_torch.ops.sampling import avg_pool2x
from raft_stereo_tpu_torch.runtime import telemetry


def _guide_blocks(module: nn.Module, in_channels: int) -> None:
    cin = in_channels
    for i, ch in enumerate((64, 128), start=1):
        setattr(module, f"block{i}", nn.Sequential(
            conv2d(cin, ch, 3, 2), _leaky(), conv2d(ch, ch, 3, 1), _leaky()))
        cin = ch


class GuidanceEncoder(nn.Module):
    """1-channel proxy disparity → {k: 5-channel guidance at 1/2^k}, each
    divided by its level's disparity scale (reference
    submodule_fusion.py:33-89). NCHW."""

    def __init__(self, in_channels: int = 1):
        super().__init__()
        _guide_blocks(self, in_channels)
        for k in LEVELS:
            setattr(self, f"conv_{k}", conv2d(128, 5, 1))

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        y = self.block2(self.block1(x))
        outs = {2: self.conv_2(y)}
        for k, div in ((3, 4.0), (4, 8.0), (5, 16.0), (6, 32.0)):
            y = avg_pool2x(y)
            outs[k] = getattr(self, f"conv_{k}")(y) / div
        return outs


class GuidanceEncoderSmall(nn.Module):
    """The single-scale guidance variant (reference submodule_fusion.py:
    91-143; experimental there, standalone here). NCHW."""

    def __init__(self, in_channels: int = 1):
        super().__init__()
        _guide_blocks(self, in_channels)
        self.conv_out = Conv2d(128, 32, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.block2(self.block1(x)))


class FusionBlock(nn.Module):
    """1x1 channel mixing + LeakyReLU (reference submodule_fusion.py:144-160). NCHW."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1)
        self.act = _leaky()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x))


class MADNet2Fusion(nn.Module):
    """``forward(image2, image3, guide)`` → (disp2..disp6) as ``MADNet2``;
    ``guide`` is the [B, H, W, 1] proxy disparity at full resolution
    (reference madnet2_fusion.py:37-134). Marks as ``MADNet2`` does, with
    ``guidance`` after the pyramid and ``xattn{k}`` at each level."""

    def __init__(self, hidden_dim: int = 5, nhead: int = 1, mixed_precision: bool = False):
        super().__init__()
        self.mixed_precision = bool(mixed_precision)
        self.feature_extraction = FeatureExtraction()
        self.guidance_encoder = GuidanceEncoder()
        for k in LEVELS:
            setattr(self, f"cross_attn_layer_{k}", TransformerCrossAttnLayer(hidden_dim, nhead))
            setattr(self, f"decoder{k}", DisparityDecoder(decoder_channels(k)))

    def extra_repr(self) -> str:
        return f"mixed_precision={self.mixed_precision}"

    def forward(self, image2: torch.Tensor, image3: torch.Tensor, guide: torch.Tensor):
        dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        telemetry.mark("start")
        x = torch.cat([image2, image3], dim=0).to(dtype).permute(0, 3, 1, 2)
        both = self.feature_extraction(x)
        im2_fea = [t.chunk(2, dim=0)[0] for t in both]
        im3_fea = [t.chunk(2, dim=0)[1] for t in both]
        telemetry.mark("pyramid")
        enc = self.guidance_encoder(guide.to(dtype).permute(0, 3, 1, 2))
        guides = {k: v.float().permute(0, 2, 3, 1) for k, v in enc.items()}
        telemetry.mark("guidance")
        attns = {k: getattr(self, f"cross_attn_layer_{k}") for k in LEVELS}
        decoders = {k: getattr(self, f"decoder{k}") for k in LEVELS}
        return decoder_cascade(decoders, im2_fea, im3_fea, mad=False, dtype=dtype,
                               attns=attns, guides=guides)


__all__ = ["FusionBlock", "GuidanceEncoder", "GuidanceEncoderSmall", "MADNet2Fusion"]

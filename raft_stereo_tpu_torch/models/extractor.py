"""Feature and context encoders (PyTorch port of
``raft_stereo_tpu/models/extractor.py``), with the reference's module names.

Stride schedule keyed off ``downsample`` (conv1 strides iff downsample > 2,
layer2 iff > 1, layer3 iff > 0) and channel plan 64 → 64 → 96 → 128.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.models.layers import ResidualBlock, conv, make_norm


class _Trunk(nn.Module):
    """conv1 + norm1 + relu and three residual stages, shared by both
    encoders (a base class, so the parameter names stay the reference's)."""

    def __init__(self, norm_fn: str, downsample: int):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = conv(3, 64, 7, 1 + (downsample > 2))
        self.norm1 = make_norm(norm_fn, 64)
        self.relu1 = nn.ReLU()
        self.in_planes = 64
        self.layer1 = self._make_layer(64, 1)
        self.layer2 = self._make_layer(96, 1 + (downsample > 1))
        self.layer3 = self._make_layer(128, 1 + (downsample > 0))

    def _make_layer(self, dim: int, stride: int) -> nn.Sequential:
        layers = (
            ResidualBlock(self.in_planes, dim, self.norm_fn, stride),
            ResidualBlock(dim, dim, self.norm_fn, 1),
        )
        self.in_planes = dim
        return nn.Sequential(*layers)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu1(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_Trunk):
    """Residual CNN → ``output_dim`` features at 1/2^downsample (the fnet)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", downsample: int = 3):
        super().__init__(norm_fn, downsample)
        self.conv2 = conv(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.trunk(x))


class MultiBasicEncoder(_Trunk):
    """Context encoder: shared trunk + per-resolution output heads.

    ``output_dim`` holds one (dim32, dim16, dim08) triple per head. The
    1/64 branch (``layer5``, ``outputs32``) exists only when the model runs
    three GRU levels.
    """

    def __init__(self, output_dim: Sequence[Tuple[int, int, int]] = ((128, 128, 128),),
                 norm_fn: str = "batch", downsample: int = 3, num_layers: int = 3):
        super().__init__(norm_fn, downsample)
        self.num_layers = num_layers
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), conv(128, dim[2], 3))
            for dim in output_dim
        )
        if num_layers > 1:
            self.layer4 = self._make_layer(128, 2)
            self.outputs16 = nn.ModuleList(
                nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), conv(128, dim[1], 3))
                for dim in output_dim
            )
        if num_layers > 2:
            self.layer5 = self._make_layer(128, 2)
            self.outputs32 = nn.ModuleList(conv(128, dim[0], 3) for dim in output_dim)

    def forward(self, x: torch.Tensor, dual_inp: bool = False):
        """Returns (outputs08, outputs16, outputs32)[:num_layers], each a
        tuple over heads, plus the raw trunk features of the stacked pair
        when ``dual_inp`` (the heads then see only the first half)."""
        x = self.trunk(x)
        v = None
        if dual_inp:
            v = x
            x = x[: x.shape[0] // 2]
        outs = [tuple(head(x) for head in self.outputs08)]
        if self.num_layers > 1:
            y = self.layer4(x)
            outs.append(tuple(head(y) for head in self.outputs16))
        if self.num_layers > 2:
            z = self.layer5(y)
            outs.append(tuple(head(z) for head in self.outputs32))
        return (*outs, v) if dual_inp else tuple(outs)

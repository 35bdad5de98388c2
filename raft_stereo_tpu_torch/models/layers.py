"""Encoder building blocks: convs, norms and the residual unit (PyTorch port
of ``raft_stereo_tpu/models/layers.py``), with the reference's torch module
and parameter names.

Parameters stay fp32. Under mixed precision the activations are bf16 and a
conv casts its weights to the activation's dtype per call, as the JAX
package does with its bf16 compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> Conv2d:
    """torch ``Conv2d(padding=kernel // 2)``."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init, the JAX package's distributions: conv kernels
    kaiming-normal (fan_out, relu gain), conv biases 0, norm affine (1, 0),
    running statistics (0, 1)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            with torch.no_grad():
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm with eval semantics always: the reference freezes BN for
    all of training, so y = x·scale + shift from the running statistics.
    Scale and shift are formed in fp32 and applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class InstanceNorm(nn.Module):
    """torch InstanceNorm2d defaults (affine=False, eps 1e-5, no running
    statistics). Both moments come from one fp32 pass (E[x²] − E[x]²); the
    normalisation is applied in the input's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        msq = xf.square().mean(dim=(2, 3), keepdim=True)
        var = (msq - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + self.eps)
        return x * inv.to(x.dtype) + (-mean * inv).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(planes // 8) with fp32 statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def make_norm(kind: str, planes: int) -> nn.Module:
    if kind == "group":
        return GroupNorm(max(planes // 8, 1), planes)
    if kind == "batch":
        return FrozenBatchNorm(planes)
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs + norm/relu, with a strided 1x1 conv + norm shortcut
    iff stride != 1 or in_planes != planes. As in the reference, the
    shortcut norm is registered both as ``norm3`` and as ``downsample.1``.
    """

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3)
        self.relu = nn.ReLU()
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(conv(in_planes, planes, 1, stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)

"""Iterative update block: motion encoder + multi-level ConvGRU cascade
(PyTorch port of ``raft_stereo_tpu/models/update.py``), with the
reference's module names. Shapes are logical NCHW; the modules keep their
inputs' memory format. Under mixed precision the model's refinement
iteration gives them dense channels-last inputs only (``RAFTStereo._step``),
so the convs, cats and gate products all run on NHWC memory.

Stereo flow has no y component, so the loop carries only the x-flow
[B, 1, H, W]. The motion encoder feeds ``convf1`` the x channel alone and
the flow head computes only conv2's x channel: both equal the reference's
two-channel form with y = 0, whose parameters they keep.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from raft_stereo_tpu_torch.models.layers import Conv2d, conv
from raft_stereo_tpu_torch.ops.sampling import avg_pool2x, interp_bilinear


def _conv_x(m: nn.Conv2d, x: torch.Tensor, in_slice=slice(None), out_slice=slice(None)):
    """``m`` restricted to some input / output channels, in x's dtype."""
    w = m.weight[out_slice, in_slice].to(x.dtype)
    return F.conv2d(x, w, m.bias[out_slice].to(x.dtype), padding=m.padding)


class FlowHead(nn.Module):
    """conv3x3 → relu → conv3x3; returns only the x channel [B, 1, H, W]."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, output_dim: int = 2):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, output_dim, 3)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_x(self.conv2, self.relu(self.conv1(x)), out_slice=slice(0, 1))


class ConvGRU(nn.Module):
    """h' = (1-z)h + z·tanh(Wq[r·h, x] + cq), z = σ(Wz[h, x] + cz),
    r = σ(Wr[h, x] + cr); the context biases (cz, cr, cq) come precomputed."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel_size: int = 3):
        super().__init__()
        self.convz = conv(hidden_dim + input_dim, hidden_dim, kernel_size)
        self.convr = conv(hidden_dim + input_dim, hidden_dim, kernel_size)
        self.convq = conv(hidden_dim + input_dim, hidden_dim, kernel_size)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """Separable ConvGRU: a 1x5 GRU pass, then a 5x1 one, on h and the
    concatenated inputs (the JAX ``SepConvGRU``, ``models/update.py:197``;
    no model of either package builds one). No context biases."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}", Conv2d(cin, hidden_dim, k, padding=pad))

    def forward(self, h, *x_list):
        if not x_list:
            raise ValueError("SepConvGRU requires at least one input tensor")
        x = torch.cat(x_list, dim=1)
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    """(corr window, x-flow) → 128 motion channels laid out
    [126 conv, flow_x, 0], the reference's [out, flow] with y = 0."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1)
        self.convc1 = conv(cor_planes, 64, 1)
        self.convc2 = conv(64, 64, 3)
        self.convf1 = conv(2, 64, 7)
        self.convf2 = conv(64, 64, 3)
        self.conv = conv(64 + 64, 128 - 2, 3)

    def forward(self, flow_x: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(_conv_x(self.convf1, flow_x, in_slice=slice(0, 1)))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow_x, torch.zeros_like(flow_x)], dim=1)


class BasicMultiUpdateBlock(nn.Module):
    """GRU hierarchy with cross-scale state exchange, flow head and mask
    head (×0.25). ``net`` lists the hidden states finest first; ``inp`` the
    per-level (cz, cr, cq). Only the GRU levels the model runs are built.
    """

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), n_gru_layers: int = 3,
                 n_downsample: int = 2, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        self.n_gru_layers = n_gru_layers
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        enc_dim = 128
        self.gru08 = ConvGRU(hidden_dims[2], enc_dim + hidden_dims[1] * (n_gru_layers > 1))
        if n_gru_layers > 1:
            self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] * (n_gru_layers == 3) + hidden_dims[2])
        if n_gru_layers > 2:
            self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.flow_head = FlowHead(hidden_dims[2], hidden_dim=256, output_dim=2)
        factor = 2 ** n_downsample
        self.mask = nn.Sequential(
            conv(hidden_dims[2], 256, 3), nn.ReLU(), conv(256, factor * factor * 9, 1)
        )

    def forward(self, net: List[torch.Tensor], inp, corr: Optional[torch.Tensor] = None,
                flow_x: Optional[torch.Tensor] = None, iter08: bool = True,
                iter16: bool = True, iter32: bool = True, update: bool = True,
                with_mask: bool = True):
        net = list(net)
        if iter32:
            net[2] = self.gru32(net[2], *inp[2], avg_pool2x(net[1]))
        if iter16:
            if self.n_gru_layers > 2:
                net[1] = self.gru16(net[1], *inp[1], avg_pool2x(net[0]),
                                    interp_bilinear(net[2], net[1].shape[-2:]))
            else:
                net[1] = self.gru16(net[1], *inp[1], avg_pool2x(net[0]))
        if iter08:
            motion = self.encoder(flow_x, corr)
            if self.n_gru_layers > 1:
                net[0] = self.gru08(net[0], *inp[0], motion,
                                    interp_bilinear(net[1], net[0].shape[-2:]))
            else:
                net[0] = self.gru08(net[0], *inp[0], motion)
        if not update:
            return net
        delta_flow = self.flow_head(net[0])
        # only the final test-mode iteration needs the upsampling mask
        mask = 0.25 * self.mask(net[0]) if with_mask else None
        return net, mask, delta_flow

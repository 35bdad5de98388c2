"""Plain reference of RAFT-Stereo (Lipson et al., 3DV 2021) in float32.

A frozen, standalone copy of the architecture the benchmark measures,
written with plain ``torch`` operations: no kernel, no CUDA graph, no
batching, no mixed precision. It imports nothing of the program. Its
module and parameter names are the upstream model's (and so the
program's), so one state dict made by the benchmark loads into both.

Departures from the upstream code, each without effect on the values:

  * the correlation is the all-pairs volume of each level against the
    width-pooled right features (``reg``); the ``alt`` lookup of the
    program gives the same values from the pooled features directly;
  * the flow carries only its x channel (stereo: y is 0), so the motion
    encoder reads channel 0 of ``convf1`` and the flow head computes
    channel 0 of ``conv2``;
  * batch norm is frozen (running statistics), as in evaluation.

:func:`set_precision` selects how the model computes. The reference is
float32 throughout (run it under :func:`strict_fp32` on a GPU). The
convolutions may instead round their inputs and weights to ``"bf16"``
(and their outputs: the configurations' mixed precision) or to ``"fp8"``
(float8 e4m3 with one scale a tensor, products summed in float32); the
correlation volumes and their lookups, the flow state and the convex
upsampling may round to ``"bf16"``. The control puts every part one step
below what the configurations state: fp8 convolutions, the rest bf16.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn value


@contextlib.contextmanager
def strict_fp32():
    """Inside the block: matrix products in full float32 (TF32 off) and
    convolutions by PyTorch's own im2col and GEMM, not cuDNN, whose float32
    heuristics pick an FFT algorithm that launches ~33,000 GEMV kernels for
    some coarse-level shapes (a 3x3 conv of 256 to 128 channels at 124x180:
    240 ms against 0.7 ms; on an H100). The settings before it come back
    after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, back in
    float32; the gradient passes straight through."""
    xf = x.float()
    scale = xf.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return xf + (q - xf).detach()


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in float32; the gradient passes
    straight through."""
    xf = x.float()
    return xf + (xf.to(torch.bfloat16).float() - xf).detach()


class Conv2d(nn.Conv2d):
    """A convolution in the model's ``precision`` (set on every conv by
    :func:`set_precision`). ``in_channels_used`` reads the leading input
    channels only (the flow's x channel); ``out_channels_used`` keeps the
    leading output channels (the flow head's x channel). Inputs and
    weights go in dense (NCHW): on a permuted view or a sliced weight
    cuDNN's float32 path falls back to a per-row GEMV algorithm that is
    far slower."""

    precision = "fp32"
    out_channels_used: Optional[int] = None
    in_channels_used: Optional[int] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.in_channels_used is not None:
            w = w[:, : self.in_channels_used]
        x, w = x.float().contiguous(), w.float().contiguous()
        if self.precision == "fp8":
            x, w = round_fp8(x), round_fp8(w)
        elif self.precision == "bf16":
            x, w = round_bf16(x), round_bf16(w)
        y = F.conv2d(x, w, self.bias.float(), self.stride, self.padding)
        if self.precision == "bf16":
            y = round_bf16(y)
        return y if self.out_channels_used is None else y[:, : self.out_channels_used]


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)


def set_precision(model: "RAFTStereoReference", convs: str = "fp32",
                  state: str = "fp32") -> "RAFTStereoReference":
    """Every convolution in ``convs`` (fp32, bf16 or fp8); the correlation,
    the flow state and the upsampling in ``state`` (fp32 or bf16)."""
    if convs not in ("fp32", "bf16", "fp8") or state not in ("fp32", "bf16"):
        raise ValueError(f"no such precision: convs {convs!r}, state {state!r}")
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.precision = convs
    model.state_precision = state
    return model


class FrozenBatchNorm(nn.BatchNorm2d):
    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class InstanceNorm(nn.Module):
    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def make_norm(kind: str, planes: int) -> nn.Module:
    if kind == "batch":
        return FrozenBatchNorm(planes)
    if kind == "instance":
        return InstanceNorm()
    if kind == "group":
        return nn.GroupNorm(max(planes // 8, 1), planes)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3)
        self.norm1 = make_norm(norm, planes)
        self.norm2 = make_norm(norm, planes)
        if stride == 1 and cin == planes:
            self.downsample = None
        else:
            self.norm3 = make_norm(norm, planes)
            self.downsample = nn.Sequential(conv(cin, planes, 1, stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Trunk(nn.Module):
    """conv1, norm1 and three residual stages (strides from downsample)."""

    def __init__(self, norm: str, downsample: int):
        super().__init__()
        self.norm_kind = norm
        self.conv1 = conv(3, 64, 7, 1 + (downsample > 2))
        self.norm1 = make_norm(norm, 64)
        self.in_planes = 64
        self.layer1 = self._layer(64, 1)
        self.layer2 = self._layer(96, 1 + (downsample > 1))
        self.layer3 = self._layer(128, 1 + (downsample > 0))

    def _layer(self, dim: int, stride: int) -> nn.Sequential:
        blocks = (ResidualBlock(self.in_planes, dim, self.norm_kind, stride),
                  ResidualBlock(dim, dim, self.norm_kind, 1))
        self.in_planes = dim
        return nn.Sequential(*blocks)

    def trunk(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class FeatureEncoder(Trunk):
    def __init__(self, output_dim: int, downsample: int):
        super().__init__("instance", downsample)
        self.conv2 = conv(128, output_dim, 1)

    def forward(self, x):
        return self.conv2(self.trunk(x))


class ContextEncoder(Trunk):
    def __init__(self, hd: int, norm: str, downsample: int, num_layers: int):
        super().__init__(norm, downsample)
        self.num_layers = num_layers
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm, 1), conv(128, hd, 3)) for _ in range(2))
        if num_layers > 1:
            self.layer4 = self._layer(128, 2)
            self.outputs16 = nn.ModuleList(
                nn.Sequential(ResidualBlock(128, 128, norm, 1), conv(128, hd, 3))
                for _ in range(2))
        if num_layers > 2:
            self.layer5 = self._layer(128, 2)
            self.outputs32 = nn.ModuleList(conv(128, hd, 3) for _ in range(2))

    def forward(self, x, dual: bool = False):
        x = self.trunk(x)
        both = x
        if dual:
            x = x[: x.shape[0] // 2]
        outs = [[head(x) for head in self.outputs08]]
        if self.num_layers > 1:
            y = self.layer4(x)
            outs.append([head(y) for head in self.outputs16])
        if self.num_layers > 2:
            z = self.layer5(y)
            outs.append([head(z) for head in self.outputs32])
        return outs, both


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = conv(hidden + cin, hidden, 3)
        self.convr = conv(hidden + cin, hidden, 3)
        self.convq = conv(hidden + cin, hidden, 3)

    def forward(self, h, cz, cr, cq, *xs):
        x = torch.cat(xs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class MotionEncoder(nn.Module):
    def __init__(self, levels: int, radius: int):
        super().__init__()
        self.convc1 = conv(levels * (2 * radius + 1), 64, 1)
        self.convc2 = conv(64, 64, 3)
        self.convf1 = conv(2, 64, 7)
        self.convf1.in_channels_used = 1  # the flow's x channel; y is 0
        self.convf2 = conv(64, 64, 3)
        self.conv = conv(128, 126, 3)

    def forward(self, flow_x, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow_x))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow_x, torch.zeros_like(flow_x)], dim=1)


class FlowHead(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = conv(cin, 256, 3)
        self.conv2 = conv(256, 2, 3)
        self.conv2.out_channels_used = 1  # the x channel

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def resize(x, size):
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class UpdateBlock(nn.Module):
    def __init__(self, hd: int, layers: int, downsample: int, levels: int, radius: int):
        super().__init__()
        self.layers = layers
        self.encoder = MotionEncoder(levels, radius)
        self.gru08 = ConvGRU(hd, 128 + hd * (layers > 1))
        if layers > 1:
            self.gru16 = ConvGRU(hd, hd * (layers == 3) + hd)
        if layers > 2:
            self.gru32 = ConvGRU(hd, hd)
        self.flow_head = FlowHead(hd)
        f = 2 ** downsample
        self.mask = nn.Sequential(conv(hd, 256, 3), nn.ReLU(), conv(256, f * f * 9, 1))

    def gru_levels(self, net, inp, i08: bool, i16: bool, i32: bool, corr=None, flow=None):
        net = list(net)
        if i32:
            net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        if i16:
            if self.layers > 2:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                                    resize(net[2], net[1].shape[-2:]))
            else:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]))
        if i08:
            motion = self.encoder(flow, corr)
            if self.layers > 1:
                net[0] = self.gru08(net[0], *inp[0], motion,
                                    resize(net[1], net[0].shape[-2:]))
            else:
                net[0] = self.gru08(net[0], *inp[0], motion)
        return net


def pool_w2(x):
    """Average-pool [..., W, C] by 2 along W, an odd last column dropped."""
    w2 = x.shape[-2] // 2
    x = x[..., : 2 * w2, :]
    return x.reshape(*x.shape[:-2], w2, 2, x.shape[-1]).mean(dim=-2)


def corr_pyramid(fmap1, fmap2, levels: int) -> List[torch.Tensor]:
    """All-pairs volumes [B, H, W1, W2/2^l] of fmap1 against the W-pooled
    fmap2 of each level, scaled by 1/sqrt(D); features channel-last."""
    d = fmap1.shape[-1]
    out, f2 = [], fmap2
    for lvl in range(levels):
        if lvl:
            f2 = pool_w2(f2)
        out.append(torch.einsum("bhxd,bhyd->bhxy", fmap1, f2) / math.sqrt(d))
    return out


def corr_lookup(pyramid: Sequence[torch.Tensor], x: torch.Tensor, radius: int):
    """Linear interpolation of each level at x/2^l + [-r, r], zero outside
    the image: [B, H, W1, L*(2r+1)]."""
    dx = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    out = []
    for lvl, vol in enumerate(pyramid):
        w2 = vol.shape[-1]
        pos = x[..., None] / 2 ** lvl + dx
        p0 = torch.floor(pos)
        frac = pos - p0
        i0 = p0.long()
        taps = []
        for i in (i0, i0 + 1):
            v = torch.gather(vol, -1, i.clamp(0, w2 - 1))
            taps.append(v * ((i >= 0) & (i < w2)).float())
        out.append(taps[0] * (1 - frac) + taps[1] * frac)
    return torch.cat(out, dim=-1)


def convex_upsample(flow, mask, f: int):
    """flow [B, 1, H, W], mask [B, 9*f*f, H, W] → [B, f*H, f*W, 1]."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, f, f, h, w), dim=2)
    up = F.unfold(f * flow, [3, 3], padding=1).reshape(b, 1, 9, 1, 1, h, w)
    up = (m * up).sum(dim=2)  # [B, 1, f, f, H, W]
    return up.permute(0, 4, 2, 5, 3, 1).reshape(b, f * h, f * w, 1)


class RAFTStereoReference(nn.Module):
    """``forward(img1, img2, iters)`` on [B, H, W, 3] images in [0, 255]:
    the x-flow [B, H, W, 1] (negative disparity) after ``iters``
    refinements."""

    state_precision = "fp32"

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        hd = int(cfg["hidden_dims"][0])
        layers, down = int(cfg["n_gru_layers"]), int(cfg["n_downsample"])
        self.cnet = ContextEncoder(hd, cfg["context_norm"], down, layers)
        self.update_block = UpdateBlock(hd, layers, down, int(cfg["corr_levels"]),
                                        int(cfg["corr_radius"]))
        self.context_zqr_convs = nn.ModuleList(conv(hd, 3 * hd, 3) for _ in range(layers))
        if cfg["shared_backbone"]:
            self.conv2 = nn.Sequential(ResidualBlock(128, 128, "instance", 1),
                                       conv(128, int(cfg["fnet_dim"]), 3))
        else:
            self.fnet = FeatureEncoder(int(cfg["fnet_dim"]), down)

    def encode(self, img1, img2):
        cfg = self.cfg
        a = (2 * (img1.float() / 255.0) - 1).permute(0, 3, 1, 2)
        b = (2 * (img2.float() / 255.0) - 1).permute(0, 3, 1, 2)
        if cfg["shared_backbone"]:
            outs, both = self.cnet(torch.cat([a, b], dim=0), dual=True)
            fmap1, fmap2 = self.conv2(both).chunk(2, dim=0)
        else:
            outs, _ = self.cnet(a)
            fmap1, fmap2 = self.fnet(a), self.fnet(b)
        net = [torch.tanh(o[0]) for o in outs]
        inp = [tuple(zqr(F.relu(o[1])).chunk(3, dim=1))
               for zqr, o in zip(self.context_zqr_convs, outs)]
        pyramid = [self.lower(v) for v in corr_pyramid(
            fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1), int(cfg["corr_levels"]))]
        bsz, _, h, w = net[0].shape
        x0 = torch.arange(w, dtype=torch.float32, device=a.device).expand(bsz, h, w)
        return net, inp, pyramid, x0

    def step(self, net, inp, pyramid, x0, flow, with_mask: bool):
        """One refinement: (net, flow [B, H, W], up mask or None)."""
        ub, layers = self.update_block, int(self.cfg["n_gru_layers"])
        corr = self.lower(corr_lookup(pyramid, x0 + flow, int(self.cfg["corr_radius"])))
        corr = corr.permute(0, 3, 1, 2)
        if self.cfg["slow_fast_gru"]:
            if layers == 3:
                net = ub.gru_levels(net, inp, False, False, True)
            if layers >= 2:
                net = ub.gru_levels(net, inp, False, True, layers == 3)
        net = ub.gru_levels(net, inp, True, layers >= 2, layers == 3, corr, flow[:, None])
        flow = self.lower(flow + ub.flow_head(net[0])[:, 0])
        mask = 0.25 * ub.mask(net[0]) if with_mask else None
        return net, flow, mask

    def lower(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the state's precision."""
        return round_bf16(x) if self.state_precision == "bf16" else x

    def forward(self, img1, img2, iters: int):
        net, inp, pyramid, x0 = self.encode(img1, img2)
        f = 2 ** int(self.cfg["n_downsample"])
        flow = torch.zeros_like(x0)
        for _ in range(iters - 1):
            net, flow, _ = self.step(net, inp, pyramid, x0, flow, False)
        net, flow, mask = self.step(net, inp, pyramid, x0, flow, True)
        return self.lower(convex_upsample(self.lower(flow[:, None]), self.lower(mask), f))


def pad_amounts(h: int, w: int, divis_by: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) edge padding to the next multiple of
    ``divis_by``, split evenly (the upstream ``InputPadder``'s sintel mode)."""
    ph = (-h) % divis_by
    pw = (-w) % divis_by
    return pw // 2, pw - pw // 2, ph // 2, ph - ph // 2


@torch.no_grad()
def predict(model: RAFTStereoReference, img1, img2, iters: int, divis_by: int = 32):
    """The reference x-flow [H, W] of one pair [H, W, 3] (torch tensors on
    the model's device), padded as the upstream evaluation pads it."""
    h, w = img1.shape[:2]
    left, right, top, bottom = pad_amounts(h, w, divis_by)

    def pad(img):
        x = img.float().permute(2, 0, 1)[None]
        x = F.pad(x, (left, right, top, bottom), mode="replicate")
        return x.permute(0, 2, 3, 1)

    out = model(pad(img1), pad(img2), iters)[0, :, :, 0]
    return out[top: top + h, left: left + w]

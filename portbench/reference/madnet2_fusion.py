"""Plain reference of MADNet2Fusion in float32: MADNet2 (Poggi et al.,
"Continual Adaptation for Deep Stereo", TPAMI 2021; after MADNet, Tonioni
et al., CVPR 2019) with the guidance branch of "Guided Stereo Matching"
(Poggi et al., CVPR 2019) fused into each level's correlation window by a
cross-attention along the epipolar line taken from STTR (Li et al., ICCV
2021); the fork's core/madnet2/madnet2_fusion.py (github.com/0ju-un/
RAFT-Stereo), with submodule.py, submodule_fusion.py, corr.py and
attention.py beside it.

Written from the equations with plain ``torch`` operations, batch by
batch, imports nothing of the program. Its module and parameter names are
the fork's, so one state dict loads into this model and the program's
``MADNet2Fusion`` (and, with ``fusion=False``, ``MADNet2``). The model,
channel-first inside:

  * pyramid: six blocks of (3x3 conv stride 2, LeakyReLU 0.2, 3x3 conv,
    LeakyReLU 0.2) of 16/32/64/96/128/192 channels on the raw [0, 255]
    images, both images through the same weights;
  * guidance encoder (fusion): two such blocks of 64 and 128 channels on
    the 1-channel proxy disparity, to 1/4; then at 1/4 a 1x1 conv to 5
    channels, and at 1/8 .. 1/64 the 1/4 features 3x3 stride-2 pad-1
    average-pooled (padding counted) once more a level, a 1x1 conv to 5
    channels, divided by 4, 8, 16, 32;
  * at each level k from 6 to 2 (1/64 .. 1/4): the all-pairs correlation
    along the row, corr(x, y) = <f_left(x), f_right(y)> / sqrt(D); its
    5-tap window at x + u + o, o in -2..2, u the coarser level's
    upsampled disparity (0 at level 6), read linearly with zeros outside
    the row;
  * the cross-attention (fusion), pre-norm, one head of width 5 along the
    row: window and guidance both through ``norm1`` (LayerNorm), q from
    the window, k and v from the guidance (the packed ``in_proj``), logits
    q k^T / sqrt(5), softmax over the W key positions, out = out_proj(p v),
    and the window + out;
  * a decoder of 3x3 convs of 128/128/96/64 channels with LeakyReLU 0.2
    and a 3x3 conv to 1 channel, on (features, window, u); the result
    upsampled nearest x2 and scaled by 20 / 2^(k-1) is the next level's u;
  * the served disparity: level 2's, upsampled bilinearly x4
    (align_corners False) and scaled by -20.

Departures from the fork, none of which changes a value the fork's
evaluation computes:

  * each pixel's window reads its own row of the volume; the fork's
    corr.py permutes the volume rows into (w, h, b) order while its
    sampling coordinates stay (b, h, w), which the program corrects too;
  * the attention's relative-position terms and its last-layer mask are
    left out (the fork's forward passes neither), as are the attention
    maps it returns and the forward discards; ``norm2`` exists so its
    parameters load, and is unused, as in the fork;
  * the window and the attention run in blocks of ``block_rows`` rows
    (each row is independent of the others), to bound the level-2
    volume's memory; ``ContextNet`` is absent (the fork's forward never
    runs it).

:func:`set_precision` selects how it computes: float32 throughout (run it
under :func:`model.strict_fp32` on a GPU); convolutions, all or those
named, may round their inputs and weights to TF32 (``"tf32"``: the
configured precision, whose products cuDNN's tensor cores take at 10
mantissa bits and sum in float32) or to bf16 with a bf16 output
(``"bf16"``); the correlation and the attention may round the operands of
their matrix products to TF32 (``"tf32"``, as cuBLAS does with
``cuda.matmul.allow_tf32``) or their operands and results to bf16
(``"bf16"``); and the attention may be bypassed (the window passes
through unchanged).
"""

from __future__ import annotations

import math
from typing import Collection, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.model import pad_amounts, round_bf16

LEVELS = (2, 3, 4, 5, 6)
FEATURE_CHANNELS = (16, 32, 64, 96, 128, 192)
GUIDE_CHANNELS = (64, 128)
WINDOW = 5  # taps of the window at radius 2: the attention's width
DIVIS_BY = 128
SLOPE = 0.2


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), back in
    float32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -0x2000).view(torch.float32)


ROUND = {"fp32": lambda x: x.float(), "tf32": round_tf32, "bf16": round_bf16}


def round_result(precision: str):
    """How a product's result is rounded: to bf16 under bf16; TF32 and
    float32 products sum and return in float32."""
    return round_bf16 if precision == "bf16" else (lambda x: x)


class Conv(nn.Conv2d):
    """A convolution in the model's ``precision``: its inputs and weights
    rounded (TF32 or bf16) before a float32 convolution, and under bf16 its
    output too."""

    precision = "fp32"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rnd = ROUND[self.precision]
        y = F.conv2d(rnd(x.contiguous()), rnd(self.weight), self.bias.float(), self.stride,
                     self.padding, self.dilation)
        return round_bf16(y) if self.precision == "bf16" else y


def conv2d(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> nn.Sequential:
    """The fork's ``conv2d``: ``Sequential(Conv2d)``, padding kernel // 2."""
    return nn.Sequential(Conv(cin, cout, kernel, stride=stride, padding=kernel // 2))


def block(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(conv2d(cin, cout, 3, 2), nn.LeakyReLU(SLOPE),
                         conv2d(cout, cout, 3, 1), nn.LeakyReLU(SLOPE))


class FeatureExtraction(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for i, ch in enumerate(FEATURE_CHANNELS, start=1):
            setattr(self, f"block{i}", block(cin, ch))
            cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = [x]
        for i in range(1, len(FEATURE_CHANNELS) + 1):
            outs.append(getattr(self, f"block{i}")(outs[-1]))
        return outs


class GuidanceEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.block1 = block(1, GUIDE_CHANNELS[0])
        self.block2 = block(*GUIDE_CHANNELS)
        for k in LEVELS:
            setattr(self, f"conv_{k}", conv2d(GUIDE_CHANNELS[1], WINDOW, 1))

    def forward(self, guide: torch.Tensor) -> Dict[int, torch.Tensor]:
        y = self.block2(self.block1(guide))
        outs = {2: self.conv_2(y)}
        for k in LEVELS[1:]:
            y = F.avg_pool2d(y, 3, stride=2, padding=1)
            outs[k] = getattr(self, f"conv_{k}")(y) / 2.0 ** (k - 1)
        return outs


class Decoder(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        layers: List[nn.Module] = []
        for ch in (128, 128, 96, 64):
            layers += [conv2d(cin, ch), nn.LeakyReLU(SLOPE)]
            cin = ch
        layers.append(conv2d(cin, 1))
        self.decoder = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(x)


class Projections(nn.Module):
    """The attention's parameters under the fork's names: the packed
    q | k | v projection and the output projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class CrossAttention(nn.Module):
    """Pre-norm single-head cross-attention of the window [.., W, 5] with
    the guidance [.., W, 5] along W, with its residual."""

    precision = "fp32"
    bypass = False

    def __init__(self, dim: int = WINDOW):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = Projections(dim)

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.norm1.eps) * self.norm1.weight + self.norm1.bias

    def forward(self, win: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        if self.bypass:
            return win
        rin, rout = ROUND[self.precision], round_result(self.precision)
        p = self.cross_attn
        c = win.shape[-1]
        w, b = rin(p.in_proj_weight), p.in_proj_bias.float()
        nq, nk = rin(self.norm(win)), rin(self.norm(guide))
        q = rin(rout((nq @ w[:c].T + b[:c]) * c ** -0.5))
        k = rin(rout(nk @ w[c:2 * c].T + b[c:2 * c]))
        v = rin(rout(nk @ w[2 * c:].T + b[2 * c:]))
        logits = rout(torch.einsum("...xc,...yc->...xy", q, k))
        attn = rin(rout(torch.softmax(logits, dim=-1)))
        out = rin(rout(torch.einsum("...xy,...yc->...xc", attn, v)))
        out = rout(out @ rin(p.out_proj.weight).T + p.out_proj.bias.float())
        return win + out


class MADNet2FusionReference(nn.Module):
    """``forward(left, right, guide)`` on channel-last [B, H, W, 3] images in
    [0, 255] and the [B, H, W, 1] proxy disparity, H and W divisible by
    128 → (disp2 .. disp6), [B, 1, H/2^k, W/2^k] in the network's units
    (-1/20 of a pixel). ``fusion=False`` is MADNet2 (no guidance)."""

    corr_precision = "fp32"
    block_rows: Optional[int] = None

    def __init__(self, fusion: bool = True):
        super().__init__()
        self.fusion = bool(fusion)
        self.feature_extraction = FeatureExtraction()
        if self.fusion:
            self.guidance_encoder = GuidanceEncoder()
        for k in LEVELS:
            if self.fusion:
                setattr(self, f"cross_attn_layer_{k}", CrossAttention())
            cin = FEATURE_CHANNELS[k - 1] + WINDOW + (0 if k == 6 else 1)
            setattr(self, f"decoder{k}", Decoder(cin))

    def window(self, f1: torch.Tensor, f2: torch.Tensor, x: torch.Tensor,
               attn: Optional[CrossAttention], guide: Optional[torch.Tensor]) -> torch.Tensor:
        """The level's window [B, 5, H, W] at ``x`` [B, H, W], fused with
        the guidance [B, 5, H, W] when ``attn`` is given."""
        rin, rout = ROUND[self.corr_precision], round_result(self.corr_precision)
        _, d, h, w = f1.shape
        taps = torch.arange(-(WINDOW // 2), WINDOW // 2 + 1, device=f1.device,
                            dtype=torch.float32)
        step = self.block_rows or h
        out = []
        for r0 in range(0, h, step):
            rows = slice(r0, min(r0 + step, h))
            a = rin(f1[:, :, rows].permute(0, 2, 3, 1))
            b = rin(f2[:, :, rows].permute(0, 2, 3, 1))
            vol = rout(torch.einsum("bhxd,bhyd->bhxy", a, b) / math.sqrt(d))
            at = x[:, rows, :, None] + taps
            lo = torch.floor(at)
            frac = at - lo
            i0 = lo.long()
            i1 = i0 + 1

            def read(i):
                inside = ((i >= 0) & (i <= w - 1)).float()
                return torch.gather(vol, -1, i.clamp(0, w - 1)) * inside

            win = rout(read(i0) * (1.0 - frac) + read(i1) * frac)
            if attn is not None:
                win = attn(win, guide[:, :, rows].permute(0, 2, 3, 1).float())
            out.append(win)
        return torch.cat(out, dim=1).permute(0, 3, 1, 2)

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                guide: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        x = torch.cat([left, right], dim=0).float().permute(0, 3, 1, 2)
        feats = [f.chunk(2, dim=0) for f in self.feature_extraction(x)]
        guides = (self.guidance_encoder(guide.float().permute(0, 3, 1, 2))
                  if self.fusion else {})
        up = None
        disps = {}
        for k in (6, 5, 4, 3, 2):
            f1, f2 = feats[k]
            b, _, h, w = f1.shape
            at = torch.arange(w, device=f1.device, dtype=torch.float32).expand(b, h, w)
            if up is not None:
                at = at + up[:, 0]
            attn = getattr(self, f"cross_attn_layer_{k}") if self.fusion else None
            win = self.window(f1, f2, at, attn, guides.get(k))
            parts = [f1, win] + ([up] if up is not None else [])
            disps[k] = getattr(self, f"decoder{k}")(torch.cat(parts, dim=1))
            if k > 2:
                up = F.interpolate(disps[k], scale_factor=2, mode="nearest") * 20.0 / 2 ** (k - 1)
        return tuple(disps[k] for k in LEVELS)


def set_precision(model: MADNet2FusionReference, convs: str = "fp32", corr: str = "fp32",
                  attn: str = "fp32", bypass_attention: bool = False,
                  conv_names: Optional[Collection[str]] = None) -> MADNet2FusionReference:
    """Convolutions in ``convs`` (fp32, tf32 or bf16), only those named in
    ``conv_names`` when it is given (the others in float32), the
    correlation and its window in ``corr`` and the attention in ``attn``
    (each fp32, tf32 or bf16); ``bypass_attention`` passes each window
    through the attention unchanged."""
    if convs not in ROUND or corr not in ROUND or attn not in ROUND:
        raise ValueError(f"no such precision: convs {convs!r}, corr {corr!r}, attn {attn!r}")
    names = None if conv_names is None else set(conv_names)
    convs_of = {n for n, m in model.named_modules() if isinstance(m, Conv)}
    if names is not None and not names <= convs_of:
        raise ValueError(f"no such convolutions: {sorted(names - convs_of)}")
    for name, m in model.named_modules():
        if isinstance(m, Conv):
            m.precision = convs if names is None or name in names else "fp32"
        elif isinstance(m, CrossAttention):
            m.precision, m.bypass = attn, bool(bypass_attention)
    model.corr_precision = corr
    return model


def serve(model: MADNet2FusionReference, disps: Sequence[torch.Tensor]) -> torch.Tensor:
    """The served disparity [B, 4h, 4w] from level 2's [B, 1, h, w]."""
    up = F.interpolate(disps[0], scale_factor=4, mode="bilinear", align_corners=False)
    return up[:, 0] * -20.0


@torch.no_grad()
def predict(model: MADNet2FusionReference, left, right, guide=None) -> torch.Tensor:
    """The served disparity [H, W] of one pair ([H, W, 3] tensors, with the
    [H, W, 1] guidance for the Fusion model), edge-padded to /128 as the
    evaluation pads it and cut back."""
    h, w = left.shape[:2]
    lpad, rpad, top, bottom = pad_amounts(h, w, DIVIS_BY)

    def pad(img):
        x = img.float().permute(2, 0, 1)[None]
        return F.pad(x, (lpad, rpad, top, bottom), mode="replicate").permute(0, 2, 3, 1)

    out = serve(model, model(pad(left), pad(right),
                             None if guide is None else pad(guide)))[0]
    return out[top: top + h, lpad: lpad + w]

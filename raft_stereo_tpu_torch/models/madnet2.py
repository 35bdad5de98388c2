"""MADNet2: the fast coarse-to-fine disparity network and the MAD machinery
(PyTorch port of ``raft_stereo_tpu/models/madnet2.py``; the reference's
core/madnet2/madnet2.py and submodule.py).

  * A 6-block feature pyramid (stride 2 each, 16 → 192 channels, LeakyReLU
    0.2); under ``mad`` the input of blocks 2–6 is detached, the gradient
    isolation that makes Modular ADaptation possible.
  * 5 disparity decoders on (features, 5-tap correlation window, the
    coarser disparity upsampled nearest ×2 and scaled by 20/2^(k-1)); under
    ``mad`` that upsampled disparity is detached too.
  * One correlation level at radius 2 a pyramid level, the ops layer's
    ``corr_volume`` + ``corr_lookup_reg`` in fp32, with an optional
    cross-attention hook for the Fusion variant.

    The JAX package deliberately corrects the reference's lookup layout
    (its corr.py permutes the volume rows into (w, h, b) order while the
    sampling coordinates stay (b, h, w)), and so does the port: pixel
    (h, w) samples its own row.
  * The supervised pyramid loss, the 4-mode adaptation loss and the
    host-side ``MADController`` (numpy) that picks which block adapts.

The forward marks its stages on the stream (``telemetry.mark``): ``start``,
``pyramid`` (both images' features), then at each level k from 6 to 2
``corr{k}`` (the volume and the window at the warped x), ``xattn{k}`` (the
Fusion variant's cross-attention with the guidance) and ``decode{k}`` (the
decoder and the upsampled disparity); the Fusion variant marks
``guidance`` after its guidance encoder. They record only inside a
``telemetry.stage_marks`` block, which a sink arms.

Module and parameter names are the reference's torch names (each conv of a
block or decoder is the ``Sequential(Conv2d)`` of the reference's
``conv2d`` helper), NCHW inside; ``MADNet2.forward`` takes and returns the
JAX package's channel-last layout. Under ``mixed_precision`` the convs run
in bf16 on fp32 parameters, the correlation in fp32, and the outputs are
fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from raft_stereo_tpu_torch import losses as L
from raft_stereo_tpu_torch.models.layers import Conv2d
from raft_stereo_tpu_torch.ops.corr import corr_lookup_reg, corr_volume
from raft_stereo_tpu_torch.runtime import telemetry

LEVELS = (2, 3, 4, 5, 6)  # pyramid levels with a decoder, 1/4 .. 1/64
DIVIS_BY = 128  # inputs pad to it: six stride-2 levels (reference train_mad.py:232-237)
FEATURE_CHANNELS = (16, 32, 64, 96, 128, 192)  # blocks 1..6


def _leaky() -> nn.LeakyReLU:
    return nn.LeakyReLU(0.2)


def conv2d(cin: int, cout: int, kernel: int = 3, stride: int = 1,
           dilation: int = 1) -> nn.Sequential:
    """The reference's ``conv2d``: ``Sequential(Conv2d)`` with torch's
    symmetric ``dilation·(k // 2)`` padding."""
    return nn.Sequential(Conv2d(cin, cout, kernel, stride=stride,
                                padding=dilation * (kernel // 2), dilation=dilation))


def init_mad_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init, the JAX family's distributions: conv kernels uniform in
    ±1/sqrt(fan_in) (torch's default conv init), conv biases 0; attention
    projections xavier-uniform with zero biases; layer norms (1, 0)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = math.sqrt(6.0 / (m.in_features + m.out_features))
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
        elif hasattr(m, "in_proj_weight"):
            c3, c = m.in_proj_weight.shape
            bound = math.sqrt(6.0 / (c3 + c))
            with torch.no_grad():
                m.in_proj_weight.uniform_(-bound, bound, generator=generator)
                m.in_proj_bias.zero_()


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 of channel-last ``x`` [B, H, W, C]."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def nearest_down(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch ``F.interpolate(scale_factor=1/k, mode='nearest')`` of
    channel-last ``x`` whose sizes divide by ``k``."""
    return x[:, ::k, ::k, :]


class FeatureExtraction(nn.Module):
    """6 stride-2 double-conv blocks (reference submodule.py:27-81), NCHW.
    ``forward(x, mad)`` returns ``[x, block1(x), ..., block6(...)]``."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for i, ch in enumerate(FEATURE_CHANNELS, start=1):
            setattr(self, f"block{i}", nn.Sequential(
                conv2d(cin, ch, 3, 2), _leaky(), conv2d(ch, ch, 3, 1), _leaky()))
            cin = ch

    def forward(self, x: torch.Tensor, mad: bool = False) -> List[torch.Tensor]:
        outs = [x]
        for i in range(1, len(FEATURE_CHANNELS) + 1):
            inp = outs[-1]
            if mad and i > 1:
                inp = inp.detach()
            outs.append(getattr(self, f"block{i}")(inp))
        return outs


class DisparityDecoder(nn.Module):
    """5 convs to a 1-channel disparity (reference submodule.py:83-100), NCHW."""

    def __init__(self, in_channels: int):
        super().__init__()
        layers: List[nn.Module] = []
        cin = in_channels
        for ch in (128, 128, 96, 64):
            layers += [conv2d(cin, ch), _leaky()]
            cin = ch
        layers.append(conv2d(cin, 1))
        self.decoder = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(x)


class ContextNet(nn.Module):
    """Dilated refinement net (reference submodule.py:103-124; the reference
    defines it but its forward never runs it, so it stands alone), NCHW."""

    def __init__(self, in_channels: int = 33):
        super().__init__()
        layers: List[nn.Module] = []
        cin = in_channels
        for ch, dil in ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1)):
            layers += [conv2d(cin, ch, 3, 1, dil), _leaky()]
            cin = ch
        layers.append(conv2d(cin, 1))
        self.context = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.context(x)


def _level_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, coords_x: torch.Tensor,
                radius: int = 2) -> torch.Tensor:
    """One level at radius r on channel-last features → [B, H, W, 2r+1] in
    fp32 (reference madnet2/corr.py:41-70; the Fusion variant then fuses it
    with the guidance)."""
    vol = corr_volume(fmap1.float(), fmap2.float())
    return corr_lookup_reg([vol], coords_x, radius)


def decoder_cascade(decoders: Dict[int, nn.Module], im2_fea: Sequence[torch.Tensor],
                    im3_fea: Sequence[torch.Tensor], mad: bool, dtype: torch.dtype,
                    attns=None, guides=None):
    """The coarse-to-fine chain of MADNet2 and its Fusion variant (reference
    madnet2.py:95-130): at each level correlate at the disparity-warped x,
    decode (features, window, upsampled coarser disparity), upsample
    nearest ×2 scaled by 20/2^(k-1), detached under ``mad``. Features are
    NCHW; ``guides`` channel-last. Marks ``corr{k}``, ``xattn{k}`` (with
    ``attns``) and ``decode{k}`` at each level. Returns (disp2..disp6)
    channel-last fp32."""
    disp_u = None  # [B, 1, h, w] fp32
    disps = {}
    for k in (6, 5, 4, 3, 2):
        fea = im2_fea[k]
        B, _, H, W = fea.shape
        coords_x = torch.arange(W, dtype=torch.float32, device=fea.device).expand(B, H, W)
        if disp_u is not None:
            coords_x = coords_x + disp_u[:, 0]
        win = _level_corr(fea.permute(0, 2, 3, 1), im3_fea[k].permute(0, 2, 3, 1), coords_x,
                          radius=2)
        telemetry.mark(f"corr{k}")
        if attns:
            win, _ = attns[k](win, guides[k])
            telemetry.mark(f"xattn{k}")
        corr = win.to(dtype).permute(0, 3, 1, 2)
        parts = [fea, corr] + ([disp_u.to(dtype)] if disp_u is not None else [])
        disp = decoders[k](torch.cat(parts, dim=1))
        disps[k] = disp
        if k > 2:
            d = disp.detach() if mad else disp
            up = F.interpolate(d, scale_factor=2, mode="nearest")
            disp_u = (up * 20.0 / (2 ** (k - 1))).float()
        telemetry.mark(f"decode{k}")
    return tuple(disps[k].float().permute(0, 2, 3, 1) for k in LEVELS)


def decoder_channels(k: int) -> int:
    """Decoder k's input channels: the level's features, the 5-tap window
    and (below the coarsest level) the upsampled disparity."""
    return FEATURE_CHANNELS[k - 1] + 5 + (0 if k == 6 else 1)


class MADNet2(nn.Module):
    """``forward(image2, image3, mad=False)`` → (disp2..disp6), channel-last
    [B, H/2^k, W/2^k, 1] fp32 at the pyramid's native resolutions, in the
    network's units (−1/20 of pixels; reference madnet2.py:87-130). Images
    [B, H, W, 3] in [0, 255], H and W divisible by 128."""

    def __init__(self, mixed_precision: bool = False):
        super().__init__()
        self.mixed_precision = bool(mixed_precision)
        self.feature_extraction = FeatureExtraction()
        for k in LEVELS:
            setattr(self, f"decoder{k}", DisparityDecoder(decoder_channels(k)))

    def extra_repr(self) -> str:
        return f"mixed_precision={self.mixed_precision}"

    def _features(self, image2, image3, mad: bool, dtype):
        """Both images' pyramids, in one batched pass (no norm couples the
        two halves)."""
        x = torch.cat([image2, image3], dim=0).to(dtype).permute(0, 3, 1, 2)
        both = self.feature_extraction(x, mad)
        return [t.chunk(2, dim=0)[0] for t in both], [t.chunk(2, dim=0)[1] for t in both]

    def forward(self, image2: torch.Tensor, image3: torch.Tensor, mad: bool = False):
        dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        telemetry.mark("start")
        im2_fea, im3_fea = self._features(image2, image3, mad, dtype)
        telemetry.mark("pyramid")
        decoders = {k: getattr(self, f"decoder{k}") for k in LEVELS}
        return decoder_cascade(decoders, im2_fea, im3_fea, mad, dtype)


def training_loss(pred_disps: Sequence[torch.Tensor], gt_disp: torch.Tensor) -> torch.Tensor:
    """MADNet's supervised pyramid loss (reference madnet2.py:132-144): the
    sum-reduced L1 of disp2..disp5 against −nearest_down(gt)/20."""
    loss = 0.0
    for w, s, pred in zip((0.005, 0.01, 0.02, 0.08), (4, 8, 16, 32), pred_disps[:4]):
        target = -nearest_down(gt_disp, s) / 20.0
        loss = loss + w * (pred - target).abs().sum()
    return loss


def compute_mad_loss(image2, image3, predictions, gt, validgt, max_disp: float = 192.0):
    """Full-resolution supervised loss and metrics (reference
    train_mad.py:100-129). ``predictions``: 5 full-resolution disparities in
    pixels; gt [B, H, W, 1]; validgt [B, H, W] or [B, H, W, 1]."""
    if validgt.ndim == 3:
        validgt = validgt[..., None]
    mag = torch.sqrt(torch.sum(gt ** 2, dim=-1, keepdim=True))
    valid = (validgt >= 0.5) & (mag < max_disp)

    def masked_sum_l1(pred):
        return torch.where(valid, (pred - gt).abs(), 0.0).sum()

    loss = sum(0.001 * masked_sum_l1(p) / 20.0 for p in predictions)
    epe = torch.sqrt(torch.sum((predictions[0] - gt) ** 2, dim=-1))
    v = valid[..., 0]
    denom = v.sum().clamp_min(1)

    def mean(x):
        return torch.where(v, x, 0.0).sum() / denom

    metrics = {
        "epe": mean(epe),
        "1px": mean((epe < 1).float()),
        "3px": mean((epe < 3).float()),
        "5px": mean((epe < 5).float()),
    }
    return loss, metrics


def adaptation_loss(image2, image3, predictions, gt, validgt, adapt_mode: str = "full",
                    idx: int = -1, loss_weights: Sequence[float] = (1, 1, 1, 1, 1)):
    """The 4-mode MAD loss (reference madnet2.py:146-179). Returns (loss,
    per-level weighted losses) for ``full``/``full++``, (loss, None) for the
    single-block modes ``mad``/``mad++``."""
    if validgt is not None and validgt.ndim == 3:
        validgt = validgt[..., None]
    if adapt_mode == "full":
        per = [L.self_supervised_loss(p, image2, image3) for p in predictions]
        return sum(per), torch.stack([p * w for p, w in zip(per, loss_weights)])
    if adapt_mode == "full++":
        valid = validgt > 0
        per = [0.001 * torch.where(valid, (p - gt).abs(), 0.0).sum() / 20.0
               for p in predictions]
        return sum(per), torch.stack([p * w for p, w in zip(per, loss_weights)])
    if adapt_mode == "mad":
        return L.self_supervised_loss(predictions[idx], image2, image3), None
    if adapt_mode == "mad++":
        valid = validgt > 0
        denom = valid.sum().clamp_min(1)
        return torch.where(valid, (predictions[idx] - gt).abs(), 0.0).sum() / denom, None
    raise ValueError(f"unknown adapt_mode {adapt_mode!r}")


@dataclasses.dataclass
class MADController:
    """Host-side MAD bookkeeping (reference madnet2.py:21-76): reward-based
    block sampling. The sampling distribution decays by 0.99 and the
    last-trained block is credited with 0.01·(expected-loss gain); the
    update histogram (which block to broadcast) decays by 0.9 on send."""

    num_blocks: int = 5
    seed: int = 0

    def __post_init__(self):
        self.sample_distribution = np.zeros(self.num_blocks, np.float32)
        self.updates_histogram = np.zeros(self.num_blocks, np.float32)
        self.accumulated_loss = np.zeros(self.num_blocks, np.float32)
        self.loss_t1 = 0.0
        self.loss_t2 = 0.0
        self.last_trained_blocks: List[int] = []
        self._rng = np.random.default_rng(self.seed)

    @staticmethod
    def _softmax(x):
        e = np.exp(x - x.max())
        return e / e.sum()

    def sample_block(self, sample_mode: str = "prob") -> int:
        if sample_mode == "prob":
            block = int(self._rng.choice(self.num_blocks,
                                         p=self._softmax(self.sample_distribution)))
        else:
            block = 0
        self.updates_histogram[block] += 1
        return block

    def sample_all(self) -> int:
        self.updates_histogram += 1
        return -1

    def get_block_to_send(self, sample_mode: str = "prob") -> int:
        if sample_mode == "prob":
            block = int(self._rng.choice(self.num_blocks,
                                         p=self._softmax(self.updates_histogram)))
            self.updates_histogram[block] *= 0.9
            self.accumulated_loss *= 0
        else:
            block = 0
        return block

    def update_sample_distribution(self, block: int, new_loss: float) -> None:
        new_loss = float(new_loss)
        if self.loss_t1 == 0.0 and self.loss_t2 == 0.0:
            self.loss_t1 = new_loss
            self.loss_t2 = new_loss
        gain = (2 * self.loss_t1 - self.loss_t2) - new_loss
        self.sample_distribution = 0.99 * self.sample_distribution
        for i in self.last_trained_blocks:
            self.sample_distribution[i] += 0.01 * gain
        self.last_trained_blocks = [block]
        self.loss_t2 = self.loss_t1
        self.loss_t1 = new_loss


def make_madnet2(mixed_precision: bool = False, fusion: bool = False, seed: int = 0,
                 device=None) -> nn.Module:
    """MADNet2 (or MADNet2Fusion) with seeded weights, in eval mode on
    ``device`` (the CPU when None)."""
    if fusion:
        from raft_stereo_tpu_torch.models.madnet2_fusion import MADNet2Fusion

        model: nn.Module = MADNet2Fusion(mixed_precision=mixed_precision)
    else:
        model = MADNet2(mixed_precision=mixed_precision)
    init_mad_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device or "cpu").eval()


__all__ = [
    "ContextNet",
    "DisparityDecoder",
    "FeatureExtraction",
    "DIVIS_BY",
    "MADController",
    "MADNet2",
    "adaptation_loss",
    "compute_mad_loss",
    "decoder_cascade",
    "init_mad_weights",
    "make_madnet2",
    "nearest_down",
    "nearest_up2",
    "training_loss",
]

"""RAFT-Stereo test-mode inference (PyTorch port of
``raft_stereo_tpu/models/raft_stereo.py:207-453``).

Images enter channel-last [B, H, W, 3] in [0, 255]; inside, the modules run
NCHW. Under mixed precision the encoders and the GRU cascade compute in
bf16, while the correlation features, the x-flow state and the upsampling
stay fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import ResidualBlock, conv
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.ops.corr import make_corr_fn
from raft_stereo_tpu_torch.ops.sampling import convex_upsample, coords_grid

# Above this many input pixels the fnet runs one image at a time: the
# batched pair would hold both images' full-resolution activations at once.
TWO_CALL_FNET_PIXELS = 2_000_000


class RAFTStereo(nn.Module):
    """``forward(image1, image2, iters)`` → ``(lowres [B, H, W, 2] with
    y = 0, disp_up [B, f·H, f·W, 1])``, the x-flow at 1/f resolution and
    convex-upsampled (negate it for positive disparity)."""

    def __init__(self, config: RAFTStereoConfig = RAFTStereoConfig()):
        super().__init__()
        self.config = cfg = config
        hd = cfg.hidden_dims
        self.cnet = MultiBasicEncoder(output_dim=(hd, hd), norm_fn=cfg.context_norm,
                                      downsample=cfg.n_downsample, num_layers=cfg.n_gru_layers)
        self.update_block = BasicMultiUpdateBlock(hd, cfg.n_gru_layers, cfg.n_downsample,
                                                  cfg.corr_levels, cfg.corr_radius)
        self.context_zqr_convs = nn.ModuleList(
            conv(hd[i], hd[i] * 3, 3) for i in range(cfg.n_gru_layers)
        )
        if cfg.shared_backbone:
            self.conv2 = nn.Sequential(ResidualBlock(128, 128, "instance", 1), conv(128, 256, 3))
        else:
            self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                     downsample=cfg.n_downsample)

    @torch.no_grad()
    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None):
        cfg = self.config
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        n_layers = cfg.n_gru_layers

        def prep(img):
            return (2.0 * (img / 255.0) - 1.0).to(dtype).permute(0, 3, 1, 2)

        image1, image2 = prep(image1), prep(image2)
        if cfg.shared_backbone:
            *cnet_list, x = self.cnet(torch.cat([image1, image2], dim=0), dual_inp=True)
            fmap1, fmap2 = self.conv2(x).chunk(2, dim=0)
        else:
            cnet_list = self.cnet(image1)
            if image1.shape[2] * image1.shape[3] > TWO_CALL_FNET_PIXELS:
                fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
            else:
                fmap1, fmap2 = self.fnet(torch.cat([image1, image2], dim=0)).chunk(2, dim=0)

        net = [torch.tanh(o[0]) for o in cnet_list]
        # context gate biases (cz, cr, cq), computed once per pair
        inp = [
            tuple(zqr(torch.relu(o[1])).chunk(3, dim=1))
            for zqr, o in zip(self.context_zqr_convs, cnet_list)
        ]

        corr_fn = make_corr_fn(cfg.corr_backend, fmap1.permute(0, 2, 3, 1),
                               fmap2.permute(0, 2, 3, 1), cfg.corr_levels, cfg.corr_radius)
        B, _, H, W = net[0].shape
        coords0_x = coords_grid(B, H, W, device=net[0].device)[..., 0]
        flow_x = torch.zeros((B, H, W), dtype=torch.float32, device=net[0].device)
        if flow_init is not None:
            flow_x = flow_x + flow_init[..., 0].float()

        up_mask = None
        for it in range(iters):
            last = it == iters - 1
            corr = corr_fn(coords0_x + flow_x).to(dtype).permute(0, 3, 1, 2)
            flow = flow_x[:, None].to(dtype)
            if n_layers == 3 and cfg.slow_fast_gru:
                net = self.update_block(net, inp, iter32=True, iter16=False,
                                        iter08=False, update=False)
            if n_layers >= 2 and cfg.slow_fast_gru:
                net = self.update_block(net, inp, iter32=n_layers == 3, iter16=True,
                                        iter08=False, update=False)
            net, up_mask, delta = self.update_block(
                net, inp, corr, flow, iter32=n_layers == 3, iter16=n_layers >= 2,
                with_mask=last,
            )
            flow_x = flow_x + delta[:, 0].float()

        disp_up = convex_upsample(flow_x[..., None], up_mask.float().permute(0, 2, 3, 1),
                                  cfg.downsample_factor)
        lowres = torch.stack([flow_x, torch.zeros_like(flow_x)], dim=-1)
        return lowres, disp_up

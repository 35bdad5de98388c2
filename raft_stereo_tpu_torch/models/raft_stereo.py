"""RAFT-Stereo, test-mode inference and the train-mode forward (PyTorch
port of ``raft_stereo_tpu/models/raft_stereo.py:117-479``).

Images enter channel-last [B, H, W, 3] in [0, 255]; inside, the modules run
NCHW. Under mixed precision the encoders and the GRU cascade compute in
bf16, while the correlation features, the x-flow state and the upsampling
stay fp32.
"""

from __future__ import annotations

from typing import Optional

import functools

import torch
import torch.nn as nn
import torch.utils.checkpoint

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import ResidualBlock, conv
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.ops import fused_update
from raft_stereo_tpu_torch.ops.corr import make_corr_fn
from raft_stereo_tpu_torch.ops.sampling import convex_upsample, coords_grid, interp_bilinear

# Above this many input pixels the fnet runs one image at a time: the
# batched pair would hold both images' full-resolution activations at once.
TWO_CALL_FNET_PIXELS = 2_000_000


class RAFTStereo(nn.Module):
    """``forward(image1, image2, iters)`` → ``(lowres [B, H, W, 2] with
    y = 0, disp_up [B, f·H, f·W, 1])``, the x-flow at 1/f resolution and
    convex-upsampled (negate it for positive disparity). With
    ``config.converge_eps > 0`` a third element follows: the number of
    refinement iterations run, the masked final one included.

    ``test_mode=False`` is the train-mode forward: the stack
    [iters, B, f·H, f·W, 1] of every iteration's upsampled x-flow, with
    gradients. The port's default is test mode (the JAX package's is
    train mode)."""

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

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None, test_mode: bool = True,
                remat: bool = False):
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if test_mode:
            return self._test_forward(image1, image2, iters, flow_init)
        return self._train_forward(image1, image2, iters, flow_init, remat)

    def _encode(self, image1, image2, flow_init, corr_backend):
        """Encoders, context gates and the correlation state: ``(net, inp,
        corr_fn, coords0_x, flow_x)``."""
        cfg = self.config
        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32

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

        corr_fn = make_corr_fn(corr_backend, fmap1.permute(0, 2, 3, 1),
                               fmap2.permute(0, 2, 3, 1), cfg.corr_levels, cfg.corr_radius)
        B, _, H, W = net[0].shape
        coords0_x = coords_grid(B, H, W, device=net[0].device)[..., 0]
        flow_x = torch.zeros((B, H, W), dtype=torch.float32, device=net[0].device)
        if flow_init is not None:
            flow_x = flow_x + flow_init[..., 0].float()
        return net, inp, corr_fn, coords0_x, flow_x

    def _step(self, net, inp, corr_fn, coords0_x, flow_x, with_mask):
        """One unfused refinement iteration → (net, flow_x, up_mask or None)."""
        cfg = self.config
        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        n_layers = cfg.n_gru_layers
        corr = corr_fn(coords0_x + flow_x).to(dtype).permute(0, 3, 1, 2)
        flow = flow_x[:, None].to(dtype)
        net = self._slow_fast(net, inp)
        net, up_mask, delta = self.update_block(
            net, inp, corr, flow, iter32=n_layers == 3, iter16=n_layers >= 2,
            with_mask=with_mask,
        )
        return net, flow_x + delta[:, 0].float(), up_mask

    @torch.no_grad()
    def _test_forward(self, image1, image2, iters, flow_init):
        cfg = self.config
        dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        # The fused step recomputes correlation from the alt state, and the
        # masked final step then looks up through the same alt backend, so
        # with fused_update the corr state is alt whatever corr_backend says.
        net, inp, corr_fn, coords0_x, flow_x = self._encode(
            image1, image2, flow_init, "alt" if cfg.fused_update else cfg.corr_backend)

        fused = None
        if cfg.fused_update:
            # weights in the compute dtype and ctx = cz|cr|cq channel-last,
            # once a forward
            fused = (fused_update.pack_fused_params(self.update_block, dtype),
                     torch.cat(inp[0], dim=1).permute(0, 2, 3, 1).contiguous())

        def step(net, flow_x, with_mask):
            """One refinement iteration → (net, flow_x, up_mask or None)."""
            if fused is not None and not with_mask:
                return self._fused_step(net, inp, flow_x, corr_fn, fused, dtype)
            return self._step(net, inp, corr_fn, coords0_x, flow_x, with_mask)

        # iters-1 unmasked steps, then the masked one. With converge_eps > 0,
        # a batch-level exit: stop the unmasked steps once the largest
        # per-sample mean |Δflow| is below eps. Reading that signal costs
        # one host sync per iteration.
        ran = 0
        while ran < iters - 1:
            net, new_flow, _ = step(net, flow_x, with_mask=False)
            converged = cfg.converge_eps > 0 and (
                float(fused_update.batch_max_delta(new_flow - flow_x)) < cfg.converge_eps)
            flow_x = new_flow
            ran += 1
            if converged:
                break
        net, flow_x, up_mask = step(net, flow_x, with_mask=True)
        outputs = self._outputs(flow_x, up_mask)
        return (*outputs, ran + 1) if cfg.converge_eps > 0 else outputs

    def _train_forward(self, image1, image2, iters, flow_init, remat):
        """The JAX train mode (``models/raft_stereo.py:455-479``): every
        iteration masked and convex-upsampled, the flow carry detached at
        the start of each (no gradient flows between iterations through
        it), the stack [iters, B, f·H, f·W, 1] returned. ``fused_update``
        and ``converge_eps`` are test-mode options and are ignored here.
        With ``remat`` each iteration is recomputed in the backward
        (activation checkpointing), so memory holds the carry and not
        iters × the GRU cascade's activations."""
        net, inp, corr_fn, coords0_x, flow_x = self._encode(
            image1, image2, flow_init, self.config.corr_backend)
        body = functools.partial(self._train_iteration, inp, corr_fn, coords0_x)
        preds = []
        for _ in range(iters):
            args = (flow_x.detach(), *net)
            if remat:
                flow_x, disp_up, *net = torch.utils.checkpoint.checkpoint(
                    body, *args, use_reentrant=False)
            else:
                flow_x, disp_up, *net = body(*args)
            preds.append(disp_up)
        return torch.stack(preds)

    def _train_iteration(self, inp, corr_fn, coords0_x, flow_x, *net):
        net, flow_x, up_mask = self._step(list(net), inp, corr_fn, coords0_x, flow_x, True)
        disp_up = convex_upsample(flow_x[..., None], up_mask.float().permute(0, 2, 3, 1),
                                  self.config.downsample_factor)
        return (flow_x, disp_up, *net)

    def _slow_fast(self, net, inp):
        """The slow-fast schedule's extra coarse-level GRU updates."""
        n_layers = self.config.n_gru_layers
        if self.config.slow_fast_gru:
            if n_layers == 3:
                net = self.update_block(net, inp, iter32=True, iter16=False, iter08=False,
                                        update=False)
            if n_layers >= 2:
                net = self.update_block(net, inp, iter32=n_layers == 3, iter16=True,
                                        iter08=False, update=False)
        return net

    def _fused_step(self, net, inp, flow_x, corr_fn, fused, dtype):
        """An unmasked iteration through the fused step (the JAX
        ``_RefinementStep``'s fused branch): the coarse GRU levels first,
        as in the unfused order, then lookup, motion encoder, finest GRU and
        flow head in ``fused_update.fused_refine_step``."""
        n_layers = self.config.n_gru_layers
        net = self._slow_fast(net, inp)
        if n_layers >= 2:
            net = self.update_block(net, inp, iter32=n_layers == 3, iter16=True,
                                    iter08=False, update=False)
        packed, ctx = fused
        inp16 = None
        if n_layers > 1:
            inp16 = interp_bilinear(net[1], net[0].shape[-2:]).permute(0, 2, 3, 1)
        # h' comes back channel-last; net[0] keeps it as an NCHW view, so
        # the next step passes it to the kernel without a copy.
        h_new, delta = fused_update.fused_refine_step(
            packed, corr_fn.fmap1, corr_fn.fmap2_pyramid, flow_x, net[0].permute(0, 2, 3, 1),
            inp16, ctx, self.config.corr_radius, compute_dtype=dtype,
        )
        net = [h_new.permute(0, 3, 1, 2)] + list(net[1:])
        return net, flow_x + delta, None

    def _outputs(self, flow_x, up_mask):
        disp_up = convex_upsample(flow_x[..., None], up_mask.float().permute(0, 2, 3, 1),
                                  self.config.downsample_factor)
        lowres = torch.stack([flow_x, torch.zeros_like(flow_x)], dim=-1)
        return lowres, disp_up

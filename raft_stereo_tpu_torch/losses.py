"""Losses and metrics (the port's own copy of ``raft_stereo_tpu/losses.py``):
the supervised sequence loss and the self-supervised suite, NHWC tensors.

  * ``sequence_loss``: γ-weighted L1 over the prediction sequence, γ
    adjusted to the iteration count, the validity and max-flow mask, and
    the EPE metrics (reference: train_stereo.py:35-69);
  * SSIM, edge-aware smoothness, disparity warping, the photometric loss
    and their combination (reference: core/losses.py:6-100);
  * ``kitti_metrics`` (reference: core/losses.py:102-107).

Masked means are written as sums over the mask, as in the JAX package
(the same values as boolean indexing).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch.ops.sampling import bilinear_sampler, coords_grid


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask == True, 0 if the mask is empty."""
    denom = torch.clamp(mask.sum(), min=1.0)
    return torch.where(mask, x, torch.zeros_like(x)).sum() / denom


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  loss_gamma: float = 0.9, max_flow: float = 700.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """γ-weighted L1 over the refinement sequence.

    flow_preds [iters, B, H, W, C] (the train-mode stack), flow_gt
    [B, H, W, C], valid [B, H, W]. The decay is ``loss_gamma**(15/(n-1))``
    so the total weighting is the same for any iteration count; pixels
    count where valid >= 0.5 and the GT magnitude is below ``max_flow``.
    Metrics: the last prediction's EPE and its 1/3/5 px fractions.
    """
    n = flow_preds.shape[0]
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    valid = (valid >= 0.5) & (mag < max_flow)
    mask = valid[..., None]
    gamma = loss_gamma ** (15.0 / (n - 1)) if n > 1 else loss_gamma
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    abs_err = torch.abs(flow_preds - flow_gt[None])
    per_iter = torch.stack([_masked_mean(e, mask) for e in abs_err])
    flow_loss = torch.sum(weights * per_iter)

    epe = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
    metrics = {
        "epe": _masked_mean(epe, valid),
        "1px": _masked_mean((epe < 1).float(), valid),
        "3px": _masked_mean((epe < 3).float(), valid),
        "5px": _masked_mean((epe < 5).float(), valid),
    }
    return flow_loss, metrics


def ssim_distance(x: torch.Tensor, y: torch.Tensor, md: int = 1) -> torch.Tensor:
    """Per-pixel SSIM distance (1 - SSIM)/2 in [0, 1] over a reflect-padded
    (2·md+1)² window; x, y [B, H, W, C]."""
    patch = 2 * md + 1
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def avg(v):
        vp = F.pad(v.permute(0, 3, 1, 2), (md, md, md, md), mode="reflect")
        return F.avg_pool2d(vp, patch, stride=1).permute(0, 2, 3, 1)

    mu_x, mu_y = avg(x), avg(y)
    sigma_x = avg(x * x) - mu_x ** 2
    sigma_y = avg(y * y) - mu_y ** 2
    sigma_xy = avg(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - num / den) / 2, 0.0, 1.0)


def _gradient(data: torch.Tensor):
    """(d/dx, d/dy) forward differences of [B, H, W, C]."""
    return data[:, :, 1:, :] - data[:, :, :-1, :], data[:, 1:, :, :] - data[:, :-1, :, :]


def smooth_grad(disp: torch.Tensor, image: torch.Tensor, alpha: float,
                order: int = 1) -> torch.Tensor:
    """Edge-aware smoothness (reference: core/losses.py:52-72)."""
    img_dx, img_dy = _gradient(image)
    w_x = torch.exp(-torch.mean(torch.abs(img_dx), dim=-1, keepdim=True) * alpha)
    w_y = torch.exp(-torch.mean(torch.abs(img_dy), dim=-1, keepdim=True) * alpha)
    dx, dy = _gradient(disp)
    if order == 2:
        dx, _ = _gradient(dx)
        _, dy = _gradient(dy)
        # second-order weights crop one more pixel
        w_x = w_x[:, :, 1:, :]
        w_y = w_y[:, 1:, :, :]
    loss_x = w_x[:, :, 1:, :] * torch.abs(dx[:, :, 1:, :])
    loss_y = w_y[:, 1:, :, :] * torch.abs(dy[:, 1:, :, :])
    return loss_x.mean() / 2.0 + loss_y.mean() / 2.0


def loss_smooth(disp: torch.Tensor, im1_scaled: torch.Tensor) -> torch.Tensor:
    return smooth_grad(disp, im1_scaled, 1.0, order=1)


def disp_warp(x: torch.Tensor, disp: torch.Tensor, r2l: bool = False) -> torch.Tensor:
    """Warp ``x`` [B, H, W, C] along the epipolar line by ``disp``
    [B, H, W, 1], with the reference's coordinate quirk (core/losses.py:
    74-83): the grid is normalised for align_corners=True but sampled with
    align_corners=False, so a pixel p samples p·W/(W-1) - 0.5 on both axes,
    clamped to the border."""
    B, H, W, _ = x.shape
    offset = 1.0 if r2l else -1.0
    grid = coords_grid(B, H, W, device=x.device, dtype=x.dtype)
    sample_x = grid[..., :1] + offset * disp
    px = torch.clamp(sample_x * (W / (W - 1)) - 0.5, 0.0, W - 1.0)
    py = torch.clamp(grid[..., 1:] * (H / (H - 1)) - 0.5, 0.0, H - 1.0)
    return bilinear_sampler(x, torch.cat([px, py], dim=-1))


def loss_photometric(im1_scaled: torch.Tensor, im1_recons: torch.Tensor) -> torch.Tensor:
    """0.15·L1 + 0.85·SSIM, averaged over channels → [B, H, W, 1]
    (reference: core/losses.py:85-90)."""
    l1 = 0.15 * torch.abs(im1_scaled - im1_recons).mean(dim=-1, keepdim=True)
    ssim = 0.85 * ssim_distance(im1_recons, im1_scaled).mean(dim=-1, keepdim=True)
    return l1 + ssim


def self_supervised_loss(disp12: torch.Tensor, im1: torch.Tensor, im2: torch.Tensor,
                         r2l: bool = False) -> torch.Tensor:
    """Min-composite photometric + 1e-5 smoothness (core/losses.py:92-100)."""
    im1_recons = disp_warp(im2, disp12, r2l)
    warp_losses = torch.cat([loss_photometric(im1, im1_recons), loss_photometric(im2, im1)],
                            dim=-1)
    loss_warp = torch.min(warp_losses, dim=-1).values
    loss_sm = 1e-5 * loss_smooth(disp12, im1)
    return (loss_warp + loss_sm).mean()


def kitti_metrics(disp: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor):
    """D1-style metrics (reference: core/losses.py:102-107)."""
    error = torch.abs(disp - gt)
    v = valid > 0
    bad3 = _masked_mean(((error > 3) & (error / torch.clamp(gt, min=1e-9) > 0.05)).float(), v)
    return {"bad 3": bad3 * 100.0, "epe": _masked_mean(error, v), "errormap": error * v}

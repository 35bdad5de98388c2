"""The guided cells' inputs: ``traffic.image_pool``'s stereo pairs with a
third slot, a dense proxy disparity of each pair, in the form
``evaluate_mad --fusion`` feeds its guidance (the decoded ``flow_gt``: the
x-flow, -disparity, host float32 [H, W, 1]).

The proxy is the pair's true x-flow with seeded Gaussian noise of
``guide_noise_px`` pixels, standing in for an SGM map or rasterised LiDAR
(the fork's own evaluation feeds the dense ground truth). Each pair's
disparity follows ``traffic.image_pool``'s rule, so the guide matches the
shift between the pair's views.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from portbench import traffic


def disparities(cell: dict, seed: int) -> np.ndarray:
    """Each pool pair's disparity in pixels, in pool order: the rule of
    ``traffic.image_pool`` (the same set for every seed, in the seed's
    order)."""
    lo, hi = (int(v) for v in cell.get("disparity_px", (8, 64)))
    disp = np.linspace(lo, hi, len(traffic.pool_sizes(cell))).round().astype(int)
    return np.random.default_rng([int(seed), 3]).permutation(disp)


def guided_pool(cell: dict, seed: int, device) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``pool_pairs`` (left, right, guide) host float32 triples: [H, W, 3],
    [H, W, 3] and the noisy x-flow [H, W, 1], the noise drawn on the
    device."""
    device = torch.device(device)
    noise_seed = int(np.random.default_rng([int(seed), 5]).integers(2 ** 62))
    g = torch.Generator(device=device).manual_seed(noise_seed)
    sigma = float(cell["guide_noise_px"])
    out = []
    for (left, right), d in zip(traffic.image_pool(cell, seed, device),
                                disparities(cell, seed)):
        h, w = left.shape[:2]
        guide = torch.randn((h, w, 1), generator=g, device=device).mul_(sigma).sub_(float(d))
        out.append((left, right, guide.cpu().numpy()))
    return out

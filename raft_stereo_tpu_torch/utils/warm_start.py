"""Host-side warm-start helper (the port's own copy of
``raft_stereo_tpu/utils/warm_start.py``; reference:
core/utils/utils.py:28-56).

``forward_interpolate`` forward-warps a flow field to serve as the next
frame's ``flow_init`` (video inference): each pixel's flow is scattered to
its target, and the holes are filled by nearest-neighbour interpolation
(scipy's ``griddata``, imported when called). Pure numpy/scipy: it runs on
the host, on the thread that decodes the next frame.
"""

from __future__ import annotations

import numpy as np


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """flow: [H, W, 2] (x, y) numpy → forward-warped [H, W, 2] float32.

    The reference's semantics (out-of-range targets dropped, nearest
    griddata fill), channel-last.
    """
    from scipy import interpolate

    flow = np.asarray(flow)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))

    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)

    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]

    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)

"""Host-side data augmentation, dense and sparse (the port's own copy of
``raft_stereo_tpu/data/augmentor.py:92-358``), with the same probability
schedule, semantics and random draws in the same order:

  * photometric: brightness/contrast/saturation/hue jitter + gamma, applied
    asymmetrically per image with prob 0.2 else to the stacked pair (dense;
    the sparse variant is always symmetric), through the native kernel
    (``native/``) as the JAX package runs it;
  * eraser occlusion rectangles on img2 with its mean colour (prob 0.5);
  * scale + stretch with a min-scale clamp, optional h/v/hf flips;
  * random crop, the dense one with ±2 px of y-jitter between the two
    crops; the sparse flow resized by scattering its valid samples and
    crops clamped to a margin.

There is no OpenCV here: :func:`resize_linear` is the port's own bilinear
resize with ``cv2.resize(src, None, fx, fy, INTER_LINEAR)``'s rules (output
size round(w·fx), source position (x + 0.5)/fx − 0.5, edge clamp; 8-bit
images through its 11-bit fixed-point weights, float images in float32).

All randomness flows through an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from raft_stereo_tpu_torch import native

COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _taps(n_in: int, n_out: int, scale: float):
    """Per output index of one axis: the two source indices and their
    float32 weights (cv2's rule: position computed in double, cast to
    float, floored; left of 0 and at or right of n_in-1 clamped with weight
    0 on the second tap)."""
    pos = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s0 = np.floor(pos).astype(np.int64)
    frac = (pos - s0.astype(np.float32)).astype(np.float32)
    clamp = (s0 < 0) | (s0 >= n_in - 1)
    frac[clamp] = 0.0
    s0 = np.clip(s0, 0, n_in - 1)
    s1 = np.minimum(s0 + 1, n_in - 1)
    return s0, s1, (np.float32(1.0) - frac).astype(np.float32), frac


def resize_linear(src: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Bilinear resize of [H, W] or [H, W, C] by factors (fx, fy), as
    ``cv2.resize(src, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)``."""
    H, W = src.shape[:2]
    out_w, out_h = int(round(W * fx)), int(round(H * fy))
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize of {W}x{H} by ({fx}, {fy}) is empty")
    if out_w == W and out_h == H and fx == 1.0 and fy == 1.0:
        return src.copy()
    x0, x1, ax0, ax1 = _taps(W, out_w, 1.0 / fx)
    y0, y1, by0, by1 = _taps(H, out_h, 1.0 / fy)
    expand = (slice(None),) + (None,) * (src.ndim - 2)
    if src.dtype == np.uint8:
        ia0 = np.rint(ax0 * COEF_SCALE).astype(np.int64)
        ia1 = np.rint(ax1 * COEF_SCALE).astype(np.int64)
        ib0 = np.rint(by0 * COEF_SCALE).astype(np.int64)
        ib1 = np.rint(by1 * COEF_SCALE).astype(np.int64)
        s = src.astype(np.int64)
        rows = s[:, x0] * ia0[expand] + s[:, x1] * ia1[expand]  # [H, out_w, ...]
        r0, r1 = rows[y0] >> 4, rows[y1] >> 4
        v = (((r0 * ib0[(slice(None), None) + expand[1:]]) >> 16)
             + ((r1 * ib1[(slice(None), None) + expand[1:]]) >> 16) + 2) >> 2
        return np.clip(v, 0, 255).astype(np.uint8)
    s = src.astype(np.float32)
    rows = s[:, x0] * ax0[expand] + s[:, x1] * ax1[expand]
    by0 = by0[(slice(None), None) + expand[1:]]
    by1 = by1[(slice(None), None) + expand[1:]]
    return (rows[y0] * by0 + rows[y1] * by1).astype(src.dtype)


class ColorJitter:
    """Colour jitter with torchvision-compatible factor sampling, through
    the native fused kernel."""

    def __init__(self, brightness, contrast, saturation, hue, gamma=(1, 1, 1, 1)):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = tuple(saturation)
        self.hue = hue
        self.gamma = tuple(gamma)  # (gamma_min, gamma_max, gain_min, gain_max)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        # the four jitters in a fixed order (torchvision draws one)
        b = rng.uniform(max(0.0, 1 - self.brightness), 1 + self.brightness)
        c = rng.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
        s = rng.uniform(*self.saturation)
        h = rng.uniform(-self.hue, self.hue)
        gmin, gmax, gainmin, gainmax = self.gamma
        gamma = rng.uniform(gmin, gmax)
        gain = rng.uniform(gainmin, gainmax)
        return native.fused_photometric(np.ascontiguousarray(img.astype(np.uint8)),
                                        b, c, s, h * 360.0, gamma, gain)


class FlowAugmentor:
    """Dense augmentor (reference: core/utils/augmentor.py:60-182)."""

    sparse = False

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip=True, yjitter: bool = False,
                 saturation_range: Sequence[float] = (0.6, 1.4),
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitter(0.4, 0.4, saturation_range, 0.5 / 3.14, gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            return self.photo_aug(img1, rng), self.photo_aug(img2, rng)
        stack = self.photo_aug(np.concatenate([img1, img2], axis=0), rng)
        i1, i2 = np.split(stack, 2, axis=0)
        return i1, i2

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = np.ascontiguousarray(img2)
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            rects = np.asarray(
                [[rng.integers(0, wd), rng.integers(0, ht),
                  rng.integers(bounds[0], bounds[1]), rng.integers(bounds[0], bounds[1])]
                 for _ in range(rng.integers(1, 3))], np.int64)
            if img2.dtype == np.uint8:
                native.eraser_fill(img2, mean_color.astype(np.float32), rects)
            else:
                for x0, y0, dx, dy in rects:
                    img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def _sample_scales(self, ht, wd, rng, pad):
        min_scale = max((self.crop_size[0] + pad) / float(ht),
                        (self.crop_size[1] + pad) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(scale_x, min_scale), max(scale_y, min_scale)

    def _flips(self, img1, img2, flow, rng):
        if self.do_flip:
            if rng.random() < self.h_flip_prob and self.do_flip == "hf":
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.h_flip_prob and self.do_flip == "h":
                # stereo-consistent: swap eyes and mirror
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.random() < self.v_flip_prob and self.do_flip == "v":
                img1, img2 = img1[::-1, :], img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]
        return img1, img2, flow

    def spatial_transform(self, img1, img2, flow, rng):
        ht, wd = img1.shape[:2]
        scale_x, scale_y = self._sample_scales(ht, wd, rng, pad=8)
        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow = resize_linear(flow, scale_x, scale_y) * [scale_x, scale_y]
        img1, img2, flow = self._flips(img1, img2, flow, rng)
        ch, cw = self.crop_size
        if self.yjitter:
            y0 = rng.integers(2, img1.shape[0] - ch - 2)
            x0 = rng.integers(2, img1.shape[1] - cw - 2)
            y1 = y0 + rng.integers(-2, 3)
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y1:y1 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        else:
            y0 = rng.integers(0, img1.shape[0] - ch)
            x0 = rng.integers(0, img1.shape[1] - cw)
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y0:y0 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return np.ascontiguousarray(img1), np.ascontiguousarray(img2), np.ascontiguousarray(flow)


class SparseFlowAugmentor(FlowAugmentor):
    """Sparse-GT augmentor (reference: core/utils/augmentor.py:184-317)."""

    sparse = True

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False, yjitter=False,
                 saturation_range=(0.7, 1.3), gamma=(1, 1, 1, 1)):
        super().__init__(crop_size, min_scale, max_scale, do_flip, yjitter, saturation_range,
                         gamma)
        self.spatial_aug_prob = 0.8
        self.photo_aug = ColorJitter(0.3, 0.3, saturation_range, 0.3 / 3.14, gamma)

    def color_transform(self, img1, img2, rng):
        # always symmetric (reference :204-208)
        stack = self.photo_aug(np.concatenate([img1, img2], axis=0), rng)
        i1, i2 = np.split(stack, 2, axis=0)
        return i1, i2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Scatter-based sparse resize (reference :223-255)."""
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        valid_flat = valid.reshape(-1).astype(np.float32)
        coords0 = coords[valid_flat >= 1]
        flow0 = flow_flat[valid_flat >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
        valid_img = np.zeros([ht1, wd1], dtype=np.int32)
        flow_img[yy[v], xx[v]] = flow1[v]
        valid_img[yy[v], xx[v]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng):
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht), (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = max(scale, min_scale)
        scale_y = max(scale, min_scale)
        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid, fx=scale_x, fy=scale_y)
        img1, img2, flow = self._flips(img1, img2, flow, rng)
        ch, cw = self.crop_size
        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, img1.shape[0] - ch + margin_y)
        x0 = rng.integers(-margin_x, img1.shape[1] - cw + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, img1.shape[1] - cw))
        img1 = img1[y0:y0 + ch, x0:x0 + cw]
        img2 = img2[y0:y0 + ch, x0:x0 + cw]
        flow = flow[y0:y0 + ch, x0:x0 + cw]
        valid = valid[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow, valid, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))

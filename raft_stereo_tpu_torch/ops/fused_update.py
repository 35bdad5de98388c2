"""One fused test-mode refinement step through the hand-written CUDA kernel
``csrc/fused_update.cu`` (the port of
``raft_stereo_tpu/ops/pallas_fused_update.py``).

The step covers, at the finest GRU level, the alt correlation lookup, the
motion encoder, the ConvGRU and the x-only flow head, and returns only
``(h', delta_disp)``. Public functions take the JAX layout: fmap1
[B, H, W, D] and the pooled pyramid fmap2_pyramid[i] [B, H, W_i, D] in
fp32, flow_x [B, H, W] fp32, h [B, H, W, dh], inp16 [B, H, W, Ci] or None
(one GRU level), ctx [B, H, W, 3·dh] = cz|cr|cq, the last three in the
compute dtype.

``fused_refine_step`` computes the plain version ``reference_refine_step``
on CPU tensors; on CUDA tensors it launches the kernel or raises.
Inference only: there is no backward yet (the JAX VJP,
``pallas_fused_update.py:474-497``, is still to port), so a call under
grad mode with an input that requires grad raises on either device rather
than return a result without a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch.ops import _build
from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain

KERNEL = "fused_update"
MAX_LEVELS = 8
RADII = (1, 2, 3, 4)
MAX_D = 512
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

# The motion encoder's fixed widths: cor|flo, cf2 and m have 128 channels
# (m = 126 conv channels, the x-flow, a zero), the flow head 256 hidden.
MOTION_CH = 128
FLOW_CH = 126
HEAD_CH = 256

# Weight keys in the kernel's layout: taps first, [kh·kw, cin, cout];
# biases are fp32 vectors.
WEIGHT_KEYS = ("wc1", "kf7", "wcf", "km", "wzr", "wq", "kfh1", "kfh2")
BIAS_KEYS = ("bc1", "bf7", "bcf", "bm", "bzr", "bq", "bfh1", "bfh2")

# Pointer slots of ``fused_update_step``, in the order of the kernel
# source's ``Slot`` enum.
SLOTS = (
    "f1", "flow", "h", "inp16", "ctx",
    "wc1", "bc1", "kf7", "bf7", "wcf", "bcf", "km", "bm", "wzr", "bzr", "wq", "bq",
    "kfh1", "bfh1", "kfh2", "bfh2",
    "h_out", "delta",
    "cf", "cf2", "m", "z", "rh", "fh1",
)

# Kernel launches since the count was last set to 0 (one a step).
LAUNCHES = 0

_fn = None


def _taps(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight → [kh·kw, cin, cout]."""
    o, i, kh, kw = weight.shape
    return weight.permute(2, 3, 1, 0).reshape(kh * kw, i, o)


@torch.no_grad()
def pack_fused_params(update_block, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The kernel's weights from the port's ``BasicMultiUpdateBlock``
    (``encoder``, ``gru08``, ``flow_head``): weights in ``dtype``, biases
    in fp32, all contiguous.

    The counterpart of the JAX ``pack_fused_params``. It drops the TPU's
    layout pads where the kernel has no use for them: convf1 keeps only its
    x input channel ([49, 64], not 8 padded channels), convc2|convf2 are
    two groups ([9, 64, 128], not a block-diagonal 128→128 kernel), and
    the flow head's conv2 keeps its x output column ([9, 256]). The motion
    conv keeps its two zero output channels (126 → 128), so m comes out at
    full width with the flow added in channel 126.
    """
    enc, gru, head = update_block.encoder, update_block.gru08, update_block.flow_head
    conv_m = _taps(enc.conv.weight)
    packed = {
        "wc1": enc.convc1.weight[:, :, 0, 0].t(),
        "bc1": enc.convc1.bias,
        "kf7": _taps(enc.convf1.weight[:, :1])[:, 0],
        "bf7": enc.convf1.bias,
        "wcf": torch.cat([_taps(enc.convc2.weight), _taps(enc.convf2.weight)], dim=2),
        "bcf": torch.cat([enc.convc2.bias, enc.convf2.bias]),
        "km": F.pad(conv_m, (0, MOTION_CH - conv_m.shape[2])),
        "bm": F.pad(enc.conv.bias, (0, MOTION_CH - conv_m.shape[2])),
        "wzr": torch.cat([_taps(gru.convz.weight), _taps(gru.convr.weight)], dim=2),
        "bzr": torch.cat([gru.convz.bias, gru.convr.bias]),
        "wq": _taps(gru.convq.weight),
        "bq": gru.convq.bias,
        "kfh1": _taps(head.conv1.weight),
        "bfh1": head.conv1.bias,
        "kfh2": _taps(head.conv2.weight[:1])[:, :, 0],
        "bfh2": head.conv2.bias[:1],
    }
    return {k: v.detach().to(dtype if k in WEIGHT_KEYS else torch.float32).contiguous()
            for k, v in packed.items()}


def _conv(x: torch.Tensor, taps: torch.Tensor, cd: torch.dtype, bias=None, groups: int = 1):
    """SAME conv of NCHW ``x`` with [k·k, cin, cout] ``taps``: operands
    rounded to ``cd``, products summed in fp32 (the JAX twin's
    ``preferred_element_type=float32``), fp32 out."""
    k = int(round(taps.shape[0] ** 0.5))
    w = taps.reshape(k, k, taps.shape[1], taps.shape[2]).permute(3, 2, 0, 1)
    y = F.conv2d(x.to(cd).float(), w.to(cd).float(), padding=k // 2, groups=groups)
    return y if bias is None else y + bias.float()[:, None, None]


def reference_refine_step(packed: Dict[str, torch.Tensor], fmap1: torch.Tensor,
                          fmap2_pyramid: Sequence[torch.Tensor], flow_x: torch.Tensor,
                          h: torch.Tensor, inp16: Optional[torch.Tensor], ctx: torch.Tensor,
                          radius: int, compute_dtype: torch.dtype = torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel, with the cast points of the JAX
    ``reference_refine_step``: the corr window, cor, flo, cf2 and m in the
    compute dtype; h in fp32 for the blend and cast for the convs; r·h
    cast; h' computed in fp32 and stored in h's dtype; fh1 cast; delta
    fp32. Returns ``(h' [B, H, W, dh], delta [B, H, W] fp32)``."""
    cd = compute_dtype
    W1 = fmap1.shape[2]
    dh = h.shape[-1]

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    coords = torch.arange(W1, dtype=torch.float32, device=flow_x.device) + flow_x
    corr = corr_lookup_alt_plain(fmap1, list(fmap2_pyramid), coords, radius).to(cd)
    cor = torch.relu(torch.einsum("bhwk,kc->bchw", corr.float(), packed["wc1"].to(cd).float())
                     + packed["bc1"].float()[:, None, None]).to(cd)
    flow = flow_x[:, None].float()
    flo = torch.relu(_conv(flow, packed["kf7"][:, None], cd, packed["bf7"])).to(cd)
    cf2 = torch.relu(_conv(torch.cat([cor, flo], 1), packed["wcf"], cd, packed["bcf"],
                           groups=2)).to(cd)
    m = torch.relu(_conv(cf2, packed["km"], cd, packed["bm"]))
    m[:, FLOW_CH] += flow_x  # m's channel layout: [126 conv, x-flow, 0]
    m = m.to(cd)

    xs = [m] + ([nchw(inp16).to(cd)] if inp16 is not None else [])
    hf = nchw(h).float()
    cz, cr, cq = (nchw(ctx[..., i * dh:(i + 1) * dh]).float() for i in range(3))
    zr = _conv(torch.cat([hf.to(cd)] + xs, 1), packed["wzr"], cd, packed["bzr"])
    z = torch.sigmoid(zr[:, :dh] + cz)
    r = torch.sigmoid(zr[:, dh:] + cr)
    q = _conv(torch.cat([(r * hf).to(cd)] + xs, 1), packed["wq"], cd, packed["bq"])
    q = torch.tanh(q + cq)
    h_new = (1.0 - z) * hf + z * q

    fh1 = torch.relu(_conv(h_new.to(cd), packed["kfh1"], cd, packed["bfh1"])).to(cd)
    delta = _conv(fh1, packed["kfh2"][..., None], cd)[:, 0] + packed["bfh2"].float()[0]
    return h_new.permute(0, 2, 3, 1).to(h.dtype), delta


def batch_max_delta(delta: torch.Tensor) -> torch.Tensor:
    """The batch's convergence signal for one step: the largest over the
    batch of each sample's mean |delta| ([B, H, W] → scalar fp32). A batch
    leaves the refinement loop once its worst member has converged."""
    return delta.float().abs().mean(dim=(1, 2)).amax()


def _kernel():
    """The bound C entry point, built and loaded at first use."""
    global _fn
    if _fn is None:
        lib = _build.load(KERNEL)
        if lib.fused_update_slots() != len(SLOTS):
            raise RuntimeError(f"{KERNEL} kernel takes {lib.fused_update_slots()} pointer "
                               f"slots, the wrapper passes {len(SLOTS)}")
        fn = lib.fused_update_step
        fn.argtypes = [
            ctypes.c_int,  # bf16 compute
            ctypes.POINTER(ctypes.c_void_p),  # host array of SLOTS pointers
            ctypes.POINTER(ctypes.c_void_p),  # host array of level pointers
            ctypes.POINTER(ctypes.c_int),  # host array of level widths
            ctypes.c_int,  # levels
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, D
            ctypes.c_int,  # radius
            ctypes.c_int,  # dh
            ctypes.c_int,  # inp16 channels (0: none)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _expect(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the step runs on {device}")


def _check(packed, fmap1, pyramid, flow_x, h, inp16, ctx, radius, cd) -> None:
    if cd not in COMPUTE_DTYPES:
        raise TypeError(f"fused_update kernel computes in {COMPUTE_DTYPES}, got {cd}")
    if fmap1.dim() != 4 or fmap1.numel() == 0:
        raise ValueError(f"fmap1 must be a non-empty [B, H, W, D], got {tuple(fmap1.shape)}")
    B, H, W, D = fmap1.shape
    dev = fmap1.device
    if D % 4 or D > MAX_D:
        raise ValueError(f"fused_update kernel needs D % 4 == 0 and D <= {MAX_D}, got D={D}")
    if radius not in RADII:
        raise ValueError(f"fused_update kernel supports radius in {RADII}, got {radius}")
    L = len(pyramid)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"fused_update kernel takes 1..{MAX_LEVELS} levels, got {L}")
    _expect("fmap1", fmap1, (B, H, W, D), torch.float32, dev)
    for i, f2 in enumerate(pyramid):
        if f2.dim() != 4 or f2.shape[2] < 1:
            raise ValueError(f"pyramid level {i} must be [{B}, {H}, W_i >= 1, {D}], "
                             f"got {tuple(f2.shape)}")
        _expect(f"pyramid level {i}", f2, (B, H, f2.shape[2], D), torch.float32, dev)
    _expect("flow_x", flow_x, (B, H, W), torch.float32, dev)
    if h.dim() != 4:
        raise ValueError(f"h must be [B, H, W, dh], got {tuple(h.shape)}")
    dh = h.shape[-1]
    if dh % 64:
        raise ValueError(f"fused_update kernel needs dh % 64 == 0, got dh={dh}")
    _expect("h", h, (B, H, W, dh), cd, dev)
    ci = 0
    if inp16 is not None:
        ci = inp16.shape[-1]
        if ci % 32 or ci == 0:
            raise ValueError(f"fused_update kernel needs inp16 channels % 32 == 0, got {ci}")
        _expect("inp16", inp16, (B, H, W, ci), cd, dev)
    _expect("ctx", ctx, (B, H, W, 3 * dh), cd, dev)
    din = dh + MOTION_CH + ci
    K = 2 * radius + 1
    want = {
        "wc1": (L * K, 64), "bc1": (64,), "kf7": (49, 64), "bf7": (64,),
        "wcf": (9, 64, MOTION_CH), "bcf": (MOTION_CH,), "km": (9, MOTION_CH, MOTION_CH),
        "bm": (MOTION_CH,), "wzr": (9, din, 2 * dh), "bzr": (2 * dh,), "wq": (9, din, dh),
        "bq": (dh,), "kfh1": (9, dh, HEAD_CH), "bfh1": (HEAD_CH,), "kfh2": (9, HEAD_CH),
        "bfh2": (1,),
    }
    for k, shape in want.items():
        if k not in packed:
            raise ValueError(f"packed weights lack {k!r}")
        if tuple(packed[k].shape) != shape:
            raise ValueError(f"packed {k} must be {shape} for this step, "
                             f"got {tuple(packed[k].shape)}")
        if packed[k].device != dev:
            raise ValueError(f"packed {k} is on {packed[k].device}, the step runs on {dev}")


def fused_refine_step(packed: Dict[str, torch.Tensor], fmap1: torch.Tensor,
                      fmap2_pyramid: Sequence[torch.Tensor], flow_x: torch.Tensor,
                      h: torch.Tensor, inp16: Optional[torch.Tensor], ctx: torch.Tensor,
                      radius: int, compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One refinement step: ``(h' [B, H, W, dh] in h's dtype, delta_disp
    [B, H, W] fp32)`` (see the module docstring)."""
    global LAUNCHES
    if torch.is_grad_enabled():
        needs = [name for name, t in (("fmap1", fmap1), ("flow_x", flow_x), ("h", h),
                                      ("inp16", inp16), ("ctx", ctx), *packed.items(),
                                      *((f"pyramid level {i}", f)
                                        for i, f in enumerate(fmap2_pyramid)))
                 if t is not None and t.requires_grad]
        if needs:
            raise RuntimeError(
                f"fused_refine_step has no backward yet, but {needs} require grad: the "
                "fused step runs in test mode only (call it under torch.no_grad())")
    if fmap1.device.type == "cpu":
        return reference_refine_step(packed, fmap1, fmap2_pyramid, flow_x, h, inp16, ctx,
                                     radius, compute_dtype)
    if fmap1.device.type != "cuda":
        raise ValueError(f"fused_update runs on CPU or CUDA tensors, not {fmap1.device}")
    cd = compute_dtype
    _check(packed, fmap1, fmap2_pyramid, flow_x, h, inp16, ctx, radius, cd)
    B, H, W, D = fmap1.shape
    dh = h.shape[-1]
    dev = fmap1.device
    P = B * H * W
    # Pooled levels and permuted states may be strided views: the kernel
    # indexes dense rows. Weights already packed in the compute dtype (as
    # the model packs them, once a forward) pass through without a copy.
    t = {
        "f1": fmap1.contiguous(), "flow": flow_x.contiguous(), "h": h.contiguous(),
        "inp16": None if inp16 is None else inp16.contiguous(), "ctx": ctx.contiguous(),
        **{k: packed[k].to(cd).contiguous() for k in WEIGHT_KEYS},
        **{k: packed[k].float().contiguous() for k in BIAS_KEYS},
        "h_out": torch.empty((B, H, W, dh), dtype=cd, device=dev),
        "delta": torch.empty((B, H, W), dtype=torch.float32, device=dev),
        "cf": torch.empty((P, MOTION_CH), dtype=cd, device=dev),
        "cf2": torch.empty((P, MOTION_CH), dtype=cd, device=dev),
        "m": torch.empty((P, MOTION_CH), dtype=cd, device=dev),
        "z": torch.empty((P, dh), dtype=torch.float32, device=dev),
        "rh": torch.empty((P, dh), dtype=cd, device=dev),
        "fh1": torch.empty((P, HEAD_CH), dtype=cd, device=dev),
    }
    levels = [f.contiguous() for f in fmap2_pyramid]
    for name, x in list(t.items()) + [(f"pyramid level {i}", x) for i, x in enumerate(levels)]:
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"fused_update kernel needs 16-byte aligned {name}")
    fn = _kernel()
    ptrs = (ctypes.c_void_p * len(SLOTS))(
        *[None if t[k] is None else t[k].data_ptr() for k in SLOTS])
    lvl = (ctypes.c_void_p * len(levels))(*[x.data_ptr() for x in levels])
    widths = (ctypes.c_int * len(levels))(*[x.shape[2] for x in levels])
    ci = 0 if inp16 is None else inp16.shape[-1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(int(cd == torch.bfloat16), ptrs, lvl, widths, len(levels), B, H, W, D,
                 radius, dh, ci, stream)
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t["h_out"], t["delta"]

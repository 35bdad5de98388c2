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
``motion_in`` does the same for the kernel's first launch alone (the
lookup with convc1 and convf1, plain version ``reference_motion_in``);
``motion_in_geometry`` is that launch's geometry. ``head_out`` does it
for the last launch alone (the flow head's conv2, x channel, plain
version ``reference_head_out``, geometry ``head_out_geometry``).
``fused_refine_step`` is differentiable on both devices, as the JAX
``_fused_op`` is (``pallas_fused_update.py:465-497``): its backward is the
plain version's autograd, recomputed from the saved inputs, and gives
gradients to the packed weights, fmap1, every pyramid level, h, inp16 and
ctx; ``flow_x`` gets none (the model detaches the flow every step).
``motion_in`` and ``head_out`` have no backward: under grad mode, an
input that requires grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

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

# Stage 1's geometry: at most SEGMENT (level, pixel) pairs a block; the
# channels staged a step, widest first (all but the last may leave three
# blocks an SM); the shared memory of a block and of an SM, less what the
# card keeps of an SM's for each resident block.
SEGMENT = 256
CHUNKS = (32, 16, 8, 4)
SMEM = 227 * 1024
SMEM_SM = 228 * 1024
SMEM_RESERVED = 1024

# Stage 7's output tile, rows x columns of one image (csrc/fused_update.cu,
# namespace ho).
HEAD_TILE = (8, 32)

# Kernel launches since the count was last set to 0: fused steps (one a
# step), stage-1 launches through ``motion_in`` and stage-7 launches
# through ``head_out``.
LAUNCHES = 0
MOTION_IN_LAUNCHES = 0
HEAD_OUT_LAUNCHES = 0

_fn = None


def _taps(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight → [kh·kw, cin, cout]."""
    o, i, kh, kw = weight.shape
    return weight.permute(2, 3, 1, 0).reshape(kh * kw, i, o)


def pack_fused_params(update_block, dtype: torch.dtype = torch.float32, *,
                      grad: bool = False) -> Dict[str, torch.Tensor]:
    """The kernel's weights from the port's ``BasicMultiUpdateBlock``
    (``encoder``, ``gru08``, ``flow_head``): weights in ``dtype``, biases
    in fp32, all contiguous; detached, unless ``grad`` asks for a packing
    that gradients flow through to the block's convs.

    The counterpart of the JAX ``pack_fused_params``. It drops the TPU's
    layout pads where the kernel has no use for them: convf1 keeps only its
    x input channel ([49, 64], not 8 padded channels), convc2|convf2 are
    two groups ([9, 64, 128], not a block-diagonal 128→128 kernel), and
    the flow head's conv2 keeps its x output column ([9, 256]). The motion
    conv keeps its two zero output channels (126 → 128), so m comes out at
    full width with the flow added in channel 126.
    """
    with torch.set_grad_enabled(grad):
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
        return {k: (v if grad else v.detach()).to(dtype if k in WEIGHT_KEYS else torch.float32)
                .contiguous() for k, v in packed.items()}


def _conv(x: torch.Tensor, taps: torch.Tensor, cd: torch.dtype, bias=None, groups: int = 1):
    """SAME conv of NCHW ``x`` with [k·k, cin, cout] ``taps``: operands
    rounded to ``cd``, products summed in fp32 (the JAX twin's
    ``preferred_element_type=float32``), fp32 out."""
    k = int(round(taps.shape[0] ** 0.5))
    w = taps.reshape(k, k, taps.shape[1], taps.shape[2]).permute(3, 2, 0, 1)
    y = F.conv2d(x.to(cd).float(), w.to(cd).float(), padding=k // 2, groups=groups)
    return y if bias is None else y + bias.float()[:, None, None]


def reference_motion_in(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                        flow_x: torch.Tensor, packed: Dict[str, torch.Tensor], radius: int,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the kernel's first launch: cor|flo [B, H, W,
    128] in the compute dtype, cor = relu(convc1(the lookup's window, cast)
    + bc1) and flo = relu(convf1(the x-flow, cast) + bf7), each cast (the
    JAX ``reference_refine_step``'s first cast points). A channels-last view
    of an NCHW tensor."""
    cd = compute_dtype
    W1 = fmap1.shape[2]
    coords = torch.arange(W1, dtype=torch.float32, device=flow_x.device) + flow_x
    corr = corr_lookup_alt_plain(fmap1, list(fmap2_pyramid), coords, radius).to(cd)
    cor = torch.relu(torch.einsum("bhwk,kc->bchw", corr.float(), packed["wc1"].to(cd).float())
                     + packed["bc1"].float()[:, None, None]).to(cd)
    flo = torch.relu(_conv(flow_x[:, None].float(), packed["kf7"][:, None], cd,
                           packed["bf7"])).to(cd)
    return torch.cat([cor, flo], 1).permute(0, 2, 3, 1)


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
    dh = h.shape[-1]

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    cf = nchw(reference_motion_in(fmap1, fmap2_pyramid, flow_x, packed, radius, cd))
    cf2 = torch.relu(_conv(cf, packed["wcf"], cd, packed["bcf"], groups=2)).to(cd)
    m = torch.relu(_conv(cf2, packed["km"], cd, packed["bm"]))
    # m's channel layout: [126 conv, x-flow, 0] (out of place: relu keeps
    # its output for the backward)
    m = torch.cat([m[:, :FLOW_CH], (m[:, FLOW_CH] + flow_x)[:, None], m[:, FLOW_CH + 1:]], 1)
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
    delta = reference_head_out(fh1.permute(0, 2, 3, 1), packed, cd)
    return h_new.permute(0, 2, 3, 1).to(h.dtype), delta


def reference_head_out(fh1: torch.Tensor, packed: Dict[str, torch.Tensor],
                       compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the kernel's last launch: delta [B, H, W] fp32,
    the flow head's conv2 (x output channel only, ``kfh2`` [9, 256]) of
    fh1 [B, H, W, 256] with operands in the compute dtype and fp32 sums,
    plus ``bfh2`` (the JAX ``reference_refine_step``'s last line)."""
    x = fh1.permute(0, 3, 1, 2)
    return _conv(x, packed["kfh2"][..., None], compute_dtype)[:, 0] + packed["bfh2"].float()[0]


def batch_max_delta(delta: torch.Tensor) -> torch.Tensor:
    """The batch's convergence signal for one step: the largest over the
    batch of each sample's mean |delta| ([B, H, W] → scalar fp32). A batch
    leaves the refinement loop once its worst member has converged."""
    return delta.float().abs().mean(dim=(1, 2)).amax()


class MotionInGeometry(NamedTuple):
    """How stage 1 covers a lookup: one block for each (image row, segment
    of ``seg`` pixels), ``threads`` a block (one a level and pixel), the
    channels staged ``dc`` at a time in ``chunks`` steps (the last partial
    where ``dc`` does not divide D), ``smem`` bytes of dynamic shared
    memory a block, ``per_sm`` blocks of it on an SM, ``blocks`` in all."""

    seg: int
    segments: int
    threads: int
    dc: int
    chunks: int
    smem: int
    per_sm: int
    blocks: int


def _conv_phase_bytes(seg: int, levels: int) -> int:
    """Stage 1's conv-phase tiles (the kernel's ``mi::Layout``) at radius 4
    and fp32, the most any radius and compute dtype take: taps [seg][36|1
    a level], convc1's and convf1's weights in fp32, the 7 x (seg + 6) flow
    patch and the [seg][128] output tile with 16 bytes of pad a row."""
    def round4(n):
        return -(-n // 4) * 4

    lk = 9 * levels
    floats = (round4(seg * (lk | 1)) + lk * 64 + 49 * 64 + round4(7 * (seg + 6))
              + seg * (MOTION_CH * 4 + 16) // 4)
    return 4 * floats


def motion_in_geometry(rows: int, W: int, widths: Sequence[int], D: int) -> MotionInGeometry:
    """Stage 1's launch over ``rows`` = B·H image rows of W pixels, pyramid
    levels of ``widths`` positions and D channels. A segment holds at most
    SEGMENT // L pixels, and W splits into as few and as even segments as
    that allows. The chunk of channels is the widest of CHUNKS[:-1] (no
    wider than D) for which a block's shared memory leaves room for three
    blocks an SM; failing that, of CHUNKS for two, then for one. A block's shared
    memory is the larger of two stages of the segment's f1 rows and every
    level's row, [seg + Σ widths, dc] in fp32, and the conv phase's tiles,
    which alias them. Raises ValueError where the rows are too wide for
    even one block."""
    L = len(widths)
    segments = -(-W // (SEGMENT // L))
    seg = -(-W // segments)
    staged = seg + sum(widths)
    conv = _conv_phase_bytes(seg, L)
    for per_sm, chunks in ((3, CHUNKS[:-1]), (2, CHUNKS), (1, CHUNKS)):
        room = min(SMEM, SMEM_SM // per_sm - SMEM_RESERVED)
        for dc in chunks:
            smem = max(8 * dc * staged, conv)
            if dc <= D and smem <= room:
                return MotionInGeometry(seg, segments, -(-seg * L // 32) * 32, dc, -(-D // dc),
                                        smem, per_sm, rows * segments)
    raise ValueError(
        f"fused_update stage 1 stages every level's whole row ({sum(widths)} positions) and "
        f"{seg} pixels of f1 in shared memory: at {CHUNKS[-1]} channels a step that needs "
        f"{8 * CHUNKS[-1] * staged} bytes, more than the {SMEM} a block can have (level rows "
        f"of up to {SMEM // (8 * CHUNKS[-1]) - seg} positions in all)")


class HeadOutGeometry(NamedTuple):
    """How stage 7 covers B images of H x W: one block for each output
    tile of ``tile`` = (rows, columns) of one image, ``blocks`` in all,
    ``threads`` a block (one an output pixel), the tile's ``halo`` pixels
    projected onto the 9 taps, ``smem`` bytes of static shared memory a
    block (the weights and the projections, fp32)."""

    tile: Tuple[int, int]
    threads: int
    halo: int
    blocks: int
    smem: int


def head_out_geometry(B: int, H: int, W: int) -> HeadOutGeometry:
    """Stage 7's launch over B images of H x W (the kernel's ``ho``
    constants; the grid is one-dimensional, tile columns fastest)."""
    rows, cols = HEAD_TILE
    halo = (rows + 2) * (cols + 2)
    return HeadOutGeometry(HEAD_TILE, rows * cols, halo, B * -(-H // rows) * -(-W // cols),
                           4 * (9 * HEAD_CH + 9 * halo))


class _Bound(NamedTuple):
    step: Callable[..., int]  # fused_update_step
    motion_in: Callable[..., int]  # fused_motion_in
    head_out: Callable[..., int]  # fused_head_out


def _kernel() -> _Bound:
    """The bound C entry points, built and loaded at first use."""
    global _fn
    if _fn is None:
        lib = _build.load(KERNEL)
        if lib.fused_update_slots() != len(SLOTS):
            raise RuntimeError(f"{KERNEL} kernel takes {lib.fused_update_slots()} pointer "
                               f"slots, the wrapper passes {len(SLOTS)}")
        geometry = [ctypes.c_int] * 4  # seg, threads, dc, dynamic shared memory (bytes)
        step = lib.fused_update_step
        step.argtypes = [
            ctypes.c_int,  # bf16 compute
            ctypes.POINTER(ctypes.c_void_p),  # host array of SLOTS pointers
            ctypes.POINTER(ctypes.c_void_p),  # host array of level pointers
            ctypes.POINTER(ctypes.c_int),  # host array of level widths
            ctypes.c_int,  # levels
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, D
            ctypes.c_int,  # radius
            ctypes.c_int,  # dh
            ctypes.c_int,  # inp16 channels (0: none)
            *geometry,
            ctypes.c_void_p,  # stream
        ]
        step.restype = ctypes.c_int
        mi = lib.fused_motion_in
        mi.argtypes = [
            ctypes.c_int,  # bf16 compute
            ctypes.c_void_p,  # f1
            ctypes.POINTER(ctypes.c_void_p),  # host array of level pointers
            ctypes.POINTER(ctypes.c_int),  # host array of level widths
            ctypes.c_int,  # levels
            *[ctypes.c_void_p] * 6,  # flow, wc1, bc1, kf7, bf7, cf
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, D
            ctypes.c_int,  # radius
            *geometry,
            ctypes.c_void_p,  # stream
        ]
        mi.restype = ctypes.c_int
        ho = lib.fused_head_out
        ho.argtypes = [
            ctypes.c_int,  # bf16 compute
            *[ctypes.c_void_p] * 4,  # fh1, kfh2, bfh2, delta
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W
            ctypes.c_void_p,  # stream
        ]
        ho.restype = ctypes.c_int
        _fn = _Bound(step, mi, ho)
    return _fn


def _expect(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the step runs on {device}")


def _check_packed(packed, want, dev) -> None:
    for k, shape in want.items():
        if k not in packed:
            raise ValueError(f"packed weights lack {k!r}")
        if tuple(packed[k].shape) != shape:
            raise ValueError(f"packed {k} must be {shape} for this step, "
                             f"got {tuple(packed[k].shape)}")
        if packed[k].device != dev:
            raise ValueError(f"packed {k} is on {packed[k].device}, the step runs on {dev}")


def _check_motion_in(packed, fmap1, pyramid, flow_x, radius, cd) -> None:
    """What stage 1 takes: the lookup's inputs and convc1's and convf1's
    weights."""
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
    _check_packed(packed, {"wc1": (L * (2 * radius + 1), 64), "bc1": (64,), "kf7": (49, 64),
                           "bf7": (64,)}, dev)


def _check(packed, fmap1, pyramid, flow_x, h, inp16, ctx, radius, cd) -> None:
    _check_motion_in(packed, fmap1, pyramid, flow_x, radius, cd)
    B, H, W, _ = fmap1.shape
    dev = fmap1.device
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
    _check_packed(packed, {
        "wcf": (9, 64, MOTION_CH), "bcf": (MOTION_CH,), "km": (9, MOTION_CH, MOTION_CH),
        "bm": (MOTION_CH,), "wzr": (9, din, 2 * dh), "bzr": (2 * dh,), "wq": (9, din, dh),
        "bq": (dh,), "kfh1": (9, dh, HEAD_CH), "bfh1": (HEAD_CH,), "kfh2": (9, HEAD_CH),
        "bfh2": (1,),
    }, dev)


def _refuse_grad(name: str, tensors) -> None:
    """Stages 1 and 7 alone have no backward: under grad mode, an input
    that requires grad raises on either device rather than give a result
    without one."""
    if torch.is_grad_enabled():
        needs = [k for k, t in tensors if t is not None and t.requires_grad]
        if needs:
            raise RuntimeError(
                f"{name} has no backward, but {needs} require grad "
                "(call it under torch.no_grad())")


def _aligned(tensors) -> None:
    for name, x in tensors:
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"fused_update kernel needs 16-byte aligned {name}")


def motion_in(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor], flow_x: torch.Tensor,
              packed: Dict[str, torch.Tensor], radius: int,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's first launch alone: cor|flo [B, H, W, 128] in the
    compute dtype (see ``reference_motion_in``, which it computes on CPU
    tensors; on CUDA tensors it launches stage 1 or raises)."""
    global MOTION_IN_LAUNCHES
    levels_in = list(fmap2_pyramid)
    _refuse_grad("motion_in", [("fmap1", fmap1), ("flow_x", flow_x), *packed.items(),
                               *((f"pyramid level {i}", f) for i, f in enumerate(levels_in))])
    if fmap1.device.type == "cpu":
        return reference_motion_in(fmap1, levels_in, flow_x, packed, radius, compute_dtype)
    if fmap1.device.type != "cuda":
        raise ValueError(f"fused_update runs on CPU or CUDA tensors, not {fmap1.device}")
    cd = compute_dtype
    _check_motion_in(packed, fmap1, levels_in, flow_x, radius, cd)
    B, H, W, D = fmap1.shape
    f1, flow = fmap1.contiguous(), flow_x.contiguous()
    levels = [f.contiguous() for f in levels_in]
    w = {k: packed[k].to(cd).contiguous() for k in ("wc1", "kf7")}
    b = {k: packed[k].float().contiguous() for k in ("bc1", "bf7")}
    cf = torch.empty((B, H, W, MOTION_CH), dtype=cd, device=f1.device)
    _aligned([("fmap1", f1), *w.items(),
              *((f"pyramid level {i}", x) for i, x in enumerate(levels))])
    widths = [x.shape[2] for x in levels]
    geo = motion_in_geometry(B * H, W, widths, D)
    fn = _kernel().motion_in
    lvl = (ctypes.c_void_p * len(levels))(*[x.data_ptr() for x in levels])
    c_widths = (ctypes.c_int * len(levels))(*widths)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(int(cd == torch.bfloat16), f1.data_ptr(), lvl, c_widths, len(levels),
                 flow.data_ptr(), w["wc1"].data_ptr(), b["bc1"].data_ptr(), w["kf7"].data_ptr(),
                 b["bf7"].data_ptr(), cf.data_ptr(), B, H, W, D, radius, geo.seg, geo.threads,
                 geo.dc, geo.smem, stream)
    if err != 0:
        raise RuntimeError(f"fused_update stage 1 launch failed: CUDA error {err}")
    MOTION_IN_LAUNCHES += 1
    return cf


def _check_head_out(fh1, kfh2, bfh2, cd) -> None:
    """What stage 7 takes: fh1 [B, H, W, 256] and kfh2 [9, 256] in the
    compute dtype and bfh2 [1] in fp32, contiguous, 16-byte aligned, on
    fh1's device."""
    if cd not in COMPUTE_DTYPES:
        raise ValueError(f"fused_update kernel computes in {COMPUTE_DTYPES}, got {cd}")
    if fh1.dim() != 4 or fh1.shape[-1] != HEAD_CH or fh1.numel() == 0:
        raise ValueError(f"fh1 must be a non-empty [B, H, W, {HEAD_CH}], got {tuple(fh1.shape)}")
    if tuple(kfh2.shape) != (9, HEAD_CH) or tuple(bfh2.shape) != (1,):
        raise ValueError(f"kfh2 must be (9, {HEAD_CH}) and bfh2 (1,), got "
                         f"{tuple(kfh2.shape)} and {tuple(bfh2.shape)}")
    for name, t, dtype in (("fh1", fh1, cd), ("kfh2", kfh2, cd), ("bfh2", bfh2, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != fh1.device:
            raise ValueError(f"{name} is on {t.device}, stage 7 runs on {fh1.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_update stage 7 needs a contiguous {name}")
    _aligned([("fh1", fh1), ("kfh2", kfh2), ("bfh2", bfh2)])


def head_out(fh1: torch.Tensor, packed: Dict[str, torch.Tensor],
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's last launch alone: delta [B, H, W] fp32 from fh1 [B, H,
    W, 256] (see ``reference_head_out``, which it computes on CPU tensors;
    on CUDA tensors it launches stage 7 or raises). Takes fh1 and
    ``packed["kfh2"]`` in the compute dtype and ``packed["bfh2"]`` in fp32
    as they are: no cast, no copy."""
    global HEAD_OUT_LAUNCHES
    kfh2, bfh2 = packed["kfh2"], packed["bfh2"]
    _refuse_grad("head_out", [("fh1", fh1), ("kfh2", kfh2), ("bfh2", bfh2)])
    if fh1.device.type == "cpu":
        return reference_head_out(fh1, packed, compute_dtype)
    if fh1.device.type != "cuda":
        raise ValueError(f"fused_update runs on CPU or CUDA tensors, not {fh1.device}")
    _check_head_out(fh1, kfh2, bfh2, compute_dtype)
    B, H, W, _ = fh1.shape
    delta = torch.empty((B, H, W), dtype=torch.float32, device=fh1.device)
    fn = _kernel().head_out
    with torch.cuda.device(fh1.device):
        stream = torch.cuda.current_stream(fh1.device).cuda_stream
        err = fn(int(compute_dtype == torch.bfloat16), fh1.data_ptr(), kfh2.data_ptr(),
                 bfh2.data_ptr(), delta.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"fused_update stage 7 launch failed: CUDA error {err}")
    HEAD_OUT_LAUNCHES += 1
    return delta


def fused_refine_step(packed: Dict[str, torch.Tensor], fmap1: torch.Tensor,
                      fmap2_pyramid: Sequence[torch.Tensor], flow_x: torch.Tensor,
                      h: torch.Tensor, inp16: Optional[torch.Tensor], ctx: torch.Tensor,
                      radius: int, compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One refinement step: ``(h' [B, H, W, dh] in h's dtype, delta_disp
    [B, H, W] fp32)`` (see the module docstring)."""
    if fmap1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_update runs on CPU or CUDA tensors, not {fmap1.device}")
    if fmap1.device.type == "cuda":
        _check(packed, fmap1, fmap2_pyramid, flow_x, h, inp16, ctx, radius, compute_dtype)
    keys = tuple(packed)
    return _FusedStep.apply(radius, compute_dtype, keys, flow_x, fmap1, h, inp16, ctx,
                            *fmap2_pyramid, *(packed[k] for k in keys))


def fused_step_vjp(packed: Dict[str, torch.Tensor], fmap1: torch.Tensor,
                   fmap2_pyramid: Sequence[torch.Tensor], flow_x: torch.Tensor,
                   h: torch.Tensor, inp16: Optional[torch.Tensor], ctx: torch.Tensor,
                   radius: int, compute_dtype: torch.dtype, grads, wrt):
    """The step's backward: ``reference_refine_step``'s autograd at the
    given inputs, for the output gradients ``grads = (d h', d delta)``, with
    respect to the named inputs in ``wrt`` (``"fmap1"``, ``"h"``,
    ``"inp16"``, ``"ctx"``, ``"level<i>"`` or a packed key). Returns a dict
    of gradients by name (None where the input does not reach the output)."""
    names = (["fmap1", "h", "inp16", "ctx"] + [f"level{i}" for i in range(len(fmap2_pyramid))]
             + list(packed))
    values = [fmap1, h, inp16, ctx, *fmap2_pyramid, *packed.values()]
    with torch.enable_grad():
        leaf = {n: None if v is None else v.detach().requires_grad_(n in wrt)
                for n, v in zip(names, values)}
        levels = [leaf[f"level{i}"] for i in range(len(fmap2_pyramid))]
        out = reference_refine_step({k: leaf[k] for k in packed}, leaf["fmap1"], levels,
                                    flow_x.detach(), leaf["h"], leaf["inp16"], leaf["ctx"],
                                    radius, compute_dtype)
        asked = [n for n in names if n in wrt and leaf[n] is not None]
        got = torch.autograd.grad(out, [leaf[n] for n in asked], grads, allow_unused=True)
    return dict(zip(asked, got))


class _FusedStep(torch.autograd.Function):
    """The step's forward (the kernel on CUDA, the plain version on the
    CPU) with :func:`fused_step_vjp` as its backward, as the JAX
    ``_fused_op_bwd`` recomputes ``reference_refine_step``. ``flow_x`` gets
    no gradient."""

    @staticmethod
    def forward(fctx, radius, cd, keys, flow_x, fmap1, h, inp16, context, *rest):
        levels, weights = rest[:len(rest) - len(keys)], rest[len(rest) - len(keys):]
        packed = dict(zip(keys, weights))
        fctx.radius, fctx.cd, fctx.keys, fctx.n_levels = radius, cd, keys, len(levels)
        fctx.save_for_backward(flow_x, fmap1, h, inp16, context, *levels, *weights)
        if fmap1.device.type == "cpu":
            return reference_refine_step(packed, fmap1, levels, flow_x, h, inp16, context,
                                         radius, cd)
        return _launch(packed, fmap1, levels, flow_x, h, inp16, context, radius, cd)

    @staticmethod
    def backward(fctx, g_h, g_delta):
        flow_x, fmap1, h, inp16, context, *rest = fctx.saved_tensors
        L = fctx.n_levels
        levels, weights = rest[:L], rest[L:]
        names = (["fmap1", "h", "inp16", "ctx"] + [f"level{i}" for i in range(L)]
                 + list(fctx.keys))
        wrt = {n for n, need in zip(names, fctx.needs_input_grad[4:]) if need}
        got = fused_step_vjp(dict(zip(fctx.keys, weights)), fmap1, levels, flow_x, h, inp16,
                             context, fctx.radius, fctx.cd, (g_h, g_delta), wrt)
        return (None, None, None, None, *(got.get(n) for n in names))


def _launch(packed: Dict[str, torch.Tensor], fmap1: torch.Tensor,
            fmap2_pyramid: Sequence[torch.Tensor], flow_x: torch.Tensor, h: torch.Tensor,
            inp16: Optional[torch.Tensor], ctx: torch.Tensor, radius: int,
            cd: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Function's forward on CUDA: one kernel call on checked inputs."""
    global LAUNCHES
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
    _aligned(list(t.items()) + [(f"pyramid level {i}", x) for i, x in enumerate(levels)])
    widths = [x.shape[2] for x in levels]
    geo = motion_in_geometry(B * H, W, widths, D)
    fn = _kernel().step
    ptrs = (ctypes.c_void_p * len(SLOTS))(
        *[None if t[k] is None else t[k].data_ptr() for k in SLOTS])
    lvl = (ctypes.c_void_p * len(levels))(*[x.data_ptr() for x in levels])
    c_widths = (ctypes.c_int * len(levels))(*widths)
    ci = 0 if inp16 is None else inp16.shape[-1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(int(cd == torch.bfloat16), ptrs, lvl, c_widths, len(levels), B, H, W, D,
                 radius, dh, ci, geo.seg, geo.threads, geo.dc, geo.smem, stream)
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t["h_out"], t["delta"]

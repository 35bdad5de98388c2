"""The port's CUDA kernels on the card: the alt-correlation kernel (K1), the
fused refinement step (K2, and its first and last launches alone) and the
packed stage's 3x3x64 conv (K3) against their plain versions, the
wrappers' checks and launch counts, and the
forwards with the kernels against the forwards with the plain versions;
then the captured forwards: replays against eager runs, the graph cache's
eviction, and the engine on the card; and the serving layers over the
captured engine: a weight update replayed without a new capture, the
scheduler on a FIFO stream, the video forward's three-input graph; and
several engines in one process: one capturing while another replays on
its own thread, and the cascade's held fast result outliving the fast
engine's later replays; and two fleet worker processes sharing the card;
and one seed of the port's chaos campaign served on the card.

Marked ``gpu``; each test skips when no CUDA card is present (decided
inside the test, so every worker collects the same tests). This file
imports no JAX, so it also runs where only PyTorch is installed; the
tests/conftest.py beside it imports JAX, so run it there as
``python -m pytest tests/test_torch_port_cuda.py --noconftest -m gpu``.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from chip_smoke import (K3_PER_TRUNK, k2_errors, k3_abs_sums, k3_errors, k3_inputs,
                        stage1_allowances, stage1_errors, stage7_errors, stage7_fh1,
                        stage7_sums)
from raft_stereo_tpu_torch.config import PRESETS
from raft_stereo_tpu_torch.evaluate import (load_model, make_adaptive_forward, make_engine,
                                            make_forward)
from raft_stereo_tpu_torch.experiments import packed_conv
from raft_stereo_tpu_torch.models import extractor
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.ops import alt_corr, fused_update
from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain, pool_fmap_pyramid
from raft_stereo_tpu_torch.ops.pad import BatchPadder
from raft_stereo_tpu_torch.runtime.infer import (
    GraphCache,
    InferOptions,
    InferRequest,
    kernel_launches,
)
from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler

pytestmark = pytest.mark.gpu

# fp32 summation order only: coordinates sit on a 1/64 grid, where the plain
# version's per-tap positions x/2^l + k are exact (see chip_smoke.py)
ATOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(B, H, W, D, levels, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn((B, H, W, D), generator=g, device="cuda")
    f2 = torch.randn((B, H, W, D), generator=g, device="cuda")
    coords = torch.rand((B, H, W), generator=g, device="cuda") * (W + 16) - 8
    flat = coords.view(-1)
    flat[:4] = torch.tensor([0.0, W - 1.0, -1e3, 4.0 * W])
    flat[4::9] = torch.round(flat[4::9])
    return f1, pool_fmap_pyramid(f2, levels), torch.round(coords * 64) / 64


@pytest.mark.parametrize(
    "B,H,W,D,levels,radius",
    [(1, 4, 32, 256, 4, 4), (2, 3, 37, 256, 4, 4), (1, 5, 123, 64, 3, 2),
     (1, 2, 50, 128, 2, 1), (1, 2, 64, 512, 1, 3), (1, 3, 41, 100, 4, 4),
     # the staged kernel's edges: rows of two and three segments (ragged,
     # B > 1), a chunk that does not divide D, the Middlebury-F width (four
     # segments, shortened to fit), a level row of one position, the
     # realtime shape, level rows too wide for 32 channels a chunk (16, 8
     # and 4 channels)
     (1, 3, 300, 256, 4, 4), (2, 2, 517, 256, 4, 4), (1, 3, 41, 260, 4, 4),
     (1, 2, 720, 256, 4, 4), (1, 2, 9, 64, 4, 4), (1, 68, 120, 256, 4, 4),
     (1, 1, 1200, 256, 2, 4), (1, 1, 2000, 256, 2, 4), (1, 1, 4000, 64, 1, 4)],
)
def test_kernel_matches_plain(B, H, W, D, levels, radius):
    _cuda()
    f1, pyr, coords = _inputs(B, H, W, D, levels)
    got = alt_corr.corr_lookup_alt(f1, pyr, coords, radius)
    torch.cuda.synchronize()
    want = corr_lookup_alt_plain(f1, pyr, coords, radius)
    assert got.shape == (B, H, W, levels * (2 * radius + 1))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_kernel_takes_strided_views_and_counts_launches():
    _cuda()
    f1, pyr, coords = _inputs(1, 4, 40, 256, 4, seed=1)
    f1_view = f1.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # strided
    before = alt_corr.LAUNCHES
    got = alt_corr.corr_lookup_alt(f1_view, pyr, coords[..., :], 4)
    got2 = alt_corr.corr_lookup_alt(f1, pyr, coords, 4)
    torch.cuda.synchronize()
    assert alt_corr.LAUNCHES == before + 2
    torch.testing.assert_close(got, got2, rtol=0, atol=0)


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda f1, pyr, c: (f1.double(), pyr, c, 4), TypeError),
        (lambda f1, pyr, c: (f1, [p.bfloat16() for p in pyr], c, 4), TypeError),
        (lambda f1, pyr, c: (f1, pyr, c[:, :, :-1], 4), ValueError),
        (lambda f1, pyr, c: (f1, pyr, c, 5), ValueError),
        (lambda f1, pyr, c: (f1[..., :6], [p[..., :6] for p in pyr], c, 4), ValueError),
        (lambda f1, pyr, c: (f1, [p.cpu() for p in pyr], c, 4), ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, err):
    _cuda()
    f1, pyr, coords = _inputs(1, 2, 16, 8, 2, seed=2)
    before = alt_corr.LAUNCHES
    with pytest.raises(err):
        alt_corr.corr_lookup_alt(*change(f1, pyr, coords))
    assert alt_corr.LAUNCHES == before


def test_forward_with_kernel_matches_plain_lookup(monkeypatch):
    """fp32, TF32 off, few iterations (random weights do not contract)."""
    dev = _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], mixed_precision=False)
    model = load_model(cfg, seed=3)
    assert next(model.parameters()).device.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.rand((1, 64, 128, 3), generator=g, device=dev) * 255
    b = torch.rand((1, 64, 128, 3), generator=g, device=dev) * 255
    before = alt_corr.LAUNCHES
    low_k, up_k = model(a, b, iters=3)
    assert alt_corr.LAUNCHES == before + 3
    monkeypatch.setattr(alt_corr, "corr_lookup_alt", corr_lookup_alt_plain)
    low_p, up_p = model(a, b, iters=3)
    torch.testing.assert_close(low_k, low_p, rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(up_k, up_p, rtol=1e-4, atol=5e-3)


# K2 against its plain version. fp32: summation order only (TF32 off for
# the plain version's convs; coordinates on a 1/64 grid, as for K1); the
# tolerances of tests/test_fused_update.py. bf16: chip_smoke.py's check
# (K2_BF16_TOL there), the one the smoke run holds the kernel to.
K2_FP32_ATOL = {"h": 5e-5, "delta": 2e-4}


def _fused_case(B, H, W, D, levels, radius, with_inp, dtype, seed=0, hidden=(128, 128, 128)):
    """Seeded step inputs; ``hidden`` sets dh (its last entry) and, with
    inp16, inp16's channels (its middle entry)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=g, device="cuda") * scale

    dh, ci = hidden[2], hidden[1]
    block = BasicMultiUpdateBlock(hidden, 3 if with_inp else 1, 2, levels, radius)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(rnd(*p.shape, scale=0.1))
    packed = fused_update.pack_fused_params(block.cuda(), dtype)
    f1 = rnd(B, H, W, D, scale=0.5)
    pyr = pool_fmap_pyramid(rnd(B, H, W, D, scale=0.5), levels)
    flow = torch.round(rnd(B, H, W, scale=2.0) * 64) / 64
    h = torch.tanh(rnd(B, H, W, dh)).to(dtype)
    inp = rnd(B, H, W, ci, scale=0.5).to(dtype) if with_inp else None
    ctx = rnd(B, H, W, 3 * dh, scale=0.5).to(dtype)
    return packed, f1, pyr, flow, h, inp, ctx, radius


FUSED_CASES = [
    (1, 10, 16, 32, 4, 4, True, torch.float32), (2, 37, 23, 64, 4, 4, True, torch.float32),
    (1, 10, 16, 32, 4, 4, False, torch.float32), (1, 6, 77, 100, 3, 2, True, torch.float32),
    (2, 37, 23, 64, 4, 4, True, torch.bfloat16), (1, 9, 40, 256, 4, 4, False, torch.bfloat16)]


@pytest.mark.parametrize("B,H,W,D,levels,radius,with_inp,dtype", FUSED_CASES)
def test_fused_kernel_matches_plain(monkeypatch, B, H, W, D, levels, radius, with_inp, dtype):
    _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    args = _fused_case(B, H, W, D, levels, radius, with_inp, dtype)
    before = fused_update.LAUNCHES
    h_k, d_k = fused_update.fused_refine_step(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert fused_update.LAUNCHES == before + 1
    h_p, d_p = fused_update.reference_refine_step(*args, compute_dtype=dtype)
    assert h_k.shape == (B, H, W, 128) and h_k.dtype == dtype
    assert d_k.shape == (B, H, W) and d_k.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(h_k, h_p, rtol=0, atol=K2_FP32_ATOL["h"])
        torch.testing.assert_close(d_k, d_p, rtol=0, atol=K2_FP32_ATOL["delta"])
    else:
        res = k2_errors((h_k, d_k), (h_p, d_p), dtype)
        assert res["ok"], res


@pytest.mark.parametrize("B,H,W,D,levels,radius,with_inp,dtype", FUSED_CASES)
def test_motion_in_matches_plain(monkeypatch, B, H, W, D, levels, radius, with_inp, dtype):
    """K2's first launch alone against its plain version, held to
    chip_smoke.py's stage-1 check (K2_STAGE1_FP32_TOL, K2_STAGE1_BF16_TOL)."""
    _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    packed, f1, pyr, flow, *_ = _fused_case(B, H, W, D, levels, radius, with_inp, dtype)
    before = (fused_update.MOTION_IN_LAUNCHES, fused_update.LAUNCHES)
    got = fused_update.motion_in(f1, pyr, flow, packed, radius, dtype)
    torch.cuda.synchronize()
    assert (fused_update.MOTION_IN_LAUNCHES, fused_update.LAUNCHES) == (before[0] + 1, before[1])
    want = fused_update.reference_motion_in(f1, pyr, flow, packed, radius, dtype)
    assert got.shape == (B, H, W, 128) and got.dtype == dtype
    res = stage1_errors(got, want, stage1_allowances(f1, pyr, flow, packed, radius, dtype))
    assert res["ok"], res


# stage 7's cases (chip_smoke.K2_STAGE7_CASES) at small widths: one image of
# two tiles a row, two ragged images (a halo row at the batch edge), a
# batch of 4, a wider image, and three images each smaller than a tile
HEAD_OUT_CASES = [(1, 16, 64), (2, 37, 23), (4, 12, 40), (1, 24, 100), (3, 5, 17)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W", HEAD_OUT_CASES)
def test_head_out_matches_plain(monkeypatch, B, H, W, dtype):
    """K2's last launch alone against its plain version, held to
    chip_smoke.py's stage-7 check (K2_STAGE7_TOL), two calls bitwise equal."""
    _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    packed = _fused_case(1, 4, 8, 32, 4, 4, True, dtype, seed=B * H * W)[0]
    fh1 = stage7_fh1(B, H, W, dtype, seed=W)
    before = (fused_update.HEAD_OUT_LAUNCHES, fused_update.LAUNCHES)
    got = fused_update.head_out(fh1, packed, dtype)
    again = fused_update.head_out(fh1, packed, dtype)
    torch.cuda.synchronize()
    assert (fused_update.HEAD_OUT_LAUNCHES, fused_update.LAUNCHES) == (before[0] + 2, before[1])
    assert got.shape == (B, H, W) and got.dtype == torch.float32
    assert torch.equal(got, again)
    want = fused_update.reference_head_out(fh1, packed, dtype)
    res = stage7_errors(got, want, stage7_sums(fh1, packed, dtype))
    assert res["ok"], res


def _misaligned(t):
    """``t``'s values in contiguous storage that starts 2 bytes past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda fh1, p: (fh1[..., :128].contiguous(), p), ValueError),  # 128 channels
        (lambda fh1, p: (fh1.float(), p), ValueError),  # fh1 not in the compute dtype
        (lambda fh1, p: (fh1, {**p, "kfh2": p["kfh2"].float()}), ValueError),
        (lambda fh1, p: (fh1.transpose(1, 2), p), ValueError),  # not contiguous
        (lambda fh1, p: (_misaligned(fh1), p), ValueError),  # not 16-byte aligned
        (lambda fh1, p: (fh1.float().requires_grad_(), p), RuntimeError),  # no backward
    ],
)
def test_head_out_refuses_what_the_kernel_does_not_take(change, err):
    _cuda()
    packed = _fused_case(1, 4, 8, 32, 4, 4, True, torch.bfloat16, seed=2)[0]
    fh1 = stage7_fh1(1, 8, 8, torch.bfloat16, seed=2)
    fh1_bad, packed_bad = change(fh1, packed)
    before = fused_update.HEAD_OUT_LAUNCHES
    with pytest.raises(err):
        fused_update.head_out(fh1_bad, packed_bad, torch.bfloat16)
    assert fused_update.HEAD_OUT_LAUNCHES == before


@pytest.mark.parametrize(
    "B,H,W,hidden",
    [(1, 20, 40, (128, 128, 64)),   # dh = 64: the z|r conv at 128, the q conv at 64 channels
     (1, 20, 40, (128, 32, 128)),   # a 32-channel inp16: a 32-channel tail chunk
     (2, 5, 9, (128, 128, 128))],   # P = 90, less than one 8 x 16 tile an image
)
def test_fused_kernel_tiling_matches_plain(monkeypatch, B, H, W, hidden):
    """The bf16 convs' tiles (8 x 16 pixels x all output channels) and
    input chunks (64 channels, a 32-channel tail) at the shapes the
    wrapper accepts, held to the plain step by chip_smoke.k2_errors."""
    _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    args = _fused_case(B, H, W, 64, 4, 4, True, torch.bfloat16, seed=5, hidden=hidden)
    got = fused_update.fused_refine_step(*args, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = fused_update.reference_refine_step(*args, compute_dtype=torch.bfloat16)
    assert got[0].shape == (B, H, W, hidden[2])
    res = k2_errors(got, want, torch.bfloat16)
    assert res["ok"], res


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda a: (a[0], *a[1:4], a[4].double(), *a[5:]), TypeError),  # h not in fp32
        (lambda a: (*a[:7], 5), ValueError),  # radius
        (lambda a: (a[0], a[1][..., :6], [p[..., :6] for p in a[2]], *a[3:]), ValueError),
        (lambda a: (a[0], a[1], [p.cpu() for p in a[2]], *a[3:]), ValueError),
        (lambda a: (*a[:5], None, *a[6:]), ValueError),  # packed for inp16, none given
        (lambda a: (a[0], *a[1:4], a[4][..., :96], a[5], a[6][..., :288], a[7]), ValueError),
    ],
)
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(change, err):
    _cuda()
    args = _fused_case(1, 4, 16, 32, 4, 4, True, torch.float32, seed=1)
    before = fused_update.LAUNCHES
    with pytest.raises(err):
        fused_update.fused_refine_step(*change(args))
    assert fused_update.LAUNCHES == before


def test_fused_forward_matches_plain_step_forward(monkeypatch):
    """fp32, TF32 off, few iterations: the fused path launches K2 for the
    unmasked steps and K1 once, for the masked step."""
    dev = _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], mixed_precision=False,
                              fused_update=True)
    model = load_model(cfg, seed=3)
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.rand((1, 64, 128, 3), generator=g, device=dev) * 255
    b = torch.rand((1, 64, 128, 3), generator=g, device=dev) * 255
    before = (fused_update.LAUNCHES, alt_corr.LAUNCHES)
    low_k, up_k = model(a, b, iters=3)
    assert (fused_update.LAUNCHES, alt_corr.LAUNCHES) == (before[0] + 2, before[1] + 1)
    monkeypatch.setattr(fused_update, "fused_refine_step", fused_update.reference_refine_step)
    low_p, up_p = model(a, b, iters=3)
    torch.testing.assert_close(low_k, low_p, rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(up_k, up_p, rtol=1e-4, atol=5e-3)


def test_fused_early_exit_launches_once_a_step():
    dev = _cuda()
    cfg = dataclasses.replace(PRESETS["raftstereo-middlebury"], fused_update=True,
                              converge_eps=1e9)
    model = load_model(cfg, seed=4)
    a = torch.full((1, 64, 96, 3), 100.0, device=dev)
    before = fused_update.LAUNCHES
    low, up, n = model(a, a, iters=5)
    assert n == 2 and fused_update.LAUNCHES == before + 1
    assert torch.isfinite(up).all()


# K3 against its plain version, held by chip_smoke.k3_errors (the check the
# smoke run holds it to): fp32 summation order only, bf16 within one ulp
# plus each element's own order allowance, with a bounded share of
# differing elements.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,H,W,prologue",
    [(2, 12, 128, None), (2, 12, 128, "relu"), (1, 9, 64, "affine"), (1, 37, 122, "relu"),
     (3, 5, 6, None), (1, 3, 34, "relu"),
     # the bf16 kernel's 16 x 16 tiles: H and W not multiples of 16, W = 2,
     # and more tiles (3 x 7 x 13) than SMs, so the persistent loop wraps
     (2, 17, 30, "affine"), (1, 5, 2, "relu"), (3, 100, 202, None)],
)
def test_packed_conv_matches_plain(monkeypatch, B, H, W, prologue, dtype):
    _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    args = k3_inputs(B, H, W, dtype, prologue, seed=B * H + W)
    before = packed_conv.LAUNCHES
    got = packed_conv.packed_conv3x3(*args)
    torch.cuda.synchronize()
    assert packed_conv.LAUNCHES == before + 1
    assert got.shape == (B, H, W // 2, 128) and got.dtype == dtype
    res = k3_errors(got, packed_conv.packed_conv3x3_plain(*args), k3_abs_sums(*args))
    assert res["ok"], res


def test_packed_conv_prologue_takes_64_or_128_lanes():
    _cuda()
    xp, w, scale, shift, _ = k3_inputs(1, 6, 40, torch.float32, "affine", seed=7)
    tiled = packed_conv.packed_conv3x3(xp, w, scale[:, :64].repeat(1, 2), shift[:, :64].repeat(1, 2))
    half = packed_conv.packed_conv3x3(xp, w, scale[:, :64], shift[:, :64])
    torch.testing.assert_close(half, tiled, rtol=0, atol=0)


@pytest.mark.parametrize(
    "make,err",
    [
        (lambda xp, w: (xp[..., :96], w), ValueError),  # C = 48, not 64
        (lambda xp, w: (packed_conv.pack_x(packed_conv.unpack_x(xp)[:, :, :-1]), w),
         ValueError),  # odd W
        (lambda xp, w: (xp.half(), w), TypeError),
        (lambda xp, w: (xp.double(), w), TypeError),
        (lambda xp, w: (xp, w[:, :, :32]), ValueError),
        (lambda xp, w: (xp, w.float()), TypeError),  # not in xp's dtype
        (lambda xp, w: (xp, w.cpu()), ValueError),
    ],
)
def test_packed_conv_refuses_what_the_kernel_does_not_take(make, err):
    _cuda()
    xp, w, _, _, _ = k3_inputs(1, 4, 16, torch.bfloat16, seed=8)
    before = packed_conv.LAUNCHES
    with pytest.raises(err):
        packed_conv.packed_conv3x3(*make(xp, w))
    assert packed_conv.LAUNCHES == before


def test_packed_forward_launches_k3_four_times_a_pair(monkeypatch):
    """The realtime preset with the packed stage: layer1's 4 convs of the
    shared trunk on the stacked pair go through K3; the stage off, none."""
    dev = _cuda()
    model = load_model(PRESETS["raftstereo-realtime"], seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.rand((1, 64, 128, 3), generator=g, device=dev) * 255
    b = torch.rand((1, 64, 128, 3), generator=g, device=dev) * 255
    before = packed_conv.LAUNCHES
    _, up_off = model(a, b, iters=2)
    assert packed_conv.LAUNCHES == before
    monkeypatch.setattr(extractor, "_ENABLE_PACKED", True)
    for _ in range(2):
        _, up_on = model(a, b, iters=2)
    assert packed_conv.LAUNCHES == before + 2 * K3_PER_TRUNK
    assert torch.isfinite(up_on).all() and up_on.shape == up_off.shape


# ------------------------------------------------ captured forwards (A.1)

GRAPH_CELLS = [
    # preset, fused_update, packed stage, iterations
    ("raftstereo-middlebury", False, False, 3),
    ("raftstereo-middlebury", True, False, 3),
    ("raftstereo-realtime", False, False, 3),
    ("raftstereo-realtime", False, True, 3),
]


@pytest.mark.parametrize("preset,fused,packed,iters", GRAPH_CELLS)
def test_replayed_forward_equals_eager_bitwise(monkeypatch, preset, fused, packed, iters):
    """``make_forward``'s captured forward against the eager forward on the
    same inputs, at the preset's dtype: the same kernels in the same order,
    so the same bits. A second shape captures its own graph; the wrapper
    counters count the warm-up's and the capture's launches, the cache
    counts each replay's."""
    dev = _cuda()
    monkeypatch.setattr(extractor, "_ENABLE_PACKED", packed)
    cfg = dataclasses.replace(PRESETS[preset], fused_update=fused)
    model = load_model(cfg, seed=6)
    forward = make_forward(model, iters)
    g = torch.Generator(device=dev).manual_seed(6)
    for shape in ((2, 96, 160, 3), (1, 64, 128, 3)):
        a = torch.rand(shape, generator=g, device=dev) * 255
        b = torch.rand(shape, generator=g, device=dev) * 255
        before = kernel_launches()
        got = [forward(a, b) for _ in range(2)]  # capture, then a hit
        captured = forward.graphs.entry((tuple(a.shape), tuple(b.shape), iters)).launches
        assert {k: n - before[k] for k, n in kernel_launches().items()} == \
            {k: 2 * n for k, n in captured.items()}  # warm-up + capture
        assert captured["alt_corr"] == (1 if fused else iters)
        assert captured["fused_update"] == (iters - 1 if fused else 0)
        assert captured["packed_conv"] == (K3_PER_TRUNK if packed else 0)
        want = model(a, b, iters=iters)[1]
        for x in got:
            assert torch.equal(x, want)
    graphs = forward.graphs
    assert (graphs.captures, graphs.hits, graphs.replays) == (2, 2, 4)
    assert graphs.replayed_launches["alt_corr"] == 4 * (1 if fused else iters)


def test_replayed_fused_step_equals_eager_bitwise():
    _cuda()
    args = _fused_case(2, 37, 23, 64, 4, 4, True, torch.bfloat16, seed=9)
    packed, f1, pyr, flow, h, inp, ctx, radius = args

    def step(f1, flow, h, inp, ctx):
        return fused_update.fused_refine_step(packed, f1, pyr, flow, h, inp, ctx, radius,
                                              compute_dtype=torch.bfloat16)[0]

    cache = GraphCache()
    inputs = (f1, flow, h, inp, ctx)
    got = cache.run("step", step, inputs).clone()
    assert cache.entry("step").launches["fused_update"] == 1
    assert torch.equal(got, step(*inputs))


def test_graph_cache_eviction_frees_its_entry():
    dev = _cuda()
    cache = GraphCache(max_entries=1)
    x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
    out_a = cache.run("a", lambda t: t * 2 + 1, (x,))
    assert torch.equal(out_a, x * 2 + 1)
    ref = weakref.ref(cache.entry("a").output)
    del out_a
    cache.run("b", lambda t: t - 3, (x,))
    gc.collect()
    assert len(cache) == 1 and "a" not in cache and cache.evictions == 1
    assert ref() is None  # the evicted graph's buffers are gone
    # a third key reuses the pool's freed memory instead of growing it
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for i in range(4):
        cache.run(("c", i), lambda t: t * 3, (x,))
    assert torch.cuda.memory_reserved() <= reserved + (8 << 20)


def _engine_requests(shapes, seed):
    rng = np.random.RandomState(seed)
    return [InferRequest(payload=i, inputs=tuple(
        (rng.rand(h, w, 3) * 255).astype(np.float32) for _ in range(2)))
        for i, (h, w) in enumerate(shapes)]


def test_engine_replays_equal_eager_at_the_same_batch():
    """The engine on the card (realtime preset, bf16): two buckets with a
    partial batch each. Each result equals, bitwise, the eager forward of
    the batch it rode in, filler included, and launch counts are captured x
    replays."""
    _cuda()
    model = load_model(PRESETS["raftstereo-realtime"], seed=7)
    engine = make_engine(model, 3, InferOptions(batch=2))
    assert engine.capture
    shapes = [(60, 100), (60, 100), (80, 128), (60, 100)]
    reqs = _engine_requests(shapes, seed=7)
    out = {r.payload: r for r in engine.stream(iter(reqs))}
    assert sorted(out) == [0, 1, 2, 3] and all(r.ok for r in out.values())
    s = engine.stats
    assert (engine.graphs.captures, s.batches, s.padded_slots) == (2, 3, 2)
    assert engine.graphs.replays == 3
    assert engine.graphs.replayed_launches["alt_corr"] == 3 * 3
    for members in ([0, 1], [3, 3], [2, 2]):  # bucket batches; filler = last item
        padder = BatchPadder([shapes[i] for i in members], divis_by=32)
        a, b = (torch.from_numpy(padder.pad([reqs[i].inputs[k] for i in members])).cuda()
                for k in (0, 1))
        want = model(a, b, iters=3)[1].cpu().numpy()
        for slot, i in enumerate(dict.fromkeys(members)):
            np.testing.assert_array_equal(out[i].output, padder.unpad(want, slot))


def test_a_failing_kernel_fails_the_batch_and_falls_back_to_nothing(monkeypatch):
    _cuda()
    model = load_model(PRESETS["raftstereo-middlebury"], seed=8)
    engine = make_engine(model, 2, InferOptions(batch=2))

    def refused(*args):
        return 1  # cudaErrorInvalidValue

    def plain(*args, **kw):
        raise AssertionError("the plain lookup ran on CUDA tensors")

    monkeypatch.setattr(alt_corr, "_kernel", lambda: refused)
    monkeypatch.setattr(alt_corr, "corr_lookup_alt_plain", plain)
    out = list(engine.stream(iter(_engine_requests([(64, 96)] * 3, seed=8))))
    assert sorted(r.payload for r in out) == [0, 1, 2]
    assert all(not r.ok and "alt_corr kernel launch failed" in str(r.error) for r in out)
    assert engine.stats.failed == 3 and engine.stats.images == 0 and len(engine.graphs) == 0


def test_update_variables_replays_the_new_weights_without_a_capture():
    """``update_variables`` copies into the weights the graphs read: after
    it, the engine's replays equal, bitwise, a fresh engine built on the new
    weights, and no graph was captured again."""
    _cuda()
    shapes = [(60, 100), (60, 100), (80, 128)]
    engine = make_engine(load_model(PRESETS["raftstereo-realtime"], seed=7), 3,
                         InferOptions(batch=2))
    before = {r.payload: r.output for r in engine.stream(iter(_engine_requests(shapes, 9)))}
    captures = engine.graphs.captures
    new = load_model(PRESETS["raftstereo-realtime"], seed=8)
    engine.update_variables(new.state_dict())
    after = {r.payload: r.output for r in engine.stream(iter(_engine_requests(shapes, 9)))}
    fresh = make_engine(new, 3, InferOptions(batch=2))
    want = {r.payload: r.output for r in fresh.stream(iter(_engine_requests(shapes, 9)))}
    assert engine.graphs.captures == captures == 2
    for k in want:
        np.testing.assert_array_equal(after[k], want[k])
        assert not np.array_equal(after[k], before[k])


def test_scheduler_fifo_stream_is_the_plain_captured_engine():
    """A bucket-contiguous stream with no deadlines or priorities: the
    scheduler packs the plain engine's batches, so every output is the
    plain engine's, bitwise, on the same graphs' keys."""
    _cuda()
    model = load_model(PRESETS["raftstereo-realtime"], seed=7)
    shapes = [(60, 100)] * 3 + [(80, 128)] * 3
    plain = make_engine(model, 3, InferOptions(batch=2))
    want = {r.payload: r.output for r in plain.stream(iter(_engine_requests(shapes, 10)))}
    engine = make_engine(model, 3, InferOptions(batch=2))
    sched = ContinuousBatchingScheduler(engine, max_wait_s=30.0)
    got = {r.payload: r.output for r in sched.serve(iter(_engine_requests(shapes, 10)))}
    assert sorted(got) == sorted(want) == list(range(6))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert engine.graphs.captures == plain.graphs.captures == 2


def test_video_forward_replay_equals_eager_bitwise():
    """The warm-started forward (a third input, resized into flow_init) with
    no convergence exit is captured; its replay equals the eager forward
    bitwise, for two warm slots through one graph."""
    _cuda()
    model = load_model(PRESETS["raftstereo-realtime"], seed=7)
    fwd = make_adaptive_forward(model, 3, video=True)
    g = torch.Generator().manual_seed(3)
    a, b = (torch.rand((1, 64, 128, 3), generator=g) * 255 for _ in range(2))
    cache = GraphCache()
    for scale in (0.0, 6.0):
        slot = torch.rand((1, 64, 128, 2), generator=g) * scale
        replay = cache.run(("video",), fwd, (a, b, slot)).clone()
        eager = fwd(a.cuda(), b.cuda(), slot.cuda())
        assert torch.equal(replay, eager)
    assert cache.captures == 1 and cache.replays == 2


def test_mad_engine_replays_equal_eager_and_launch_no_kernel():
    """MADNet2 and its Fusion variant on the ÷128 engine: two buckets with a
    partial batch; each result equals, bitwise, the eager forward of the
    batch it rode in; K1-K3 never launch."""
    _cuda()
    from raft_stereo_tpu_torch.evaluate_mad import make_mad_engine
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2

    shapes = [(100, 200), (120, 250), (100, 200), (130, 140)]
    before = kernel_launches()
    for fusion in (False, True):
        model = make_madnet2(fusion=fusion, seed=5, device="cuda")
        engine = make_mad_engine(model, fusion, InferOptions(batch=2))
        reqs = _engine_requests(shapes, 12)
        if fusion:
            reqs = [InferRequest(payload=r.payload, inputs=r.inputs + (r.inputs[0][..., :1],))
                    for r in reqs]
        got = {r.payload: r for r in engine.stream(iter(reqs))}
        assert engine.divis_by == 128 and engine.graphs.captures == 2
        for bucket in {r.bucket for r in got.values()}:
            members = [i for i in sorted(got) if got[i].bucket == bucket]
            items = members + [members[-1]] * (2 - len(members))  # the filler
            padder = BatchPadder([shapes[i] for i in items], divis_by=128)
            arrays = [padder.pad([reqs[i].inputs[k] for i in items])
                      for k in range(len(reqs[0].inputs))]
            with torch.no_grad():
                eager = engine.forward_fn(*(torch.from_numpy(a).cuda() for a in arrays))
            for j, i in enumerate(members):
                np.testing.assert_array_equal(got[i].output,
                                              padder.unpad(eager.cpu().numpy(), j))
    assert kernel_launches() == before


def test_adaptive_server_pushes_steps_without_a_capture(tmp_path):
    """Adaptive serving on the card: the adapting copy's steps reach the
    captured graph through ``update_variables`` (the served outputs move)
    with one capture for the whole stream, and the served module is never
    the adapting one."""
    _cuda()
    import copy

    from raft_stereo_tpu_torch.evaluate_mad import make_mad_engine
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.parallel.train_step import TrainState
    from raft_stereo_tpu_torch.runtime.adapt import AdaptConfig, AdaptiveServer, AdaptPolicy
    from raft_stereo_tpu_torch.train_mad import fetch_mad_optimizer

    model = make_madnet2(seed=6, device="cuda").train()
    served = copy.deepcopy(model).eval().requires_grad_(False)
    engine = make_mad_engine(served, infer=InferOptions(batch=2))
    args = type("Args", (), {"lr": 1e-4, "variant": "mad", "wdecay": 0.0})
    opt, sched, _ = fetch_mad_optimizer(args, list(model.parameters()))
    server = AdaptiveServer(engine, TrainState(model, opt, sched), str(tmp_path / "snap"),
                            AdaptConfig(adapt_mode="mad", policy=AdaptPolicy(every=2)))
    shapes = [(100, 200)] * 6
    first = next(iter(engine.stream(iter(_engine_requests(shapes[:1], 13))))).output
    out = list(server.serve(iter(_engine_requests(shapes, 13))))
    assert all(r.ok for r in out) and server.adapt_steps == 3
    assert engine.graphs.captures == 1 and list(engine.graphs.captures_by_key.values()) == [1]
    assert all(torch.equal(p, q) for p, q in zip(served.state_dict().values(),
                                                 model.state_dict().values()))
    assert served is not model
    again = next(iter(engine.stream(iter(_engine_requests(shapes[:1], 13))))).output
    assert not np.array_equal(first, again)


def test_two_engines_capture_while_the_other_serves():
    """Two captured engines in one process, each on its own thread (the
    tiers' shape): each of engine B's captures is held open until engine A,
    serving a stream on another thread, has replayed a batch, copied it out
    and synced on it. Thread-local capture mode keeps both valid: one
    capture per key on each engine, and every output bitwise a fresh
    engine's serving that stream alone."""
    import threading

    _cuda()
    a_model = load_model(PRESETS["raftstereo-realtime"], seed=7)
    b_model = load_model(PRESETS["raftstereo-realtime"], seed=8)
    pool = _engine_requests([(60, 100)] * 4, seed=14)  # A cycles these: batches (0,1), (2,3)
    b_reqs = lambda: _engine_requests([(80, 128)] * 3 + [(60, 100)] * 2, seed=15)  # noqa: E731
    engine_a = make_engine(a_model, 3, InferOptions(batch=2))
    engine_b = make_engine(b_model, 3, InferOptions(batch=2))
    a_started, in_capture, a_replayed, stop = (threading.Event() for _ in range(4))
    overlapped = []
    forward_b = engine_b.forward_fn

    def held_forward(*inputs):
        if torch.cuda.is_current_stream_capturing():
            in_capture.set()
            overlapped.append(a_replayed.wait(timeout=60))
            a_replayed.clear()
        return forward_b(*inputs)

    engine_b.forward_fn = held_forward
    got_a, got_b, errors = {}, {}, []

    def a_source():
        i = 0
        while not stop.is_set():
            yield InferRequest(payload=i, inputs=pool[i % 4].inputs)
            i += 1

    def serve_a():
        try:
            for r in engine_a.stream(a_source()):
                got_a[r.payload] = r
                if len(got_a) == 2:
                    a_started.set()
                if in_capture.is_set():  # a result replayed during B's capture
                    in_capture.clear()
                    a_replayed.set()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        finally:
            a_started.set()
            a_replayed.set()

    thread_a = threading.Thread(target=serve_a)
    thread_a.start()
    try:
        assert a_started.wait(timeout=120)
        for r in engine_b.stream(iter(b_reqs())):
            got_b[r.payload] = r
    finally:
        stop.set()
        thread_a.join(timeout=120)
    assert not errors and not thread_a.is_alive()
    assert overlapped == [True, True]  # both of B's captures held while A served
    alone_a = make_engine(a_model, 3, InferOptions(batch=2))
    want_a = {r.payload: r.output for r in alone_a.stream(iter(pool))}
    alone_b = make_engine(b_model, 3, InferOptions(batch=2))
    want_b = {r.payload: r.output for r in alone_b.stream(iter(b_reqs()))}
    for engine, got, want, key in ((engine_a, got_a, want_a, lambda k: k % 4),
                                   (engine_b, got_b, want_b, lambda k: k)):
        assert all(r.ok for r in got.values())
        assert set(engine.graphs.captures_by_key.values()) == {1}
        for k, r in got.items():
            np.testing.assert_array_equal(r.output, want[key(k)])
    assert sorted(got_b) == sorted(want_b) and len(got_a) > 4


def test_cascade_fallback_holds_the_fast_result_past_later_replays():
    """The cascade holds an escalated pair's fast result while the fast
    engine replays its graph for later batches; when the escalation fails
    (the quality stream ends unserved) the held result is served, bitwise
    the fast engine's output for that pair alone."""
    _cuda()
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.runtime.tiers import (CascadeServer, TierSet, madnet2_tier,
                                                     raft_stereo_tier)

    mad = make_madnet2(seed=5, device="cuda")
    raft = load_model(PRESETS["raftstereo-realtime"], seed=7)
    ts = TierSet([madnet2_tier(mad), raft_stereo_tier(raft, 3)], InferOptions(batch=2))
    ts._stream_fns["quality"] = lambda feed: iter(())
    reqs = _engine_requests([(100, 200)] * 8, 16)
    reqs[0].inputs[0][0, 0, 0] = -1.0  # the pair the gate escalates
    casc = CascadeServer(ts, threshold=0.5,
                         confidence_fn=lambda left, right, d: float(left[0, 0, 0] >= 0))
    got = {r.payload: r for r in casc.serve(iter(reqs))}
    fast = ts.engine("fast")
    assert casc.summary()["fallbacks"] == 1 and casc.summary()["accepted"] == 7
    assert fast.graphs.replays == 4 and fast.graphs.captures == 1
    alone = TierSet([madnet2_tier(mad)], InferOptions(batch=2)).engine("fast")
    want = {r.payload: r.output for r in alone.stream(iter(reqs))}
    assert sorted(got) == sorted(want) == list(range(8))
    for k in want:
        np.testing.assert_array_equal(got[k].output, want[k])


def test_fleet_workers_capture_on_one_card_bitwise_one_host(tmp_path):
    """Two fleet workers on the card, each capturing its own MADNet2 graph,
    serve a paced stream bitwise this process's captured engine at the
    same batch; after host 0 is SIGKILLed mid-stream, every request still
    resolves once, on the other."""
    _cuda()
    import os
    import signal
    import time

    from raft_stereo_tpu_torch import serve_fleet
    from raft_stereo_tpu_torch.evaluate_mad import make_mad_engine
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.runtime.fleet import FleetRouter

    reqs = _engine_requests([(200, 300)] * 12, 21)
    # the workers' weights: build_engine's seed 0
    engine = make_mad_engine(make_madnet2(seed=0, device="cuda"), infer=InferOptions(batch=2))
    want = {r.payload: r.output for r in engine.stream(iter(reqs))}
    kw = {"model": "madnet2", "device": "cuda", "batch": 2}

    def paced():
        for r in reqs:
            yield r
            time.sleep(0.15)

    for kill in (False, True):
        seen = {}
        with FleetRouter(serve_fleet.FACTORY, 2, factory_kw=kw, max_wait_s=0.1,
                         workdir=str(tmp_path / f"fleet{int(kill)}")) as router:
            for r in router.serve(paced()):
                seen[r.payload] = seen.get(r.payload, 0) + 1
                assert r.ok, r.error
                np.testing.assert_array_equal(r.output, want[r.payload])
                if kill and len(seen) == 4:
                    os.kill(router.host_pid(0), signal.SIGKILL)
            deadline = time.monotonic() + 10.0
            while kill and router.snapshot()["hosts"]["0"]["state"] != "down" \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            snap = router.snapshot()
        assert sorted(seen) == list(range(12)) and set(seen.values()) == {1}
        assert snap["typed_losses"] == 0 and snap["fenced"] == 0
        assert snap["hosts"]["0"]["state"] == ("down" if kill else "up")
        if not kill:
            assert snap["failovers"] == 0


def test_chaos_seed_green_on_the_card(tmp_path):
    """Seed 0 of the port's chaos campaign (``tools/chaos.py``: a sched
    trial with a stalled dispatch pass) served on the card, its child
    process capturing the toy forward: every invariant green."""
    _cuda()
    from raft_stereo_tpu_torch.tools import chaos

    violations, rc = chaos.run_trial(chaos.make_spec(0), str(tmp_path), device="cuda")
    assert rc == 0 and violations == [], violations

"""The port's CUDA kernel on the card: the alt-correlation kernel against its
plain version, the wrapper's checks and launch count, and the forward with
the kernel against the forward with the plain lookup.

Marked ``gpu``; each test skips when no CUDA card is present (decided
inside the test, so every worker collects the same tests). This file
imports no JAX, so it also runs where only PyTorch is installed; the
tests/conftest.py beside it imports JAX, so run it there as
``python -m pytest tests/test_torch_port_cuda.py --noconftest -m gpu``.
"""

import dataclasses

import pytest
import torch

from raft_stereo_tpu_torch.config import PRESETS
from raft_stereo_tpu_torch.evaluate import load_model
from raft_stereo_tpu_torch.ops import alt_corr
from raft_stereo_tpu_torch.ops.corr import corr_lookup_alt_plain, pool_fmap_pyramid

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
     (1, 2, 50, 128, 2, 1), (1, 2, 64, 512, 1, 3), (1, 3, 41, 100, 4, 4)],
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

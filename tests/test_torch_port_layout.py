"""One memory format through the port's unfused refinement iteration.

``RAFTStereo._step`` keeps logical NCHW shapes on channels-last memory:
every tensor an iteration makes or reads at a GRU level's resolution is
dense NHWC. Under a ``TorchDispatchMode`` that sees each aten op's
operands, one unmasked and one masked step of the middlebury (3 GRU
levels) and realtime (2 levels, slow-fast, shared backbone) presets, in
bf16 on the CPU, must meet three conditions:

  * every ``aten.convolution`` input is dense channels-last, so cuDNN's
    NHWC kernels run with no transpose in or out;
  * no element-wise op, ``cat``, pool or resize mixes memory formats,
    which would send it to PyTorch's strided element-wise kernel;
  * none of them takes an operand that is dense in neither format (a
    channel slice of a wider tensor, say).

The context gate biases that make this so, one conv on each third of
``context_zqr_convs``' weights, are held to the chunks of the one conv.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raft_stereo_tpu_torch.config import PRESETS
from raft_stereo_tpu_torch.models.layers import init_weights
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo, _gate_biases

B, H, W = 2, 64, 128

# ops whose operands must share one dense format (beside the convolution)
_LAYOUT_OPS = {torch.ops.aten.cat.default, torch.ops.aten._to_copy.default,
               torch.ops.aten.avg_pool2d.default, torch.ops.aten.upsample_bilinear2d.default}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _layout(t: torch.Tensor) -> str:
    for name, fmt in (("nhwc", torch.channels_last), ("nchw", torch.contiguous_format)):
        if t.stride() == torch.empty(t.shape, memory_format=fmt, device="meta").stride():
            return name
    return "neither"


class _Layouts(TorchDispatchMode):
    """Records, for each aten op, the layouts of its activation operands:
    4-D tensors of the batch at one of ``sizes`` (weights and the
    correlation state's [B, H, W, C] tensors are left out)."""

    def __init__(self, sizes):
        super().__init__()
        self.sizes = set(sizes)
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = []
        for a in (*args, *kwargs.values()):
            flat.extend(a if isinstance(a, (list, tuple)) else [a])
        acts = [_layout(t) for t in flat if isinstance(t, torch.Tensor) and t.dim() == 4
                and t.shape[0] == B and tuple(t.shape[-2:]) in self.sizes]
        if acts:
            self.calls.append((func, acts))
        return func(*args, **kwargs)


def _model(preset):
    cfg = PRESETS[preset]
    assert cfg.mixed_precision and cfg.corr_backend == "alt"
    model = RAFTStereo(cfg).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("with_mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("preset", ["raftstereo-middlebury", "raftstereo-realtime"])
def test_step_runs_channels_last(preset, with_mask):
    model = _model(preset)
    g = torch.Generator().manual_seed(1)
    image1 = torch.rand(B, H, W, 3, generator=g) * 255
    image2 = torch.rand(B, H, W, 3, generator=g) * 255
    with torch.no_grad():
        net, inp, corr_fn, coords0_x, flow_x = model._encode(image1, image2, None, "alt")
        flow_x = flow_x + torch.randn(flow_x.shape, generator=g)
        mode = _Layouts([tuple(h.shape[-2:]) for h in net])
        with mode:
            model._step(net, inp, corr_fn, coords0_x, flow_x, with_mask)

    convs = [acts for f, acts in mode.calls if f is torch.ops.aten.convolution.default]
    assert len(convs) == (18 if with_mask else 16)
    assert [acts[0] for acts in convs if acts[0] != "nhwc"] == []
    rest = [(str(f), acts) for f, acts in mode.calls
            if torch.Tag.pointwise in f.tags or f in _LAYOUT_OPS]
    assert rest
    assert [c for c in rest if len(set(c[1])) > 1] == []
    assert [c for c in rest if "neither" in c[1]] == []


@pytest.mark.parametrize("preset", ["raftstereo-middlebury", "raftstereo-realtime"])
def test_gate_biases_are_the_one_convs_thirds(preset):
    model = _model(preset)
    g = torch.Generator().manual_seed(2)
    for zqr in model.context_zqr_convs:
        with torch.no_grad():
            zqr.bias.normal_(generator=g)
        x = torch.randn(B, zqr.in_channels, 16, 32, generator=g).to(
            memory_format=torch.channels_last)
        with torch.no_grad():
            got = _gate_biases(zqr, x)
            want = zqr(x).chunk(3, dim=1)
        for a, b in zip(got, want):
            assert _layout(a) == "nhwc"
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

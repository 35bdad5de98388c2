"""The port's MADNet2Fusion, and MADNet2 through the same reference with the
guidance branch off, against the benchmark's plain reference
(``portbench/reference/madnet2_fusion.py``) on the CPU in float32: one
seeded state dict (``portbench/mad_weights.py``: every parameter drawn,
the attention's projections and LayerNorms included), two pairs at
128x256, all five pyramid disparities and the served x4, x-20 output.

Tolerance: both sides compute in float32 on the CPU with the same
convolutions; they differ in the order of a few sums (the reference writes
LayerNorm, the attention and the window's reads out by hand), each off by
about 1e-7 of its value, and five levels of warped lookups and decoders
carry that to at most 2e-5 of the output's scale (0.1e-6 to 2.0e-5 over
four seeds of each model). The bound, 1e-4 of the largest |value| of each
output (and of at least 1), leaves five times that room and is still far
below what the cross-attention contributes: zeroing its output projection
moves the served answer by 0.14 of its scale
(``test_zeroed_attention_moves_the_answer`` asks for more than 1e-2)."""

import pytest
import torch

from portbench import guided, mad_weights
from portbench.reference import madnet2_fusion as mref
from raft_stereo_tpu_torch.models.madnet2 import MADNet2
from raft_stereo_tpu_torch.models.madnet2_fusion import MADNet2Fusion
from raft_stereo_tpu_torch.ops.sampling import bilinear_upsample

WEIGHTS = {"image_scale": 0.02, "decoder_out_scale": 0.15, "attn_out_scale": 4.0,
           "norm_std": 0.1, "bias_std": 0.01}
CELL = {"sizes": [[128, 256]], "pool_pairs": 2, "disparity_px": [4, 20], "texture_blur": 5,
        "guide_noise_px": 1.0}
REL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    pool = guided.guided_pool(CELL, seed, "cpu")
    return [torch.stack([torch.from_numpy(p[k]) for p in pool]) for k in range(3)]


def _pair(fusion, seed):
    ref = mref.MADNet2FusionReference(fusion).eval()
    sd = mad_weights.make_state_dict(ref, seed, "cpu", WEIGHTS)
    ref.load_state_dict(sd, strict=True)
    port = (MADNet2Fusion() if fusion else MADNet2()).eval()
    port.load_state_dict(sd, strict=True)
    return ref, port, sd


def _outputs(ref, port, fusion, left, right, guide):
    with torch.no_grad():
        want = ref(left, right, guide if fusion else None)
        got = port(left, right, guide) if fusion else port(left, right)
    served_want = mref.serve(ref, want)
    served_got = (bilinear_upsample(got[0], 4) * -20.0)[..., 0]
    return ([w[:, 0] for w in want] + [served_want],
            [g[..., 0] for g in got] + [served_got])


def _close(got, want):
    scale = max(float(want.abs().max()), 1.0)
    return float((got - want).abs().max()) <= REL * scale


@pytest.mark.parametrize("fusion", [True, False], ids=["fusion", "madnet2"])
@pytest.mark.parametrize("seed", [2 ** 31 + 3, 11])
def test_port_matches_the_plain_reference(fusion, seed):
    ref, port, _ = _pair(fusion, seed)
    left, right, guide = _inputs(seed)
    want, got = _outputs(ref, port, fusion, left, right, guide)
    assert len(want) == 6
    assert float(want[-1].abs().mean()) > 0.1  # the served answer is not trivially 0
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, level
        assert _close(g, w), (level, float((g - w).abs().max()), float(w.abs().max()))


def test_the_reference_loads_the_ports_state_dicts_strictly():
    for fusion, cls in ((True, MADNet2Fusion), (False, MADNet2)):
        names = set(cls().state_dict())
        assert set(mref.MADNet2FusionReference(fusion).state_dict()) == names


def test_zeroed_attention_moves_the_answer():
    """With the cross-attention's output projection zeroed (weight and
    bias) the port's served answer leaves the tolerance by far: the
    comparison sees the mechanism."""
    seed = 2 ** 31 + 3
    ref, port, sd = _pair(True, seed)
    left, right, guide = _inputs(seed)
    want, _ = _outputs(ref, port, True, left, right, guide)
    zeroed = {k: (torch.zeros_like(v) if ".out_proj." in k else v) for k, v in sd.items()}
    port.load_state_dict(zeroed, strict=True)
    _, got = _outputs(ref, port, True, left, right, guide)
    scale = max(float(want[-1].abs().max()), 1.0)
    assert float((got[-1] - want[-1]).abs().max()) > 100 * REL * scale
    assert not _close(got[-1], want[-1])


def test_window_rows_in_blocks_are_the_whole():
    """The reference's row blocks (its memory bound on the card) give the
    same answer as one block."""
    seed = 5
    ref, _, _ = _pair(True, seed)
    left, right, guide = _inputs(seed)
    with torch.no_grad():
        whole = mref.serve(ref, ref(left, right, guide))
        ref.block_rows = 7
        blocks = mref.serve(ref, ref(left, right, guide))
    assert torch.allclose(whole, blocks, rtol=0, atol=1e-4 * float(whole.abs().max()))

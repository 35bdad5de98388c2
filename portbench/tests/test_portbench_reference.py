"""The plain reference against the program's plain path, at a tiny size on
the CPU: the same weights give the same forward in float32."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench.reference import model as ref
from portbench.weights import make_state_dict

WEIGHTS = {"gru_scale": 0.5, "flow_head_out_scale": 0.05}


def configs():
    from raft_stereo_tpu_torch.config import PRESETS

    full = dict(hidden_dims=[128] * 3, n_gru_layers=3, n_downsample=2, corr_levels=4,
                corr_radius=4, context_norm="batch", shared_backbone=False,
                slow_fast_gru=False, fnet_dim=256)
    realtime = dict(full, n_gru_layers=2, n_downsample=3, shared_backbone=True,
                    slow_fast_gru=True)
    return {"raftstereo": (full, PRESETS["raftstereo"]),
            "raftstereo-realtime": (realtime, PRESETS["raftstereo-realtime"])}


def pair(seed, h=70, w=130, b=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, h, w, 3, generator=g) * 255, torch.rand(b, h, w, 3, generator=g) * 255


@pytest.mark.parametrize("name", ["raftstereo", "raftstereo-realtime"])
@pytest.mark.parametrize("corr", ["reg", "alt"])
def test_forward_matches_the_programs_plain_path(name, corr):
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.ops.pad import InputPadder

    dims, preset = configs()[name]
    m = ref.RAFTStereoReference(dims).eval()
    sd = make_state_dict(m, 11, "cpu", WEIGHTS)
    m.load_state_dict(sd)
    port = RAFTStereo(dataclasses.replace(preset, mixed_precision=False,
                                          corr_implementation=corr)).eval()
    port.load_state_dict(sd, strict=True)
    a, b = pair(3)
    padder = InputPadder(a.shape, divis_by=32)
    got = padder.unpad(port(*padder.pad(a, b), iters=2)[1])[0, :, :, 0]
    want = ref.predict(m, a[0], b[0], 2)
    assert want.abs().mean() > 0.1
    assert (got - want).abs().max() < 1e-4


@pytest.mark.parametrize("convs,state", [("fp8", "bf16"), ("bf16", "bf16"), ("fp8", "fp32")])
def test_lower_precisions_move_the_answer(convs, state):
    """Each control of ``calibrate.py`` computes what it says: a lowered
    state hands back bf16 values, and every control moves the answer."""
    dims, _ = configs()["raftstereo-realtime"]
    m = ref.RAFTStereoReference(dims).eval()
    m.load_state_dict(make_state_dict(m, 11, "cpu", WEIGHTS))
    a, b = pair(4)
    want = ref.predict(m, a[0], b[0], 2)
    got = ref.predict(ref.set_precision(m, convs, state), a[0], b[0], 2)
    assert (got - want).abs().max() > 0
    if state == "bf16":
        assert torch.equal(got, got.bfloat16().float())
    with pytest.raises(ValueError):
        ref.set_precision(m, "fp16")


def test_padding_is_the_programs_bucket_padding():
    from raft_stereo_tpu_torch.ops.pad import _pad_amounts

    for h, w in [(375, 1242), (1958, 2852), (64, 64), (70, 130)]:
        assert list(ref.pad_amounts(h, w, 32)) == _pad_amounts(h, w, 32, "sintel")

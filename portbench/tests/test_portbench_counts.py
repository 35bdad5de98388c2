"""The benchmark's operation and byte counts against hand counts at small
shapes."""

from __future__ import annotations

import json

import pytest

from portbench import harness
from portbench.counts import flops, k1, peaks


def dims(config):
    full = json.loads((harness.BENCH_DIR / "configs" / "raftstereo.json").read_text())["model"]
    if config == "raftstereo-realtime":
        return dict(full, n_gru_layers=2, n_downsample=3, shared_backbone=True,
                    slow_fast_gru=True)
    return full


def conv(cin, cout, k, px):
    return 2 * cin * cout * k * k * px


def test_full_model_iteration_by_hand():
    """One more refinement of raftstereo at 64x128 (features 16x32, 8x16,
    4x8): three ConvGRUs, the motion encoder, the flow head's x channel and
    K1's taps; the mask head runs only on the last iteration."""
    c = dims("raftstereo")
    p08, p16, p32 = 16 * 32, 8 * 16, 4 * 8
    by_hand = (3 * conv(256, 128, 3, p32) + 3 * conv(384, 128, 3, p16)
               + 3 * conv(384, 128, 3, p08)
               + conv(36, 64, 1, p08) + conv(64, 64, 3, p08) + conv(1, 64, 7, p08)
               + conv(64, 64, 3, p08) + conv(128, 126, 3, p08)
               + conv(128, 256, 3, p08) + conv(256, 1, 3, p08)
               + 2 * 256 * 10 * 4 * p08)
    one, two = (flops.forward_flops(c, "alt", n, 64, 128) for n in (1, 2))
    assert two - one == by_hand


def test_realtime_iteration_by_hand():
    """The realtime model at 64x128 (features 8x16, 4x8): the slow-fast
    schedule runs the coarse GRU twice an iteration."""
    c = dims("raftstereo-realtime")
    p08, p16 = 8 * 16, 4 * 8
    by_hand = (2 * 3 * conv(256, 128, 3, p16) + 3 * conv(384, 128, 3, p08)
               + conv(36, 64, 1, p08) + conv(64, 64, 3, p08) + conv(1, 64, 7, p08)
               + conv(64, 64, 3, p08) + conv(128, 126, 3, p08)
               + conv(128, 256, 3, p08) + conv(256, 1, 3, p08)
               + 2 * 256 * 10 * 4 * p08)
    one, two = (flops.forward_flops(c, "alt", n, 64, 128) for n in (1, 2))
    assert two - one == by_hand


@pytest.mark.parametrize("config,corr", [("raftstereo", "alt"), ("raftstereo-realtime", "reg")])
def test_counts_scale_with_the_batch(config, corr):
    one = flops.forward_flops(dims(config), corr, 2, 64, 128)
    assert flops.forward_flops(dims(config), corr, 2, 64, 128, batch=3) == 3 * one


def test_reg_builds_each_level_once():
    c = dims("raftstereo")
    h, w = 16, 32  # features of a 64x128 pair
    volume = 2 * 256 * h * w * (32 + 16 + 8 + 4)
    alt_iter = 2 * 256 * 10 * 4 * h * w
    diff = (flops.forward_flops(c, "reg", 3, 64, 128)
            - flops.forward_flops(c, "alt", 3, 64, 128))
    assert diff == volume - 3 * alt_iter


@pytest.mark.parametrize("shape,bound_us", [((1, 136, 240, 256), 30.13),
                                            ((4, 496, 720, 256), 1318.5)])
def test_k1_bound_is_the_kernel_tables(shape, bound_us):
    """Bytes bound K1: fmap1, the W-pooled pyramid, the coordinates and the
    output once each, in fp32 (the kernel table's 0.030 ms at 544x960)."""
    b, h, w, d = shape
    n_bytes = 4 * (b * h * w * d + b * h * sum(w // 2 ** lvl for lvl in range(4)) * d
                   + b * h * w + b * h * w * 36)
    assert k1.call_bytes(b, h, w, d, 4, 4) == n_bytes
    assert k1.call_flops(b, h, w, d, 4, 4) / peaks.FP32_FLOPS < n_bytes / peaks.HBM_BYTES_PER_S
    assert k1.call_bound_s(b, h, w, d, 4, 4) * 1e6 == pytest.approx(bound_us, rel=1e-3)

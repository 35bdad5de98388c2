"""The fused refinement step (``--fused_update``) and the ``converge_eps``
early exit of the port, against the JAX package, on the CPU.

On CPU tensors the port's ``fused_refine_step`` computes its plain version,
so these tests hold that plain version to the JAX ``reference_refine_step``
and to the Pallas kernel run by the Pallas interpreter (the JAX package's
own CPU route, ``tests/test_fused_update.py``). Inputs and weights are made
from numpy seeds; tolerances are those of ``tests/test_fused_update.py``
(fp32 step) and ``tests/test_torch_port_slice.py`` (fp32 model), or are
stated with their measurement.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import PRESETS as JAX_PRESETS
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.ops import pallas_fused_update as jfu
from raft_stereo_tpu_torch.config import PRESETS, RAFTStereoConfig, config_from_args
from raft_stereo_tpu_torch.evaluate import add_model_args, load_model, make_forward
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.ops import alt_corr, fused_update
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

H_ATOL, DELTA_ATOL = 5e-5, 2e-4  # tests/test_fused_update.py
LOW_ATOL, UP_ATOL, RTOL = 2e-3, 5e-3, 1e-4  # tests/test_torch_port_slice.py
MODEL_H, MODEL_W, MODEL_ITERS = 48, 64, 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fused_interpret(monkeypatch):
    """The JAX fused model engages its Pallas kernel through the Pallas
    interpreter on the CPU (its own test route)."""
    monkeypatch.setenv("RAFT_STEREO_TPU_FUSED_INTERPRET", "1")


# ------------------------------------------------------------------ step


def _raw_params(rng, LK=36, dh=128, din=384):
    """JAX-layout (HWIO) weights of the encoder, gru08 and flow head."""
    def a(*s, scale=0.1):
        return np.asarray(rng.randn(*s) * scale, np.float32)

    return {
        "encoder": {
            "convc1": {"kernel": a(1, 1, LK, 64), "bias": a(64)},
            "convf1": {"kernel": a(7, 7, 2, 64), "bias": a(64)},
            "convc2": {"kernel": a(3, 3, 64, 64), "bias": a(64)},
            "convf2": {"kernel": a(3, 3, 64, 64), "bias": a(64)},
            "conv": {"kernel": a(3, 3, 128, 126), "bias": a(126)},
        },
        "gru": tuple({"kernel": a(3, 3, din, dh), "bias": a(dh)} for _ in range(3)),
        "flow_head": {
            "conv1": {"kernel": a(3, 3, dh, 256), "bias": a(256)},
            "conv2": {"kernel": a(3, 3, 256, 2), "bias": a(2)},
        },
    }


def _port_block(raw, n_gru_layers):
    """The port's update block carrying ``raw`` (HWIO → OIHW)."""
    block = BasicMultiUpdateBlock((128, 128, 128), n_gru_layers)
    enc, gru, head = block.encoder, block.gru08, block.flow_head
    mods = {
        enc.convc1: raw["encoder"]["convc1"], enc.convf1: raw["encoder"]["convf1"],
        enc.convc2: raw["encoder"]["convc2"], enc.convf2: raw["encoder"]["convf2"],
        enc.conv: raw["encoder"]["conv"], gru.convz: raw["gru"][0], gru.convr: raw["gru"][1],
        gru.convq: raw["gru"][2], head.conv1: raw["flow_head"]["conv1"],
        head.conv2: raw["flow_head"]["conv2"],
    }
    with torch.no_grad():
        for m, p in mods.items():
            m.weight.copy_(torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1).copy()))
            m.bias.copy_(torch.from_numpy(p["bias"]))
    return block


def _step_inputs(rng, B=1, H=10, W=16, D=32, dh=128, L=4, with_inp=True):
    """tests/test_fused_update.py's inputs, as numpy."""
    def a(*s, scale=0.1):
        return np.asarray(rng.randn(*s) * scale, np.float32)

    f1 = a(B, H, W, D, scale=0.5)
    f2p = [a(B, H, max(W // (2 ** i), 1), D, scale=0.5) for i in range(L)]
    flow = a(B, H, W, scale=2.0)
    h = np.tanh(a(B, H, W, dh, scale=1.0))
    inp = a(B, H, W, 128, scale=0.5) if with_inp else None
    ctx = a(B, H, W, 3 * dh, scale=0.5)
    return f1, f2p, flow, h, inp, ctx


STEP_CASES = {
    # name: (seed, B, H, with inp16) — tests/test_fused_update.py:65-111
    "single_tile": (0, 1, 10, True),
    "b2_h37_ragged": (1, 2, 37, True),
    "no_inp16": (2, 1, 10, False),
}


def _step_case(name, dtype=np.float32):
    seed, B, H, with_inp = STEP_CASES[name]
    rng = np.random.RandomState(seed)
    raw = _raw_params(rng, din=384 if with_inp else 256)
    inputs = _step_inputs(rng, B=B, H=H, with_inp=with_inp)
    return raw, inputs, 3 if with_inp else 1


def _jax_packed(raw):
    return jfu.pack_fused_params(jax.tree_util.tree_map(jnp.asarray, raw))


def _to_jax(inputs, cd=jnp.float32):
    f1, f2p, flow, h, inp, ctx = inputs
    a = jnp.asarray
    return (a(f1), [a(x) for x in f2p], a(flow), a(h, cd),
            None if inp is None else a(inp, cd), a(ctx, cd))


def _to_torch(inputs, cd=torch.float32):
    f1, f2p, flow, h, inp, ctx = inputs
    t = torch.from_numpy
    return (t(f1), [t(x) for x in f2p], t(flow), t(h).to(cd),
            None if inp is None else t(inp).to(cd), t(ctx).to(cd))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax_reference_and_interpreted_kernel_fp32(case):
    raw, inputs, n_layers = _step_case(case)
    packed_j = _jax_packed(raw)
    f1, f2p, flow, h, inp, ctx = _to_jax(inputs)
    h_ref, d_ref = jfu.reference_refine_step(packed_j, f1, f2p, flow, h, inp, ctx, 4)
    h_k, d_k = jax.jit(lambda *a: jfu.fused_refine_step(*a, 4, interpret=True))(
        packed_j, f1, f2p, flow, h, inp, ctx)
    packed = fused_update.pack_fused_params(_port_block(raw, n_layers))
    before = fused_update.LAUNCHES
    h_t, d_t = fused_update.fused_refine_step(packed, *_to_torch(inputs), 4)
    assert fused_update.LAUNCHES == before  # CPU tensors take the plain version
    assert h_t.shape == h_ref.shape and d_t.shape == d_ref.shape
    assert h_t.dtype == torch.float32 and d_t.dtype == torch.float32
    for want_h, want_d in ((h_ref, d_ref), (h_k, d_k)):
        np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), atol=H_ATOL, rtol=0)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(want_d), atol=DELTA_ATOL, rtol=0)


def test_step_matches_jax_reference_bf16():
    """bf16 compute, bf16 h/inp16/ctx, on the ragged case. The two plain
    versions round at the same points; their fp32 sums run in another
    order, which flips a few bf16 roundings of cor/flo/cf2/m, and those
    flips reach h' and delta. Measured on the CPU: 1.1% of h' elements
    differ, by at most 1.6e-2 (4 bf16 ulps at |h'| < 1; mean 2.6e-5);
    delta by at most 4.1e-2 with |delta| up to 25.5 (0.16%). Bounds: twice
    each."""
    raw, inputs, n_layers = _step_case("b2_h37_ragged")
    h_ref, d_ref = jfu.reference_refine_step(
        _jax_packed(raw), *_to_jax(inputs, jnp.bfloat16), 4, jnp.bfloat16)
    packed = fused_update.pack_fused_params(_port_block(raw, n_layers), torch.bfloat16)
    h_t, d_t = fused_update.fused_refine_step(packed, *_to_torch(inputs, torch.bfloat16), 4,
                                              compute_dtype=torch.bfloat16)
    assert h_t.dtype == torch.bfloat16 and d_t.dtype == torch.float32
    dh = np.abs(h_t.float().numpy() - np.asarray(h_ref, np.float32))
    dd = np.abs(d_t.numpy() - np.asarray(d_ref))
    assert dh.max() <= 2 ** -5, dh.max()
    assert (dh > 0).mean() <= 0.022, (dh > 0).mean()
    assert dd.max() <= 0.0032 * float(np.abs(d_ref).max()), dd.max()


# Gradients of the step against ``jax.vjp`` of the JAX ``fused_refine_step``
# (its Pallas kernel interpreted forward, its custom VJP's XLA recompute
# backward), fp32, on weights carried across: each gradient within 1e-4 of
# its own largest magnitude. Measured on the CPU: at most 4.6e-6 of it (the
# two recomputes sum in other orders).
GRAD_RTOL = 1e-4


@pytest.mark.parametrize("case", ["no_inp16", "single_tile"])
def test_step_gradients_match_jax_vjp(case):
    """The port's ``fused_refine_step`` is differentiable like the JAX
    ``_fused_op``: gradients reach the weights (through the packing, to the
    update block's convs), fmap1, every pyramid level, h, inp16 and ctx;
    ``flow_x`` gets none (the JAX VJP returns zeros for it)."""
    raw, inputs, n_layers = _step_case(case)
    rng = np.random.RandomState(7)
    f1, f2p, flow, h, inp, ctx = inputs
    g_h = rng.randn(*h.shape).astype(np.float32)
    g_d = rng.randn(*flow.shape).astype(np.float32)

    def jax_step(raw_j, f1, f2p, h, inp, ctx):
        return jfu.fused_refine_step(jfu.pack_fused_params(raw_j), f1, f2p, jnp.asarray(flow),
                                     h, inp, ctx, 4, interpret=True)

    jf1, jf2p, _, jh, jinp, jctx = _to_jax(inputs)
    want = jax.jit(lambda *a: jax.vjp(jax_step, *a)[1]((jnp.asarray(g_h), jnp.asarray(g_d))))(
        jax.tree_util.tree_map(jnp.asarray, raw), jf1, jf2p, jh, jinp, jctx)
    d_raw, d_f1, d_f2p, d_h, d_inp, d_ctx = want

    block = _port_block(raw, n_layers)
    packed = fused_update.pack_fused_params(block, grad=True)
    tf1, tf2p, tflow, th, tinp, tctx = _to_torch(inputs)
    leaves = [tf1, *tf2p, th, tctx, tflow] + ([tinp] if tinp is not None else [])
    for t in leaves:
        t.requires_grad_(True)
    h_t, d_t = fused_update.fused_refine_step(packed, tf1, tf2p, tflow, th, tinp, tctx, 4)
    torch.autograd.backward((h_t, d_t), (torch.from_numpy(g_h), torch.from_numpy(g_d)))

    def close(got, want_j):
        want_j = np.asarray(want_j)
        assert got is not None and got.shape == want_j.shape
        scale = max(float(np.abs(want_j).max()), 1e-12)
        assert float(np.abs(got.detach().numpy() - want_j).max()) <= GRAD_RTOL * scale

    assert tflow.grad is None
    close(tf1.grad, d_f1)
    for lv, want_l in zip(tf2p, d_f2p):
        close(lv.grad, want_l)
    close(th.grad, d_h)
    close(tctx.grad, d_ctx)
    if tinp is not None:
        close(tinp.grad, d_inp)
    enc, gru, head = block.encoder, block.gru08, block.flow_head
    convs = {(enc.convc1, ("encoder", "convc1")), (enc.convf1, ("encoder", "convf1")),
             (enc.convc2, ("encoder", "convc2")), (enc.convf2, ("encoder", "convf2")),
             (enc.conv, ("encoder", "conv")), (gru.convz, ("gru", 0)), (gru.convr, ("gru", 1)),
             (gru.convq, ("gru", 2)), (head.conv1, ("flow_head", "conv1")),
             (head.conv2, ("flow_head", "conv2"))}
    for conv, (group, key) in convs:
        d = d_raw[group][key]
        close(conv.weight.grad.permute(2, 3, 1, 0), d["kernel"])
        close(conv.bias.grad, d["bias"])


# ------------------------------------------------------------- stage 1


def _jax_motion_in(packed_j, f1, f2p, flow, radius):
    """The JAX package's plain alt lookup composed with convc1 and convf1
    (the first cast points of its ``reference_refine_step``, fp32)."""
    from raft_stereo_tpu.ops.corr import corr_lookup_alt

    coords = jnp.arange(f1.shape[2], dtype=jnp.float32)[None, None, :] + flow
    corr = corr_lookup_alt(f1, f2p, coords, radius)
    cor = jax.nn.relu(jnp.einsum("bhwk,kc->bhwc", corr, packed_j["wc1"])
                      + packed_j["bc1"][0])
    flow8 = jnp.pad(flow[..., None], ((0, 0), (0, 0), (0, 0), (0, 7)))
    flo = jax.lax.conv_general_dilated(flow8, packed_j["kf7"], (1, 1), [(3, 3), (3, 3)],
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jnp.concatenate([cor, jax.nn.relu(flo + packed_j["bf7"][0])], -1)


@pytest.mark.parametrize("case", ["single_tile", "b2_h37_ragged"])
def test_reference_motion_in_matches_jax_composition_fp32(case):
    """fp32 sums in another order only: within 1e-5 (cor|flo reach a few
    units here)."""
    raw, inputs, n_layers = _step_case(case)
    f1, f2p, flow, *_ = _to_jax(inputs)
    want = np.asarray(_jax_motion_in(_jax_packed(raw), f1, f2p, flow, 4))
    packed = fused_update.pack_fused_params(_port_block(raw, n_layers))
    f1_t, f2p_t, flow_t, *_ = _to_torch(inputs)
    got = fused_update.reference_motion_in(f1_t, f2p_t, flow_t, packed, 4)
    assert got.shape == want.shape == (*flow_t.shape, fused_update.MOTION_CH)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_motion_in_on_the_cpu_is_the_plain_version():
    raw, inputs, n_layers = _step_case("b2_h37_ragged")
    packed = fused_update.pack_fused_params(_port_block(raw, n_layers), torch.bfloat16)
    f1, f2p, flow, *_ = _to_torch(inputs)
    before = (fused_update.MOTION_IN_LAUNCHES, fused_update.LAUNCHES)
    got = fused_update.motion_in(f1, f2p, flow, packed, 4, torch.bfloat16)
    assert (fused_update.MOTION_IN_LAUNCHES, fused_update.LAUNCHES) == before
    want = fused_update.reference_motion_in(f1, f2p, flow, packed, 4, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# rows, W, widths, D -> seg, segments, threads, dc, chunks, blocks an SM
GEOMETRY_CASES = {
    # the slice shape: 544x960 at 1/4, 4 levels
    "slice": ((136, 240, (240, 120, 60, 30), 256), (60, 4, 256, 16, 16, 3)),
    # the Middlebury-F width: a level row of 1350 positions in all
    "middlebury_F": ((496, 720, (720, 360, 180, 90), 256), (60, 12, 256, 8, 32, 2)),
    "ragged_w123": ((74, 123, (123, 61, 30, 15), 256), (62, 2, 256, 32, 8, 3)),
    "three_levels": ((6, 77, (77, 38, 19), 100), (77, 1, 256, 32, 4, 3)),
    "eight_levels": ((2, 300, (300, 150, 75, 37, 18, 9, 4, 2), 64), (30, 10, 256, 8, 8, 3)),
    # a partial last chunk: 100 channels in chunks of 32
    "d100": ((3, 41, (41, 20, 10, 5), 100), (41, 1, 192, 32, 4, 3)),
}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_motion_in_geometry(case):
    (rows, W, widths, D), (seg, segments, threads, dc, chunks, per_sm) = GEOMETRY_CASES[case]
    geo = fused_update.motion_in_geometry(rows, W, widths, D)
    assert (geo.seg, geo.segments, geo.threads, geo.dc, geo.chunks, geo.per_sm) == (
        seg, segments, threads, dc, chunks, per_sm)
    assert geo.blocks == rows * segments
    L = len(widths)
    assert seg * L <= threads <= fused_update.SEGMENT and threads % 32 == 0
    assert (segments - 1) * seg < W <= segments * seg  # as few and as even as fit
    assert geo.smem >= 8 * dc * (seg + sum(widths))  # two stages of the staged rows
    assert per_sm * (geo.smem + fused_update.SMEM_RESERVED) <= fused_update.SMEM_SM
    if case == "slice":
        assert (geo.smem, geo.blocks) == (65280, 544)
    if case == "middlebury_F":  # DC = 8 does not leave room for a third block
        assert 3 * (8 * 8 * (seg + sum(widths)) + 1024) > fused_update.SMEM_SM


def test_motion_in_geometry_refuses_a_row_too_wide_to_stage():
    with pytest.raises(ValueError, match="stages every level's whole row"):
        fused_update.motion_in_geometry(1, 8000, (8000, 4000, 2000, 1000), 256)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 8])
def test_motion_in_geometry_shared_memory_never_exceeds_a_block(levels):
    """Every width up to the widest that stages, and small D: the shared
    memory stays within the 227 KB a block may have and covers the conv
    phase's tiles, whatever W or D."""
    for W in list(range(1, 70)) + list(range(70, 4000, 37)):
        widths = [max(W >> i, 1) for i in range(levels)]
        segments = -(-W // (fused_update.SEGMENT // levels))
        staged = -(-W // segments) + sum(widths)  # a segment's f1 rows and the level rows
        for D in (4, 32, 100, 256):
            if 2 * 4 * 4 * staged > fused_update.SMEM:  # two stages at 4 channels
                with pytest.raises(ValueError):
                    fused_update.motion_in_geometry(3, W, widths, D)
                continue
            geo = fused_update.motion_in_geometry(3, W, widths, D)
            assert geo.smem <= fused_update.SMEM
            assert geo.smem >= fused_update._conv_phase_bytes(geo.seg, levels)
            assert geo.dc <= D


# ------------------------------------------------------------- stage 7


def _fh1(case):
    """Seeded stage-7 input at the case's shape: relu of unit normals,
    [B, H, 16, 256] fp32."""
    seed, B, H, _ = STEP_CASES[case]
    rng = np.random.RandomState(100 + seed)
    return np.maximum(rng.randn(B, H, 16, fused_update.HEAD_CH), 0.0).astype(np.float32)


@pytest.mark.parametrize("case", ["single_tile", "b2_h37_ragged"])
def test_reference_head_out_matches_jax_composition_fp32(case):
    """The JAX ``reference_refine_step``'s last line, conv(fh1, kfh2[...,
    :1])[..., 0] + bfh2, on carried weights: fp32 sums of 2304 products in
    another order only, within 1e-5 of delta's scale, max(1, |delta| max)
    (delta reaches about 10 here, where two orders of the sum differ by up
    to 1.7e-5: 18 fp32 ulps)."""
    raw, inputs, n_layers = _step_case(case)
    fh1 = _fh1(case)
    pj = _jax_packed(raw)
    want = jax.lax.conv_general_dilated(jnp.asarray(fh1), pj["kfh2"][..., :1], (1, 1),
                                        [(1, 1), (1, 1)],
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = np.asarray(want[..., 0] + pj["bfh2"][0, 0])
    packed = fused_update.pack_fused_params(_port_block(raw, n_layers))
    got = fused_update.reference_head_out(torch.from_numpy(fh1), packed)
    assert got.shape == want.shape == fh1.shape[:3]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()),
                               rtol=0)


def test_head_out_on_the_cpu_is_the_plain_version():
    raw, _, n_layers = _step_case("b2_h37_ragged")
    packed = fused_update.pack_fused_params(_port_block(raw, n_layers), torch.bfloat16)
    fh1 = torch.from_numpy(_fh1("b2_h37_ragged")).to(torch.bfloat16)
    before = (fused_update.HEAD_OUT_LAUNCHES, fused_update.MOTION_IN_LAUNCHES,
              fused_update.LAUNCHES)
    got = fused_update.head_out(fh1, packed, torch.bfloat16)
    assert (fused_update.HEAD_OUT_LAUNCHES, fused_update.MOTION_IN_LAUNCHES,
            fused_update.LAUNCHES) == before
    want = fused_update.reference_head_out(fh1, packed, torch.bfloat16)
    assert got.shape == fh1.shape[:3] and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# (B, H, W) -> blocks: 8 x 32 tiles, tile columns fastest
HEAD_OUT_GEOMETRY_CASES = {
    "slice": ((1, 136, 240), 136),
    "engine_b4_544x960": ((4, 136, 240), 544),
    "engine_b4_480x640": ((4, 120, 160), 300),
    "ragged_b2_h37_w123": ((2, 37, 123), 40),
    "middlebury_F": ((1, 496, 720), 1426),
    "tile_over_image": ((3, 5, 17), 3),
}


@pytest.mark.parametrize("case", list(HEAD_OUT_GEOMETRY_CASES))
def test_head_out_geometry(case):
    (B, H, W), blocks = HEAD_OUT_GEOMETRY_CASES[case]
    geo = fused_update.head_out_geometry(B, H, W)
    assert geo.blocks == blocks
    assert (geo.tile, geo.threads, geo.halo) == ((8, 32), 256, 340)
    assert geo.smem == 21456  # w[9][256] and t[9][340], fp32
    rows, cols = geo.tile
    assert geo.blocks * rows * cols >= B * H * W  # every pixel has a thread


def test_head_out_geometry_mirrors_the_kernel_constants():
    """``head_out_geometry`` and the kernel's ``ho`` constants agree, so the
    CPU tests and the build line describe the launch the card makes."""
    import re
    from pathlib import Path

    src = (Path(fused_update.__file__).parent.parent / "csrc" / "fused_update.cu").read_text()
    rows, cols = re.search(r"constexpr int kRows = (\d+), kCols = (\d+);", src).groups()
    assert (int(rows), int(cols)) == fused_update.HEAD_TILE
    # the static shared memory: w[9][256] and t[9][halo], fp32
    assert "float w[9][kHeadCh];" in src and "float t[9][kHalo];" in src


def test_batch_max_delta_matches_jax():
    d = np.random.RandomState(3).randn(3, 5, 7).astype(np.float32)
    d[1] *= 4.0
    got = float(fused_update.batch_max_delta(torch.from_numpy(d)))
    assert got == pytest.approx(float(jfu.batch_max_delta(jnp.asarray(d))), rel=1e-6)


# --------------------------------------------------------------- weights


def _perturb(variables, seed):
    """Non-trivial biases and norm statistics (tests/test_torch_port_slice.py)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        if name in ("bias", "mean"):
            return (0.05 * rng.randn(*x.shape)).astype(x.dtype)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@functools.lru_cache(maxsize=None)
def _variables(preset):
    """One seeded JAX init a preset's architecture (fp32, alt)."""
    jcfg = dataclasses.replace(JAX_PRESETS[preset], corr_implementation="alt",
                               mixed_precision=False)
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    model = JaxRAFTStereo(jcfg)
    init = jax.jit(lambda k: model.init(k, img, img, iters=1, test_mode=True))
    return _perturb(init(jax.random.PRNGKey(0)), seed=1)


def test_pack_matches_jax_packing_on_carried_weights():
    variables = _variables("raftstereo-middlebury")
    ub = variables["params"]["step"]["update_block"]
    raw = {
        "encoder": {k: ub["encoder"][k] for k in ("convc1", "convf1", "convc2", "convf2", "conv")},
        "gru": tuple(ub["gru08"][k] for k in ("convz", "convr", "convq")),
        "flow_head": {k: ub["flow_head"][k] for k in ("conv1", "conv2")},
    }
    want = {k: np.asarray(v) for k, v in jfu.pack_fused_params(raw).items()}
    model = load_model(PRESETS["raftstereo-middlebury"], device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = {k: v.numpy() for k, v in fused_update.pack_fused_params(model.update_block).items()}
    # the same keys, but convc2|convf2 as two groups rather than the
    # block-diagonal kcf
    assert set(got) == set(jfu._PACKED_KEYS) - {"kcf"} | {"wcf"}
    eq = np.testing.assert_array_equal

    def taps(w):  # HWIO → [kh·kw, cin, cout]
        return w.reshape(-1, *w.shape[2:])

    eq(got["wc1"], want["wc1"])
    eq(got["kf7"], taps(want["kf7"])[:, 0])
    eq(taps(want["kf7"])[:, 1:], 0)  # the TPU's 8-channel pad
    kcf = taps(want["kcf"])
    eq(got["wcf"][:, :, :64], kcf[:, :64, :64])
    eq(got["wcf"][:, :, 64:], kcf[:, 64:, 64:])
    eq(kcf[:, :64, 64:], 0)  # the block-diagonal packing's zero blocks
    eq(kcf[:, 64:, :64], 0)
    for k in ("km", "wzr", "wq", "kfh1"):
        eq(got[k], taps(want[k]))
    eq(got["kfh2"], taps(want["kfh2"])[..., 0])
    eq(taps(want["kfh2"])[..., 1:], 0)  # the 128-lane pad
    for k in ("bc1", "bf7", "bcf", "bm", "bzr", "bq", "bfh1"):
        eq(got[k], want[k][0])
    eq(got["bfh2"], want["bfh2"][0])


def test_pack_casts_weights_and_keeps_fp32_biases():
    block = BasicMultiUpdateBlock((128, 128, 128), 2)
    packed = fused_update.pack_fused_params(block, torch.bfloat16)
    for k, v in packed.items():
        assert v.is_contiguous()
        assert v.dtype == (torch.bfloat16 if k in fused_update.WEIGHT_KEYS else torch.float32), k
    assert packed["wzr"].shape == (9, 128 + 128 + 128, 256)
    assert packed["km"][..., 126:].abs().max() == 0 and packed["bm"][126:].abs().max() == 0


# ----------------------------------------------------------------- model


def _pair(seed, H=MODEL_H, W=MODEL_W):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, H, W, 3) * 255).astype(np.float32) for _ in range(2)]


def _jax_apply(preset, variables, img1, img2, iters, **cfg):
    jcfg = dataclasses.replace(JAX_PRESETS[preset], mixed_precision=False, **cfg)
    model = JaxRAFTStereo(jcfg)
    return jax.jit(lambda v, a, b: model.apply(v, a, b, iters=iters, test_mode=True))(
        variables, jnp.asarray(img1), jnp.asarray(img2))


def _port_model(preset, variables, **cfg):
    tcfg = dataclasses.replace(PRESETS[preset], mixed_precision=False, **cfg)
    model = load_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("preset", ["raftstereo-middlebury", "raftstereo-realtime"])
def test_fused_model_matches_jax_fused_model_fp32(preset, fused_interpret):
    """The middlebury preset's 3 GRU levels, and the realtime preset's 2
    levels with the slow-fast schedule and the shared backbone."""
    variables = _variables(preset)
    img1, img2 = _pair(4)
    low_j, up_j = _jax_apply(preset, variables, img1, img2, MODEL_ITERS, fused_update=True)
    model = _port_model(preset, variables, fused_update=True)
    low_t, up_t = model(torch.from_numpy(img1), torch.from_numpy(img2), iters=MODEL_ITERS)
    assert np.isfinite(up_t.numpy()).all()
    np.testing.assert_allclose(low_t.numpy(), np.asarray(low_j), atol=LOW_ATOL, rtol=RTOL)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=UP_ATOL, rtol=RTOL)


def test_fused_model_matches_unfused_model_fp32(monkeypatch):
    """Port fused against port unfused, same weights: only the unmasked
    steps differ, by fp32 summation order. The fused path calls the step
    iters-1 times; the masked step stays unfused."""
    variables = _variables("raftstereo-middlebury")
    img1, img2 = (torch.from_numpy(x) for x in _pair(5))
    calls = []
    real = fused_update.fused_refine_step
    monkeypatch.setattr(fused_update, "fused_refine_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fused = _port_model("raftstereo-middlebury", variables, fused_update=True)
    low_f, up_f = fused(img1, img2, iters=MODEL_ITERS)
    assert len(calls) == MODEL_ITERS - 1
    plain = _port_model("raftstereo-middlebury", variables)
    low_p, up_p = plain(img1, img2, iters=MODEL_ITERS)
    assert len(calls) == MODEL_ITERS - 1
    torch.testing.assert_close(low_f, low_p, atol=LOW_ATOL, rtol=RTOL)
    torch.testing.assert_close(up_f, up_p, atol=UP_ATOL, rtol=RTOL)


def test_fused_update_makes_the_corr_state_alt(monkeypatch):
    """With fused_update the `reg` preset's lookups go through the alt
    backend too (the JAX model does the same)."""
    import raft_stereo_tpu_torch.models.raft_stereo as rs

    backends = []
    real = rs.make_corr_fn
    monkeypatch.setattr(rs, "make_corr_fn",
                        lambda backend, *a: backends.append(backend) or real(backend, *a))
    cfg = RAFTStereoConfig(corr_levels=2, corr_radius=2, fused_update=True)
    model = load_model(cfg, device="cpu", seed=2)
    img1, img2 = (torch.from_numpy(x) for x in _pair(6, H=32, W=64))
    model(img1, img2, iters=2)
    assert backends == ["alt"]


# ----------------------------------------------------------- early exit


def _jax_step_deltas(preset, variables, img1, img2, n):
    """Per-step batch-max mean |Δflow| of the JAX model's first n steps,
    from its lowres outputs at 1..n iterations (unfused: every step there
    is the same step, so iters=k ends after step k)."""
    prev, out = 0.0, []
    for k in range(1, n + 1):
        low, _ = _jax_apply(preset, variables, img1, img2, k)
        flow = np.asarray(low)[..., 0]
        out.append(float(np.abs(flow - prev).mean(axis=(1, 2)).max()))
        prev = flow
    return out


def test_converge_eps_matches_jax_iters_executed_and_outputs(fused_interpret):
    preset, iters = "raftstereo-middlebury", 4
    variables = _variables(preset)
    img1, img2 = _pair(7)
    d1, d2 = _jax_step_deltas(preset, variables, img1, img2, 2)
    # Half-way between the first two step deltas: if the second step moves
    # less than the first, the loop exits after it (3 iterations with the
    # masked one), else after the first (2). The fused steps' deltas differ
    # from the unfused ones by fp32 summation order only, far inside this
    # margin.
    eps = 0.5 * (d1 + d2)
    assert abs(d1 - d2) > 1e-3 * max(d1, d2), (d1, d2)
    expect = 3 if d2 < d1 else 2
    low_j, up_j, it_j = _jax_apply(preset, variables, img1, img2, iters, fused_update=True,
                                   converge_eps=eps)
    assert int(it_j) == expect
    model = _port_model(preset, variables, fused_update=True, converge_eps=eps)
    calls = []
    real = fused_update.fused_refine_step
    fused_update.fused_refine_step = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        low_t, up_t, it_t = model(torch.from_numpy(img1), torch.from_numpy(img2), iters=iters)
    finally:
        fused_update.fused_refine_step = real
    assert it_t == int(it_j)
    assert len(calls) == it_t - 1  # the masked step is never fused
    np.testing.assert_allclose(low_t.numpy(), np.asarray(low_j), atol=LOW_ATOL, rtol=RTOL)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=UP_ATOL, rtol=RTOL)


def test_converge_eps_that_never_triggers_runs_every_iteration():
    """A threshold below every delta runs all iterations and gives the
    fixed loop's outputs exactly; make_forward returns the disparity."""
    cfg = RAFTStereoConfig(corr_implementation="alt", corr_levels=2, corr_radius=2)
    img1, img2 = (torch.from_numpy(x) for x in _pair(8, H=32, W=64))
    fixed = load_model(cfg, device="cpu", seed=3)
    low_a, up_a = fixed(img1, img2, iters=3)
    early = load_model(dataclasses.replace(cfg, converge_eps=1e-30), device="cpu", seed=3)
    low_b, up_b, n = early(img1, img2, iters=3)
    assert n == 3
    torch.testing.assert_close(low_b, low_a, rtol=0, atol=0)
    torch.testing.assert_close(up_b, up_a, rtol=0, atol=0)
    torch.testing.assert_close(make_forward(early, 3)(img1, img2), up_a, rtol=0, atol=0)


@pytest.mark.parametrize("eps", [float("nan"), -1e-3, float("inf")])
def test_config_rejects_bad_converge_eps(eps):
    with pytest.raises(ValueError, match="converge_eps"):
        RAFTStereoConfig(converge_eps=eps)
    assert RAFTStereoConfig(converge_eps=0.0).converge_eps == 0.0


# ------------------------------------------------------------------- CLI


def test_cli_fused_update_flag_reaches_the_config():
    parser = add_model_args(argparse.ArgumentParser())
    assert config_from_args(parser.parse_args(["--fused_update"])).fused_update is True
    assert config_from_args(parser.parse_args([])).fused_update is False


def test_demo_runs_fused_on_the_cpu(tmp_path):
    from PIL import Image

    from raft_stereo_tpu_torch import demo

    rng = np.random.RandomState(9)
    d = tmp_path / "pairs" / "scene0"
    d.mkdir(parents=True)
    for name in ("im0.png", "im1.png"):
        Image.fromarray((rng.rand(45, 70, 3) * 255).astype(np.uint8)).save(d / name)
    before = (fused_update.LAUNCHES, alt_corr.LAUNCHES)
    run = demo.main([
        "--preset", "raftstereo-middlebury", "--fused_update", "--valid_iters", "2",
        "--corr_levels", "2", "--corr_radius", "2",
        "--left_imgs", str(tmp_path / "pairs" / "*" / "im0.png"),
        "--right_imgs", str(tmp_path / "pairs" / "*" / "im1.png"),
        "--output_directory", str(tmp_path / "out"), "--save_numpy",
    ], device="cpu")
    assert run.saved == 1
    assert (fused_update.LAUNCHES, alt_corr.LAUNCHES) == before  # plain versions on the CPU
    disp = np.load(tmp_path / "out" / "scene0.npy")
    assert disp.shape == (45, 70) and np.isfinite(disp).all()

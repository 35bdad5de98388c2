"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both; every tolerance is stated
with its reason. The alt lookup is held against the JAX recompute path and
the Pallas kernel in interpret mode (mirroring tests/test_ops.py:318-377).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.ops import corr as jcorr
from raft_stereo_tpu.ops import pad as jpad
from raft_stereo_tpu.ops import sampling as jsamp
from raft_stereo_tpu.ops.pallas_corr import corr_lookup_alt_pallas
from raft_stereo_tpu_torch.ops import alt_corr
from raft_stereo_tpu_torch.ops import corr as tcorr
from raft_stereo_tpu_torch.ops import pad as tpad
from raft_stereo_tpu_torch.ops import sampling as tsamp

# fp32 on both sides; only summation order and op fusion differ
FP32_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_coords_grid_matches():
    np.testing.assert_array_equal(
        tsamp.coords_grid(2, 5, 7).numpy(), np.asarray(jsamp.coords_grid(2, 5, 7))
    )


@pytest.mark.parametrize("src,dst", [((6, 10), (12, 20)), ((5, 7), (9, 13)), ((4, 4), (4, 4))])
def test_interp_bilinear_align_corners(src, dst):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jsamp.interp_bilinear(jnp.asarray(x), dst))
    got = _nhwc(tsamp.interp_bilinear(_nchw(x), dst))
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_avg_pool2x(hw):
    x = np.random.RandomState(1).randn(1, *hw, 4).astype(np.float32)
    want = np.asarray(jsamp.avg_pool2x(jnp.asarray(x)))
    got = _nhwc(tsamp.avg_pool2x(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)


@pytest.mark.parametrize("w", [16, 15, 1])
def test_avg_pool_w2_floor(w):
    x = np.random.RandomState(2).randn(2, 3, w, 5).astype(np.float32)
    want = np.asarray(jsamp.avg_pool_w2(jnp.asarray(x)))
    got = tsamp.avg_pool_w2(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, w // 2, 5)
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)


@pytest.mark.parametrize("factor,d", [(4, 1), (8, 2)])
def test_convex_upsample(factor, d):
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 5, 6, d).astype(np.float32)
    mask = rng.randn(2, 5, 6, 9 * factor * factor).astype(np.float32)
    want = np.asarray(jsamp.convex_upsample(jnp.asarray(flow), jnp.asarray(mask), factor))
    got = tsamp.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask), factor).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(37, 70), (64, 96)])
def test_input_padder(mode, hw):
    x = np.random.RandomState(4).rand(1, *hw, 3).astype(np.float32)
    jp = jpad.InputPadder(x.shape, mode=mode, divis_by=32)
    tp = tpad.InputPadder(x.shape, mode=mode, divis_by=32)
    (want,) = jp.pad(x)
    (got_np,) = tp.pad(x)
    (got_t,) = tp.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert want.shape[1] % 32 == 0 and want.shape[2] % 32 == 0
    np.testing.assert_array_equal(tp.unpad(got_t).numpy(), x)


def test_corr_volume_and_reg_lookup():
    rng = np.random.RandomState(5)
    f1 = rng.randn(1, 4, 33, 8).astype(np.float32)
    f2 = rng.randn(1, 4, 33, 8).astype(np.float32)
    vol_j = jcorr.corr_volume(jnp.asarray(f1), jnp.asarray(f2))
    vol_t = tcorr.corr_volume(torch.from_numpy(f1), torch.from_numpy(f2))
    np.testing.assert_allclose(vol_t.numpy(), np.asarray(vol_j), atol=FP32_ATOL)

    coords = (rng.rand(1, 4, 33) * 45 - 6).astype(np.float32)
    coords[0, 0, :3] = [0.0, 32.0, -1.5]
    pyr_j = jcorr.build_corr_pyramid(vol_j, 3)
    pyr_t = [tcorr.corr_volume(torch.from_numpy(f1), p)
             for p in tcorr.pool_fmap_pyramid(torch.from_numpy(f2), 3)]
    want = np.asarray(jcorr.corr_lookup_reg(pyr_j, jnp.asarray(coords), 3))
    got = tcorr.corr_lookup_reg(pyr_t, torch.from_numpy(coords), 3).numpy()
    assert got.shape == (1, 4, 33, 3 * 7)
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)


def _alt_case(seed, B, H, W, D, levels, lo, hi):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, D).astype(np.float32)
    f2 = rng.randn(B, H, W, D).astype(np.float32)
    coords = (rng.rand(B, H, W) * (hi - lo) + lo).astype(np.float32)
    flat = coords.reshape(-1)
    flat[:4] = [0.0, W - 1.0, -1e3, 4.0 * W]  # edges, wholly outside
    flat[4::11] = np.round(flat[4::11])  # exact integers
    return f1, f2, coords


@pytest.mark.parametrize(
    "B,H,W,D,levels,radius",
    [
        (1, 4, 32, 8, 3, 2),  # tests/test_ops.py's shape
        (2, 3, 37, 8, 4, 4),  # odd and ragged widths 37/18/9/4
        (1, 2, 123, 16, 4, 3),  # widths 123/61/30/15
    ],
)
def test_alt_plain_matches_jax_and_pallas(B, H, W, D, levels, radius):
    f1, f2, coords = _alt_case(B * W + levels, B, H, W, D, levels, -6, W + 6)
    pyr_j = jcorr.pool_fmap_pyramid(jnp.asarray(f2), levels)
    want = np.asarray(jcorr.corr_lookup_alt(jnp.asarray(f1), pyr_j, jnp.asarray(coords), radius))
    pallas = np.asarray(corr_lookup_alt_pallas(
        jnp.asarray(f1), pyr_j, jnp.asarray(coords), radius, interpret=True))
    pyr_t = tcorr.pool_fmap_pyramid(torch.from_numpy(f2), levels)
    got = tcorr.corr_lookup_alt_plain(torch.from_numpy(f1), pyr_t, torch.from_numpy(coords), radius)
    assert got.shape == (B, H, W, levels * (2 * radius + 1))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL)
    # the Pallas kernel's matmul + triangular contraction sums in another
    # order; tests/test_ops.py holds it to its twin at 1e-4
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4)


def test_alt_wrapper_on_cpu_is_the_plain_version():
    f1, f2, coords = _alt_case(9, 1, 3, 29, 8, 3, -4, 33)
    pyr = tcorr.pool_fmap_pyramid(torch.from_numpy(f2), 3)
    before = alt_corr.LAUNCHES
    got = alt_corr.corr_lookup_alt(torch.from_numpy(f1), pyr, torch.from_numpy(coords), 2)
    want = tcorr.corr_lookup_alt_plain(torch.from_numpy(f1), pyr, torch.from_numpy(coords), 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert alt_corr.LAUNCHES == before  # no kernel ran


def test_alt_wrapper_refuses_other_devices():
    f1 = torch.zeros((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        alt_corr.corr_lookup_alt(f1, [f1], torch.zeros((1, 2, 8), device="meta"), 2)


@pytest.mark.parametrize(
    "rows,W1,widths,D,dc,chunks",
    [
        (136, 240, (240, 120, 60, 30), 256, 32, 8),  # the 544x960 slice
        (496, 720, (720, 360, 180, 90), 256, 32, 8),  # Middlebury-F width
        (68, 120, (120, 60, 30, 15), 256, 32, 8),  # the realtime preset
        (12, 517, (517, 258, 129, 64), 100, 32, 4),  # 3 x 32 + a partial 4
        (3, 41, (41, 20, 10, 5), 260, 32, 9),  # 8 x 32 + a partial 4
        (2, 9, (9, 4, 2, 1), 8, 8, 1),  # no chunk wider than D
        (1, 2000, (2000, 1000), 256, 8, 32),  # a level row too wide for 16 channels
    ],
)
def test_alt_launch_geometry_takes_the_widest_chunk_that_fits(rows, W1, widths, D, dc, chunks):
    geo = alt_corr.launch_geometry(rows, W1, widths, D)
    assert (geo.dc, geo.chunks) == (dc, chunks)
    assert (geo.chunks - 1) * geo.dc < D <= geo.chunks * geo.dc
    # two stages of the segment's f1 rows and the widest level row
    assert geo.smem == 2 * (geo.seg + max(widths)) * geo.dc * 4 <= alt_corr.SMEM
    for wider in (c for c in alt_corr.CHUNKS if geo.dc < c <= D):
        assert 2 * (min(W1, 32) + max(widths)) * wider * 4 > alt_corr.SMEM


@pytest.mark.parametrize("rows,W1,levels", [(136, 240, 4), (496, 720, 4), (10, 300, 2),
                                            (3, 517, 3), (2, 256, 1), (2, 257, 4), (1, 1, 1),
                                            (1, 2000, 2)])
def test_alt_launch_geometry_grid_counts_rows_levels_and_segments(rows, W1, levels):
    widths = [max(W1 >> l, 1) for l in range(levels)]
    geo = alt_corr.launch_geometry(rows, W1, widths, 256)
    assert geo.blocks == rows * levels * geo.segments
    assert (geo.segments - 1) * geo.seg < W1 <= geo.segments * geo.seg <= W1 + geo.segments
    assert geo.seg <= alt_corr.SEGMENT
    assert geo.seg <= geo.threads < geo.seg + 32 and geo.threads % 32 == 0
    # as few segments as fit: one fewer would not
    fewer = geo.segments - 1
    if fewer:
        seg = -(-W1 // fewer)
        assert seg > alt_corr.SEGMENT or 2 * (seg + widths[0]) * geo.dc * 4 > alt_corr.SMEM


def test_alt_launch_geometry_shortens_segments_to_fit():
    # Middlebury-F width: three segments of 240 pixels beside the 720-position
    # level row would take more than a block's shared memory at 32 channels
    geo = alt_corr.launch_geometry(496, 720, (720, 360, 180, 90), 256)
    assert 2 * (240 + 720) * 32 * 4 > alt_corr.SMEM
    assert (geo.segments, geo.seg, geo.threads, geo.dc) == (4, 180, 192, 32)


def test_alt_launch_geometry_refuses_a_row_too_wide_to_stage():
    alt_corr.launch_geometry(1, 7000, (7000,), 256)  # rows of images about 28,000 px wide
    with pytest.raises(ValueError, match=f"more than the {alt_corr.SMEM}"):
        alt_corr.launch_geometry(1, 13000, (13000, 6500), 256)


@pytest.mark.parametrize("backend", ["reg", "alt", "reg_pallas", "alt_pallas"])
def test_corr_fn_backends_match_jax(backend):
    """make_corr_fn + CorrFn for every backend, from bf16 features: reg/alt
    cast to fp32 first, the *_pallas backends pool in bf16."""
    rng = np.random.RandomState(11)
    f1 = rng.randn(1, 3, 40, 16).astype(np.float32)
    f2 = rng.randn(1, 3, 40, 16).astype(np.float32)
    coords = (rng.rand(1, 3, 40) * 50 - 5).astype(np.float32)
    jf = jcorr.make_corr_fn(
        backend, jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16), 4, 4)
    if backend == "alt_pallas":
        # what the JAX package runs on the TPU: the kernel, which upcasts the
        # bf16 pyramid (off the TPU its CorrFn falls back to bf16 math)
        want = np.asarray(corr_lookup_alt_pallas(
            jf.fmap1, jf.fmap2_pyramid, jnp.asarray(coords), 4, interpret=True))
    else:
        want = np.asarray(jf(jnp.asarray(coords)), np.float32)
    tf = tcorr.make_corr_fn(backend, torch.from_numpy(f1).bfloat16(),
                            torch.from_numpy(f2).bfloat16(), 4, 4)
    got = tf(torch.from_numpy(coords))
    assert got.dtype == torch.float32
    # bf16-rounded inputs agree exactly; fp32 products and sums differ in
    # order only (reg_pallas: bf16 x bf16 products are exact in fp32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

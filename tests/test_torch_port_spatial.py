"""The spatial tier on the CPU (``parallel/spatial.py``,
``models/raft_stereo_spatial.py``, the engine's, scheduler's, tiers' and
controller's spatial parts and ``evaluate --spatial_threshold``).

  * Whole-slice parity: ``SpatialRAFTStereo`` on k = 2, 3 and 4 repeated
    CPU devices (uneven slabs at 64x96 and 96x128, 3 iterations, width 32,
    fp32) against the JAX ``RAFTStereo.apply(test_mode=True)`` unsharded,
    on the same weights (``state_dict_from_jax``), within atol 2e-3 and
    rtol 1e-4 (the JAX package's own limit for its sharded forward,
    ``tests/test_parallel.py:117``); k = 1 bitwise the model's forward.
  * Each sharded op against its unsharded torch op at k = 1..4, with uneven
    slabs and shards that get no rows, within 1e-5 of the output's scale.
  * Planted faults the parity limit must catch: a conv halo one row short,
    a per-slab (local) resize, per-slab norm moments, K2 with one halo row
    too few.
  * The packed encoder stage (K3, ``models.extractor._ENABLE_PACKED``) per
    slab: the realtime preset (fp32, the file's widths) at k = 2, 3 and 4
    against the unsharded JAX packed forward (its K3 through the Pallas
    interpreter), within the same limit, with 4·k K3 calls a forward (one
    trunk: the shared backbone's, on the stacked pair); k = 1 bitwise the
    port's unsharded packed forward; K3 per slab with no halo row fails the
    limit; a slab geometry K3 refuses raises, naming the slab.
  * The 20 cases of ``tests/test_spatial_tier.py`` under their names, on
    the port's engine, scheduler, tiers and controller with the toy
    elementwise forward (its spatial twin sharded over ``[cpu] * 8``), and
    ``evaluate.main --spatial_threshold`` on a mixed fixture tree.
"""

import dataclasses
import functools
import json
import os
import os.path as osp
import threading

import fixture_trees as ft
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import raft_stereo_tpu.experiments.pallas_packed_conv as ppc
import raft_stereo_tpu.models.extractor as jext
from raft_stereo_tpu.config import PRESETS as JAX_PRESETS
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import PRESETS, RAFTStereoConfig
from raft_stereo_tpu_torch.data import frame_io
from raft_stereo_tpu_torch.evaluate import load_model
from raft_stereo_tpu_torch.experiments import packed_conv, packed_encoder
from raft_stereo_tpu_torch.models import extractor
from raft_stereo_tpu_torch.models import raft_stereo_spatial as rss
from raft_stereo_tpu_torch.models.layers import GroupNorm, InstanceNorm, conv
from raft_stereo_tpu_torch.models.raft_stereo_spatial import SpatialRAFTStereo
from raft_stereo_tpu_torch.ops import sampling
from raft_stereo_tpu_torch.ops.pad import BatchPadder, bucket_shape, spatial_divis
from raft_stereo_tpu_torch.parallel import spatial
from raft_stereo_tpu_torch.parallel.mesh import mesh_spatial_size, shard_spatial, spatial_mesh
from raft_stereo_tpu_torch.runtime import faultinject, infer, telemetry
from raft_stereo_tpu_torch.runtime.controller import OverloadController
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferOptions, InferRequest
from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler, ShedError
from raft_stereo_tpu_torch.runtime.tiers import ModelTier, SpatialServer, TierSet
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

ATOL, RTOL = 2e-3, 1e-4  # tests/test_parallel.py:117
ITERS = 3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- whole-slice parity

BASE = dict(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
# name: (config, size); each config's weights carry from a seeded JAX
# variables tree. The shared backbone with the slow-fast schedule is the
# realtime preset's architecture (two GRU levels at 1/8).
CONFIGS = {
    "reg": ({}, (64, 96)),
    "alt_context_instance": (dict(corr_implementation="alt", context_norm="instance"),
                             (96, 128)),
    "fused_context_group": (dict(corr_implementation="alt", fused_update=True,
                                 context_norm="group"), (96, 128)),
    "shared_backbone_slow_fast": (dict(shared_backbone=True, slow_fast_gru=True,
                                       n_gru_layers=2, n_downsample=3), (64, 96)),
    "gru1": (dict(n_gru_layers=1), (64, 96)),
    "gru2": (dict(n_gru_layers=2), (96, 128)),
}


def _seeded_variables(jcfg, seed=1):
    """A JAX variables tree of the architecture's shapes (``eval_shape``, no
    init run), filled from a numpy seed at an init's scales, with random
    norm statistics."""
    model = JaxRAFTStereo(dataclasses.replace(jcfg, fused_update=False))
    img = jnp.zeros((1, 32, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), img, img, iters=1,
                                               test_mode=True))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_out = int(np.prod(s.shape[:2])) * s.shape[-1]
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_out)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(H, W, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, H, W, 3) * 255).astype(np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port model, images, JAX (lowres, disp_up)) of one config."""
    kw, (H, W) = CONFIGS[name]
    jcfg = JaxConfig(**BASE, **kw)
    variables = _seeded_variables(jcfg)
    img1, img2 = _images(H, W, seed=len(name))
    jmodel = JaxRAFTStereo(jcfg)
    low, up = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=ITERS, test_mode=True))(
        variables, jnp.asarray(img1), jnp.asarray(img2))
    model = load_model(RAFTStereoConfig(**BASE, **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, (torch.from_numpy(img1), torch.from_numpy(img2)), (np.asarray(low),
                                                                       np.asarray(up))


def _within(got, want) -> bool:
    return all(np.allclose(g.numpy(), w, atol=ATOL, rtol=RTOL) for g, w in zip(got, want))


@pytest.fixture
def fused_interpret(monkeypatch):
    """The JAX fused model runs its Pallas kernel through the interpreter on
    the CPU (its own tests' route)."""
    monkeypatch.setenv("RAFT_STEREO_TPU_FUSED_INTERPRET", "1")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_forward_matches_jax(name, fused_interpret):
    """k = 2, 3 and 4 against the unsharded JAX forward: at 64 rows and 16-row
    units k = 3 splits 2/1/1 units, at 96 rows k = 4 splits 2/2/1/1 (gru1's
    4-row units split 64 rows 6/5/5 at k = 3)."""
    model, (a, b), want = _case(name)
    for k in (2, 3, 4):
        got = SpatialRAFTStereo(model, [CPU] * k)(a, b, iters=ITERS)
        assert got[1].shape == (1, *a.shape[1:3], 1) and torch.isfinite(got[1]).all()
        assert float(got[0][..., 1].abs().max()) == 0.0
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=f"k={k}")


def test_one_shard_is_the_model_forward_bitwise():
    """k = 1, and k = 4 on a bucket of one unit (one shard holds rows), run
    the model's own forward."""
    model, (a, b), _ = _case("reg")
    want = model(a, b, iters=ITERS)
    for devices, (x, y) in (([CPU], (a, b)), ([CPU] * 4, (a[:, :16], b[:, :16]))):
        ref = want if x is a else model(x, y, iters=ITERS)
        got = SpatialRAFTStereo(model, devices)(x, y, iters=ITERS)
        for g, w in zip(got, ref):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_flow_init_is_split_by_rows():
    """``flow_init`` seeds each slab's x-flow from its own rows at 1/4
    resolution: the sharded forward matches the unsharded one from the same
    initial flow."""
    model, (a, b), _ = _case("gru1")
    H, W = a.shape[1:3]
    init = torch.from_numpy(
        (np.random.RandomState(6).randn(1, H // 4, W // 4, 2) * 4).astype(np.float32))
    want = model(a, b, iters=ITERS, flow_init=init)
    got = SpatialRAFTStereo(model, [CPU] * 3)(a, b, iters=ITERS, flow_init=init)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=RTOL)


def test_converge_eps_exit_reads_every_shard():
    """The convergence exit stops where the unsharded one does: the max
    over samples of the whole image's mean |delta|."""
    model, (a, b), _ = _case("alt_context_instance")
    eps_model = load_model(dataclasses.replace(model.config, converge_eps=1e9), device="cpu")
    eps_model.load_state_dict(model.state_dict())
    want = eps_model(a, b, iters=ITERS)
    got = SpatialRAFTStereo(eps_model, [CPU] * 3)(a, b, iters=ITERS)
    assert got[2] == want[2] == 2  # one unmasked step, then the masked one
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=ATOL, rtol=RTOL)


# ------------------------------------------------- the packed stage (K3)


# The packed cases run 2 refinement iterations, not ITERS: with the
# realtime preset's alt lookup at 3 iterations the random network amplifies
# fp32 noise to the limit itself (over image seeds 11-21 the unsharded port
# reaches 1.7x it against JAX, and the stock sharded forward, no K3, 2.1x),
# while at 2 the worst of k = 2-4 over those seeds is 0.41 of it and K3
# without its halo rows over 1000x.
PACKED_ITERS = 2


@functools.lru_cache(maxsize=None)
def _packed_case():
    """(port model, images, JAX (lowres, disp_up)) of the realtime preset in
    fp32 at the file's widths, 64x96 (four 16-row units), the JAX forward
    with its packed stage on and K3 through the Pallas interpreter."""
    kw = dict(mixed_precision=False, **BASE)
    jcfg = dataclasses.replace(JAX_PRESETS["raftstereo-realtime"], **kw)
    variables = _seeded_variables(jcfg)
    img1, img2 = _images(64, 96, seed=11)
    jmodel = JaxRAFTStereo(jcfg)
    saved = jext._ENABLE_PACKED, ppc._INTERPRET
    jext._ENABLE_PACKED, ppc._INTERPRET = True, True
    try:
        apply = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=PACKED_ITERS,
                                                     test_mode=True))
        low, up = apply(variables, jnp.asarray(img1), jnp.asarray(img2))
        low, up = np.asarray(low), np.asarray(up)
    finally:
        jext._ENABLE_PACKED, ppc._INTERPRET = saved
    model = load_model(dataclasses.replace(PRESETS["raftstereo-realtime"], **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, (torch.from_numpy(img1), torch.from_numpy(img2)), (low, up)


@pytest.fixture
def k3_calls(monkeypatch):
    """The port's packed stage on; the shapes its K3 wrapper is called at
    (on the CPU it runs the plain version and launches nothing)."""
    monkeypatch.setattr(extractor, "_ENABLE_PACKED", True)
    calls = []
    wrapped = packed_conv.packed_conv3x3

    def count(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(packed_conv, "packed_conv3x3", count)
    return calls


@pytest.mark.parametrize("k", [2, 3, 4])
def test_packed_sharded_forward_matches_jax(k, k3_calls):
    """Layer1's four convs as K3 on every slab, each slab extended by one
    halo row a side: 4·k calls a forward, the packed rows [2, 16/k + 2,
    24, 128] at stem stride 2, within the parity limit of the unsharded
    JAX packed forward."""
    model, (a, b), want = _packed_case()
    got = SpatialRAFTStereo(model, [CPU] * k)(a, b, iters=PACKED_ITERS)
    assert len(k3_calls) == 4 * k
    rows = [r1 - r0 for r0, r1 in spatial.row_split(32, 8, k)]
    assert sorted(set(k3_calls)) == sorted({(2, n + 2, 24, 128) for n in rows})
    assert got[1].shape == (1, 64, 96, 1) and torch.isfinite(got[1]).all()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=f"k={k}")


def test_packed_one_shard_is_the_packed_forward_bitwise(k3_calls):
    model, (a, b), _ = _packed_case()
    want = model(a, b, iters=PACKED_ITERS)
    assert len(k3_calls) == 4
    got = SpatialRAFTStereo(model, [CPU])(a, b, iters=PACKED_ITERS)
    assert len(k3_calls) == 8
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_packed_k3_without_halo_rows_fails_the_parity_limit(k3_calls, monkeypatch):
    """The planted fault: K3 on each slab alone, its zero padding in place
    of the neighbours' rows."""
    model, (a, b), want = _packed_case()
    assert _within(SpatialRAFTStereo(model, [CPU] * 2)(a, b, iters=PACKED_ITERS), want)
    monkeypatch.setattr(rss, "K3_HALO_ROWS", 0)
    assert not _within(SpatialRAFTStereo(model, [CPU] * 2)(a, b, iters=PACKED_ITERS), want)
    assert set(k3_calls[8:]) == {(2, 16, 24, 128)}


def test_packed_slab_geometry_k3_refuses_names_the_slab(k3_calls, monkeypatch):
    """With the gate forced open at a width K3 cannot pack (51 columns
    after the stride-2 stem), the forward raises naming the slab; it
    does not fall back to the stock conv."""
    model, _, _ = _packed_case()
    monkeypatch.setattr(packed_encoder, "packable_hw", lambda *args: True)
    a, b = (torch.from_numpy(x) for x in _images(64, 102, seed=3))
    with pytest.raises(ValueError, match=r"K3 cannot take the slab \(2, 64, 18, 51\)"):
        SpatialRAFTStereo(model, [CPU] * 2)(a, b, iters=1)
    assert k3_calls == []


# ------------------------------------------------------------ planted faults


def _short_conv_halo(monkeypatch):
    """Every conv's halo one row short: the farthest neighbour row reads
    zeros."""
    conv2d, halo = spatial.conv2d, spatial.halo

    def short_halo(slabs, above, below, dim=2, zeros=True):
        out = halo(slabs, above, below, dim, zeros)
        for i, t in enumerate(out):
            if i > 0 and above:
                t.narrow(dim, 0, 1).zero_()
            if i < len(out) - 1 and below:
                t.narrow(dim, t.shape[dim] - 1, 1).zero_()
        return out

    def faulty(*args, **kw):
        spatial.halo = short_halo
        try:
            return conv2d(*args, **kw)
        finally:
            spatial.halo = halo

    monkeypatch.setattr(spatial, "conv2d", faulty)


def _local_resize(monkeypatch):
    def local(slabs, rows, width):
        return [F.interpolate(s, size=(n, width), mode="bilinear", align_corners=True)
                for s, n in zip(slabs, rows)]

    monkeypatch.setattr(spatial, "interp_bilinear", local)


def _per_slab_moments(monkeypatch):
    moments = spatial.moments
    monkeypatch.setattr(spatial, "moments", lambda slabs, groups=0: [
        moments([s], groups)[0] for s in slabs])


def _k2_one_row_short(monkeypatch):
    monkeypatch.setattr(rss, "K2_HALO_ROWS", rss.K2_HALO_ROWS - 1)


FAULTS = {
    "conv_halo_one_row_short": (_short_conv_halo, "reg"),
    "local_resize": (_local_resize, "reg"),
    "per_slab_norm_moments": (_per_slab_moments, "alt_context_instance"),
    "k2_halo_one_row_short": (_k2_one_row_short, "fused_context_group"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_parity_limit(fault, monkeypatch, fused_interpret):
    plant, name = FAULTS[fault]
    model, (a, b), want = _case(name)
    assert _within(SpatialRAFTStereo(model, [CPU] * 2)(a, b, iters=ITERS), want)
    plant(monkeypatch)
    assert not _within(SpatialRAFTStereo(model, [CPU] * 2)(a, b, iters=ITERS), want)


# ------------------------------------------------------------- sharded ops

# (H, unit, k): even, uneven, and shards without rows
SPLITS = [(16, 4, 1), (16, 4, 2), (24, 4, 3), (20, 4, 4), (8, 4, 4), (12, 4, 3)]


def _slabs(x, H, unit, k, dim=2):
    bounds = spatial.row_split(H, unit, k)
    assert [r1 - r0 for r0, r1 in bounds].count(0) == max(k - H // unit, 0)
    return spatial.split(x, bounds, [CPU] * k, dim=dim)


def _close(got, want):
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("H,unit,k", SPLITS)
def test_row_split_and_halo_round_trip(H, unit, k):
    x = torch.randn(2, 3, H, 5, generator=torch.Generator().manual_seed(H + k))
    slabs = _slabs(x, H, unit, k)
    torch.testing.assert_close(spatial.gather(slabs), x, rtol=0, atol=0)
    padded = F.pad(x, (0, 0, 5, 6))
    starts = np.cumsum([0] + [s.shape[2] for s in slabs])
    for i, ext in enumerate(spatial.halo(slabs, 5, 6)):
        torch.testing.assert_close(ext, padded[:, :, starts[i]:starts[i + 1] + 11])
    for i, ext in enumerate(spatial.halo(slabs, 5, 6, zeros=False)):
        lo, hi = max(starts[i] - 5, 0), min(starts[i + 1] + 6, H)
        torch.testing.assert_close(ext, x[:, :, lo:hi])


CONVS = [(3, 1), (3, 2), (7, 1), (7, 2), (1, 1), (1, 2)]


@pytest.mark.parametrize("H,unit,k", SPLITS)
@torch.no_grad()
def test_sharded_ops_match_unsharded(H, unit, k):
    g = torch.Generator().manual_seed(7 * H + k)
    x = torch.randn(2, 16, H, 12, generator=g) * 3 + 1
    slabs = _slabs(x, H, unit, k)
    for kernel, stride in CONVS:
        m = conv(16, 8, kernel, stride)
        with torch.no_grad():
            m.bias.normal_(generator=g)
        _close(spatial.gather(spatial.conv2d(slabs, [m] * len(slabs))), m(x))
        _close(spatial.gather(spatial.conv2d(_slabs(x[:, :4], H, unit, k), [m] * len(slabs),
                                             in_slice=slice(0, 4), out_slice=slice(0, 1))),
               F.conv2d(x[:, :4], m.weight[:1, :4], m.bias[:1], stride, kernel // 2))
    _close(spatial.gather(spatial.instance_norm(slabs, 1e-5)), InstanceNorm()(x))
    gn = GroupNorm(2, 16)
    with torch.no_grad():
        gn.weight.normal_(generator=g)
        gn.bias.normal_(generator=g)
    _close(spatial.gather(spatial.group_norm(slabs, [gn] * len(slabs))), gn(x))
    _close(spatial.gather(spatial.avg_pool2x(slabs)), sampling.avg_pool2x(x))
    # the coarse level of a 2x pyramid, up to this one (and an odd ratio)
    coarse = _slabs(torch.randn(2, 16, H // 2, 6, generator=g), H // 2, unit // 2, k)
    rows = [s.shape[2] for s in slabs]
    _close(spatial.gather(spatial.interp_bilinear(coarse, rows, 12)),
           sampling.interp_bilinear(spatial.gather(coarse), (H, 12)))
    odd = torch.randn(2, 4, 7, 3, generator=g)
    parts = list(torch.tensor_split(odd, len(rows), dim=2))
    _close(spatial.gather(spatial.interp_bilinear(parts, rows, 12)),
           sampling.interp_bilinear(odd, (H, 12)))
    flow = torch.randn(2, H, 12, 1, generator=g) * 4
    mask = torch.randn(2, H, 12, 9 * 16, generator=g)
    up = spatial.convex_upsample(_slabs(flow, H, unit, k, dim=1),
                                 _slabs(mask, H, unit, k, dim=1), 4)
    _close(spatial.gather(up, dim=1), sampling.convex_upsample(flow, mask, 4))


def test_bf16_norms_and_resize_cast_once():
    """In bf16 the sharded norm and resize compute in fp32 and round once, as
    the unsharded modules do: they agree to a bf16 ulp."""
    x = (torch.randn(1, 8, 16, 6, generator=torch.Generator().manual_seed(3)) * 2
         ).to(torch.bfloat16)
    slabs = _slabs(x, 16, 4, 3)
    got = spatial.gather(spatial.instance_norm(slabs, 1e-5)).float()
    want = InstanceNorm()(x).float()
    assert float((got - want).abs().max()) <= 2 ** -7 * max(1.0, float(want.abs().max()))
    rows = [s.shape[2] for s in slabs]
    coarse = _slabs(x[:, :, ::2], 8, 2, 3)
    got = spatial.gather(spatial.interp_bilinear(coarse, rows, 6)).float()
    want = sampling.interp_bilinear(x[:, :, ::2], (16, 6)).float()
    assert float((got - want).abs().max()) <= 2 ** -7 * max(1.0, float(want.abs().max()))


# ------------------------------------------------------------------ toy tier
# tests/test_spatial_tier.py's toy forward and tiers, on the port

SCALE = 3.0
SMALL = (24, 48)    # bucket (32, 64)  -> 2048 px
BIG = (40, 100)     # bucket (64, 128) -> 8192 px
THRESHOLD = 4000    # SMALL stays on the base tier, BIG routes spatial
WAIT_S = 30.0


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(SCALE), requires_grad=False)


def _linear(m, a, b):
    return (a * m.scale - b).sum(-1, keepdim=True)


def _make_forward(m, devices=None):
    """The toy forward; on a device list, sharded by rows (8-row units) and
    gathered, the port's twin of the JAX toy on a spatial mesh."""
    if devices is None:
        return functools.partial(_linear, m)

    def fwd(a, b):
        slabs = zip(shard_spatial(devices, a, 8), shard_spatial(devices, b, 8))
        return spatial.gather([_linear(m, x, y) for x, y in slabs], dim=1)

    return fwd


def _tier(name, num_spatial=1):
    return ModelTier(name=name, model=_Toy(), make_forward=_make_forward,
                     num_spatial=num_spatial,
                     devices=[CPU] * 8 if num_spatial != 1 else None)


def _pair(i, hw):
    rng = np.random.RandomState(i)
    return rng.rand(*hw, 3).astype(np.float32), rng.rand(*hw, 3).astype(np.float32)


def _want(i, hw):
    a, b = _pair(i, hw)
    return (a * np.float32(SCALE) - b).sum(-1, keepdims=True)


def _spatial_set(**opts):
    opts.setdefault("batch", 2)
    opts.setdefault("sched", True)
    opts.setdefault("deadline_s", WAIT_S)
    return TierSet([_tier("quality"), _tier("spatial", num_spatial=0)], InferOptions(**opts))


def _spatial_engine(**kw):
    devices = spatial_mesh(0, [CPU] * 8)
    return InferenceEngine(_make_forward(_Toy(), devices), device=CPU, batch=2, divis_by=32,
                           spatial=devices, deadline_s=WAIT_S, **kw)


@pytest.fixture(autouse=True)
def _fi_reset():
    faultinject.reset()
    yield
    faultinject.reset()


@pytest.fixture()
def tel_events(tmp_path):
    tel = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))

    def events(name=None):
        tel.flush_trace()
        path = tmp_path / "tel" / "events.jsonl"
        out = [json.loads(line) for line in path.read_text().splitlines() if line.strip()] \
            if path.exists() else []
        return [e for e in out if name is None or e["event"] == name]

    yield events
    telemetry.uninstall(tel)


class TestSpatialPadding:
    def test_spatial_divis_is_lcm(self):
        assert spatial_divis(32, 1) == 32
        assert spatial_divis(32, 8) == 32
        assert spatial_divis(32, 3) == 96
        assert spatial_divis(32, 0) == 32

    def test_bucket_shape_divis_h(self):
        assert bucket_shape(100, 200, 32) == (128, 224)
        assert bucket_shape(100, 200, 32, divis_h=96) == (192, 224)
        assert bucket_shape(100, 200, 32, divis_h=32) == bucket_shape(100, 200, 32)

    def test_batchpadder_roundtrip_with_divis_h(self):
        shapes = [(100, 200), (128, 200), (97, 221)]
        padder = BatchPadder(shapes, divis_by=32, divis_h=64)
        assert padder.bucket == (128, 224)
        items = [np.random.RandomState(i).rand(h, w, 3).astype(np.float32)
                 for i, (h, w) in enumerate(shapes)]
        batch = padder.pad(items)
        assert batch.shape == (3, 128, 224, 3)
        for i, item in enumerate(padder.unpad_all(batch, valid=3)):
            np.testing.assert_array_equal(item, items[i])

    def test_batchpadder_rejects_cross_bucket_shape(self):
        with pytest.raises(ValueError, match="does not belong"):
            BatchPadder([(100, 200), (130, 200)], divis_by=32, divis_h=64)


class TestSpatialMesh:
    """The JAX mesh's ``spatial`` axis is the port's device list; the JAX
    tests' 8 virtual CPU devices are ``[cpu] * 8``."""

    def test_auto_puts_every_device_on_spatial(self):
        devices = spatial_mesh(0, [CPU] * 8)
        assert devices == [CPU] * 8 and mesh_spatial_size(devices) == 8
        assert spatial_mesh(0) == ([torch.device("cuda", i)
                                    for i in range(torch.cuda.device_count())]
                                   if torch.cuda.is_available() else [CPU])

    def test_mixed_mesh(self):
        devices = spatial_mesh(4, [CPU] * 8)
        assert mesh_spatial_size(devices) == 4

    def test_non_divisor_rejected(self):
        with pytest.raises(ValueError, match="divide"):
            spatial_mesh(3, [CPU] * 8)

    def test_data_mesh_spatial_size_is_one(self):
        assert mesh_spatial_size(None) == 1
        assert mesh_spatial_size(spatial_mesh(1, [CPU] * 8)) == 1


class TestSpatialEngineParity:
    def test_engine_reports_spatial_geometry(self):
        eng = _spatial_engine()
        assert eng.num_spatial == 8
        assert eng.divis_h == spatial_divis(32, 8)
        snap = eng.snapshot()
        assert snap["num_spatial"] == 8 and snap["divis_h"] == eng.divis_h
        plain = InferenceEngine(_make_forward(_Toy()), device=CPU, batch=2)
        assert (plain.num_spatial, plain.divis_h) == (1, 32)

    def test_sharded_output_matches_unsharded_bitwise(self):
        eng = _spatial_engine()
        reqs = [InferRequest(payload=i, inputs=_pair(i, BIG)) for i in range(4)]
        results = {r.payload: r for r in eng.stream(iter(reqs))}
        assert all(r.ok for r in results.values())
        model = _Toy()
        for i in range(4):
            a, b = (torch.from_numpy(x)[None] for x in _pair(i, BIG))
            want = _linear(model, a, b)[0].numpy()
            # elementwise toy forward: H-sharding must not change a bit
            np.testing.assert_array_equal(results[i].output, want)
            np.testing.assert_allclose(results[i].output, _want(i, BIG), rtol=1e-4, atol=1e-4)


class TestPixelRouting:
    def _serve_mixed(self, server, n=6):
        def requests():
            for i in range(n):
                yield InferRequest(payload=i, inputs=_pair(i, SMALL if i % 2 == 0 else BIG))

        return {r.payload: r for r in server.serve(requests())}

    def test_oversized_buckets_ride_the_spatial_tier(self, tel_events):
        ts = _spatial_set()
        server = SpatialServer(ts, base="quality", spatial="spatial", threshold=THRESHOLD)
        results = self._serve_mixed(server)
        assert all(r.ok for r in results.values())
        for i, r in results.items():
            np.testing.assert_allclose(r.output, _want(i, SMALL if i % 2 == 0 else BIG),
                                       rtol=1e-4, atol=1e-4)
        routed = tel_events("sched_spatial_route")
        assert len(routed) == 3
        big_px = bucket_shape(*BIG, 32)
        assert all(e["pixels"] == big_px[0] * big_px[1] for e in routed)
        assert all(e["threshold"] == THRESHOLD for e in routed)
        assert all(e["tier"] == "spatial" for e in routed)
        assert ts.schedulers["quality"].stats.spatial_routed == 3
        assert ts.engines["spatial"].stats.images == 3
        assert ts.engines["quality"].stats.images == 3
        assert tel_events("infer_degraded") == []
        assert ts.engines["quality"].stats.degraded == 0

    def test_threshold_off_is_bit_identical_admission(self, tel_events):
        ts = TierSet([_tier("quality")], InferOptions(batch=2, sched=True, deadline_s=WAIT_S))
        sched = ts.schedulers["quality"]
        reqs = [InferRequest(payload=i, inputs=_pair(i, BIG)) for i in range(2)]
        results = {r.payload: r for r in sched.serve(iter(reqs))}
        assert all(r.ok for r in results.values())
        assert tel_events("sched_spatial_route") == []
        snap = sched.snapshot()
        assert snap["spatial_threshold"] is None
        assert snap["spatial_base"] is None
        assert snap["stats"]["spatial_routed"] == 0

    def test_raised_bar_sheds_the_megapixel_band(self, tel_events):
        ts = _spatial_set()
        server = SpatialServer(ts, base="quality", spatial="spatial", threshold=THRESHOLD)
        sched = ts.schedulers["quality"]
        sched.set_spatial_threshold(400_000)
        results = self._serve_mixed(server, n=4)
        assert results[0].ok and results[2].ok
        for i in (1, 3):
            assert not results[i].ok
            assert isinstance(results[i].error, ShedError)
            assert results[i].error.reason == "spatial"
        shed = tel_events("sched_shed")
        assert [e["reason"] for e in shed] == ["spatial", "spatial"]
        assert ts.engines["spatial"].stats.images == 0

    def test_setter_validation(self):
        sched = _spatial_set().schedulers["quality"]
        with pytest.raises(RuntimeError, match="configure_spatial"):
            sched.set_spatial_threshold(10_000)
        sched.configure_spatial(THRESHOLD, lambda item: None)
        with pytest.raises(ValueError, match="only raises"):
            sched.set_spatial_threshold(THRESHOLD - 1)
        sched.set_spatial_threshold(4 * THRESHOLD)
        assert sched.spatial_threshold == 4 * THRESHOLD
        sched.set_spatial_threshold(THRESHOLD)
        assert sched.spatial_threshold == THRESHOLD

    def test_configure_validation(self):
        sched = _spatial_set().schedulers["quality"]
        with pytest.raises(ValueError, match=">= 1"):
            sched.configure_spatial(0, lambda item: None)
        with pytest.raises(TypeError, match="callable"):
            sched.configure_spatial(THRESHOLD, "not-a-sink")

    def test_server_requires_scheduler_backed_base(self):
        ts = TierSet([_tier("quality"), _tier("spatial", num_spatial=0)],
                     InferOptions(batch=2, sched=False))
        with pytest.raises(ValueError, match="scheduler-backed"):
            SpatialServer(ts, threshold=THRESHOLD)


class TestDegradedPixelContext:
    def test_infer_degraded_carries_pixels_and_bucket(self, tel_events):
        faultinject.arm(infer_compile_fail={1, 2, 3})
        eng = InferenceEngine(_make_forward(_Toy()), device=CPU, batch=2, retries=2,
                              retry_backoff_s=0.01, divis_by=32, deadline_s=WAIT_S)
        reqs = [InferRequest(payload=i, inputs=_pair(i, SMALL)) for i in range(2)]
        results = list(eng.stream(iter(reqs)))
        assert all(r.ok for r in results)  # served by the per-image path
        ev = tel_events("infer_degraded")
        assert len(ev) == 1
        bucket = bucket_shape(*SMALL, 32)
        assert ev[0]["pixels"] == bucket[0] * bucket[1]
        assert ev[0]["bucket_hw"] == f"{bucket[0]}x{bucket[1]}"
        assert ev[0]["reason"] == "circuit"


class TestControllerSpatialRung:
    def _sched(self, configured=True):
        eng = InferenceEngine(_make_forward(_Toy()), device=CPU, batch=2, divis_by=32)
        sched = ContinuousBatchingScheduler(eng)
        if configured:
            sched.configure_spatial(THRESHOLD, lambda item: None)
        return sched

    def test_spatial_bar_is_the_first_rung(self):
        sched = self._sched()
        ctrl = OverloadController(schedulers=[sched])
        assert [r.name for r in ctrl._ladder][:1] == ["spatial_bar"]
        rung = ctrl._ladder[0]
        assert rung.knob == "spatial_threshold"
        assert rung.baseline == THRESHOLD and rung.degraded == 4 * THRESHOLD
        rung.apply()
        assert sched.spatial_threshold == 4 * THRESHOLD
        rung.revert()
        assert sched.spatial_threshold == THRESHOLD

    def test_no_rung_without_configured_routing(self):
        ctrl = OverloadController(schedulers=[self._sched(configured=False)])
        assert "spatial_bar" not in [r.name for r in ctrl._ladder]


class TestDrainFanout:
    def test_drain_resolves_inflight_spatial_exactly_once(self, tel_events):
        ts = _spatial_set()
        server = SpatialServer(ts, base="quality", spatial="spatial", threshold=THRESHOLD)
        n = 8
        started, resume = threading.Event(), threading.Event()

        def requests():
            for i in range(n):
                if i == 4:
                    started.set()  # half admitted: drain now
                    resume.wait(WAIT_S)
                yield InferRequest(payload=i, inputs=_pair(i, SMALL if i % 2 == 0 else BIG))

        results = []
        done = threading.Event()

        def consume():
            try:
                results.extend(server.serve(requests()))
            finally:
                done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert started.wait(timeout=WAIT_S)
        ts.request_drain(10.0)  # fans to both tier schedulers
        resume.set()
        assert done.wait(timeout=60.0)
        t.join(timeout=5.0)
        assert sorted(r.payload for r in results) == list(range(n))
        for r in results:
            assert r.ok or isinstance(r.error, Exception)
        assert ts.schedulers["quality"].draining
        assert ts.schedulers["spatial"].draining


# ------------------------------------------------------------------- the CLI


def _write_scene(base, scene, shape, disp, seed):
    rng = np.random.RandomState(seed)
    d = osp.join(base, "two_view_training", scene)
    os.makedirs(d, exist_ok=True)
    for name in ("im0.png", "im1.png"):
        Image.fromarray(rng.randint(0, 255, shape + (3,), np.uint8)).save(osp.join(d, name))
    gt = osp.join(base, "two_view_training_gt", scene)
    os.makedirs(gt, exist_ok=True)
    frame_io.write_pfm(osp.join(gt, "disp0GT.pfm"), np.full(shape, disp, np.float32))


def test_evaluate_cli_routes_the_big_bucket(tmp_path, monkeypatch):
    """``evaluate --dataset eth3d --infer_batch 2 --spatial_threshold 5000`` on
    the 40x64 fixture scenes (bucket 64x64, 4096 px: the base tier) and one
    56x88 scene (bucket 64x96, 6144 px: the spatial tier, one shard on the
    CPU): one ``sched_spatial_route``, no ``infer_degraded``, the metrics of
    the plain run."""
    ft.build_eth3d(str(tmp_path))
    _write_scene(osp.join(str(tmp_path), "datasets", "ETH3D"), "forest_1s", (56, 88), 5.0, 7)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "eth3d", "--hidden_dims", "32", "32", "32", "--n_gru_layers", "1",
            "--corr_levels", "2", "--corr_radius", "2", "--corr_implementation", "alt",
            "--valid_iters", "2", "--infer_batch", "2"]
    plain = evaluate.main(argv, device="cpu")
    got = evaluate.main(argv + ["--spatial_threshold", "5000", "--telemetry_dir", "tel"],
                        device="cpu")
    assert infer.last_summary().completed == 3
    events = [json.loads(x) for x in open("tel/events.jsonl")]
    routed = [e for e in events if e["event"] == "sched_spatial_route"]
    assert len(routed) == 1 and routed[0]["pixels"] == 6144
    assert [e for e in events if e["event"] == "infer_degraded"] == []
    assert sorted(got) == sorted(plain)
    for k, v in plain.items():
        if not k.endswith("fps"):
            assert abs(got[k] - v) <= ATOL + RTOL * abs(v), (k, got[k], v)


@pytest.mark.parametrize("flag", ["--tier", "--cascade", "--adaptive_iters"])
def test_evaluate_cli_refuses_a_second_router(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "eth3d", "--spatial_threshold", "5000", flag]
    if flag == "--tier":
        argv.append("quality")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        evaluate.main(argv, device="cpu")

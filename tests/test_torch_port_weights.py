"""Weights between the JAX package and the port.

``state_dict_from_jax`` must fill the port's ``state_dict`` exactly
(``strict=True``), and the JAX package's own torch importer
(``utils/torch_import.py``) run over the port's ``state_dict()`` must give
back exactly the JAX leaf paths: the port keeps the reference's torch names.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import PRESETS as JAX_PRESETS
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.utils.torch_import import _flatten, convert_state_dict, import_state_dict
from raft_stereo_tpu_torch.config import PRESETS
from raft_stereo_tpu_torch.evaluate import load_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

PRESET_NAMES = ["raftstereo-middlebury", "raftstereo-realtime", "iraftstereo-rvc"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Test workers share the machine's cores: keep torch's intra-op pool
    small so this file does not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_shapes(preset):
    """The JAX variable tree's shapes, without running the init."""
    model = JaxRAFTStereo(JAX_PRESETS[preset])
    img = jnp.zeros((1, 64, 128, 3), jnp.float32)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), img, img,
                                             iters=1, test_mode=True))


def _port_state(preset, seed=0):
    model = load_model(PRESETS[preset], device="cpu", seed=seed)
    with torch.no_grad():  # non-trivial norm statistics
        g = torch.Generator().manual_seed(seed + 1)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return model, {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_jax_importer_maps_port_keys_to_jax_leaves(preset):
    _, sd = _port_state(preset)
    params, stats = convert_state_dict(sd)
    shapes = _jax_shapes(preset)
    want_p = {p: s.shape for p, s in _flatten(shapes["params"]).items()}
    want_s = {p: s.shape for p, s in _flatten(shapes.get("batch_stats", {})).items()}
    # the reference registers each shortcut norm twice (norm3 and downsample.1)
    got_p = {p: v.shape for p, v in params.items() if "norm3" not in p}
    got_s = {p: v.shape for p, v in stats.items() if "norm3" not in p}
    assert got_p == want_p
    assert got_s == want_s
    for p, v in params.items():
        if "norm3" in p:
            twin = tuple("downsample_norm" if s == "norm3" else s for s in p)
            np.testing.assert_array_equal(v, params[twin])


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_state_dict_round_trips_through_jax(preset):
    model, sd = _port_state(preset, seed=3)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), _jax_shapes(preset))
    variables, skipped = import_state_dict(sd, zeros)
    assert all("norm3" in s for s in skipped)
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    fresh = RAFTStereo(PRESETS[preset])
    fresh.load_state_dict(back, strict=True)
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue  # the Flax tree keeps no counter
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_load_model_reads_a_reference_pth(tmp_path):
    """A DataParallel-prefixed reference checkpoint loads strictly; for a
    two-level model the reference's never-run modules are dropped."""
    cfg = dataclasses.replace(PRESETS["raftstereo-realtime"])
    src = load_model(cfg, device="cpu", seed=5)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    # the reference always builds these, and a 2-level model never runs them
    sd["module.update_block.gru32.convz.weight"] = torch.zeros(128, 256, 3, 3)
    sd["module.cnet.layer5.0.conv1.weight"] = torch.zeros(128, 128, 3, 3)
    sd["module.cnet.outputs32.0.weight"] = torch.zeros(128, 128, 3, 3)
    path = tmp_path / "raftstereo-realtime.pth"
    torch.save(sd, path)
    got = load_model(cfg, device="cpu", seed=6, restore_ckpt=str(path))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_model(PRESETS["raftstereo-middlebury"], device="cpu", restore_ckpt=str(path))


def test_seeded_init_is_reproducible_and_matches_jax_distribution():
    a = load_model(PRESETS["raftstereo-middlebury"], device="cpu", seed=7).state_dict()
    b = load_model(PRESETS["raftstereo-middlebury"], device="cpu", seed=7).state_dict()
    c = load_model(PRESETS["raftstereo-middlebury"], device="cpu", seed=8).state_dict()
    w = "update_block.gru08.convz.weight"
    torch.testing.assert_close(a[w], b[w], rtol=0, atol=0)
    assert not torch.equal(a[w], c[w])
    # kaiming-normal, fan_out with the relu gain, as the JAX package inits
    fan_out = a[w].shape[0] * a[w].shape[2] * a[w].shape[3]
    assert abs(float(a[w].std()) / np.sqrt(2.0 / fan_out) - 1.0) < 0.02
    assert float(a["update_block.gru08.convz.bias"].abs().max()) == 0.0

"""Carry the JAX package's weights, and the reference's released
checkpoints, into the port.

``state_dict_from_jax(variables)`` maps a Flax variables tree
(``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays)
to a ``state_dict`` with the reference's torch names, for
``RAFTStereo.load_state_dict(..., strict=True)``. It is the inverse of the
JAX package's torch importer: HWIO → OIHW, ``scale`` → ``weight``,
``mean``/``var`` → ``running_mean``/``running_var``, and the Flax module
paths → the torch module paths.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_SEGMENT_RULES = (
    (re.compile(r"^layer(\d)_(\d)$"), r"layer\1.\2"),
    (re.compile(r"^outputs(08|16)_(\d+)_res$"), r"outputs\1.\2.0"),
    (re.compile(r"^outputs(08|16)_(\d+)_conv$"), r"outputs\1.\2.1"),
    (re.compile(r"^outputs32_(\d+)_conv$"), r"outputs32.\1"),
    (re.compile(r"^downsample_conv$"), "downsample.0"),
    (re.compile(r"^downsample_norm$"), "downsample.1"),
    (re.compile(r"^mask_conv1$"), "mask.0"),
    (re.compile(r"^mask_conv2$"), "mask.2"),
    (re.compile(r"^context_zqr_convs_(\d+)$"), r"context_zqr_convs.\1"),
    (re.compile(r"^conv2_res$"), "conv2.0"),
    (re.compile(r"^conv2_conv$"), "conv2.1"),
)


def _torch_module_path(flax_path: Tuple[str, ...]) -> str:
    parts = list(flax_path)
    if parts[:2] == ["step", "update_block"]:
        parts = parts[1:]  # the JAX refinement loop's scope
    out = []
    for seg in parts:
        for pat, rep in _SEGMENT_RULES:
            if pat.match(seg):
                seg = pat.sub(rep, seg)
                break
        out.append(seg)
    return ".".join(out)


def _flatten(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


# Modules the reference always builds but a model with fewer than three GRU
# levels never runs; the port does not build them.
UNUSED_BELOW_3_LEVELS = ("cnet.layer5.", "cnet.outputs32.", "update_block.gru32.")


def load_reference_pth(model, path: str) -> None:
    """Load a released reference checkpoint (``.pth``) into ``model``:
    strict, once ``module.`` is stripped (and, below three GRU levels, the
    modules the port does not build are dropped)."""
    sd = torch.load(path, map_location="cpu")
    sd = sd.get("state_dict", sd)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if model.config.n_gru_layers < 3:
        sd = {k: v for k, v in sd.items() if not k.startswith(UNUSED_BELOW_3_LEVELS)}
    model.load_state_dict(sd, strict=True)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) → the port's ``state_dict``.

    The reference registers a residual block's shortcut norm twice (as
    ``norm3`` and as ``downsample.1``); both keys are emitted. BatchNorm's
    ``num_batches_tracked`` counter, which the Flax tree does not keep, is 0.
    """
    sd: Dict[str, torch.Tensor] = {}

    def put(module: str, leaf: str, arr: np.ndarray) -> None:
        t = torch.from_numpy(np.array(arr))
        sd[f"{module}.{leaf}" if module else leaf] = t
        if module == "downsample.1" or module.endswith(".downsample.1"):
            sd[f"{module[: -len('downsample.1')]}norm3.{leaf}"] = t

    for path, arr in _flatten(variables.get("params", {})).items():
        module, leaf = _torch_module_path(path[:-1]), path[-1]
        if leaf == "kernel" and arr.ndim == 4:
            put(module, "weight", arr.transpose(3, 2, 0, 1))  # HWIO → OIHW
        elif leaf == "scale":
            put(module, "weight", arr)
        elif leaf == "bias":
            put(module, "bias", arr)
        else:
            raise ValueError(f"unhandled Flax param {'/'.join(path)}")
    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        module, leaf = _torch_module_path(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise ValueError(f"unhandled Flax batch stat {'/'.join(path)}")
        put(module, f"running_{leaf}", arr)
        if leaf == "mean":
            put(module, "num_batches_tracked", np.zeros((), np.int64))
    return sd

"""Carry the JAX package's weights, and the reference's released
checkpoints, into the port.

``state_dict_from_jax(variables)`` maps a Flax variables tree
(``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays)
to a ``state_dict`` with the reference's torch names, for
``RAFTStereo.load_state_dict(..., strict=True)``. It is the inverse of the
JAX package's torch importer: HWIO → OIHW, ``scale`` → ``weight``,
``mean``/``var`` → ``running_mean``/``running_var``, and the Flax module
paths → the torch module paths. The MADNet2 family's rules
(``torch_import.py:55-72``) are inverted too: a block's convs are the
reference's ``block{i}.0.0`` / ``.2.0``, a ``decoder{k}``'s ``conv{j}`` its
Sequential's index ``decoder.{2(j-1)}.0``, ``conv_{k}`` is
``conv_{k}.0``; the attention's packed ``in_proj_*`` pass verbatim, a Dense
kernel [in, out] becomes a Linear weight [out, in], a LayerNorm ``scale``
its ``weight``.
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
    # the MADNet2 family
    (re.compile(r"^block(\d)_conv1$"), r"block\1.0.0"),
    (re.compile(r"^block(\d)_conv2$"), r"block\1.2.0"),
    (re.compile(r"^conv_(\d)$"), r"conv_\1.0"),
)
_SEQ_CONV = re.compile(r"^conv(\d+)$")
_DECODER = re.compile(r"^decoder\d$")


def _torch_module_path(flax_path: Tuple[str, ...]) -> str:
    parts = list(flax_path)
    if parts[:2] == ["step", "update_block"]:
        parts = parts[1:]  # the JAX refinement loop's scope
    out = []
    for i, seg in enumerate(parts):
        m = _SEQ_CONV.match(seg)
        if m and i and _DECODER.match(parts[i - 1]):
            seg = f"decoder.{2 * (int(m.group(1)) - 1)}.0"
        else:
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
    config = getattr(model, "config", None)  # RAFTStereo's; MADNet2 keeps every key
    if config is not None and config.n_gru_layers < 3:
        sd = {k: v for k, v in sd.items() if not k.startswith(UNUSED_BELOW_3_LEVELS)}
    model.load_state_dict(sd, strict=True)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) → the port's ``state_dict``.

    The reference registers a block's shortcut norm twice, as
    ``downsample.1`` and as ``norm3`` in a residual block, ``norm4`` in a
    bottleneck block (the one with a ``conv3``); both keys are emitted.
    BatchNorm's ``num_batches_tracked`` counter, which the Flax tree does
    not keep, is 0.
    """
    sd: Dict[str, torch.Tensor] = {}
    params = _flatten(variables.get("params", {}))
    bottlenecks = {_torch_module_path(path[:-2]) for path in params
                   if len(path) >= 2 and path[-2] == "conv3"}

    def put(module: str, leaf: str, arr: np.ndarray) -> None:
        t = torch.from_numpy(np.array(arr))
        sd[f"{module}.{leaf}" if module else leaf] = t
        if module == "downsample.1" or module.endswith(".downsample.1"):
            block = module[: -len("downsample.1")]
            norm = "norm4" if block.rstrip(".") in bottlenecks else "norm3"
            sd[f"{block}{norm}.{leaf}"] = t

    for path, arr in params.items():
        module, leaf = _torch_module_path(path[:-1]), path[-1]
        if leaf == "kernel" and arr.ndim == 4:
            put(module, "weight", arr.transpose(3, 2, 0, 1))  # HWIO → OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            put(module, "weight", arr.T)  # Dense [in, out] → Linear [out, in]
        elif leaf in ("in_proj_weight", "in_proj_bias"):
            put(module, leaf, arr)  # the attention's packed q|k|v, torch layout
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

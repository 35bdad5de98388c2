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

``train_state_tree_from_jax_npz`` reads a JAX train state that
``raft_stereo_tpu/utils/checkpoints.py::save_train_state_npz`` wrote (the
step, the parameters, the frozen batch-norm statistics and optax's AdamW
state, keyed by tree path) with numpy alone, and maps it onto the port's
train state: the parameters and statistics as above, Adam's ``mu`` and
``nu`` through the same map into ``torch.optim.AdamW``'s ``exp_avg`` and
``exp_avg_sq``, its ``count`` into each parameter's ``step``, and the
schedule's ``count`` into ``LambdaLR``'s position and the learning rate.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

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


_KEY_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _key_path(key: str) -> Tuple[Any, ...]:
    """A JAX ``keystr`` (``.opt_state[1][0].mu['cnet']['conv1']['bias']``)
    as a tuple of names and indices."""
    tokens = list(_KEY_TOKEN.finditer(key))
    if "".join(m.group(0) for m in tokens) != key:
        raise ValueError(f"unparsed JAX checkpoint key {key!r}")
    return tuple(int(m.group(2)) if m.group(2) else (m.group(1) or m.group(3))
                 for m in tokens)


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def train_state_tree_from_jax_npz(path: str, target) -> dict:
    """The tree ``TrainState.load_state_dict`` takes, for ``target`` (the
    port's ``TrainState``, whose optimizer and schedule supply everything
    the JAX state does not carry), from the JAX npz train state at
    ``path``. Raises on a key it cannot place."""
    with np.load(path) as data:
        arrays = {_key_path(k): np.asarray(data[k]) for k in data.files}
    step = None
    trees: Dict[str, Dict[Tuple[str, ...], np.ndarray]] = {
        "params": {}, "batch_stats": {}, "mu": {}, "nu": {}}
    counts: List[Tuple[Tuple[Any, ...], int]] = []
    adam = None  # the opt_state path of optax's ScaleByAdamState
    for p, arr in arrays.items():
        if p == ("step",):
            step = int(arr)
        elif p[0] in ("params", "batch_stats"):
            trees[p[0]][p[1:]] = arr
        elif p[0] == "opt_state" and p[-1] == "count":
            counts.append((p[:-1], int(arr)))
        elif p[0] == "opt_state" and ("mu" in p or "nu" in p):
            at = p.index("mu") if "mu" in p else p.index("nu")
            if adam not in (None, p[:at]):
                raise ValueError(f"{path}: two Adam states ({adam}, {p[:at]})")
            adam = p[:at]
            trees[p[at]][p[at + 1:]] = arr
        else:
            raise ValueError(f"{path}: no place in the port's train state for "
                             f"{'/'.join(map(str, p))}")
    adam_count = [c for prefix, c in counts if prefix == adam]
    schedule_count = [c for prefix, c in counts if prefix != adam]
    if step is None or len(adam_count) != 1 or len(schedule_count) != 1:
        raise ValueError(f"{path}: not an AdamW train state of the JAX package (step {step}, "
                         f"counts {counts})")
    model_sd = state_dict_from_jax({"params": _nest(trees["params"]),
                                    "batch_stats": _nest(trees["batch_stats"])})
    mu = state_dict_from_jax({"params": _nest(trees["mu"])})
    nu = state_dict_from_jax({"params": _nest(trees["nu"])})

    names = {id(p): n for n, p in target.model.named_parameters()}
    order = [p for group in target.optimizer.param_groups for p in group["params"]]
    optimizer = target.optimizer.state_dict()
    optimizer["state"] = {i: {"step": torch.tensor(float(adam_count[0])),
                              "exp_avg": mu[names[id(p)]], "exp_avg_sq": nu[names[id(p)]]}
                          for i, p in enumerate(order)}
    position = schedule_count[0]
    lrs = [base * fn(position) for base, fn in zip(target.scheduler.base_lrs,
                                                   target.scheduler.lr_lambdas)]
    for group, lr in zip(optimizer["param_groups"], lrs):
        group["lr"] = lr
    scheduler = dict(target.scheduler.state_dict(), last_epoch=position,
                     _step_count=position + 1, _last_lr=lrs)
    return {"step": step, "model": model_sd, "optimizer": optimizer, "scheduler": scheduler}

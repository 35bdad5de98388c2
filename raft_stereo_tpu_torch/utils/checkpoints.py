"""Checkpoint payloads: the port's own format (the counterpart of
``raft_stereo_tpu/utils/checkpoints.py``).

A payload is one ``torch.save`` file, ``<path>.pt``, holding the train
state's tree (``TrainState.state_dict()``: the step, the model, the
optimizer's moments and the schedule) and the data-stream position. It is
written to a ``.tmp`` sibling, fsynced and published with ``os.replace``,
so a crash mid-save leaves the previous payload or none, never a torn one;
``faultinject.crash_point("ckpt_commit")`` sits just before the rename.

A state is either an object with ``state_dict``/``load_state_dict`` (the
train state) or a plain tree of dicts, lists and tensors. The manifest
layer (``runtime/checkpoint.py``) records a CRC32 of every leaf of the
tree, keyed as :func:`keyed_leaves` flattens it.

``restore_train_state`` also reads the JAX package's npz train state
(``utils/weights.py::train_state_tree_from_jax_npz``), and
``restore_weights`` (the inference CLIs' checkpoints) its npz variables
(``utils/weights.py::state_dict_from_jax_npz``). A JAX orbax directory is
refused: reading it needs orbax, which imports JAX.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from raft_stereo_tpu_torch.runtime import faultinject

PAYLOAD_SUFFIX = ".pt"
PAYLOAD_FORMAT = 1


def payload_path(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(PAYLOAD_SUFFIX) else path + PAYLOAD_SUFFIX


def state_tree(state) -> Any:
    """The tree a state saves: ``state.state_dict()`` or the tree itself."""
    if not isinstance(state, dict) and hasattr(state, "state_dict"):
        return state.state_dict()
    return state


def to_host(tree):
    """``tree`` with every tensor on the CPU (a CPU tensor is not copied;
    ``parallel/mesh.py::fetch_to_host`` takes a snapshot)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu")
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def keyed_leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """Flatten ``tree`` to {path: leaf}, a path being ``['key'][0]...``;
    the leaves are tensors, numpy arrays and numbers (strings and None are
    not data)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(keyed_leaves(v, f"{prefix}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(keyed_leaves(v, f"{prefix}[{i}]"))
    elif isinstance(tree, (torch.Tensor, np.ndarray, bool, int, float)):
        out[prefix] = tree
    return out


def leaf_bytes(x) -> bytes:
    """The bytes of a leaf, as its CRC reads them."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def leaf_meta(x) -> dict:
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype)}
    a = np.asarray(x)
    return {"shape": list(a.shape), "dtype": str(a.dtype)}


def save_train_state(path: str, state, stream_pos: Optional[int] = None) -> None:
    """Atomically commit ``state`` (moved to the host) at ``<path>.pt``."""
    payload = {"format": PAYLOAD_FORMAT, "state": to_host(state_tree(state))}
    if stream_pos is not None:
        payload["stream_pos"] = int(stream_pos)
    dst = payload_path(path)
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    faultinject.crash_point("ckpt_commit")
    os.replace(tmp, dst)


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(payload_path(path))


def load_payload(path: str) -> dict:
    """The payload dict at ``<path>.pt`` (tensors on the CPU)."""
    src = payload_path(path)
    if not os.path.isfile(src):
        raise FileNotFoundError(f"no checkpoint at {path!r}: {src!r} does not exist "
                                "(was the save interrupted before its commit?)")
    return torch.load(src, map_location="cpu", weights_only=True)


def load_keyed_leaves(path: str) -> Dict[str, Any]:
    """A payload's leaves, target-free (manifest verification)."""
    return keyed_leaves(load_payload(path)["state"])


def apply_tree(target, tree):
    """Restore ``tree`` into ``target``: ``load_state_dict`` for a train
    state (in place; returns it), else the tree itself, once its leaves
    have the target's paths and shapes (raises otherwise)."""
    if not isinstance(target, dict) and hasattr(target, "load_state_dict"):
        target.load_state_dict(tree)
        return target
    want, got = keyed_leaves(target), keyed_leaves(tree)
    if set(want) != set(got):
        raise KeyError(f"checkpoint leaves {sorted(set(got) ^ set(want))[:5]} differ from "
                       "the target's")
    for k, v in want.items():
        if leaf_meta(v)["shape"] != leaf_meta(got[k])["shape"]:
            raise ValueError(f"checkpoint leaf {k} has shape {leaf_meta(got[k])['shape']}, "
                             f"the target {leaf_meta(v)['shape']}")
    return tree


def restore_train_state(path: str, target):
    """Restore the checkpoint at ``path`` into ``target``. A released
    reference ``.pth`` loads into the target's model alone, by
    ``utils.weights.load_reference_pth`` (strict, ``module.`` stripped); a
    JAX npz train state (``path`` ending in ``.npz``, or ``path.npz`` when
    there is no ``path.pt``) into the whole train state, exactly."""
    from raft_stereo_tpu_torch.utils import weights

    if path.endswith(".pth"):
        weights.load_reference_pth(target.model if hasattr(target, "model") else target, path)
        return target
    npz = _jax_npz(path)
    if npz is not None:
        target.load_state_dict(weights.train_state_tree_from_jax_npz(npz, target))
        return target
    return apply_tree(target, load_payload(path)["state"])


def _jax_npz(path: str) -> Optional[str]:
    """The JAX npz payload ``path`` names (``path`` ending in ``.npz``, or
    ``path.npz`` when there is no ``path.pt``), else None; an orbax
    directory raises."""
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory, a JAX orbax checkpoint: the port cannot "
                         "read it (orbax imports JAX). Save the JAX train state with "
                         "raft_stereo_tpu.utils.checkpoints.save_train_state_npz and restore "
                         "the .npz")
    npz = path if path.endswith(".npz") else path + ".npz"
    if path.endswith(".npz") or (not checkpoint_exists(path) and os.path.isfile(npz)):
        return npz
    return None


def restore_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a model's weights from ``path``, strictly, as the JAX package's
    inference CLIs restore theirs: a released reference ``.pth``
    (``utils.weights.load_reference_pth``), a JAX npz variables checkpoint
    (what ``save_train_state_npz(path, variables)`` writes; through
    ``utils.weights.state_dict_from_jax_npz``, which raises on a key it
    cannot place), or a port checkpoint (a train state's model, or a bare
    state dict). An orbax directory is refused."""
    from raft_stereo_tpu_torch.utils import weights

    if path.endswith(".pth"):
        weights.load_reference_pth(model, path)
        return model
    npz = _jax_npz(path)
    if npz is not None:
        model.load_state_dict(weights.for_model(model, weights.state_dict_from_jax_npz(npz)),
                              strict=True)
        return model
    tree = load_payload(path)["state"]
    model.load_state_dict(tree.get("model", tree), strict=True)
    return model

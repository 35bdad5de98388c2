"""Durable checkpointing: manifests, verification, rotation, auto-resume
(the port's own copy of ``raft_stereo_tpu/runtime/checkpoint.py:59-431``,
on the payloads of ``utils/checkpoints.py``).

  * ``commit_checkpoint`` publishes the payload first, then a sidecar JSON
    manifest (``<name>.manifest.json``), each atomically. The manifest is
    the commit record: a payload without one counts as torn and is
    invisible to auto-resume.
  * The manifest carries the step, the tag (periodic / final / emergency),
    the leaf count, a CRC32 with shape and dtype for every leaf, and the
    caller's extra keys (the data-stream position and geometry), so
    ``verify_checkpoint`` detects bit-rot and truncation without the model.
  * ``rotate_checkpoints`` keeps the newest K periodic checkpoints; final
    checkpoints stay, and an emergency checkpoint stays while it is the
    newest state; ``.tmp``/``.old`` debris is swept.
  * ``restore_latest_verified`` (``--resume auto``) restores the newest
    checkpoint whose leaves match its manifest, reading each candidate's
    payload once, and skips corrupt ones.

Layout for a run NAME under ``checkpoints/NAME/``::

    <step>_NAME.pt + <step>_NAME.manifest.json   periodic / emergency
    NAME.pt + NAME.manifest.json                 final
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

from raft_stereo_tpu_torch.runtime import faultinject
from raft_stereo_tpu_torch.utils.checkpoints import (
    apply_tree,
    checkpoint_exists,
    keyed_leaves,
    leaf_bytes,
    leaf_meta,
    load_keyed_leaves,
    load_payload,
    payload_path,
    restore_train_state,
    save_train_state,
    state_tree,
    to_host,
)

logger = logging.getLogger(__name__)

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_FORMAT = 1


@dataclass(frozen=True)
class CheckpointInfo:
    path: str  # payload base path (no .pt / manifest suffix)
    step: int
    tag: str


def _leaf_crc(x) -> int:
    return zlib.crc32(leaf_bytes(x))


def manifest_path(path: str) -> str:
    return os.path.abspath(path) + MANIFEST_SUFFIX


def _write_json_atomic(path: str, obj: dict, crash_name: Optional[str] = None) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    if crash_name is not None:
        faultinject.crash_point(crash_name)
    os.replace(tmp, path)


def commit_checkpoint(path: str, state, *, step: Optional[int] = None, tag: str = "periodic",
                      extra: Optional[Dict] = None) -> CheckpointInfo:
    """Save ``state`` at ``path`` and publish its manifest: the payload
    first, the manifest last, each commit atomic. ``extra`` adds caller
    metadata (``stream_pos`` also goes into the payload)."""
    path = os.path.abspath(path)
    t0 = time.perf_counter()
    tree = to_host(state_tree(state))
    extra = dict(extra or {})
    save_train_state(path, tree, stream_pos=extra.get("stream_pos"))
    leaves = {k: {"crc32": _leaf_crc(x), **leaf_meta(x)} for k, x in keyed_leaves(tree).items()}
    if step is None:
        step = int(tree.get("step", 0)) if isinstance(tree, dict) else 0
    manifest = {"format": MANIFEST_FORMAT, "step": int(step), "tag": tag,
                "leaf_count": len(leaves), "leaves": leaves, **extra}
    _write_json_atomic(manifest_path(path), manifest, crash_name="manifest_commit")
    logger.info("committed %s checkpoint at step %d: %s (%.1f ms)", tag, step, path,
                (time.perf_counter() - t0) * 1e3)
    return CheckpointInfo(path=path, step=int(step), tag=tag)


def read_manifest(path: str) -> Optional[dict]:
    try:
        with open(manifest_path(path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _leaves_match_manifest(loaded: Dict, manifest: dict, what: str) -> bool:
    """CRC-compare leaves against a manifest's recorded leaves."""
    want: Dict[str, dict] = manifest.get("leaves", {})
    if len(loaded) != manifest.get("leaf_count", -1) or set(want) != set(loaded):
        logger.warning("%s leaves (%d) do not match its manifest (%s)", what, len(loaded),
                       manifest.get("leaf_count"))
        return False
    ok = all(_leaf_crc(loaded[k]) == want[k]["crc32"] for k in want)
    if not ok:
        logger.warning("%s failed CRC verification", what)
    return ok


def verify_checkpoint(path: str, manifest: Optional[dict] = None) -> bool:
    """True iff the payload at ``path`` matches its manifest."""
    path = os.path.abspath(path)
    manifest = manifest if manifest is not None else read_manifest(path)
    if manifest is None:
        return False
    if not checkpoint_exists(path):
        logger.warning("checkpoint %s has a manifest but no payload", path)
        return False
    try:
        loaded = load_keyed_leaves(path)
    except Exception as e:  # noqa: BLE001 — any unreadable payload is invalid
        logger.warning("checkpoint %s unreadable: %s", path, e)
        return False
    return _leaves_match_manifest(loaded, manifest, f"checkpoint {path}")


def restore_latest_verified(ckpt_dir: str, target):
    """``--resume auto`` with one read of each candidate's payload: newest
    first, its leaves are CRC-checked against the manifest in memory and,
    if they match, restored into ``target``. Corrupt or torn candidates are
    skipped; a good payload that does not fit the target (a changed model
    or optimizer) raises. Returns ``(CheckpointInfo, state, manifest)`` or
    None."""
    for info in list_checkpoints(ckpt_dir):
        manifest = read_manifest(info.path)
        if manifest is None:
            continue
        try:
            tree = load_payload(info.path)["state"]
        except Exception as e:  # noqa: BLE001 — an unreadable payload is skipped
            logger.warning("skipping unreadable checkpoint %s (step %d): %s", info.path,
                           info.step, e)
            continue
        if _leaves_match_manifest(keyed_leaves(tree), manifest, f"checkpoint {info.path}"):
            return info, apply_tree(target, tree), manifest
        logger.warning("skipping invalid checkpoint %s (step %d)", info.path, info.step)
    return None


def list_checkpoints(ckpt_dir: str) -> List[CheckpointInfo]:
    """All manifested checkpoints under ``ckpt_dir``, newest step first."""
    out: List[CheckpointInfo] = []
    try:
        names = sorted(os.listdir(ckpt_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(MANIFEST_SUFFIX):
            continue
        base = os.path.join(ckpt_dir, name[: -len(MANIFEST_SUFFIX)])
        m = read_manifest(base)
        if m is None:
            continue
        out.append(CheckpointInfo(path=os.path.abspath(base), step=int(m.get("step", 0)),
                                  tag=str(m.get("tag", "periodic"))))
    out.sort(key=lambda c: c.step, reverse=True)
    return out


def find_latest_checkpoint(ckpt_dir: str) -> Optional[CheckpointInfo]:
    """Newest checkpoint in ``ckpt_dir`` that passes verification."""
    for info in list_checkpoints(ckpt_dir):
        if verify_checkpoint(info.path):
            return info
        logger.warning("skipping invalid checkpoint %s (step %d)", info.path, info.step)
    return None


def delete_checkpoint(path: str) -> None:
    for p in (payload_path(path), manifest_path(path)):
        try:
            os.remove(p)
        except OSError:
            pass


def _sweep_orphans(ckpt_dir: str) -> None:
    """Remove ``.tmp``/``.old`` crash debris; a payload without a manifest
    is left (resume cannot use it) with a log line."""
    manifested = {os.path.basename(payload_path(c.path)) for c in list_checkpoints(ckpt_dir)}
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return
    for name in names:
        p = os.path.join(ckpt_dir, name)
        if name.endswith((".tmp", ".old")):
            logger.info("sweeping crash debris %s", p)
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            else:
                try:
                    os.remove(p)
                except OSError:
                    pass
        elif name.endswith(".pt") and name not in manifested:
            logger.info("checkpoint payload %s has no manifest (a torn write); leaving it: "
                        "resume cannot use it", p)


def rotate_checkpoints(ckpt_dir: str, keep: int) -> List[CheckpointInfo]:
    """Delete all but the newest ``keep`` periodic checkpoints, emergency
    checkpoints superseded by a newer periodic or final commit, and crash
    debris. Returns what was rotated out."""
    keep = max(keep, 1)
    ckpts = list_checkpoints(ckpt_dir)
    removed = [c for c in ckpts if c.tag == "periodic"][keep:]
    newest_other = max((c.step for c in ckpts if c.tag != "emergency"), default=None)
    if newest_other is not None:
        removed += [c for c in ckpts if c.tag == "emergency" and c.step < newest_other]
    for info in removed:
        logger.info("rotating out %s checkpoint %s (step %d)", info.tag, info.path, info.step)
        delete_checkpoint(info.path)
    _sweep_orphans(ckpt_dir)
    return removed


def clone_checkpoint(src: str, dst: str, *, tag: Optional[str] = None) -> None:
    """Copy a committed checkpoint (payload, then manifest) to a new name;
    how the final checkpoint dedupes a periodic one of the same step."""
    manifest = read_manifest(src)
    if manifest is None:
        raise FileNotFoundError(f"no manifest for checkpoint {src!r}")
    tmp = payload_path(dst) + ".tmp"
    shutil.copyfile(payload_path(src), tmp)
    os.replace(tmp, payload_path(dst))
    if tag is not None:
        manifest = dict(manifest, tag=tag)
    _write_json_atomic(manifest_path(dst), manifest)


__all__ = [
    "CheckpointInfo",
    "checkpoint_exists",
    "clone_checkpoint",
    "commit_checkpoint",
    "delete_checkpoint",
    "find_latest_checkpoint",
    "list_checkpoints",
    "manifest_path",
    "read_manifest",
    "restore_latest_verified",
    "restore_train_state",
    "rotate_checkpoints",
    "verify_checkpoint",
]

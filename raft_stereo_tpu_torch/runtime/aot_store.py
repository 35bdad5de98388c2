"""Persistent graph store: the serving engine's capture plan on disk (the
port's counterpart of ``raft_stereo_tpu/runtime/aot_store.py``).

The JAX store persists ``jax.export`` executables. A CUDA graph cannot be
serialised, and the port's "compile" is a warm-up and a capture
(``runtime/infer.py``), so what this store persists is the **capture
plan**: one *recipe* per (bucket, batch) key the engine captured, which is
everything needed to rebuild that key's static inputs and capture it again
(bucket, batch, each input's shape and dtype, the tier and the engine's
process-stable identity fields). An engine built on a populated store
captures every stored key of its identity while it is being built, before
it admits a request (``InferenceEngine._prewarm``), so a warm restart
serves its first batch from a replay.

Everything else is the JAX store's, under the JAX module's names:

  * **Keying.** An entry's identity is a flat JSON dict built by the
    caller, canonicalised (sorted keys) and hashed into the filename.
    Environmental versions (store format, torch, CUDA) live in the manifest
    and are *checked* at load, so skew is an observable rejection.
  * **Commits**: payload first (tmp + ``os.replace``), then a sidecar CRC32
    manifest, manifest last. An entry without a manifest is a torn commit
    and invisible.
  * **Concurrent writers** (a fleet sharing one ``--aot_dir``): every temp
    file carries a writer-unique suffix and payloads are content-addressed
    (the filename embeds the blob's CRC32, the manifest names its payload),
    so writers race only at the final manifest ``os.replace``: the last
    writer wins, and its manifest points at a payload it fully wrote.
  * **Corruption never crashes, never poisons.** A truncated payload, a CRC
    mismatch, a version skew, a key mismatch or a payload that does not
    parse as a recipe (``deserialize``) is *rejected* (``aot_store_reject``
    with the reason) and the caller captures on first use. Corrupt entries
    are also discarded, sparing a concurrent recommit; a ``version_skew``
    or ``key_mismatch`` entry is left alone, since it may be right for
    another replica or key owner in a shared directory.

Telemetry: ``aot_store_hit`` / ``aot_store_miss`` / ``aot_store_reject`` /
``aot_store_commit``, each with the entry's bucket and batch. Counters
``hits``/``misses``/``rejects``/``stores``.

Single-consumer contract, as in JAX: a store instance is used from one
thread at a time, with no internal locking. At import this module loads
only the standard library and the port's ``telemetry``; torch is imported
where its versions and dtypes are read.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from raft_stereo_tpu_torch.runtime import telemetry

logger = logging.getLogger(__name__)

STORE_FORMAT = 1
PAYLOAD_SUFFIX = ".recipe"
MANIFEST_SUFFIX = ".manifest.json"

# The fields of a key that name one (bucket, batch) entry of an engine; the
# rest of the key is the engine's identity (``AOTStore.entries``).
ENTRY_FIELDS = ("bucket", "batch", "inputs")

# A superseded content-addressed payload is only garbage-collected after
# this grace period: a commit's payload lands seconds (not minutes) before
# its manifest, so a concurrent writer pruning a key cannot plausibly
# delete a sibling's payload mid-commit; a writer wedged past the grace
# between its two replaces costs an observable missing_payload reject.
GC_GRACE_S = 60.0


def canonical_key(key: Dict[str, Any]) -> str:
    """The key dict's canonical JSON form (sorted keys, no whitespace):
    what gets hashed into the filename and recorded in the manifest."""
    return json.dumps(key, sort_keys=True, separators=(",", ":"), default=str)


def export_recipe(key: Dict[str, Any]) -> bytes:
    """The capture recipe of one engine key as canonical JSON bytes (the
    counterpart of the JAX ``export_executable``): the key's own fields,
    which name its bucket, batch and inputs and the engine it belongs to."""
    return canonical_key(key).encode()


def _check_recipe(recipe: Any, key: Dict[str, Any]) -> Dict[str, Any]:
    """The parsed recipe if its schema holds and it is ``key``'s, else
    ``ValueError``: a positive batch, an [H, W] bucket of positive ints,
    and each input a [shape, dtype] pair whose dtype names a torch dtype."""
    import torch

    if not isinstance(recipe, dict):
        raise ValueError(f"a recipe is a JSON object, got {type(recipe).__name__}")
    bucket, batch, inputs = (recipe.get(k) for k in ENTRY_FIELDS)
    if not (isinstance(bucket, list) and len(bucket) == 2
            and all(isinstance(v, int) and v > 0 for v in bucket)):
        raise ValueError(f"recipe bucket {bucket!r}")
    if not (isinstance(batch, int) and batch > 0):
        raise ValueError(f"recipe batch {batch!r}")
    if not (isinstance(inputs, list) and inputs):
        raise ValueError(f"recipe inputs {inputs!r}")
    for item in inputs:
        if not (isinstance(item, list) and len(item) == 2 and isinstance(item[0], list)
                and all(isinstance(v, int) and v > 0 for v in item[0])
                and isinstance(item[1], str)
                and isinstance(getattr(torch, item[1], None), torch.dtype)):
            raise ValueError(f"recipe input {item!r} is not [shape, torch dtype]")
    if canonical_key(recipe) != canonical_key(key):
        raise ValueError("the recipe is not its key's")
    return recipe


class AOTStore:
    """One directory of capture recipes, CRC-manifested per entry."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.hits = 0      # entries loaded (and realised) from disk
        self.misses = 0    # entries simply not present
        self.rejects = 0   # corrupt/skewed entries refused
        self.stores = 0    # entries committed by this process

    def __len__(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.root) if n.endswith(MANIFEST_SUFFIX))
        except OSError:
            return 0

    # ----------------------------------------------------------- identity

    def _base(self, key: Dict[str, Any]) -> str:
        digest = hashlib.sha256(canonical_key(key).encode()).hexdigest()[:32]
        return os.path.join(self.root, digest)

    def _paths(self, key: Dict[str, Any], crc32: Optional[int] = None):
        """(payload path, manifest path) for ``key``. Payloads are
        content-addressed (the filename embeds the blob CRC32); ``crc32``
        None gives the un-suffixed name, used before a manifest is read."""
        base = self._base(key)
        payload = (base + PAYLOAD_SUFFIX if crc32 is None
                   else f"{base}-{crc32 & 0xFFFFFFFF:08x}{PAYLOAD_SUFFIX}")
        return payload, base + MANIFEST_SUFFIX

    @staticmethod
    def _versions() -> Dict[str, Any]:
        import torch

        return {"format": STORE_FORMAT, "torch": torch.__version__,
                "cuda": torch.version.cuda}

    # --------------------------------------------------------- discovery

    def entries(self, identity: Dict[str, Any]) -> List[Dict[str, Any]]:
        """The keys of every committed entry whose fields other than
        bucket, batch and inputs equal ``identity``, newest ``created``
        first. Never raises: an unreadable manifest is skipped here (``load``
        rejects it)."""
        want = json.loads(canonical_key(identity))
        found = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for n in names:
            if not n.endswith(MANIFEST_SUFFIX):
                continue
            try:
                with open(os.path.join(self.root, n)) as f:
                    manifest = json.load(f)
                key = json.loads(manifest["key"])
                created = float(manifest.get("created") or 0.0)
            except (OSError, ValueError, KeyError, TypeError):
                continue
            if not isinstance(key, dict):
                continue
            if {k: v for k, v in key.items() if k not in ENTRY_FIELDS} == want:
                found.append((created, n, key))
        found.sort(key=lambda t: (-t[0], t[1]))
        return [key for _, _, key in found]

    # --------------------------------------------------------------- load

    def note_miss(self, key: Dict[str, Any]) -> None:
        """Count and emit a miss: ``key`` was not served from the store."""
        self.misses += 1
        telemetry.emit("aot_store_miss", path=self._paths(key)[0], bucket=key.get("bucket"),
                       batch=key.get("batch"))

    def load(self, key: Dict[str, Any],
             realize: Optional[Callable[[Dict[str, Any]], Any]] = None
             ) -> Optional[Dict[str, Any]]:
        """The validated recipe of ``key``, or None on a miss or a reject.

        ``realize(recipe)`` (the engine's capture) runs on a validated
        recipe before the hit is counted and emitted, so the hit's
        ``load_ms`` is read, validation and capture together. What it raises
        propagates to the caller and counts nothing: the entry is sound, and
        stays on disk.

        Never raises otherwise: every failure mode is counted, emitted and,
        for corruption, the entry discarded."""
        payload_path, manifest_path = self._paths(key)
        t0 = time.perf_counter()
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            self.note_miss(key)
            return None
        except (OSError, ValueError) as e:
            return self._reject(key, "unreadable_manifest", e)
        if not isinstance(manifest, dict):
            return self._reject(key, "unreadable_manifest",
                                detail=f"manifest is a {type(manifest).__name__}")
        want_versions = self._versions()
        got_versions = {k: manifest.get(k) for k in want_versions}
        if got_versions != want_versions:
            # skew is environmental, not corruption: the entry may be right
            # for the replicas that wrote it, so it stays
            return self._reject(key, "version_skew",
                                detail=f"entry {got_versions} vs runtime {want_versions}",
                                discard=False)
        if manifest.get("key") != canonical_key(key):
            # a hash-prefix collision's entry belongs to the OTHER key
            return self._reject(key, "key_mismatch", discard=False)
        if manifest.get("payload"):
            payload_path = os.path.join(self.root, os.path.basename(manifest["payload"]))
        try:
            with open(payload_path, "rb") as f:
                blob = f.read()
        except OSError as e:
            return self._reject(key, "missing_payload", e, path=payload_path, manifest=manifest)
        if len(blob) != manifest.get("bytes"):
            return self._reject(key, "truncated",
                                detail=f"{len(blob)} bytes vs manifest {manifest.get('bytes')}",
                                path=payload_path, manifest=manifest)
        if zlib.crc32(blob) != manifest.get("crc32"):
            return self._reject(key, "crc_mismatch", path=payload_path, manifest=manifest)
        try:
            recipe = _check_recipe(json.loads(blob.decode()), key)
        except (ValueError, UnicodeDecodeError) as e:
            return self._reject(key, "deserialize", e, path=payload_path, manifest=manifest)
        if realize is not None:
            realize(recipe)
        self.hits += 1
        load_ms = round((time.perf_counter() - t0) * 1e3, 1)
        logger.info("graph store: loaded the recipe of bucket %s batch %s from %s (%.1f ms)",
                    key.get("bucket"), key.get("batch"), payload_path, load_ms)
        telemetry.emit("aot_store_hit", path=payload_path, bytes=len(blob), load_ms=load_ms,
                       bucket=key.get("bucket"), batch=key.get("batch"))
        return recipe

    def _reject(self, key: Dict[str, Any], reason: str,
                error: Optional[BaseException] = None,
                detail: Optional[str] = None,
                discard: bool = True,
                path: Optional[str] = None,
                manifest: Optional[Dict[str, Any]] = None) -> None:
        payload_path = path if path is not None else self._paths(key)[0]
        err = detail
        if error is not None:
            err = f"{type(error).__name__}: {str(error)[:200]}"
        self.rejects += 1
        logger.warning("graph store: rejecting entry %s (%s%s): %s, and capturing on first "
                       "use", payload_path, reason, f": {err}" if err else "",
                       "discarding it" if discard else "leaving it in place")
        telemetry.emit("aot_store_reject", path=payload_path, reason=reason, error=err,
                       bucket=key.get("bucket"), batch=key.get("batch"))
        if discard:
            self._discard(key, rejected_manifest=manifest)
        return None

    def _discard(self, key: Dict[str, Any],
                 rejected_manifest: Optional[Dict[str, Any]] = None) -> None:
        """Drop a corrupt entry's files, manifest first (a crash mid-discard
        leaves an invisible payload, not a manifest pointing at nothing).
        Payload variants younger than ``GC_GRACE_S`` stay: one may be a
        concurrent writer's commit whose manifest is about to land. With
        ``rejected_manifest`` (the manifest the reader rejected) the
        manifest goes only if it is still that one: a writer may have
        recommitted the key between the read and this discard."""
        base = self._base(key)
        _, manifest_path = self._paths(key)
        if rejected_manifest is not None:
            try:
                with open(manifest_path) as f:
                    current = json.load(f)
            except OSError:
                current = None  # already gone: nothing to protect
            except ValueError:
                current = rejected_manifest  # unreadable = corrupt: remove
            if current is not None and current != rejected_manifest:
                logger.info("graph store: entry %s was recommitted concurrently; leaving "
                            "the new manifest in place", manifest_path)
                return
        try:
            os.remove(manifest_path)
        except OSError:
            pass
        prefix = os.path.basename(base)
        cutoff = time.time() - GC_GRACE_S
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for n in names:
            if not n.startswith(prefix) or not n.endswith(PAYLOAD_SUFFIX):
                continue
            p = os.path.join(self.root, n)
            try:
                if os.path.getmtime(p) < cutoff:
                    os.remove(p)
            except OSError:
                pass

    # -------------------------------------------------------------- store

    def store(self, key: Dict[str, Any], blob: bytes, *,
              export_ms: Optional[float] = None) -> Optional[str]:
        """Commit one recipe: payload first, manifest last, each atomic (tmp
        + ``os.replace``) under writer-unique temp names. Best-effort: a
        full disk degrades persistence, never serving. Returns the payload
        path, or None when the commit failed."""
        crc = zlib.crc32(blob)
        payload_path, manifest_path = self._paths(key, crc)
        manifest = {
            **self._versions(),
            "key": canonical_key(key),
            "payload": os.path.basename(payload_path),
            "bytes": len(blob),
            "crc32": crc,
            "created": time.time(),
        }
        unique = f".tmp.{os.getpid()}.{time.monotonic_ns()}"
        try:
            tmp = payload_path + unique
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, payload_path)
            mtmp = manifest_path + unique
            with open(mtmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, manifest_path)
        except OSError as e:
            logger.warning("graph store: commit of %s failed (%s: %s); the key will capture "
                           "on first use after a restart", payload_path, type(e).__name__, e)
            return None
        self.stores += 1
        self._gc_superseded(key, keep=os.path.basename(payload_path))
        telemetry.emit("aot_store_commit", path=payload_path, bytes=len(blob),
                       export_ms=export_ms, bucket=key.get("bucket"), batch=key.get("batch"))
        return payload_path

    def _gc_superseded(self, key: Dict[str, Any], keep: str) -> None:
        """Best-effort prune of the key's stale content-addressed payload
        variants after a commit: only those older than ``GC_GRACE_S``, never
        the payload just committed."""
        base_name = os.path.basename(self._base(key))
        prefix = base_name + "-"
        legacy = base_name + PAYLOAD_SUFFIX
        cutoff = time.time() - GC_GRACE_S
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for n in names:
            if n == keep or not n.endswith(PAYLOAD_SUFFIX):
                continue
            if not n.startswith(prefix) and n != legacy:
                continue
            p = os.path.join(self.root, n)
            try:
                if os.path.getmtime(p) < cutoff:
                    os.remove(p)
                    logger.info("graph store: pruned superseded payload %s", p)
            except OSError:
                pass


__all__ = [
    "AOTStore",
    "ENTRY_FIELDS",
    "GC_GRACE_S",
    "MANIFEST_SUFFIX",
    "PAYLOAD_SUFFIX",
    "STORE_FORMAT",
    "canonical_key",
    "export_recipe",
]

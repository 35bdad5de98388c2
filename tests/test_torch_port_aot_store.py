"""The persistent graph store (``runtime/aot_store.py``) and the engine's
store-through and prewarm (``runtime/infer.py``), on the CPU: a counterpart
of each of the 26 cases of ``tests/test_aot_store.py`` under its name, and
the port's own.

The contract under test: a warm restart on a populated ``aot_dir`` prewarms
every stored key while the engine is built, so serving performs ZERO
compiles (no ``bucket_compile`` event, ``stats.compiles == 0``, one
``aot_store_hit`` a key) and its outputs are bitwise the cold engine's; a
truncated, CRC-mismatched, version-skewed or unparsable entry is rejected
(``aot_store_reject`` with its reason) and its key compiles on first use,
never crashing and never poisoning the store (the recompile re-commits a
clean entry). What a port entry holds is a capture recipe (JSON), not an
executable; on the CPU a key's "compile" is its first eager use, and a
prewarm marks it compiled.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_stereo_tpu.runtime import aot_store as jax_aot_store
from raft_stereo_tpu_torch.runtime import faultinject, telemetry
from raft_stereo_tpu_torch.runtime.aot_store import (
    GC_GRACE_S,
    MANIFEST_SUFFIX,
    PAYLOAD_SUFFIX,
    AOTStore,
    canonical_key,
    export_recipe,
)
from raft_stereo_tpu_torch.runtime.infer import InferenceEngine, InferOptions, InferRequest

REPO = pathlib.Path(__file__).resolve().parent.parent
WAIT_S = 30.0  # every engine's deadline


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fi_reset():
    faultinject.reset()
    yield
    faultinject.reset()


class _Toy(torch.nn.Module):
    """A stand-in model: its weight ``scale`` and, for a second parameter
    structure, ``bias``."""

    def __init__(self, scale=2.0, bias=None):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(float(scale)), requires_grad=False)
        if bias is not None:
            self.bias = torch.nn.Parameter(torch.tensor(float(bias)), requires_grad=False)


def _forward(m):
    """One forward code for every ``_Toy``: out = sum_c(a * scale - b
    [+ bias])."""

    def fwd(a, b):
        out = a * m.scale - b
        if hasattr(m, "bias"):
            out = out + m.bias
        return out.sum(-1, keepdim=True)

    return fwd


def _engine(aot, model=None, fwd=None, batch=4, **kw):
    model = _Toy() if model is None else model
    kw.setdefault("deadline_s", WAIT_S)
    return InferenceEngine(fwd or _forward(model), device="cpu", batch=batch, divis_by=32,
                           module=model, aot_dir=aot, **kw)


def _requests(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [InferRequest(payload=i, inputs=(rng.rand(h, w, 3).astype(np.float32),
                                            rng.rand(h, w, 3).astype(np.float32)))
            for i, (h, w) in enumerate(shapes)]


def _serve(engine, shapes, seed=0):
    return {r.payload: r.output for r in engine.stream(iter(_requests(shapes, seed)))}


MIXED = [(24, 48), (40, 72), (24, 48), (32, 64), (24, 48),
         (40, 72), (24, 48), (24, 48), (40, 72)]  # 2 buckets, 1 partial each


def _entry_files(root, suffix):
    return sorted(os.path.join(root, n) for n in os.listdir(root) if n.endswith(suffix))


def _events(run_dir):
    p = pathlib.Path(run_dir) / "events.jsonl"
    if not p.exists():
        return []
    return [json.loads(x) for x in p.read_text().splitlines() if x.strip()]


@pytest.fixture()
def tel(tmp_path):
    t = telemetry.install(telemetry.Telemetry(str(tmp_path / "tel")))
    yield t
    telemetry.uninstall(t)


# ---------------------------------------------------------------- standalone


def _key(**extra):
    """An engine-shaped key: bucket, batch, inputs and identity fields."""
    return {"bucket": [8, 8], "batch": 2, "inputs": [[[2, 8, 8, 3], "float32"]] * 2,
            "kind": "infer_forward", **extra}


class TestAOTStoreStandalone:
    def test_roundtrip_hit(self, tmp_path):
        store = AOTStore(str(tmp_path))
        key = _key(k="v")
        assert store.store(key, export_recipe(key)) is not None
        assert len(store) == 1 and store.stores == 1
        recipe = store.load(key)
        assert recipe == key and store.hits == 1 and store.rejects == 0
        # the realize hook runs on the validated recipe before the hit counts
        seen = []
        assert store.load(key, realize=seen.append) == key and seen == [key]
        assert store.hits == 2

    def test_miss_on_absent_entry(self, tmp_path):
        store = AOTStore(str(tmp_path))
        assert store.load(_key()) is None
        assert store.misses == 1 and store.rejects == 0

    def test_key_difference_is_a_miss_not_a_hit(self, tmp_path):
        store = AOTStore(str(tmp_path))
        store.store(_key(), export_recipe(_key()))
        assert store.load(dict(_key(), batch=4)) is None
        assert store.misses == 1

    def test_truncated_payload_rejected_and_discarded(self, tmp_path, tel):
        store = AOTStore(str(tmp_path))
        key = _key()
        blob = export_recipe(key)
        store.store(key, blob)
        (payload,) = _entry_files(str(tmp_path), PAYLOAD_SUFFIX)
        with open(payload, "wb") as f:
            f.write(blob[: len(blob) // 2])
        assert store.load(key) is None
        assert store.rejects == 1
        # the bad entry is discarded: the next load is a clean miss and a
        # fresh store() recommits
        assert not _entry_files(str(tmp_path), MANIFEST_SUFFIX)
        assert store.load(key) is None and store.misses == 1
        store.store(key, blob)
        assert store.load(key) is not None

    def test_crc_mismatch_rejected(self, tmp_path):
        store = AOTStore(str(tmp_path))
        key = _key()
        blob = export_recipe(key)
        store.store(key, blob)
        (payload,) = _entry_files(str(tmp_path), PAYLOAD_SUFFIX)
        flipped = bytearray(blob)
        flipped[len(flipped) // 2] ^= 0x01  # same length, one flipped bit
        with open(payload, "wb") as f:
            f.write(bytes(flipped))
        assert store.load(key) is None and store.rejects == 1

    def test_version_skew_rejected(self, tmp_path):
        store = AOTStore(str(tmp_path))
        key = _key()
        store.store(key, export_recipe(key))
        (mpath,) = _entry_files(str(tmp_path), MANIFEST_SUFFIX)
        manifest = json.load(open(mpath))
        manifest["torch"] = "0.0.0"
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        assert store.load(key) is None and store.rejects == 1
        # skew is not corruption: the entry stays for the replicas it suits
        assert _entry_files(str(tmp_path), MANIFEST_SUFFIX) == [mpath]

    def test_stale_reject_spares_concurrent_recommit(self, tmp_path):
        # a reader holding a STALE manifest whose payload a concurrent
        # recommit GC'd rejects with missing_payload: the discard must not
        # remove the writer's freshly committed VALID manifest
        store = AOTStore(str(tmp_path))
        key = _key()
        store.store(key, export_recipe(key))
        (mpath,) = _entry_files(str(tmp_path), MANIFEST_SUFFIX)
        stale = json.load(open(mpath))
        blob2 = json.dumps(key, sort_keys=True, indent=1).encode()  # same recipe, other bytes
        assert blob2 != export_recipe(key)
        store.store(key, blob2)  # the concurrent writer's recommit
        old_payload = os.path.join(str(tmp_path), os.path.basename(stale["payload"]))
        os.remove(old_payload)  # superseded payload GC'd past the grace
        store._reject(key, "missing_payload", path=old_payload, manifest=stale)
        # the new manifest survived and its entry still loads
        assert _entry_files(str(tmp_path), MANIFEST_SUFFIX) == [mpath]
        assert store.load(key) == key

    def test_undeserializable_blob_rejected(self, tmp_path, tel):
        store = AOTStore(str(tmp_path))
        key = _key()
        store.store(key, b"not a capture recipe")  # CRC will PASS
        assert store.load(key) is None and store.rejects == 1
        assert not _entry_files(str(tmp_path), MANIFEST_SUFFIX)  # corrupt: discarded
        reasons = [e["reason"] for e in _events(tel.run_dir) if e["event"] == "aot_store_reject"]
        assert reasons == ["deserialize"]

    def test_manifest_is_the_commit_record(self, tmp_path):
        """A payload without a manifest (torn commit) is invisible."""
        store = AOTStore(str(tmp_path))
        key = _key()
        store.store(key, export_recipe(key))
        (mpath,) = _entry_files(str(tmp_path), MANIFEST_SUFFIX)
        os.remove(mpath)
        assert store.load(key) is None and store.misses == 1
        assert store.rejects == 0
        assert store.entries({"kind": "infer_forward"}) == []

    def test_reject_reasons_emitted(self, tmp_path, tel):
        store = AOTStore(str(tmp_path))
        for tag, corrupt in (
            ("truncated", lambda p, m, blob: open(p, "wb").write(blob[:10])),
            ("version_skew", lambda p, m, blob: json.dump(
                dict(json.load(open(m)), cuda="0.0"), open(m, "w"))),
        ):
            key = _key(case=tag)
            blob = export_recipe(key)
            store.store(key, blob)
            _, manifest = store._paths(key)
            # payloads are content-addressed: the manifest names the file
            # the commit actually wrote
            payload = os.path.join(str(tmp_path), json.load(open(manifest))["payload"])
            corrupt(payload, manifest, blob)
            assert store.load(key) is None
        rejects = [e for e in _events(tel.run_dir) if e["event"] == "aot_store_reject"]
        assert {e["reason"] for e in rejects} == {"truncated", "version_skew"}
        assert all(e["bucket"] == [8, 8] and e["batch"] == 2 for e in rejects)

    def test_canonical_key_order_independent(self):
        assert canonical_key({"a": 1, "b": [2, 3]}) == canonical_key({"b": [2, 3], "a": 1})


@pytest.mark.parametrize("key", [
    {"a": 1, "b": [2, 3]},
    {"bucket": [32, 64], "batch": 4, "inputs": [[[4, 32, 64, 3], "float32"]] * 2,
     "model": "RAFTStereoConfig(hidden_dims=(32, 32, 32))", "iters": 7, "video": False,
     "capture": True, "tier": "quality", "scale": 0.5, "none": None},
    {"nested": {"z": 1, "a": {"y": [1.5, "x"]}}, "unicode": "ü", "tuple": (1, 2)},
    {"non_json": np.float32(2.0), "path": pathlib.Path("a/b")},
], ids=["plain", "engine_key", "nested", "non_json"])
def test_canonical_key_matches_jax(key):
    """Byte for byte the JAX function's output on the same dict."""
    assert canonical_key(key) == jax_aot_store.canonical_key(key)


def test_recipe_with_a_foreign_dtype_is_rejected(tmp_path, tel):
    """A recipe that parses but names no torch dtype is a ``deserialize``
    reject, discarded."""
    store = AOTStore(str(tmp_path))
    key = dict(_key(), inputs=[[[2, 8, 8, 3], "float128x"]])
    store.store(key, export_recipe(key))
    assert store.load(key) is None and store.rejects == 1 and len(store) == 0
    assert [e["reason"] for e in _events(tel.run_dir)
            if e["event"] == "aot_store_reject"] == ["deserialize"]


# ------------------------------------------------------------- engine wiring


class TestEngineWarmRestart:
    def test_warm_restart_zero_compiles_bit_identical(self, tmp_path, tel):
        aot = str(tmp_path / "aot")
        cold = _engine(aot)
        want = _serve(cold, MIXED)
        assert cold.stats.compiles == 2 and cold.stats.prewarmed == 0
        assert cold.aot_store.stores == 2 and cold.aot_store.misses == 2
        assert len(cold.aot_store) == 2
        n_cold = len(_events(tel.run_dir))

        warm = _engine(aot)
        # captured while it was built, before any request
        assert warm.stats.prewarmed == 2 and warm.aot_store.hits == 2
        got = _serve(warm, MIXED)
        # THE acceptance criterion: zero compiles on the warm restart:
        # stats, store counters and events all agree
        assert warm.stats.compiles == 0 and warm.stats.compile_s == 0.0
        assert warm.aot_store.hits == 2 and warm.aot_store.rejects == 0
        assert warm.aot_store.misses == 0 and warm.aot_store.stores == 0
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        events = _events(tel.run_dir)
        assert [e["event"] for e in events].count("bucket_compile") == 2  # the COLD engine's
        warm_events = [e["event"] for e in events[n_cold:]]
        assert "bucket_compile" not in warm_events
        hits = [e for e in events if e["event"] == "aot_store_hit"]
        assert len(hits) == 2
        assert {tuple(e["bucket"]) for e in hits} == {(32, 64), (64, 96)}
        assert all(e["batch"] == 4 and e["load_ms"] >= 0 for e in hits)

    def test_corrupt_entry_recompiles_and_repairs(self, tmp_path, tel):
        aot = str(tmp_path / "aot")
        want = _serve(_engine(aot), MIXED)
        (payload, _other) = _entry_files(aot, PAYLOAD_SUFFIX)
        blob = open(payload, "rb").read()
        with open(payload, "wb") as f:
            f.write(blob[: len(blob) // 2])

        hurt = _engine(aot)
        got = _serve(hurt, MIXED)
        # one bucket prewarms, the corrupt one is rejected, compiled on
        # first use and recommitted: results stay exact
        assert hurt.stats.compiles == 1 and hurt.stats.prewarmed == 1
        assert hurt.aot_store.hits == 1 and hurt.aot_store.rejects == 1
        assert hurt.aot_store.stores == 1
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

        healed = _engine(aot)
        _serve(healed, MIXED)
        assert healed.stats.compiles == 0 and healed.aot_store.hits == 2

    def test_distinct_variable_structures_do_not_collide(self, tmp_path):
        """Two engines over different parameter structures (the same forward
        code) share one aot_dir without ever hitting each other's entries."""
        aot = str(tmp_path / "aot")
        e1 = _engine(aot, model=_Toy(2.0), batch=2)
        _serve(e1, [(24, 48), (24, 48)])
        e2 = _engine(aot, model=_Toy(2.0, bias=1.0), batch=2)
        assert e2.store_identity()["forward"] == e1.store_identity()["forward"]
        assert e2.store_identity()["variables"] != e1.store_identity()["variables"]
        _serve(e2, [(24, 48), (24, 48)])
        # same bucket/batch/shapes, yet e2 must MISS (another structure)
        assert e2.aot_store.hits == 0 and e2.stats.compiles == 1
        assert len(e2.aot_store) == 2

    def test_forward_code_change_invalidates_entries(self, tmp_path):
        """Editing the forward (same weights, same shapes, no torch upgrade)
        must MISS the store, not serve the old math."""
        aot = str(tmp_path / "aot")

        def v1(a, b):
            return (a * 2.0 - b).sum(-1, keepdim=True) * 2.0

        def v2(a, b):
            return (a * 2.0 - b).sum(-1, keepdim=True) * 3.0

        _serve(_engine(aot, fwd=v1, batch=2), [(24, 48), (24, 48)])
        e2 = _engine(aot, fwd=v2, batch=2)
        out = _serve(e2, [(24, 48), (24, 48)])
        assert e2.aot_store.hits == 0 and e2.stats.compiles == 1
        reqs = _requests([(24, 48), (24, 48)])
        want = v2(torch.from_numpy(reqs[0].inputs[0][None]),
                  torch.from_numpy(reqs[0].inputs[1][None]))[0].numpy()
        np.testing.assert_array_equal(out[0], want)

    def test_aot_key_extra_separates_models(self, tmp_path):
        aot = str(tmp_path / "aot")
        _serve(_engine(aot, batch=2, aot_key_extra={"model": "m1"}), [(24, 48), (24, 48)])
        e2 = _engine(aot, batch=2, aot_key_extra={"model": "m2"})
        _serve(e2, [(24, 48), (24, 48)])
        assert e2.aot_store.hits == 0 and e2.stats.compiles == 1

    def test_no_store_without_aot_dir(self):
        eng = _engine(None, batch=2)
        assert eng.aot_store is None
        _serve(eng, [(24, 48)])
        assert eng.stats.compiles == 1  # plain compile path untouched
        assert eng.snapshot()["aot_store"] is None


def test_prewarm_capped_at_max_executables(tmp_path):
    """Three stored keys, an engine of two executables: the two newest are
    prewarmed, the third compiles on first use."""
    aot = str(tmp_path / "aot")
    shapes = [(24, 48), (40, 72), (72, 100)]  # buckets 32x64, 64x96, 96x128
    cold = _engine(aot, batch=1)
    for s in shapes:  # one stream a key: commit order = creation order
        _serve(cold, [s])
    assert len(cold.aot_store) == 3
    warm = _engine(aot, batch=1, max_executables=2)
    assert warm.stats.prewarmed == 2 and warm.aot_store.hits == 2
    assert sorted(k[0] for k in warm._compiled) == [(64, 96), (96, 128)]
    _serve(warm, shapes)
    assert warm.stats.compiles == 1 and warm.aot_store.stores == 1


def test_prewarm_compile_failure_compiles_on_first_use(tmp_path, tel, monkeypatch):
    """A prewarm that raises (``RAFT_FI_INFER_COMPILE_FAIL``: the first
    compile point, which is the prewarm's) leaves the entry on disk and
    the key uncompiled; the key then compiles on first use, as without a
    store, and the outputs are the cold run's."""
    aot = str(tmp_path / "aot")
    want = _serve(_engine(aot, batch=2), [(24, 48), (24, 48)])
    monkeypatch.setenv("RAFT_FI_INFER_COMPILE_FAIL", "1")
    faultinject.reset()
    warm = _engine(aot, batch=2)
    assert warm.stats.prewarmed == 0 and warm.aot_store.hits == 0
    assert warm.aot_store.rejects == 0 and len(warm.aot_store) == 1  # the entry stays
    assert not warm._compiled
    got = _serve(warm, [(24, 48), (24, 48)])
    assert warm.stats.compiles == 1 and warm.stats.retries == 0
    assert warm.aot_store.stores == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    events = [e["event"] for e in _events(tel.run_dir)]
    assert events.count("aot_store_hit") == 0 and events.count("bucket_compile") == 2


def test_snapshot_reports_prewarm_and_store(tmp_path):
    aot = str(tmp_path / "aot")
    _serve(_engine(aot, batch=2), [(24, 48)])
    snap = _engine(aot, batch=2).snapshot()
    assert snap["stats"]["prewarmed"] == 1 and snap["stats"]["compiles"] == 0
    assert snap["aot_store"] == {"root": aot, "hits": 1, "misses": 0, "rejects": 0,
                                 "stores": 0}


# ------------------------------------------------ the real model's store key

SMALL = dict(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2, corr_radius=2,
             corr_implementation="alt")
ITERS = 2

_IDENTITY_SCRIPT = """
import sys
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.runtime.aot_store import canonical_key
from raft_stereo_tpu_torch.runtime.infer import InferOptions

cfg = RAFTStereoConfig(hidden_dims=(32, 32, 32), n_gru_layers=1, corr_levels=2,
                       corr_radius=2, corr_implementation="alt")
model = evaluate.load_model(cfg, device="cpu")
engine = evaluate.make_engine(model, 2, InferOptions(batch=4, aot_dir=sys.argv[1]))
print(canonical_key(engine.store_identity()))
"""


def test_store_identity_is_equal_across_processes(tmp_path):
    """``evaluate.make_engine``'s store identity built in a fresh process
    equals this process's, and holds no address (its graph key holds
    ``id(model)``, which would miss on every restart)."""
    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.config import RAFTStereoConfig

    aot = str(tmp_path / "aot")
    script = tmp_path / "identity.py"
    script.write_text(_IDENTITY_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                          if p))
    out = subprocess.run([sys.executable, str(script), aot], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    theirs = out.stdout.strip().splitlines()[-1]
    model = evaluate.load_model(RAFTStereoConfig(**SMALL), device="cpu")
    engine = evaluate.make_engine(model, ITERS, InferOptions(batch=4, aot_dir=aot))
    ours = canonical_key(engine.store_identity())
    assert ours == theirs
    assert "0x" not in ours and str(id(model)) not in ours
    assert id(model) in engine.graph_key  # the in-memory key keeps the model's address
    identity = json.loads(ours)
    assert identity["iters"] == ITERS and identity["model"] == repr(model.config)


def test_warm_restart_matches_the_jax_engine(tmp_path, tel):
    """The same carried weights and mixed-shape requests: the warm-restarted
    port engine (prewarmed, zero compiles) bitwise the cold one and within
    the engine tolerance (tests/test_torch_port_engine.py: atol 5e-3, rtol
    1e-4) of the JAX engine."""
    import jax
    import jax.numpy as jnp

    from raft_stereo_tpu import evaluate as jax_evaluate
    from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
    from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
    from raft_stereo_tpu.runtime import infer as jax_infer
    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

    jmodel = JaxRAFTStereo(JaxConfig(**SMALL))
    img = jnp.asarray(np.random.RandomState(0).rand(1, 32, 64, 3) * 255, jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(0))
    reqs = _requests(MIXED)
    for r in reqs:
        r.inputs = tuple(x * 255.0 for x in r.inputs)
    jengine = jax_evaluate.make_engine(jmodel, variables, ITERS,
                                       jax_infer.InferOptions(batch=4))
    want = {r.payload: np.asarray(r.output) for r in jengine.stream(iter(
        [jax_infer.InferRequest(payload=r.payload, inputs=r.inputs) for r in reqs]))}

    aot = str(tmp_path / "aot")
    outs = []
    for _ in range(2):
        model = evaluate.load_model(RAFTStereoConfig(**SMALL), device="cpu")
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        engine = evaluate.make_engine(model, ITERS, InferOptions(batch=4, aot_dir=aot,
                                                                 deadline_s=WAIT_S))
        outs.append((engine, {r.payload: r.output for r in engine.stream(iter(reqs))}))
    (cold, cold_out), (warm, warm_out) = outs
    assert cold.stats.compiles == 2 and warm.stats.compiles == 0
    assert warm.stats.prewarmed == 2 and warm.aot_store.hits == 2
    assert sorted(warm_out) == sorted(want) == list(range(len(MIXED)))
    for k, v in warm_out.items():
        np.testing.assert_array_equal(v, cold_out[k])
        np.testing.assert_allclose(v, want[k], atol=5e-3, rtol=1e-4)


# ------------------------------------------------------- concurrent writers

_WRITER_SCRIPT = """
import json, os, sys
from raft_stereo_tpu_torch.runtime.aot_store import AOTStore
assert "torch" not in sys.modules, "the store module loads torch at import"

root, writer = sys.argv[1], int(sys.argv[2])
store = AOTStore(root)
keys = [{"bucket": [8 * (k + 1), 8 * (k + 1)], "batch": 2} for k in range(3)]
committed = 0
for round_ in range(8):
    for k, key in enumerate(keys):
        # every (writer, round) commits DIFFERENT bytes for the same keys:
        # the adversarial case (real fleets commit identical recipes)
        blob = bytes([writer]) * 1024 + os.urandom(64) + bytes([round_]) * 65536
        if store.store(key, blob) is not None:
            committed += 1
print(json.dumps({"writer": writer, "committed": committed}))
"""


def _writers(script, args_list):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                          if p))
    procs = [subprocess.Popen([sys.executable, str(script), *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for args in args_list]
    outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    return outs


class TestConcurrentWriters:
    """N processes hammering one ``aot_dir`` never leave a torn or poisoned
    entry (every surviving manifest describes an intact payload it fully
    wrote), and the last writer's commit is loadable."""

    def _check_integrity(self, root: str) -> int:
        """Every manifest on disk describes an intact payload: the file it
        names exists, its size and CRC32 match, and the key round-trips.
        Returns the number of manifests checked."""
        import zlib

        manifests = _entry_files(root, MANIFEST_SUFFIX)
        for mpath in manifests:
            m = json.load(open(mpath))
            payload = os.path.join(root, m["payload"])
            assert os.path.exists(payload), (mpath, m["payload"])
            blob = open(payload, "rb").read()
            assert len(blob) == m["bytes"], (mpath, len(blob), m["bytes"])
            assert zlib.crc32(blob) == m["crc32"], mpath
            assert json.loads(m["key"]), mpath
        return len(manifests)

    def test_multiprocess_hammer_no_torn_entries(self, tmp_path):
        root = str(tmp_path / "shared_aot")
        os.makedirs(root)
        script = tmp_path / "writer.py"
        script.write_text(_WRITER_SCRIPT)
        _writers(script, [(root, str(w)) for w in range(4)])
        # 4 writers x 8 rounds x 3 keys raced; exactly 3 entries survive,
        # each internally consistent
        assert self._check_integrity(root) == 3
        # and no temp droppings (every writer's tmp was uniquely named and
        # consumed by its os.replace)
        leftovers = [n for n in os.listdir(root) if ".tmp." in n]
        assert not leftovers, leftovers

    def test_last_writer_wins_is_loadable(self, tmp_path):
        """Concurrent commits of a REAL engine recipe to one key: whoever
        wins, the surviving entry loads and an engine prewarms from it."""
        root = str(tmp_path / "shared_aot")
        os.makedirs(root)
        probe = _engine(None, batch=2)
        arrays = (np.zeros((2, 32, 64, 3), np.float32),) * 2
        key = probe._store_key((32, 64), arrays)
        blob_path = tmp_path / "recipe.json"
        blob_path.write_bytes(export_recipe(key))
        script = tmp_path / "writer_real.py"
        script.write_text(
            "import json, sys\n"
            "from raft_stereo_tpu_torch.runtime.aot_store import AOTStore\n"
            "store = AOTStore(sys.argv[1])\n"
            "blob = open(sys.argv[2], 'rb').read()\n"
            "for _ in range(4):\n"
            "    assert store.store(json.loads(blob), blob)\n"
        )
        _writers(script, [(root, str(blob_path))] * 3)
        assert self._check_integrity(root) == 1
        store = AOTStore(root)
        assert store.load(key) == key and store.rejects == 0
        warm = _engine(root, batch=2)
        assert warm.stats.prewarmed == 1
        _serve(warm, [(24, 48)])
        assert warm.stats.compiles == 0

    def test_superseded_payloads_garbage_collected(self, tmp_path):
        """Re-storing different bytes for one key must not orphan the old
        content-addressed payload: variants older than the grace window are
        pruned on the next successful commit."""
        import time as _time

        store = AOTStore(str(tmp_path))
        key = _key()
        store.store(key, b"version-one-bytes" * 100)
        (old_payload,) = _entry_files(str(tmp_path), PAYLOAD_SUFFIX)
        aged = _time.time() - GC_GRACE_S - 5
        os.utime(old_payload, (aged, aged))
        store.store(key, b"version-two-bytes" * 100)
        payloads = _entry_files(str(tmp_path), PAYLOAD_SUFFIX)
        assert len(payloads) == 1 and payloads[0] != old_payload
        self._check_integrity(str(tmp_path))

    def test_fresh_sibling_payloads_survive_gc(self, tmp_path):
        """Within the grace window a sibling variant is NOT pruned (its
        manifest may land any moment)."""
        store = AOTStore(str(tmp_path))
        key = _key()
        store.store(key, b"a" * 512)
        store.store(key, b"b" * 512)
        assert len(_entry_files(str(tmp_path), PAYLOAD_SUFFIX)) == 2
        self._check_integrity(str(tmp_path))


# ------------------------------------------------------- tier-aware store


class TestTierAwareStore:
    """N tiers sharing one ``aot_dir``: the tier name is in every store key,
    so two tiers' entries are disjoint even when the tiers are otherwise
    identical; a warm restart of a two-tier set performs zero compiles; a
    corrupt entry of one tier never poisons the other."""

    def _tier_set(self, aot_dir):
        from raft_stereo_tpu_torch.runtime.tiers import ModelTier, TierSet

        # the two tiers differ ONLY in name: the strongest collision test
        return TierSet(
            [ModelTier(name=name, model=_Toy(2.0), make_forward=_forward,
                       aot_extra={"model": "toy"}) for name in ("fast", "quality")],
            InferOptions(batch=2, aot_dir=aot_dir, deadline_s=WAIT_S))

    def _serve_both(self, ts, seed=0):
        return {name: _serve_stream(ts.stream_fn(name), seed) for name in ts.names}

    def _manifest_tiers(self, aot_dir):
        tiers = {}
        for path in _entry_files(aot_dir, MANIFEST_SUFFIX):
            key = json.loads(json.load(open(path))["key"])
            tiers.setdefault(key.get("tier"), []).append(path)
        return tiers

    def test_two_tiers_share_dir_disjoint_entries(self, tmp_path):
        aot = str(tmp_path / "aot")
        ts = self._tier_set(aot)
        self._serve_both(ts)
        for name in ts.names:
            eng = ts.engine(name)
            assert eng.stats.compiles == 1, name  # its own entry: a miss
            assert eng.aot_store.stores == 1, name
            assert eng.aot_store.hits == 0, name  # never the other's
        by_tier = self._manifest_tiers(aot)
        assert sorted(by_tier) == ["fast", "quality"]
        assert all(len(v) == 1 for v in by_tier.values()), by_tier

    def test_two_tier_warm_restart_zero_compiles(self, tmp_path):
        aot = str(tmp_path / "aot")
        want = self._serve_both(self._tier_set(aot))
        warm = self._tier_set(aot)
        got = self._serve_both(warm)
        for name in warm.names:
            eng = warm.engine(name)
            assert eng.stats.compiles == 0 and eng.stats.prewarmed == 1, name
            assert eng.aot_store.hits == 1 and eng.aot_store.rejects == 0
            for k in want[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k])
        assert warm.combined_stats().prewarmed == 2

    def test_corrupt_tier_entry_never_poisons_the_other(self, tmp_path):
        aot = str(tmp_path / "aot")
        want = self._serve_both(self._tier_set(aot))
        (fast_manifest,) = self._manifest_tiers(aot)["fast"]
        payload = os.path.join(aot, json.load(open(fast_manifest))["payload"])
        blob = open(payload, "rb").read()
        with open(payload, "wb") as f:
            f.write(blob[: len(blob) // 2])

        hurt = self._tier_set(aot)
        got = self._serve_both(hurt)
        # the fast tier rejects, compiles on first use and recommits; the
        # quality tier prewarms untouched; every output stays exact
        assert hurt.engine("fast").stats.compiles == 1
        assert hurt.engine("fast").aot_store.rejects == 1
        assert hurt.engine("fast").aot_store.stores == 1
        assert hurt.engine("quality").stats.compiles == 0
        assert hurt.engine("quality").aot_store.hits == 1
        assert hurt.engine("quality").aot_store.rejects == 0
        for name in want:
            for k in want[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k])

        healed = self._tier_set(aot)
        self._serve_both(healed)
        assert all(healed.engine(n).stats.compiles == 0 for n in healed.names)


def _serve_stream(stream_fn, seed=0):
    return {r.payload: r.output
            for r in stream_fn(iter(_requests([(24, 48), (24, 48)], seed=seed)))}


class TestIterTierStore:
    """Iteration tiers of ONE model sharing one ``aot_dir``: the tier name
    (``iters7``/``iters32``) AND the iteration count ride every store key,
    so two tiers serving the very same model, weights and shapes keep
    disjoint entries, and a warm restart of the whole set performs zero
    compiles. The real model's assembly is
    tests/test_torch_port_adaptive.py's."""

    def _tier_set(self, aot_dir):
        from raft_stereo_tpu_torch.runtime.tiers import ModelTier, TierSet, iter_tier_name

        model = _Toy(2.0)
        # identical model/weights/forward: ONLY the tier identity (name and
        # iters) differs
        tiers = [ModelTier(name=iter_tier_name(it), model=model, make_forward=_forward,
                           aot_extra={"model": "toy-raft", "iters": it})
                 for it in (7, 32)]
        return TierSet(tiers, InferOptions(batch=2, aot_dir=aot_dir, deadline_s=WAIT_S))

    def _serve_both(self, ts):
        return {name: _serve_stream(ts.stream_fn(name)) for name in ts.names}

    def test_iter_tiers_share_dir_disjoint_entries(self, tmp_path):
        aot = str(tmp_path / "aot")
        ts = self._tier_set(aot)
        self._serve_both(ts)
        for name in ts.names:
            eng = ts.engine(name)
            assert eng.stats.compiles == 1, name  # its own entry only
            assert eng.aot_store.stores == 1, name
            assert eng.aot_store.hits == 0, name  # never the other's
        keys = []
        for path in _entry_files(aot, MANIFEST_SUFFIX):
            key = json.loads(json.load(open(path))["key"])
            keys.append((key.get("tier"), key.get("iters")))
        assert sorted(keys) == [("iters32", 32), ("iters7", 7)], keys

    def test_iter_tier_warm_restart_zero_compiles(self, tmp_path):
        aot = str(tmp_path / "aot")
        want = self._serve_both(self._tier_set(aot))
        warm = self._tier_set(aot)
        got = self._serve_both(warm)
        for name in warm.names:
            eng = warm.engine(name)
            assert eng.stats.compiles == 0, name
            assert eng.aot_store.hits == 1 and eng.aot_store.rejects == 0
            for k in want[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k])

"""The port's static checks: graftcheck's GC02-GC10 over ``raft_stereo_tpu_torch``.

``tools/graftcheck`` gates the JAX package (``tests/test_graftcheck.py``,
``tests/test_graftcheck_concurrency.py``). Its scan roots and its tuned
``default_config()`` name JAX paths only, so the port's threads, locks,
signal handlers, telemetry events and fault injectors were never read.
This file builds the port's ``GraftcheckConfig`` from the JAX one with
``dataclasses.replace`` and holds the port to the same gate:

  * **Mapping.** Every path entry of the JAX config (GC01 extras, GC02
    roots, edges and allows, main roots, role seeds, thread edges) maps to
    the port by its package prefix. ``RENAMED`` and ``RENAMED_EDGES`` carry
    the entries whose port function has another file or name,
    ``RENAMED_ATTRS`` the attribute-type hints, and ``NO_COUNTERPART`` the
    entries with none, each with its reason. ``unresolved`` fails on any
    other entry whose port function does not exist, so a rename never drops
    a rule silently.
  * **What only the port has** (``PORT_ONLY_*``): the engine's device-wait
    worker, the loader's workers, the fleet CLI's restarter and the chaos
    trial drivers (``RENAMED_EDGES`` holds the graph store's realize hook). The process-wide
    ``runtime/infer.py::CAPTURE_LOCK`` needs no entry: a module-level
    ``threading.Lock()`` is a lock of the model by construction, reached
    through ``InferenceEngine.graphs`` (a ``GraphCache``).
  * **Rules.** GC02-GC05 and GC07-GC10 run on a copy of the port whose
    tests dir holds only ``tests/test_torch_*.py``, so GC04 counts port
    tests alone as arming a port injector; GC05's consumers are the port's
    ``tools/chaos.py`` and the root ``tools/run_report.py`` and
    ``tools/postmortem.py``, which read the port's run directories as they
    are. GC06 runs on the repo itself over the port, ``chip_smoke.py`` and
    the JAX gate's roots, so a flag the docs name counts as defined wherever
    a parser defines it, while only the port's CLIs are operator modules.
    GC01 (recompile) is left out: nothing in the port is jit-traced, and its
    extras name the Pallas wrapper and kernel only.
  * **Tolerated findings** (``TOLERATED``): the eleven GC06 warnings that
    ``graftcheck_baseline.json`` accepts for the JAX package, at the port's
    copies of the same flags, with the same justifications.

Planted faults on copies of the port turn each rule red, the port-only one
being a blocking call under ``CAPTURE_LOCK``. Torch's own sync spellings
(``.cpu()``, ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize()``,
``Event.synchronize()``) are not in GC02's list; teaching them is an edit
to ``tools/graftcheck`` (ROADMAP). No rule is registered from here:
``tests/test_graftcheck_concurrency.py`` counts exactly ten in the
registry, and xdist runs several files in one worker.

Pure stdlib ``ast`` over source text; the drain test imports both packages'
``runtime/preemption.py``, which load neither torch nor JAX.
"""

import ast
import dataclasses
import json
import shutil
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.graftcheck import Baseline, default_config, run_analysis  # noqa: E402
from tools.graftcheck.config import GraftcheckConfig  # noqa: E402
from tools.graftcheck.core import format_text, load_context  # noqa: E402
from tools.graftcheck.threads import CallGraph, ThreadModel  # noqa: E402

Fn = Tuple[str, str]
Edge = Tuple[Fn, Fn]

JAX = "raft_stereo_tpu/"
PORT = "raft_stereo_tpu_torch/"
_J_FUSED = JAX + "ops/pallas_fused_update.py"
_P_FUSED = PORT + "ops/fused_update.py"
_J_INFER = JAX + "runtime/infer.py"
_P_INFER = PORT + "runtime/infer.py"
_CHAOS = PORT + "tools/chaos.py"

COPY_RULES = ("GC02", "GC03", "GC04", "GC05", "GC07", "GC08", "GC09", "GC10")
REPO_RULES = ("GC06",)
PORT_CLIS = ("train.py", "train_mad.py", "evaluate.py", "serve_adaptive.py",
             "serve_fleet.py", "runtime/loop.py", "runtime/infer.py")
CAPTURE_LOCK = _P_INFER + "::CAPTURE_LOCK"

# ------------------------------------------------------------------ mapping

# JAX function -> its port counterpart, where the file or the name differs
RENAMED: Dict[Fn, Fn] = {
    # K2's launch wrapper and its plain twins live in ops/fused_update.py
    (_J_FUSED, "_fused_call"): (_P_FUSED, "_launch"),
    (_J_FUSED, "fused_refine_step"): (_P_FUSED, "fused_refine_step"),
    (_J_FUSED, "reference_refine_step"): (_P_FUSED, "reference_refine_step"),
    (_J_FUSED, "pack_fused_params"): (_P_FUSED, "pack_fused_params"),
}
# JAX edge -> the port's edge, where the caller has no port counterpart
RENAMED_EDGES: Dict[Edge, Edge] = {
    # AOTCache's load hook is a stored callable; the port's prewarm hands
    # the capture to the graph store as its realize hook, run inside load
    ((_J_INFER, "AOTCache.get"), (_J_INFER, "InferenceEngine._aot_load")):
        ((PORT + "runtime/aot_store.py", "AOTStore.load"),
         (_P_INFER, "InferenceEngine._build")),
    # the store-through: a key just compiled on the serving path is stored
    ((_J_INFER, "AOTCache.get"), (_J_INFER, "InferenceEngine._aot_save")):
        ((_P_INFER, "InferenceEngine._executable"),
         (_P_INFER, "InferenceEngine._aot_save")),
}
# JAX attribute-type hint -> the port's (class, attribute) and its type
RENAMED_ATTRS: Dict[Tuple[str, str], Tuple[Tuple[str, str], str]] = {
    # AOTCache is TPU-only (ROADMAP A); the engine's executables are
    # captured graphs in a GraphCache
    ("InferenceEngine", "cache"): (("InferenceEngine", "graphs"), "GraphCache"),
}
# JAX entry -> why the port has no counterpart
NO_COUNTERPART: Dict[Fn, str] = {
    (_J_FUSED, "_fused_kernel"): (
        "the Pallas kernel's body; the port's K2 is CUDA "
        "(csrc/fused_update.cu), with no Python function, and GC01 does not "
        "run on the port"),
}

# ------------------------------------------------------- what only the port has

PORT_ONLY_ATTR_TYPES: Dict[Tuple[str, str], str] = {
    # deadline-bounded device waits run on the engine's _WaitWorker
    ("InferenceEngine", "_wait_worker"): "_WaitWorker",
}
PORT_ONLY_MAIN_ROOTS = frozenset({
    # the chaos campaign's CLI and its trial child; run_child picks a
    # trial driver through a dict, so each driver is a root of its own
    (_CHAOS, "main"),
    (_CHAOS, "run_child"),
    (_CHAOS, "_serve_sched"),
    (_CHAOS, "_serve_video"),
    (_CHAOS, "_serve_fleet"),
    (_CHAOS, "_serve_cascade"),
    (_CHAOS, "_serve_ctrl"),
    (_CHAOS, "_serve_quality"),
    (_CHAOS, "_serve_adaptive"),
})
PORT_ONLY_SEEDS: Dict[Fn, str] = {
    # serve_fleet's fleet-restarter thread targets router.rolling_restart,
    # a bound method of a local the resolver cannot type
    (PORT + "runtime/fleet.py", "FleetRouter.rolling_restart"): "controller",
    # the loader's workers are a nested def (folded into the iterator that
    # starts them); the method they call per failed sample runs on them
    (PORT + "data/datasets.py", "PrefetchLoader._quarantine_and_resample"):
        "loader",
}
PORT_ONLY_EDGES: Tuple[Edge, ...] = (
    # the engine's wait closure (nested in _wait_device, so folded into it)
    # runs on the infer-device-wait thread: _WaitWorker.run hands it over a
    # queue. Its calls are the edges; _wait_device's own body stays on the
    # dispatching thread
    ((_P_INFER, "_WaitWorker._loop"), (PORT + "runtime/telemetry.py", "span")),
    ((_P_INFER, "_WaitWorker._loop"), (PORT + "runtime/faultinject.py", "infer_wait_point")),
)
# Thread(...) sites whose target the resolver cannot follow -> the functions
# seeded for them (in the JAX config or above)
HAND_SEEDED_THREADS: Dict[Tuple[str, str], Tuple[Fn, ...]] = {
    (PORT + "runtime/debug_server.py", "self._srv.serve_forever"): (
        (PORT + "runtime/debug_server.py", "_Handler.do_GET"),
        (PORT + "runtime/debug_server.py", "DebugServer.render"),
    ),
    (PORT + "serve_fleet.py", "router.rolling_restart"): (
        (PORT + "runtime/fleet.py", "FleetRouter.rolling_restart"),
    ),
    (PORT + "data/datasets.py", "worker"): (
        (PORT + "data/datasets.py", "PrefetchLoader._quarantine_and_resample"),
    ),
}

# ------------------------------------------------------ tolerated findings


def _tolerated() -> Baseline:
    """The JAX baseline's GC06 entries at the port's copies of the flags."""
    jax = Baseline.load(REPO / "graftcheck_baseline.json")
    entries = []
    for e in jax.entries:
        assert e["rule"] == "GC06" and e["path"].startswith(JAX), e
        entries.append(dict(e, path=PORT + e["path"][len(JAX):]))
    return Baseline(entries=entries)


TOLERATED = _tolerated()


def map_fn(fn: Fn) -> Optional[Fn]:
    """The port's counterpart of a JAX config function (None: none)."""
    if fn in NO_COUNTERPART:
        return None
    if fn in RENAMED:
        return RENAMED[fn]
    rel, qual = fn
    assert rel.startswith(JAX), fn
    return (PORT + rel[len(JAX):], qual)


def map_edges(edges) -> Tuple[Edge, ...]:
    out = []
    for a, b in edges:
        if (a, b) in RENAMED_EDGES:
            out.append(RENAMED_EDGES[(a, b)])
            continue
        pa, pb = map_fn(a), map_fn(b)
        if pa is not None and pb is not None:
            out.append((pa, pb))
    return tuple(out)


def map_fns(fns) -> frozenset:
    return frozenset(p for p in map(map_fn, fns) if p is not None)


def port_config() -> GraftcheckConfig:
    """The JAX gate's tuned config, mapped onto the port (see module doc)."""
    base = default_config()
    attr_types = {}
    for key, typ in base.attr_types.items():
        if key in RENAMED_ATTRS:
            key, typ = RENAMED_ATTRS[key]
        attr_types[key] = typ
    attr_types.update(PORT_ONLY_ATTR_TYPES)
    seeds = {map_fn(fn): role for fn, role in base.thread_role_seeds.items()
             if map_fn(fn) is not None}
    seeds.update(PORT_ONLY_SEEDS)
    return dataclasses.replace(
        base,
        scan_roots=(PORT.rstrip("/"), "tools/run_report.py", "tools/postmortem.py"),
        # the port's experiments/ holds K3's wrapper and the packed encoder,
        # which sit on a production path: nothing is excluded but caches
        exclude_parts=("__pycache__",),
        gc01_traced_extra=map_fns(base.gc01_traced_extra),
        gc02_roots=map_fns(base.gc02_roots),
        gc02_extra_edges=map_edges(base.gc02_extra_edges),
        gc02_allow=map_fns(base.gc02_allow),
        attr_types=attr_types,
        thread_main_roots=map_fns(base.thread_main_roots) | PORT_ONLY_MAIN_ROOTS,
        thread_role_seeds=seeds,
        threads_extra_edges=map_edges(base.threads_extra_edges) + PORT_ONLY_EDGES,
        gc09_allow=map_fns(base.gc09_allow),
        gc10_allow=map_fns(base.gc10_allow),
        gc04_registry_path=PORT + base.gc04_registry_path[len(JAX):],
        gc05_schema_path=PORT + base.gc05_schema_path[len(JAX):],
        gc05_consumers=(_CHAOS, "tools/run_report.py", "tools/postmortem.py"),
        gc06_operator_modules=tuple(PORT + m for m in PORT_CLIS),
    )


def gc06_config() -> GraftcheckConfig:
    """GC06 over the repo: the port and chip_smoke.py beside the JAX gate's
    roots define flags; only the port's CLIs are operator modules."""
    base = default_config()
    return dataclasses.replace(
        base, scan_roots=base.scan_roots + (PORT.rstrip("/"), "chip_smoke.py"),
        gc06_operator_modules=tuple(PORT + m for m in PORT_CLIS))


def _assigned_attrs(tree: ast.Module, cls: str) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store) \
                        and isinstance(sub.value, ast.Name) and sub.value.id == "self":
                    out.add(sub.attr)
    return out


def unresolved(root: Path, cfg: GraftcheckConfig) -> List[str]:
    """Every entry of ``cfg`` that names no function, class, attribute or
    file of the tree at ``root`` (the mapping's failures)."""
    ctx = load_context(root, cfg)
    graph = CallGraph(ctx)
    bad: List[str] = []

    def fn_ok(fn: Fn, what: str) -> None:
        rel, qual = fn
        ok = rel in ctx.files if qual == "*" else graph.node(fn) is not None
        if not ok:
            bad.append(f"{what}: {rel}::{qual}")

    for what, fns in (("gc01_traced_extra", cfg.gc01_traced_extra),
                      ("gc02_roots", cfg.gc02_roots), ("gc02_allow", cfg.gc02_allow),
                      ("thread_main_roots", cfg.thread_main_roots),
                      ("thread_role_seeds", cfg.thread_role_seeds),
                      ("gc09_allow", cfg.gc09_allow), ("gc10_allow", cfg.gc10_allow)):
        for fn in sorted(fns):
            fn_ok(fn, what)
    for what, edges in (("gc02_extra_edges", cfg.gc02_extra_edges),
                        ("threads_extra_edges", cfg.threads_extra_edges)):
        for a, b in edges:
            fn_ok(a, what)
            fn_ok(b, what)
    for (cls, attr), typ in sorted(cfg.attr_types.items()):
        for name in (cls, typ):
            if name not in graph._classes:
                bad.append(f"attr_types: no class {name}")
        if cls in graph._classes and attr not in _assigned_attrs(
                ctx.files[graph._classes[cls]].tree, cls):
            bad.append(f"attr_types: {cls} never sets self.{attr}")
    for cls, (lock, attrs) in sorted(cfg.gc03_guarded.items()):
        if cls not in graph._classes:
            bad.append(f"gc03_guarded: no class {cls}")
            continue
        have = _assigned_attrs(ctx.files[graph._classes[cls]].tree, cls)
        for a in sorted({lock} | set(attrs)):
            if a not in have:
                bad.append(f"gc03_guarded: {cls} never sets self.{a}")
    for what, rels in (("gc04_registry_path", (cfg.gc04_registry_path,)),
                       ("gc05_schema_path", (cfg.gc05_schema_path,)),
                       ("gc05_consumers", cfg.gc05_consumers),
                       ("gc06_operator_modules", cfg.gc06_operator_modules)):
        for rel in rels:
            if rel not in ctx.files:
                bad.append(f"{what}: no file {rel}")
    return bad


# ----------------------------------------------------------------- fixtures


def copy_port(dst: Path) -> Path:
    """The copy GC02-GC05 and GC07-GC10 run on (see module doc)."""
    shutil.copytree(REPO / PORT, dst / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"))
    (dst / "tests").mkdir()
    for f in sorted(REPO.glob("tests/test_torch_*.py")):
        shutil.copy(f, dst / "tests" / f.name)
    (dst / "tools").mkdir()
    for f in ("tools/run_report.py", "tools/postmortem.py", "README.md", "ROADMAP.md"):
        shutil.copy(REPO / f, dst / f)
    return dst


def gate(tree: Path, rules=COPY_RULES):
    # every tolerated finding is GC06's, which runs on the repo: the copy's
    # rules tolerate nothing
    return run_analysis(tree, config=port_config(), rule_ids=rules)


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    return copy_port(tmp_path_factory.mktemp("port_gate"))


@pytest.fixture(scope="module")
def clean(port_tree):
    """The clean analyses: the copy's rules, GC06 on the repo, and the
    thread model of the copy (for the role and lock checks)."""
    cfg = port_config()
    copy_res = gate(port_tree)
    repo_res = run_analysis(REPO, config=gc06_config(), baseline=TOLERATED,
                            rule_ids=REPO_RULES)
    model = ThreadModel(load_context(port_tree, cfg))
    return copy_res, repo_res, model


def planted(port_tree: Path, tmp_path: Path, rel: str, edits) -> Path:
    """A copy of the port with ``edits`` ((anchor, replacement), each anchor
    found exactly once) applied to ``rel``."""
    tree = tmp_path / "tree"
    shutil.copytree(port_tree, tree)
    p = tree / rel
    text = p.read_text()
    for anchor, new in edits:
        assert text.count(anchor) == 1, (rel, anchor)
        text = text.replace(anchor, new)
    p.write_text(text)
    return tree


# ---------------------------------------------------------------- the gate


def test_port_gate_clean_within_budget(clean):
    """GC02-GC10 over the port: nothing unbaselined, every tolerated entry
    still fires, each analysis well inside the budget, and the concurrency
    model as large as the JAX gate's."""
    copy_res, repo_res, _ = clean
    assert sorted(copy_res.rules_run + repo_res.rules_run) == sorted(
        COPY_RULES + REPO_RULES)
    assert copy_res.unbaselined == [], format_text(copy_res, gate=True)
    assert repo_res.unbaselined == [], format_text(repo_res, gate=True)
    assert repo_res.stale_baseline == [], repo_res.stale_baseline
    assert copy_res.duration_s < 30, copy_res.duration_s
    assert repo_res.duration_s < 30, repo_res.duration_s
    # pytest -s shows the sizes and seconds PERF.md records
    print("port gate:", copy_res.summary(), "GC06 over the repo:", repo_res.summary())
    conc = copy_res.summary()["concurrency"]
    assert {"main", "stager", "admit", "dispatch", "signal"} <= set(conc["roles"]), conc
    assert conc["role_fns"] > 50 and conc["seeds"] >= 10, conc


def test_tolerated_are_the_jax_baselines_gc06_mirrors():
    jax = Baseline.load(REPO / "graftcheck_baseline.json")
    assert len(TOLERATED.entries) == len(jax.entries) == 11
    assert {(e["rule"], e["key"], e["justification"]) for e in TOLERATED.entries} == {
        (e["rule"], e["key"], e["justification"]) for e in jax.entries}
    assert all(e["path"].startswith(PORT) for e in TOLERATED.entries)


def test_every_jax_config_entry_resolves_in_the_port(port_tree):
    """Each JAX entry maps to a port function, class or file that exists,
    or sits in NO_COUNTERPART with its reason; so do the port's own."""
    assert unresolved(port_tree, port_config()) == []
    assert all(reason for reason in NO_COUNTERPART.values())


def test_rename_tables_name_real_jax_entries():
    """The rename and no-counterpart tables name JAX config entries that
    exist, so a stale table entry cannot hide a dropped rule."""
    base = default_config()
    fns = (set(base.gc01_traced_extra) | set(base.gc02_roots) | set(base.gc02_allow)
           | set(base.thread_main_roots) | set(base.thread_role_seeds))
    edges = set(base.gc02_extra_edges) | set(base.threads_extra_edges)
    for a, b in edges:
        fns |= {a, b}
    assert set(RENAMED) <= fns and set(NO_COUNTERPART) <= fns
    assert set(RENAMED_EDGES) <= edges
    assert set(RENAMED_ATTRS) <= set(base.attr_types)
    cfg = dataclasses.replace(base, scan_roots=(JAX.rstrip("/"),), exclude_parts=("__pycache__",))
    graph = CallGraph(load_context(REPO, cfg))
    for fn in list(RENAMED) + list(NO_COUNTERPART) + [x for e in RENAMED_EDGES for x in e]:
        assert graph.node(fn) is not None, fn


def test_renamed_root_fails_the_mapping(port_tree, tmp_path):
    """A port root renamed away turns the mapping red."""
    tree = planted(port_tree, tmp_path, PORT + "runtime/infer.py", [
        ("    def _finalize(self, dispatched)", "    def _finalize_v2(self, dispatched)")])
    bad = unresolved(tree, port_config())
    assert bad == [f"gc02_roots: {_P_INFER}::InferenceEngine._finalize"], bad


def _thread_sites(tree: ast.Module):
    """(enclosing class or None, Thread(...) call) for every thread spawn."""
    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name)
                continue
            if isinstance(child, ast.Call) and ast.unparse(child.func) in (
                    "threading.Thread", "Thread"):
                yield cls, child
            yield from visit(child, cls)

    yield from visit(tree, None)


def test_every_port_thread_has_a_role(clean):
    """Each Thread(...) of the port is seeded with a configured role: its
    name literal is a key of thread_name_roles and its target resolves to a
    function seeded with that role, or HAND_SEEDED_THREADS names the
    functions seeded for it."""
    copy_res, _, model = clean
    cfg = port_config()
    sites = 0
    for rel, sf in sorted(model.ctx.files.items()):
        if not rel.startswith(PORT):
            continue
        for cls, node in _thread_sites(sf.tree):
            sites += 1
            kw = {k.arg: k.value for k in node.keywords}
            target = ast.unparse(kw["target"])
            if (rel, target) in HAND_SEEDED_THREADS:
                for fn in HAND_SEEDED_THREADS[(rel, target)]:
                    assert model.roles.get(fn), (rel, target, fn)
                continue
            name = kw.get("name")
            assert isinstance(name, ast.Constant), (
                f"{rel}:{node.lineno}: Thread(name=...) is not a literal")
            role = cfg.thread_name_roles.get(name.value)
            assert role is not None, (rel, name.value)
            fn = model.graph.resolve(rel, cls, target)
            assert fn is not None and fn in model.seeds, (rel, node.lineno, target)
            assert model.seeds[fn][0] == role, (rel, node.lineno, model.seeds[fn])
    assert sites >= 20, sites
    roles = set(copy_res.summary()["concurrency"]["roles"])
    assert {"controller", "introspect", "watchdog", "committer", "loader"} <= roles, roles


def test_capture_lock_is_in_the_lock_model(clean):
    """The port's process-wide CAPTURE_LOCK is a non-reentrant lock of the
    model, taken by GraphCache._capture on a GC10 hot role."""
    _, _, model = clean
    assert CAPTURE_LOCK in model.lock_reentrant
    assert not model.reentrant(CAPTURE_LOCK)
    capture = (_P_INFER, "GraphCache._capture")
    assert [a.lock for a in model.infos[capture].acquisitions] == [CAPTURE_LOCK]
    # the engine's dispatch runs under main here, as in the JAX model: tier
    # consumers reach engine.stream through stored callables. main is one
    # of GC10's hot roles
    assert "main" in model.roles[capture] & port_config().gc10_hot_roles
    wait = (PORT + "runtime/faultinject.py", "infer_wait_point")
    assert {"watchdog", "main"} <= model.roles[wait], model.roles[wait]


# ----------------------------------------------------------- planted faults

_SCHED = PORT + "runtime/scheduler.py"

PLANTS = {
    # an .item() after the training step's dispatch
    "gc02_item_in_step": (
        PORT + "runtime/loop.py",
        [("state, metrics = step_fn(state, staged)\n",
          "state, metrics = step_fn(state, staged)\n"
          "                    metrics[\"loss\"].item()\n")],
        "GC02", lambda f: f.key.startswith("item:run_training_loop:")),
    # an A->B / B->A inversion between the scheduler's condition and a lock
    "gc07_lock_cycle": (
        _SCHED,
        [("    # -------------------------------------------------------------- serve\n",
          "    def _plant_fwd(self):\n"
          "        with self._cond:\n"
          "            with self._plant_lock:\n"
          "                pass\n\n"
          "    def _plant_rev(self):\n"
          "        with self._plant_lock:\n"
          "            with self._cond:\n"
          "                pass\n\n"
          "    # -------------------------------------------------------------- serve\n")],
        "GC07", lambda f: f.key.startswith("lock-cycle:")
        and "ContinuousBatchingScheduler._cond" in f.key),
    # written on the admission thread, read on the consumer, no lock
    "gc08_escape": (
        _SCHED,
        [("        gen: int,\n    ) -> None:\n        try:\n",
          "        gen: int,\n    ) -> None:\n        self.plantbox = gen\n        try:\n"),
         ("        thread.start()\n        stream = self.engine.stream(self._feed())\n",
          "        thread.start()\n        _ = self.plantbox\n"
          "        stream = self.engine.stream(self._feed())\n")],
        "GC08", lambda f: f.key == "escape:ContinuousBatchingScheduler.plantbox"),
    # blocking I/O in the SIGTERM/SIGINT handler
    "gc09_signal_io": (
        PORT + "runtime/preemption.py",
        [("    def _handle(self, signum: int, frame: Optional[FrameType]) -> None:\n",
          "    def _handle(self, signum: int, frame: Optional[FrameType]) -> None:\n"
          "        open('plant.txt', 'w').close()\n")],
        "GC09", lambda f: f.key.startswith("signal-io:GracefulShutdown._handle")),
    # the drain path's reentrant condition regressed to a plain one
    "gc09_signal_lock": (
        _SCHED,
        [("self._cond = threading.Condition(threading.RLock())",
          "self._cond = threading.Condition()")],
        "GC09", lambda f: f.key.startswith("signal-lock:")
        and "ContinuousBatchingScheduler._cond" in f.key),
    # the port's own lock: a blocking call inside `with CAPTURE_LOCK:`
    "gc10_capture_lock": (
        _P_INFER,
        [("        with CAPTURE_LOCK:\n",
          "        with CAPTURE_LOCK:\n            time.sleep(0.0)\n")],
        "GC10", lambda f: f.key == "under-lock:sleep:GraphCache._capture:1"
        and CAPTURE_LOCK in f.message),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_planted_fault_turns_its_rule_red(plant, port_tree, tmp_path):
    rel, edits, rule, match = PLANTS[plant]
    res = gate(planted(port_tree, tmp_path, rel, edits), rules=(rule,))
    bad = [f for f in res.unbaselined if f.rule == rule and match(f)]
    assert bad, format_text(res, gate=True)


# ------------------------------------------------------------------ repairs


def _events(run_dir: Path) -> List[dict]:
    p = run_dir / "events.jsonl"
    return [json.loads(ln) for ln in p.read_text().splitlines() if ln.strip()]


def test_drain_complete_carries_the_jax_keys(clean, tmp_path):
    """ServeDrain.finish emits drain_complete with exactly the keys the
    JAX package's emits, each spelled out, so GC05 reads the payload."""
    from raft_stereo_tpu.runtime import preemption as jpreemption
    from raft_stereo_tpu.runtime import telemetry as jtelemetry
    from raft_stereo_tpu_torch.runtime import preemption, telemetry

    keys = []
    for mod, tel_mod, sub in ((preemption, telemetry, "port"),
                              (jpreemption, jtelemetry, "jax")):
        tel = tel_mod.install(tel_mod.Telemetry(str(tmp_path / sub)))
        try:
            drain = mod.ServeDrain(mod.GracefulShutdown(), label="t")
            drain.begin()
            drain.note_result(object())
            drain.finish()
        finally:
            tel_mod.uninstall(tel)
        rows = [r for r in _events(tmp_path / sub) if r["event"] == "drain_complete"]
        assert len(rows) == 1, rows
        keys.append(set(rows[0]))
    assert keys[0] == keys[1]
    assert {"duration_ms", "resolved", "drained", "label"} <= keys[0]
    copy_res = clean[0]
    assert not [f for f in copy_res.findings + copy_res.suppressed
                if f.key == "dynamic-payload:drain_complete"]


def test_faultinject_reset_takes_the_counters_lock():
    """GC08 found ``reset()`` writing the dispatch counters with no lock
    while a dispatch thread bumps them under ``_lock`` (the chaos child
    resets between passes). ``reset()`` now takes ``_lock``: it waits for a
    holder, then clears every counter."""
    from raft_stereo_tpu_torch.runtime import faultinject

    faultinject.reset()
    faultinject.sched_stall_point("t")
    assert faultinject.sched_dispatch_attempts() == 1
    assert faultinject._sched_dispatch_by_label == {"t": 1}
    with faultinject._lock:
        t = threading.Thread(target=faultinject.reset, daemon=True)
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive()  # parked on the counters' lock
        assert faultinject._sched_dispatch_attempts == 1
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert faultinject.sched_dispatch_attempts() == 0
    assert faultinject._sched_dispatch_by_label == {}

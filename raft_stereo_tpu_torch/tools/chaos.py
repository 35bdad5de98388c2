"""Seeded chaos campaigns over the port's serving lifecycle (the port's
counterpart of ``tools/chaos.py``: the same specs, invariants, report and
``chaos.json``, over ``raft_stereo_tpu_torch.runtime``).

Every fault the runtime defends against has a deterministic injector
(``runtime.faultinject``) and a test proving its *own* recovery path. What
none of them prove is the composition: a decode failure while a bucket is
circuit-broken while a SIGTERM drain is in flight, or, on the card, a
capture that fails during a drain or a watchdog trip beside a replay. This
harness composes the injectors into seeded, reproducible randomized fault
schedules over a real serving run in a child process, then checks *global*
invariants that must hold no matter which faults fired:

  1. **clean exit** — the child exits 0 (a SIGTERM schedule exits 0
     through the graceful drain, within its ``drain_timeout`` bound);
  2. **resolve exactly once** — every request the source handed the
     scheduler resolves exactly once: completed, or a typed error
     (injected decode failure, watchdog-failed batch, shed, drained) —
     never a duplicate, never a silent drop;
  3. **bit identity** — outputs completed under faults are bit-identical
     to a fault-free run of the same stream (an adaptive run legitimately
     changes parameters mid-stream, so the invariant is replaced by
     rails-fired checks there);
  4. **telemetry conformance** — every event the faulted run emitted uses
     a declared ``EVENT_SCHEMA`` name with declared payload keys;
  5. **no leaked threads** — stager/admission threads joined; at most the
     injected hangs' abandoned (daemon) watchdog wait workers remain;
  6. **failure budget** — non-lifecycle failures are bounded by the
     faults that were injected, and every error is a *typed* known kind.

The seven modes are the JAX tool's: ``sched`` (the scheduler over one
engine), ``video`` (``SessionServer``), ``cascade`` (two tiers, planted
confidences), ``ctrl`` (the overload controller against a seeded load
wave), ``quality`` (drift sentinels and canaries against one planted
silent degradation), ``adaptive`` (MADNet2 adapting online) and ``fleet``
(two worker processes behind a ``FleetRouter``, faults at the host).

The toy forward is the JAX tool's arithmetic, ``(a * scale - b)`` summed
over channels, as a torch function on the engine's device: on the card the
engine captures it as a CUDA graph, so every schedule composes with capture
and replay, and it is elementwise, so batch composition cannot change its
bits. A ``sched`` spec may name another forward as ``"forward":
"module:function"``, a factory ``(spec, device) -> (forward_fn, module)``
(``realtime_packed_forward``: the ``raftstereo-realtime`` preset's packed
forward, bf16, 7 iterations).

A failing seed is re-run under schedule bisection (greedy ddmin) and the
minimal failing schedule is printed as a ready-to-run repro command.

Usage::

    python -m raft_stereo_tpu_torch.tools.chaos --seeds 20 --out chaos_out
    python -m raft_stereo_tpu_torch.tools.chaos --seed 7 --out chaos_out
    python -m raft_stereo_tpu_torch.tools.chaos --repro '<spec json>' --out DIR

Trials run on the card (``device="cuda"``, the CLI's); ``main(argv,
device="cpu")``, ``run_trial(spec, out_dir, device="cpu")`` and
``run_campaign(seeds, out_dir, device="cpu")`` run them on the CPU. A child
asked for the card on a machine without one raises. The campaign summary
lands in ``<out>/chaos.json``, which the root ``tools/run_report.py``
renders. ``--violate`` plants an intentional invariant violation (a child
that silently drops one resolution) to prove the harness catches and
minimizes.

The child entry point is ``--child SPECFILE`` (hidden); everything it arms
is programmatic (``faultinject.arm``), so a repro needs nothing but the
spec.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

# Known-typed error kinds a chaos run may resolve a request with.
# Lifecycle kinds are the drain/shed layer's typed rejections (including
# the session layer's typed resolution of frames still parked behind a
# predecessor when a drain ends the inner stream); fault kinds are the
# injected failures and the watchdog's batch failure.
LIFECYCLE_ETYPES = {"ShedError", "DrainedError", "SessionShedError"}
FAULT_ETYPES = {"OSError", "RuntimeError", "_WatchdogTimeout"}

SHAPES = [(24, 48), (40, 72)]  # two /32 buckets
CHILD_TIMEOUT_S = 300.0

# the package's parent directory: the child imports the package from it
_REPO_ROOT = str(Path(__file__).resolve().parent.parent.parent)
# this module's name, also when it runs as ``python -m``
MODULE = "raft_stereo_tpu_torch.tools.chaos"


# --------------------------------------------------------- spec generation


def make_spec(seed: int, *, adaptive_every: int = 10,
              cascade_every: int = 5,
              video_every: int = 7,
              ctrl_every: int = 9,
              quality_every: int = 11,
              fleet_every: int = 13,
              violate: bool = False) -> Dict[str, Any]:
    """The seed's reproducible trial spec: stream + config + fault
    schedule, equal to the JAX tool's for every seed and cadence. Every
    randomized choice comes from ``random.Random(seed)``, so the same seed
    always produces the same trial. Every ``cascade_every``-th seed serves
    through a scheduler-backed ``CascadeServer`` (two tiers, planted
    per-pair confidences) so the exactly-once and typed-error invariants
    are checked across the fast-pass -> escalation hand-off too —
    including a SIGTERM drain landing between them. Every
    ``video_every``-th seed serves session-tagged video streams through the
    ``SessionServer`` over a scheduler-backed engine: frames serialize per
    session, a faulted frame must RESET its session (typed, observable) and
    a drain mid-stream must resolve in-flight and parked frames exactly
    once. Every ``ctrl_every``-th seed runs the overload controller against
    a seeded load wave — burst arrival, sustained saturation, or slow drain
    — and checks the control-law contract: ladder monotonicity, bounded
    actuation, full unwind after the wave, and p95 strictly better than
    the controller-off pass under the SAME armed wave."""
    rng = random.Random(seed)
    if fleet_every and seed % fleet_every == fleet_every - 1:
        mode = "fleet"
    elif adaptive_every and seed % adaptive_every == adaptive_every - 1:
        mode = "adaptive"
    elif cascade_every and seed % cascade_every == cascade_every - 1:
        mode = "cascade"
    elif video_every and seed % video_every == video_every - 1:
        mode = "video"
    elif ctrl_every and seed % ctrl_every == ctrl_every - 1:
        mode = "ctrl"
    elif quality_every and seed % quality_every == quality_every - 1:
        mode = "quality"
    else:
        mode = "sched"
    if mode == "fleet":
        # the replica-fleet seed class: a 2-host FleetRouter over toy
        # engine workers, faults at the HOST granularity —
        #   host_kill             SIGKILL one worker mid-stream: its
        #                         in-flight requests must fail over
        #                         (generation-fenced, exactly once);
        #   host_hang             SIGSTOP one worker until past the
        #                         router's down_after bound, SIGCONT it
        #                         later: the resumed zombie's late
        #                         results must be FENCED, never a double
        #                         resolve;
        #   health_blackhole      the worker's debug server vanishes
        #                         while its data path keeps serving: the
        #                         circuit must open and the host fail
        #                         over on health evidence alone;
        #   drain_during_failover SIGKILL one host, SIGTERM the router
        #                         moments later: the fleet drain and the
        #                         failover compose — every request still
        #                         resolves exactly once, exit 0.
        # Half the seeds tag requests with sessions (router affinity +
        # worker SessionServer; a killed host's sessions migrate with a
        # typed cold start). The fault-free baseline is a SINGLE-HOST
        # scheduler serve of the same stream: per-request outputs are
        # batch-composition-independent, so fleet completions must be
        # bit-identical to it.
        n = rng.randint(12, 18)
        spec = {
            "seed": seed,
            "mode": "fleet",
            "n_hosts": 2,
            "n_requests": n,
            "shapes": [rng.randrange(len(SHAPES)) for _ in range(n)],
            "deadlines": {},
            "n_sessions": rng.choice([0, 2]),
            "batch": 2,
            "max_wait_s": 0.1,
            "max_pending": None,
            "infer_timeout": 6.0,
            "retries": 1,
            "drain_timeout": 8.0,
            "pace_s": 0.06,
            "schedule": [],
        }
        menu = ["host_kill", "host_hang", "health_blackhole",
                "drain_during_failover"]
        for kind in rng.sample(menu, rng.randint(1, 2)):
            entry: Dict[str, Any] = {
                "kind": kind,
                "host": rng.randrange(spec["n_hosts"]),
                "after_results": rng.randint(2, max(3, n // 3)),
            }
            if kind == "host_hang":
                # resume AFTER the router's down_after bound so the host
                # is always declared down first — the SIGCONT zombie's
                # late results are the generation-fence test
                entry["resume_s"] = 2.0
            spec["schedule"].append(entry)
        if violate:
            spec["schedule"].append({"kind": "violate_drop_result"})
        return spec
    if mode == "quality":
        # the silent-degradation seed class: a session-sticky toy serve
        # with the quality observatory live — drift sentinels on the real
        # output path plus woven golden canaries — and ONE planted
        # degradation that corrupts no request and raises no error, only
        # quality:
        #   swap     a wrong-checkpoint weight swap mid-serve (canary
        #            bit-exact goldens must latch within the declared
        #            canary budget);
        #   regress  the user input distribution shifts (an adaptation-
        #            regression stand-in with the rails out of the
        #            picture: outputs drift, canaries — deterministic
        #            inputs — must NOT fail; the drift sentinel alone
        #            must raise within the declared window budget);
        #   stale    warm-start reuse poisoned via RAFT_FI_WARM_POISON's
        #            programmatic arm (the warm-dependent toy forward
        #            makes stale state a real output shift; sessionless
        #            canaries are untouched);
        #   none     fault-free — the zero-false-alarm bound: no
        #            quality_drift raise, no canary failure, no latch.
        n = 56
        plant = rng.choice(["swap", "regress", "stale", "none"])
        q = {"window_n": 6, "reference_n": 12,
             "canary_every": 4, "canary_latch": 2, "canary_tol": 0.5}
        # plant AFTER the reference freezes (reference_n user results)
        # so detection is window-vs-reference, never a tainted reference
        plant_at = rng.randint(q["reference_n"] + 8, q["reference_n"] + 14)
        # declared detection budgets, in USER results after the plant:
        # the canary path needs canary_latch consecutive canaries
        # (every canary_every user results) plus in-flight slack; the
        # drift path needs trip_windows (2) full windows plus the one
        # in flight, plus slack
        batch = 2
        spec = {
            "seed": seed,
            "mode": "quality",
            "plant": plant,
            "plant_at": plant_at,
            "n_requests": n,
            "n_sessions": 2,
            "batch": batch,
            # paced arrivals: an unpaced source lets the session router
            # inhale the whole stream (parking user frames, forwarding
            # every canary) so ALL canaries would dispatch before the
            # plant — pacing keeps each canary's dispatch near its weave
            # position, the way live traffic arrives
            "pace_s": 0.05,
            "max_wait_s": 0.05,
            "infer_timeout": 6.0,
            "retries": 1,
            "drain_timeout": 8.0,
            "quality": q,
            "detect_within": {
                "swap": q["canary_every"] * (q["canary_latch"] + 1)
                + 2 * batch,
                "regress": 3 * q["window_n"] + 2 * batch,
                "stale": 3 * q["window_n"] + 2 * batch,
            }.get(plant),
            "schedule": [],
        }
        if plant == "stale":
            spec["schedule"].append(
                {"kind": "warm_poison",
                 "ordinals": list(range(plant_at, n + 1)),
                 "fill": 40.0})
        if violate:
            spec["schedule"].append({"kind": "violate_drop_result"})
        return spec
    if mode == "ctrl":
        # the load-wave seed class: paced arrivals, a dispatch-stall wave
        # mid-stream, then a calm tail long enough for the promotion path
        # to unwind every rung on its own. Planted confidences are GRADED
        # (0.35 vs the 0.5 bar) so the cascade_bar rung really changes
        # routing, and max_pending is set so shed_tight really bites.
        n = 30
        # the wave is SCOPED to the quality tier's dispatch loop: the
        # overload story is "the quality tier degraded", every escalated
        # request pays the stall, and the controller's cascade_bar rung
        # (accept graded-confidence results at the fast tier) is the
        # structural win the p95 comparison measures. An unscoped stall's
        # ordinals split nondeterministically between the two tiers'
        # dispatch loops — worse, the controller REDUCING quality traffic
        # shifts stalls onto the fast loop, punishing the exact behavior
        # under test. Ordinals count from the quality scheduler's own
        # first dispatch pass (1 = its startup pass).
        # every quality dispatch pass inside the wave stalls (per-group
        # stall far above the ~0.4s escalate inter-arrival), so the
        # controller-off pass saturates and its queueing delay grows
        # with every group it keeps sending — while the controller-on
        # pass stops feeding the stalled tier after the first few
        # groups, so only its pre-engagement escalations pay. Waves
        # differ in amplitude vs length; all are long enough to cover
        # the controller-off pass's whole escalation stream.
        wave = rng.choice(["burst", "sustained", "slow_drain"])
        if wave == "burst":
            stall = {"kind": "sched_stall", "scope": "quality",
                     "ordinals": list(range(2, 9)), "ms": 900}
        elif wave == "sustained":
            stall = {"kind": "sched_stall", "scope": "quality",
                     "ordinals": list(range(2, 15)), "ms": 600}
        else:
            stall = {"kind": "sched_stall", "scope": "quality",
                     "ordinals": list(range(2, 11)), "ms": 750}
        spec = {
            "seed": seed,
            "mode": "ctrl",
            "wave": wave,
            "n_requests": n,
            "shapes": [rng.randrange(len(SHAPES)) for _ in range(n)],
            "deadlines": {},
            "batch": 2,
            "max_wait_s": 0.1,
            "max_pending": 12,
            "infer_timeout": 6.0,
            "retries": 1,
            "drain_timeout": 8.0,
            # half the stream escalates: the stalled quality tier must
            # SATURATE (arrival rate above its stalled service rate) so
            # the controller-off tail grows cumulatively while the
            # controller-on pass reroutes everything after the first
            # missed window
            "escalate": sorted(rng.sample(range(n), n // 2)),
            "pace_s": 0.1,
            # the SLO target sits ABOVE the calm steady-state latency
            # (paced arrivals pay the 0.1s batch-formation wait) and
            # BELOW the stall-driven queue waits, so the burn sensor
            # reads 0 in the tail and spikes under the wave
            "slo": {"p95_ms": 250.0, "budget": 0.01},
            # depth_high 3: the stalled tier's queue trips the ladder
            # after ~3 queued escalations (~0.6s in), well before the
            # burn sensor's first stalled round-trip resolves — late
            # engagement lets half the stream slip into the stalled
            # queue and ride the whole wave in BOTH passes. Dwell longer
            # than the stream: a mid-wave promote would probe the
            # stalled tier with a real request, so the degraded rung
            # rides out the wave and promotion is proven in the calm
            # tail instead.
            "ctrl": {"interval": 0.1, "dwell": 3.0,
                     "burn_high": 1.0, "burn_low": 0.4,
                     "depth_high": 3, "depth_low": 1},
            "schedule": [stall],
        }
        if violate:
            spec["schedule"].append({"kind": "violate_drop_result"})
        return spec
    if mode == "adaptive":
        spec: Dict[str, Any] = {
            "seed": seed,
            "mode": "adaptive",
            "n_requests": 6,
            "batch": 2,
            "adapt_every": 2,
            "size": [64, 96],
            "drain_timeout": 60.0,
            "schedule": [],
        }
        menu = ["adapt_nan", "adapt_regress", "sigterm", "sched_stall"]
        for kind in rng.sample(menu, rng.randint(1, 2)):
            if kind == "adapt_nan":
                spec["schedule"].append(
                    {"kind": "adapt_nan", "ordinals": [rng.randint(1, 2)]})
            elif kind == "adapt_regress":
                # ordinal >= 2: the child's monitor warms up on one
                # observation, so an inflation at ordinal 1 only seeds the
                # EMAs (legitimately no rollback)
                spec["schedule"].append(
                    {"kind": "adapt_regress", "ordinals": [rng.randint(2, 3)]})
            elif kind == "sigterm":
                spec["schedule"].append(
                    {"kind": "sigterm",
                     "after_results": rng.randint(2, 4)})
            else:
                spec["schedule"].append(
                    {"kind": "sched_stall",
                     "ordinals": [rng.randint(1, 3)],
                     "ms": rng.choice([150, 250])})
    else:
        if mode == "cascade":
            n = rng.randint(8, 14)
        elif mode == "video":
            n = rng.randint(10, 16)
        else:
            n = rng.randint(12, 22)
        deadlines = (
            {} if mode == "video" else {
                i: round(rng.uniform(0.5, 2.0), 2)
                for i in rng.sample(range(n), rng.randint(0, n // 3))
            }
        )
        spec = {
            "seed": seed,
            "mode": mode,
            "n_requests": n,
            "shapes": [rng.randrange(len(SHAPES)) for _ in range(n)],
            "deadlines": {str(k): v for k, v in deadlines.items()},
            "batch": 2,
            "max_wait_s": 0.2,
            "max_pending": rng.choice([None, rng.randint(6, 12)]),
            # a session-GATED feed is legitimately bursty: the stager
            # idles for a whole result -> release -> decode -> stage
            # round-trip per frame, so the stager-stall watchdog needs
            # slack over the injected delays (hangs consume a full
            # deadline) on a loaded runner; ungated sched streams keep
            # the tight bound
            "infer_timeout": 6.0 if mode == "video" else 2.0,
            "retries": 1,
            "drain_timeout": 5.0,
            "schedule": [],
        }
        menu = ["decode_fail", "compile_fail", "oom", "hang",
                "sched_stall", "sigterm"]
        for kind in rng.sample(menu, rng.randint(1, 3)):
            if kind == "decode_fail":
                spec["schedule"].append(
                    {"kind": "decode_fail",
                     "ordinals": sorted(rng.sample(range(1, n + 1),
                                                   rng.randint(1, 2)))})
            elif kind == "compile_fail":
                spec["schedule"].append(
                    {"kind": "compile_fail",
                     "ordinals": sorted(rng.sample(range(1, 5),
                                                   rng.randint(1, 3)))})
            elif kind == "oom":
                spec["schedule"].append({"kind": "oom", "threshold": 2})
            elif kind == "hang":
                spec["schedule"].append(
                    {"kind": "hang", "ordinals": [rng.randint(1, 4)]})
            elif kind == "sched_stall":
                spec["schedule"].append(
                    {"kind": "sched_stall",
                     "ordinals": sorted(rng.sample(range(1, 6),
                                                   rng.randint(1, 2))),
                     "ms": rng.choice([150, 250, 400])})
            else:
                spec["schedule"].append(
                    {"kind": "sigterm",
                     "after_results": rng.randint(1, max(2, n // 3))})
        if mode == "cascade":
            # planted per-pair confidences (the input marker the child's
            # confidence_fn reads): these payloads escalate, the rest are
            # accepted from the fast tier
            spec["escalate"] = sorted(
                rng.sample(range(n), rng.randint(1, max(2, n // 2))))
        if mode == "video":
            # interleaved session-tagged streams: request i is a frame of
            # session i % n_sessions; each session keeps ONE shape (warm
            # state never crosses a shape change by contract)
            n_sessions = rng.randint(2, 3)
            spec["n_sessions"] = n_sessions
            spec["session_shapes"] = [
                rng.randrange(len(SHAPES)) for _ in range(n_sessions)]
            spec["shapes"] = [
                spec["session_shapes"][i % n_sessions] for i in range(n)]
    if violate:
        spec["schedule"].append({"kind": "violate_drop_result"})
    return spec


# ------------------------------------------------------------ the child


def _arm_schedule(schedule: List[Dict[str, Any]]) -> None:
    from raft_stereo_tpu_torch.runtime import faultinject

    kw: Dict[str, Any] = {}
    for entry in schedule:
        kind = entry["kind"]
        if kind == "decode_fail":
            kw["infer_decode_fail"] = set(entry["ordinals"])
        elif kind == "compile_fail":
            kw["infer_compile_fail"] = set(entry["ordinals"])
        elif kind == "oom":
            kw["infer_oom_batch"] = int(entry["threshold"])
        elif kind == "hang":
            kw["infer_hang"] = set(entry["ordinals"])
        elif kind == "sched_stall":
            kw["sched_stall"] = set(entry["ordinals"])
            kw["sched_stall_ms"] = float(entry.get("ms", 200))
            if entry.get("scope"):
                kw["sched_stall_scope"] = str(entry["scope"])
        elif kind == "adapt_nan":
            kw["adapt_nan"] = set(entry["ordinals"])
        elif kind == "adapt_regress":
            kw["adapt_regress"] = set(entry["ordinals"])
        elif kind == "warm_poison":
            kw["warm_poison"] = set(entry["ordinals"])
            kw["warm_poison_fill"] = float(entry.get("fill", 40.0))
        # sigterm / violate_drop_result are the child's own, not injector arms
    if kw:
        faultinject.arm(**kw)


def _result_record(res) -> Dict[str, Any]:
    import hashlib

    if res.ok:
        import numpy as np

        arr = np.ascontiguousarray(res.output)
        return {"ok": True,
                "sha": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
                "shape": list(arr.shape)}
    return {"ok": False, "etype": type(res.error).__name__}


def _device(spec: Dict[str, Any]):
    """The spec's device, the card by default; asking for a card that is
    not there raises (no fallback to the CPU)."""
    import torch

    dev = torch.device(spec.get("device") or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trial was asked for the card; run it with "
                           "device='cpu' to serve on the CPU explicitly")
    return dev


def _toy_model(scale: float, device):
    """The toy forward's weights: one scale, a parameter the engine's
    ``update_variables`` swaps in place (the quality mode's wrong-checkpoint
    plant) and ``TierSet`` reads its device from."""
    import torch

    model = torch.nn.Module()
    model.scale = torch.nn.Parameter(
        torch.tensor(scale, dtype=torch.float32, device=device), requires_grad=False)
    return model


def toy_forward(spec: Dict[str, Any], device) -> Tuple[Callable, Any]:
    """The default forward factory: the JAX tool's toy arithmetic,
    ``(a * scale - b)`` summed over channels (dims kept), scale 2."""
    model = _toy_model(2.0, device)

    def fn(a, b):
        return (a * model.scale - b).sum(-1, keepdim=True)

    return fn, model


def realtime_packed_forward(spec: Dict[str, Any], device) -> Tuple[Callable, Any]:
    """The ``raftstereo-realtime`` preset's forward (bf16, 7 iterations,
    the alternate correlation: K1 on every lookup) with the packed encoder
    stage on (K3 on layer1's convs wherever ``packed_encoder.packable_hw``
    takes the bucket), random weights from seed 0."""
    import torch

    from raft_stereo_tpu_torch.config import PRESET_FLAGS, PRESETS
    from raft_stereo_tpu_torch.evaluate import load_model
    from raft_stereo_tpu_torch.models import extractor

    extractor._ENABLE_PACKED = True
    # a pair's output must not depend on its batch (the invariant's premise):
    # cuDNN and oneDNN pick their conv algorithms by batch size, so the
    # circuit's one-pair-at-a-time path would differ from a batch of two
    # in the last bits; the stock convs run per pair without them
    torch.backends.cudnn.enabled = False
    torch.backends.mkldnn.enabled = False
    model = load_model(PRESETS["raftstereo-realtime"], device=device, seed=0)
    iters = int(PRESET_FLAGS["raftstereo-realtime"]["valid_iters"])

    def fn(a, b):
        with torch.no_grad():
            return model(a, b, iters=iters)[1]

    return fn, model


_FORWARDS: Dict[str, Tuple[Callable, Any]] = {}


def _forward(spec: Dict[str, Any], device) -> Tuple[Callable, Any]:
    """The spec's forward factory (``"forward": "module:function"``, the toy
    when absent), built once a child: every pass serves the same model."""
    name = spec.get("forward") or f"{MODULE}:toy_forward"
    if name not in _FORWARDS:
        mod, _, fn = name.partition(":")
        _FORWARDS[name] = getattr(importlib.import_module(mod), fn)(spec, device)
    return _FORWARDS[name]


# every engine a child builds: their graphs' replayed launches
_ENGINES: List[Any] = []


def _engine(forward_fn, device, spec: Dict[str, Any], *, module=None,
            eager_finalize: bool = False):
    from raft_stereo_tpu_torch.runtime.infer import InferenceEngine

    engine = InferenceEngine(
        forward_fn, device=device, batch=spec["batch"], divis_by=32,
        deadline_s=spec["infer_timeout"], retries=spec["retries"],
        retry_backoff_s=0.01, eager_finalize=eager_finalize, module=module,
    )
    _ENGINES.append(engine)
    return engine


def _sched_requests(spec: Dict[str, Any]):
    """The seed's request stream — identical arrays for the baseline and
    the faulted pass (inputs are keyed on (seed, index) alone)."""
    import numpy as np

    from raft_stereo_tpu_torch.runtime.infer import InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

    deadlines = {int(k): v for k, v in (spec.get("deadlines") or {}).items()}
    for i, si in enumerate(spec["shapes"]):
        h, w = SHAPES[si]
        rng = np.random.RandomState(spec["seed"] * 1000 + i)
        req = InferRequest(
            payload=i,
            inputs=(rng.rand(h, w, 3).astype(np.float32),
                    rng.rand(h, w, 3).astype(np.float32)),
        )
        if i in deadlines:
            yield SchedRequest(req, deadline_s=deadlines[i])
        else:
            yield req


def _serve_sched(spec: Dict[str, Any], *, sigterm_after: Optional[int],
                 drop_one: bool) -> Dict[str, Any]:
    """One scheduler-backed serve of the spec's stream under whatever is
    currently armed. Returns the per-request resolution report."""
    import signal as _signal

    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler

    dev = _device(spec)
    fn, module = _forward(spec, dev)
    engine = _engine(fn, dev, spec, module=module)
    sched = ContinuousBatchingScheduler(
        engine, max_wait_s=spec["max_wait_s"],
        max_pending=spec["max_pending"],
    )
    yielded: List[Any] = []

    def counted(source):
        # count AFTER the drain wrapper: these are the requests the
        # scheduler actually accepted responsibility for
        for req in source:
            yielded.append(getattr(req, "request", req).payload)
            yield req

    results: Dict[str, Any] = {}
    dropped = False
    with GracefulShutdown() as shutdown:
        drain = ServeDrain(shutdown, timeout_s=spec["drain_timeout"],
                           label="chaos")
        drain.attach(sched)
        n_seen = 0
        for res in sched.serve(counted(drain.wrap_source(
                _sched_requests(spec)))):
            drain.note_result(res)
            n_seen += 1
            if drop_one and res.ok and not dropped:
                dropped = True  # the planted violation: a lost resolution
                continue
            results[str(res.payload)] = _result_record(res)
            if sigterm_after is not None and n_seen == sigterm_after:
                os.kill(os.getpid(), _signal.SIGTERM)
        drain_info = drain.finish()
    return {"yielded": yielded, "results": results, "drain": drain_info,
            "sched_stats": {
                "admitted": sched.stats.admitted,
                "shed": sched.stats.shed,
                "shed_reasons": dict(sched.stats.shed_reasons),
            }}


def _video_requests(spec: Dict[str, Any]):
    """The video seed's stream: the sched stream's deterministic arrays,
    session-tagged — request i is a frame of session ``s{i % n_sessions}``
    (each session one shape, interleaved round-robin)."""
    import numpy as np

    from raft_stereo_tpu_torch.runtime.infer import InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

    n_sessions = spec["n_sessions"]
    for i, si in enumerate(spec["shapes"]):
        h, w = SHAPES[si]
        rng = np.random.RandomState(spec["seed"] * 1000 + i)
        req = InferRequest(
            payload=i,
            inputs=(rng.rand(h, w, 3).astype(np.float32),
                    rng.rand(h, w, 3).astype(np.float32)),
        )
        yield SchedRequest(req, session=f"s{i % n_sessions}")


def _serve_video(spec: Dict[str, Any], *, sigterm_after: Optional[int],
                 drop_one: bool) -> Dict[str, Any]:
    """One session-sticky video serve (``SessionServer`` over a
    scheduler-backed engine) under whatever is armed. The toy forward takes
    the warm slot but its output does not depend on it (the fixpoint of a
    converged refinement is init-independent), so the fault-free baseline
    is the single bit-identity reference while the session machinery —
    per-session serialization, warm-state resets on typed errors,
    parked-frame resolution at a drain — is fully live."""
    import signal as _signal

    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler,
        SessionServer,
    )

    dev = _device(spec)
    model = _toy_model(2.0, dev)

    def fn(a, b, warm):
        return (a * model.scale - b).sum(-1, keepdim=True)

    # a session frame's successor cannot exist before its result — the
    # held one-deep dispatch must finalize on an empty queue
    engine = _engine(fn, dev, spec, module=model, eager_finalize=True)
    sched = ContinuousBatchingScheduler(
        engine, max_wait_s=spec["max_wait_s"],
        max_pending=spec["max_pending"],
    )
    session = SessionServer(sched.serve, forward_sched=True)
    yielded: List[Any] = []

    def counted(source):
        for req in source:
            yielded.append(getattr(req, "request", req).payload)
            yield req

    results: Dict[str, Any] = {}
    dropped = False
    with GracefulShutdown() as shutdown:
        drain = ServeDrain(shutdown, timeout_s=spec["drain_timeout"],
                           label="chaos-video")
        drain.attach(sched)
        n_seen = 0
        for res in session.serve(counted(drain.wrap_source(
                _video_requests(spec)))):
            drain.note_result(res)
            n_seen += 1
            if drop_one and res.ok and not dropped:
                dropped = True  # the planted violation: a lost resolution
                continue
            results[str(res.payload)] = _result_record(res)
            if sigterm_after is not None and n_seen == sigterm_after:
                os.kill(os.getpid(), _signal.SIGTERM)
        drain_info = drain.finish()
    return {"yielded": yielded, "results": results, "drain": drain_info,
            "sessions": session.summary()}


def _fleet_requests(spec: Dict[str, Any]):
    """The fleet seed's stream: the sched stream's deterministic arrays
    (keyed on (seed, index) alone — the single-host baseline serves the
    same bytes), optionally session-tagged for the affinity contract."""
    import numpy as np

    from raft_stereo_tpu_torch.runtime.infer import InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

    n_sessions = int(spec.get("n_sessions") or 0)
    for i, si in enumerate(spec["shapes"]):
        h, w = SHAPES[si]
        rng = np.random.RandomState(spec["seed"] * 1000 + i)
        req = InferRequest(
            payload=i,
            inputs=(rng.rand(h, w, 3).astype(np.float32),
                    rng.rand(h, w, 3).astype(np.float32)),
        )
        if n_sessions:
            yield SchedRequest(req, session=f"s{i % n_sessions}")
        else:
            yield req


def _serve_fleet(spec: Dict[str, Any], *, sigterm_after: Optional[int],
                 drop_one: bool) -> Dict[str, Any]:
    """One 2-host fleet serve of the spec's stream with the schedule's
    HOST-granularity faults fired from the result loop (mid-batch by
    construction: each trigger keys on resolved-result counts while the
    paced stream is still arriving). The workers serve the fleet CLI's toy
    engine (``serve_fleet.FACTORY``, ``model: toy``: the same arithmetic as
    this harness's toy) on the spec's device. Resolution counts are
    recorded per payload — a generation-fence failure shows up as
    ``dups``."""
    import signal as _signal
    import threading

    from raft_stereo_tpu_torch import serve_fleet
    from raft_stereo_tpu_torch.runtime.fleet import FleetRouter
    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain

    sessions = bool(spec.get("n_sessions"))
    router = FleetRouter(
        serve_fleet.FACTORY, spec["n_hosts"],
        factory_kw={"model": "toy", "device": spec.get("device") or "cuda",
                    "batch": spec["batch"],
                    "infer_timeout": spec["infer_timeout"],
                    "retries": spec["retries"], "warm": sessions,
                    "aot_dir": spec.get("aot_dir")},
        workdir=os.path.join(spec["telemetry_dir"], "fleet"),
        max_wait_s=spec["max_wait_s"],
        max_pending=spec.get("max_pending"),
        drain_timeout=spec["drain_timeout"], sessions=sessions,
        poll_interval_s=0.1, fail_threshold=3,
        probe_cooldown_s=0.4, down_after_s=1.2, max_failovers=2,
    )
    triggers = sorted(
        (e for e in spec["schedule"]
         if e["kind"] in ("host_kill", "host_hang", "health_blackhole",
                          "drain_during_failover")),
        key=lambda e: e["after_results"])
    timers: List[threading.Timer] = []

    def kill_pid(pid: Optional[int], sig) -> None:
        if pid is None:
            return
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            pass

    def fire(entry: Dict[str, Any]) -> None:
        kind = entry["kind"]
        if kind == "host_kill":
            kill_pid(router.host_pid(entry["host"]), _signal.SIGKILL)
        elif kind == "host_hang":
            pid = router.host_pid(entry["host"])
            kill_pid(pid, _signal.SIGSTOP)
            t = threading.Timer(
                entry.get("resume_s", 2.0),
                lambda: kill_pid(pid, _signal.SIGCONT))
            t.daemon = True
            t.start()
            timers.append(t)
        elif kind == "health_blackhole":
            router.inject_health_blackhole(entry["host"])
        else:  # drain_during_failover
            kill_pid(router.host_pid(entry["host"]), _signal.SIGKILL)
            t = threading.Timer(
                0.3, lambda: os.kill(os.getpid(), _signal.SIGTERM))
            t.daemon = True
            t.start()
            timers.append(t)

    yielded: List[Any] = []

    def counted(source):
        for req in source:
            yielded.append(getattr(req, "request", req).payload)
            yield req

    def paced(source):
        for req in source:
            yield req
            if spec.get("pace_s"):
                time.sleep(spec["pace_s"])

    results: Dict[str, Any] = {}
    counts: Dict[str, int] = {}
    fired: List[Dict[str, Any]] = []
    dropped = False
    router.start()
    try:
        with GracefulShutdown() as shutdown:
            drain = ServeDrain(shutdown, timeout_s=spec["drain_timeout"],
                               label="chaos-fleet")
            drain.attach(router)
            n_seen = 0
            for res in router.serve(counted(drain.wrap_source(
                    paced(_fleet_requests(spec))))):
                drain.note_result(res)
                n_seen += 1
                while triggers and n_seen >= triggers[0]["after_results"]:
                    entry = triggers.pop(0)
                    fire(entry)
                    fired.append(entry)
                if drop_one and res.ok and not dropped:
                    dropped = True  # the planted violation
                    continue
                p = str(res.payload)
                counts[p] = counts.get(p, 0) + 1
                results[p] = _result_record(res)
                if sigterm_after is not None and n_seen == sigterm_after:
                    os.kill(os.getpid(), _signal.SIGTERM)
            # settle: a fault fired near the stream's end must still
            # produce its down-declaration / circuit evidence (and give
            # a SIGCONT zombie its window to send fenceable results)
            # before the teardown races it away
            expect_down = {e["host"] for e in fired
                           if e["kind"] in ("host_kill", "host_hang",
                                            "drain_during_failover")}
            expect_circ = {e["host"] for e in fired
                           if e["kind"] == "health_blackhole"}
            deadline = time.monotonic() + 4.0
            while time.monotonic() < deadline:
                snap = router.snapshot()["hosts"]
                if all(snap[str(h)]["state"] == "down"
                       for h in expect_down) \
                        and all(snap[str(h)]["circuit"] != "closed"
                                or snap[str(h)]["state"] == "down"
                                for h in expect_circ):
                    break
                time.sleep(0.1)
            drain_info = drain.finish()
    finally:
        router.close()
        for t in timers:
            t.cancel()
    return {"yielded": yielded, "results": results,
            "dups": {p: c for p, c in counts.items() if c > 1},
            "drain": drain_info, "fleet": router.snapshot()}


def _toy_tier(name: str, scale: float, device):
    """A cascade tier over the toy forward at ``scale``."""
    from raft_stereo_tpu_torch.runtime.tiers import ModelTier

    def make_forward(model):
        def fwd(a, b):
            return (a * model.scale - b).sum(-1, keepdim=True)

        return fwd

    return ModelTier(name=name, model=_toy_model(scale, device),
                     make_forward=make_forward)


def _toy_tierset(spec: Dict[str, Any]):
    """The fast (scale 2) and quality (scale 3) toy tiers, scheduler-backed,
    on the spec's device."""
    from raft_stereo_tpu_torch.runtime.infer import InferOptions
    from raft_stereo_tpu_torch.runtime.tiers import TierSet

    dev = _device(spec)
    ts = TierSet(
        [_toy_tier("fast", 2.0, dev), _toy_tier("quality", 3.0, dev)],
        InferOptions(batch=spec["batch"], sched=True,
                     sched_max_wait=spec["max_wait_s"],
                     max_pending=spec["max_pending"],
                     deadline_s=spec["infer_timeout"],
                     retries=spec["retries"]),
    )
    _ENGINES.extend(ts.engines.values())
    return ts


def _cascade_requests(spec: Dict[str, Any]):
    """The cascade seed's stream: same deterministic arrays as the sched
    stream, plus the planted per-pair confidence marker (left image's
    first texel) the child's confidence_fn reads — payloads in the
    spec's ``escalate`` list score 0.0 (escalate), the rest 1.0."""
    import numpy as np

    from raft_stereo_tpu_torch.runtime.infer import InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

    deadlines = {int(k): v for k, v in (spec.get("deadlines") or {}).items()}
    escalate = set(spec.get("escalate") or [])
    for i, si in enumerate(spec["shapes"]):
        h, w = SHAPES[si]
        rng = np.random.RandomState(spec["seed"] * 1000 + i)
        a = rng.rand(h, w, 3).astype(np.float32)
        b = rng.rand(h, w, 3).astype(np.float32)
        a[0, 0, 0] = 0.0 if i in escalate else 1.0
        req = InferRequest(payload=i, inputs=(a, b))
        if i in deadlines:
            yield SchedRequest(req, deadline_s=deadlines[i])
        else:
            yield req


def _serve_cascade(spec: Dict[str, Any], *, sigterm_after: Optional[int],
                   drop_one: bool, fast_only: bool = False) -> Dict[str, Any]:
    """One cascade-backed serve (two toy tiers over scheduler-backed
    engines on one device, ``runtime.tiers.CascadeServer``) under whatever
    is armed — the exactly-once and typed-error invariants across the
    fast-pass -> escalation hand-off, including a SIGTERM drain landing
    between them. ``fast_only`` serves the same stream through the fast
    tier alone: the second bit-identity reference, because a faulted
    escalation legitimately falls back to the (bit-exact) fast result."""
    import signal as _signal

    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.tiers import CascadeServer, TieredServer, TierPolicy

    ts = _toy_tierset(spec)
    casc = CascadeServer(
        ts, threshold=0.5,
        confidence_fn=lambda left, right, disp: float(left[0, 0, 0]),
    )
    serve_fn = (TieredServer(ts, TierPolicy.single("fast")).serve
                if fast_only else casc.serve)
    yielded: List[Any] = []

    def counted(source):
        for req in source:
            yielded.append(getattr(req, "request", req).payload)
            yield req

    results: Dict[str, Any] = {}
    dropped = False
    with GracefulShutdown() as shutdown:
        drain = ServeDrain(shutdown, timeout_s=spec["drain_timeout"],
                           label="chaos-cascade")
        drain.attach(ts)  # fans the drain out to BOTH tiers' schedulers
        n_seen = 0
        for res in serve_fn(counted(drain.wrap_source(
                _cascade_requests(spec)))):
            drain.note_result(res)
            n_seen += 1
            if drop_one and res.ok and not dropped:
                dropped = True  # the planted violation: a lost resolution
                continue
            results[str(res.payload)] = _result_record(res)
            if sigterm_after is not None and n_seen == sigterm_after:
                os.kill(os.getpid(), _signal.SIGTERM)
        drain_info = drain.finish()
    return {"yielded": yielded, "results": results, "drain": drain_info,
            "cascade": casc.summary()}


def _ctrl_requests(spec: Dict[str, Any]):
    """The ctrl seed's stream: the cascade stream's deterministic arrays
    with GRADED planted confidences — escalate payloads score 0.35
    (below the 0.5 baseline bar, above the degraded 0.2 bar, so the
    cascade_bar rung genuinely reroutes them), the rest 0.9 — and paced
    arrivals (``pace_s``), so the load wave is the injected stalls, not
    the source."""
    import numpy as np

    from raft_stereo_tpu_torch.runtime.infer import InferRequest

    escalate = set(spec.get("escalate") or [])
    pace = float(spec.get("pace_s") or 0.0)
    for i, si in enumerate(spec["shapes"]):
        if pace:
            time.sleep(pace)
        h, w = SHAPES[si]
        rng = np.random.RandomState(spec["seed"] * 1000 + i)
        a = rng.rand(h, w, 3).astype(np.float32)
        b = rng.rand(h, w, 3).astype(np.float32)
        a[0, 0, 0] = 0.35 if i in escalate else 0.9
        yield InferRequest(payload=i, inputs=(a, b))


def _serve_ctrl(spec: Dict[str, Any], *, sigterm_after: Optional[int] = None,
                drop_one: bool = False, with_controller: bool = False,
                fast_only: bool = False,
                paced: bool = True) -> Dict[str, Any]:
    """One cascade-backed serve of the ctrl seed's paced stream under
    whatever is armed, with the overload controller optionally closing
    the loop. Per-request end-to-end latencies (yield -> resolution,
    typed sheds included — a fast typed rejection IS the graceful-
    degradation payoff) are recorded so the harness can compare the
    controller-on p95 against the controller-off pass on the SAME armed
    wave. The controller snapshot and the live knob values are captured
    BEFORE ``close()`` so the unwind invariant proves the promotion path
    unwound the wave on its own, not the teardown."""
    import signal as _signal

    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.tiers import CascadeServer, TieredServer, TierPolicy

    ts = _toy_tierset(spec)
    casc = CascadeServer(
        ts, threshold=0.5,
        confidence_fn=lambda left, right, disp: float(left[0, 0, 0]),
    )
    serve_fn = (TieredServer(ts, TierPolicy.single("fast")).serve
                if fast_only else casc.serve)
    ctrl = None
    if with_controller:
        from raft_stereo_tpu_torch.runtime.controller import (
            ControllerConfig,
            OverloadController,
        )

        c = spec["ctrl"]
        ctrl = OverloadController(
            schedulers=list(ts.schedulers.values()),
            cascade=casc,
            config=ControllerConfig(
                interval_s=c["interval"], dwell_s=c["dwell"],
                burn_high=c["burn_high"], burn_low=c.get("burn_low"),
                depth_high=c["depth_high"], depth_low=c.get("depth_low"),
            ),
        ).start()
    yielded: List[Any] = []
    t_enq: Dict[str, float] = {}
    lat_ms: Dict[str, float] = {}

    def counted(source):
        for req in source:
            payload = getattr(req, "request", req).payload
            yielded.append(payload)
            t_enq[str(payload)] = time.monotonic()
            yield req

    stream = _ctrl_requests(spec if paced else dict(spec, pace_s=0.0))
    results: Dict[str, Any] = {}
    dropped = False
    try:
        with GracefulShutdown() as shutdown:
            drain = ServeDrain(shutdown, timeout_s=spec["drain_timeout"],
                               label="chaos-ctrl")
            drain.attach(ts)
            n_seen = 0
            for res in serve_fn(counted(drain.wrap_source(stream))):
                drain.note_result(res)
                n_seen += 1
                key = str(res.payload)
                if key in t_enq:
                    lat_ms[key] = 1e3 * (time.monotonic() - t_enq[key])
                if drop_one and res.ok and not dropped:
                    dropped = True  # the planted violation
                    continue
                results[key] = _result_record(res)
                if sigterm_after is not None and n_seen == sigterm_after:
                    os.kill(os.getpid(), _signal.SIGTERM)
            drain_info = drain.finish()
        if ctrl is not None:
            # the calm tail: the wave is over and the queues are drained,
            # so the live sensors read calm — give the promotion path its
            # dwell windows to unwind every rung on its own (bounded; a
            # controller that cannot promote fails the unwind invariant)
            deadline = time.monotonic() + 10.0
            while ctrl.rung > 0 and time.monotonic() < deadline:
                time.sleep(0.05)
        # the live knob state + ladder position at serve end, BEFORE the
        # controller teardown: the unwind invariant must see what the
        # promotion path achieved, not what close() restored
        knobs_end = {
            "cascade_threshold": casc.threshold,
            "max_pending": {name: s.max_pending
                            for name, s in ts.schedulers.items()},
        }
        ctrl_snap = ctrl.snapshot() if ctrl is not None else None
    finally:
        if ctrl is not None:
            ctrl.close()
    lats = sorted(lat_ms.values())
    p95 = lats[max(0, round(0.95 * (len(lats) - 1)))] if lats else None
    return {"yielded": yielded, "results": results, "drain": drain_info,
            "cascade": casc.summary(), "knobs_end": knobs_end,
            "controller": ctrl_snap,
            "p95_ms": p95, "n_latencies": len(lats)}


def _quality_requests(spec: Dict[str, Any]):
    """The quality seed's user stream: one shape, session-tagged (two
    interleaved streams — the warm path must be live for the stale
    plant), deterministic arrays keyed on (seed, index). The ``regress``
    plant is a source-side input-distribution shift from ``plant_at``
    on: outputs drift while the canaries' deterministic inputs — and
    the weights — stay untouched."""
    import numpy as np

    from raft_stereo_tpu_torch.runtime.infer import InferRequest
    from raft_stereo_tpu_torch.runtime.scheduler import SchedRequest

    h, w = SHAPES[0]
    gain = 1.8 if spec["plant"] == "regress" else 1.0
    pace = float(spec.get("pace_s") or 0.0)
    for i in range(spec["n_requests"]):
        if pace and i:
            time.sleep(pace)
        rng = np.random.RandomState(spec["seed"] * 1000 + i)
        a = rng.rand(h, w, 3).astype(np.float32)
        b = rng.rand(h, w, 3).astype(np.float32)
        if i >= spec["plant_at"] and gain != 1.0:
            a = a * np.float32(gain)
        req = InferRequest(payload=i, inputs=(a, b))
        yield SchedRequest(req, session=f"s{i % spec['n_sessions']}")


def _serve_quality(spec: Dict[str, Any], *, sigterm_after: Optional[int],
                   drop_one: bool) -> Dict[str, Any]:
    """One session-sticky toy serve with the quality observatory live:
    drift sentinels fold every user output, golden canaries weave through
    the REAL scheduler/session path at the priority floor, and ONE planted
    silent degradation (see ``make_spec``) must be detected within the
    spec's declared budget — measured in user results after the plant, the
    unit an operator's alarm-latency SLO is written in. The warm-DEPENDENT
    toy forward makes stale session state a genuine output shift, so
    ``RAFT_FI_WARM_POISON`` plants a real degradation, not a cosmetic one.
    The swap plant copies the wrong scale into the served parameter
    (``update_variables``), which a captured graph reads by address."""
    import signal as _signal

    import torch

    from raft_stereo_tpu_torch.runtime import quality
    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler,
        SessionServer,
    )

    dev = _device(spec)
    model = _toy_model(2.0, dev)

    def fn(a, b, warm):
        return (a * model.scale - b).sum(-1, keepdim=True) + 0.05 * warm

    engine = _engine(fn, dev, spec, module=model, eager_finalize=True)
    sched = ContinuousBatchingScheduler(engine, max_wait_s=spec["max_wait_s"])
    session = SessionServer(sched.serve, forward_sched=True)
    q = spec["quality"]
    mon = quality.install(quality.QualityMonitor(quality.QualityConfig(
        window_n=q["window_n"], reference_n=q["reference_n"],
        canary_every=q["canary_every"], canary_latch=q["canary_latch"],
        canary_tol=q["canary_tol"], exact=True, canary_hw=SHAPES[0],
    )))
    detected: Dict[str, int] = {}
    # user_results is monitor-internal ground truth; the latch callback
    # runs under the monitor lock, so it reads the attribute directly
    mon.add_latch_action(
        lambda reason: detected.setdefault("latch_at", mon.user_results))
    yielded: List[Any] = []

    def counted(source):
        # canary payloads are dataclasses — record the str() the report
        # JSON can hold (results are keyed the same way)
        for req in source:
            yielded.append(str(getattr(req, "request", req).payload))
            yield req

    results: Dict[str, Any] = {}
    dropped = False
    planted = False
    try:
        with GracefulShutdown() as shutdown:
            drain = ServeDrain(shutdown, timeout_s=spec["drain_timeout"],
                               label="chaos-quality")
            drain.attach(sched)
            n_seen = 0
            user_seen = 0
            for res in session.serve(counted(drain.wrap_source(
                    quality.weave_canaries(_quality_requests(spec), mon)))):
                drain.note_result(res)
                n_seen += 1
                if not quality.is_canary(res.payload):
                    user_seen += 1
                if spec["plant"] == "swap" and not planted \
                        and user_seen >= spec["plant_at"]:
                    # the wrong-checkpoint swap: same structure, wrong
                    # numbers — no request fails, quality just changes
                    engine.update_variables({"scale": torch.tensor(3.0)})
                    planted = True
                if "drift_at" not in detected and any(
                        t["active"]
                        for t in mon.snapshot()["tiers"].values()):
                    detected["drift_at"] = user_seen
                if drop_one and res.ok and not dropped:
                    dropped = True  # the planted violation
                    continue
                results[str(res.payload)] = _result_record(res)
                if sigterm_after is not None and n_seen == sigterm_after:
                    os.kill(os.getpid(), _signal.SIGTERM)
            drain_info = drain.finish()
        snap = mon.snapshot()
    finally:
        quality.uninstall()
    return {"yielded": yielded, "results": results, "drain": drain_info,
            "quality": snap, "detected": detected,
            "canary_depth_end": sched.snapshot().get("canary_depth")}


def _serve_adaptive(spec: Dict[str, Any], *,
                    sigterm_after: Optional[int],
                    drop_one: bool) -> Dict[str, Any]:
    """One adaptive serve (MADNet2 + AdaptiveServer over the scheduler)
    under whatever is armed — the adapt rails under composition. The
    adapting copy steps with ``torch.optim.Adam`` at 1e-4 (the MAD
    optimizer, no weight decay), the served copy is the engine's module."""
    import copy
    import signal as _signal

    from raft_stereo_tpu_torch.evaluate_mad import make_mad_engine
    from raft_stereo_tpu_torch.models.madnet2 import make_madnet2
    from raft_stereo_tpu_torch.parallel.train_step import TrainState
    from raft_stereo_tpu_torch.runtime import faultinject
    from raft_stereo_tpu_torch.runtime.adapt import (
        AdaptConfig,
        AdaptiveServer,
        AdaptPolicy,
    )
    from raft_stereo_tpu_torch.runtime.infer import InferOptions, InferRequest
    from raft_stereo_tpu_torch.runtime.preemption import GracefulShutdown, ServeDrain
    from raft_stereo_tpu_torch.runtime.scheduler import ContinuousBatchingScheduler
    from raft_stereo_tpu_torch.serve_adaptive import synthetic_frame
    from raft_stereo_tpu_torch.train_mad import fetch_mad_optimizer

    h, w = spec["size"]
    dev = _device(spec)
    model = make_madnet2(seed=0, device=dev).train()
    served = copy.deepcopy(model).eval().requires_grad_(False)
    opt_args = argparse.Namespace(variant="mad", lr=1e-4, wdecay=0.0)
    optimizer, scheduler, _ = fetch_mad_optimizer(opt_args, list(model.parameters()))
    state = TrainState(model, optimizer, scheduler)
    engine = make_mad_engine(
        served, fusion=False,
        infer=InferOptions(batch=spec["batch"], prefetch=1),
    )
    _ENGINES.append(engine)
    sched = ContinuousBatchingScheduler(engine, max_wait_s=1.0)
    yielded: List[Any] = []

    def requests():
        for i in range(spec["n_requests"]):
            yield InferRequest(
                payload=i,
                inputs=lambda i=i: synthetic_frame(spec["seed"] + i, h, w),
            )

    results: Dict[str, Any] = {}
    dropped = False
    with tempfile.TemporaryDirectory() as snap:
        with GracefulShutdown() as shutdown:
            drain = ServeDrain(shutdown, timeout_s=spec["drain_timeout"],
                               label="chaos-adaptive")
            drain.attach(sched)
            server = AdaptiveServer(
                engine, state, snap,
                AdaptConfig(
                    adapt_mode="full",
                    policy=AdaptPolicy(every=spec["adapt_every"]),
                    max_adapt_skips=1, snapshot_every=1, regress_warmup=1,
                ),
                name="chaos",
                stream_fn=sched.serve,
                should_stop=lambda: shutdown.should_stop,
            )

            def counted(source):
                for req in source:
                    yielded.append(req.payload)
                    yield req

            n_seen = 0
            for res in server.serve(counted(drain.wrap_source(requests()))):
                drain.note_result(res)
                n_seen += 1
                if drop_one and res.ok and not dropped:
                    dropped = True
                    continue
                results[str(res.payload)] = _result_record(res)
                if sigterm_after is not None and n_seen == sigterm_after:
                    os.kill(os.getpid(), _signal.SIGTERM)
            drain_info = drain.finish()
        summary = server.summary()
    return {"yielded": yielded, "results": results, "drain": drain_info,
            "adapt_summary": {k: summary[k] for k in
                              ("adapt_steps", "adapt_skips", "regressions",
                               "rollbacks", "failed", "frozen")},
            # injector ground truth: how far the adaptation actually got —
            # a drain or sigterm may legitimately cut a schedule short, so
            # the rails invariants key on ordinals that were REACHED
            "fi": {"adapt_attempts": faultinject.adapt_attempts(),
                   "regress_checks": faultinject.adapt_regress_checks()}}


def _launches() -> Dict[str, Dict[str, int]]:
    """The port's kernel launches in this child: the counters (warm-ups,
    captures and eager calls) and every built engine's replayed launches
    (each graph's launches at capture times its replays)."""
    from raft_stereo_tpu_torch.runtime.infer import kernel_launches

    counted = kernel_launches()
    replayed = {k: 0 for k in counted}
    for engine in _ENGINES:
        for k, n in engine.graphs.replayed_launches.items():
            replayed[k] = replayed.get(k, 0) + n
    return {"counted": counted, "replayed": replayed}


def run_child(spec_path: str) -> int:
    """Child entry point: baseline pass (sched mode), faulted pass with the
    schedule armed + telemetry recorded, thread census, report JSON."""
    import threading

    with open(spec_path) as f:
        spec = json.load(f)
    from raft_stereo_tpu_torch.runtime import faultinject, telemetry

    schedule = spec["schedule"]
    if spec.get("forward") and spec["mode"] != "sched":
        raise ValueError(f"a spec's forward factory serves the sched mode only, not "
                         f"{spec['mode']!r}")
    _device(spec)  # a card asked for and missing fails the trial here
    sigterm_after = next((e["after_results"] for e in schedule
                          if e["kind"] == "sigterm"), None)
    drop_one = any(e["kind"] == "violate_drop_result" for e in schedule)
    report: Dict[str, Any] = {"spec": spec}

    serve = {"sched": _serve_sched, "cascade": _serve_cascade,
             "video": _serve_video, "ctrl": _serve_ctrl,
             "quality": _serve_quality,
             "fleet": _serve_fleet}.get(spec["mode"], _serve_adaptive)
    # the ctrl baselines are pure bit-identity references: unpaced (the
    # arrays are keyed on (seed, index) alone) and UNSHEDDED (blocking
    # backpressure) — an unpaced flood against the overload cap would
    # shed reference payloads and erase their allowed shas
    base_spec = (dict(spec, max_pending=None) if spec["mode"] == "ctrl"
                 else spec)
    if spec["mode"] == "fleet":
        # the fleet's bit-identity reference is a SINGLE-HOST scheduler
        # serve of the same stream (per-request outputs are batch-
        # composition-independent, so fleet completions under any
        # routing/failover must match it byte for byte)
        faultinject.reset()
        report["baseline"] = _serve_sched(
            dict(spec, mode="sched"), sigterm_after=None, drop_one=False)
    elif spec["mode"] in ("sched", "cascade", "video", "ctrl"):
        # fault-free baseline of the same stream (bit-identity reference)
        faultinject.reset()
        kw = {"paced": False} if spec["mode"] == "ctrl" else {}
        report["baseline"] = serve(base_spec, sigterm_after=None,
                                   drop_one=False, **kw)
    if spec["mode"] in ("cascade", "ctrl"):
        # the fast tier alone, fault-free: the SECOND allowed sha per
        # payload — a faulted escalation falls back to the fast result,
        # and a ctrl run's lowered bar legitimately accepts from fast
        faultinject.reset()
        fast_serve = _serve_cascade if spec["mode"] == "cascade" \
            else _serve_ctrl
        kw = {"paced": False} if spec["mode"] == "ctrl" else {}
        report["baseline_fast"] = fast_serve(
            base_spec, sigterm_after=None, drop_one=False, fast_only=True,
            **kw)
    if spec["mode"] == "ctrl":
        # the controller-OFF overload pass: the SAME armed wave, paced
        # arrivals, no controller — the p95 baseline the strictly-better
        # invariant compares against
        faultinject.reset()
        _arm_schedule(schedule)
        report["ctrl_off"] = _serve_ctrl(
            spec, sigterm_after=None, drop_one=False, with_controller=False)

    faultinject.reset()
    _arm_schedule(schedule)
    tel_dir = spec["telemetry_dir"]
    tel = telemetry.install(telemetry.Telemetry(tel_dir))
    if spec.get("slo"):
        # the controller's burn sensor reads the telemetry's SLO tracker
        tel.configure_slo(spec["slo"]["p95_ms"], spec["slo"]["budget"])
    # crash forensics: the faulted pass runs under a blackbox dumper
    # (hang -> watchdog trip and SIGTERM -> drain both leave a
    # blackbox.json the invariants check) and a live debug server whose
    # /healthz must answer while the trial serves — and whose thread must
    # NOT survive the trial (thread-leak invariant below)
    from raft_stereo_tpu_torch.runtime import blackbox
    from raft_stereo_tpu_torch.runtime.debug_server import DebugServer

    bb = blackbox.install(blackbox.BlackboxDumper(tel_dir))
    debug = DebugServer(0).start()
    try:
        if spec["mode"] == "ctrl":
            # the controller-ON pass: same wave, loop closed
            report["faulted"] = _serve_ctrl(
                spec, sigterm_after=sigterm_after, drop_one=drop_one,
                with_controller=True)
            report["p95_off_ms"] = (report.get("ctrl_off") or {}).get(
                "p95_ms")
            report["p95_on_ms"] = report["faulted"].get("p95_ms")
        else:
            report["faulted"] = serve(spec, sigterm_after=sigterm_after,
                                      drop_one=drop_one)
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{debug.port}/healthz", timeout=5) as r:
                report["debug_healthz"] = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 — a wedged/dead debug server
            # must surface as the debug_server invariant's OWN diagnosis,
            # not as a misattributed child crash
            report["debug_healthz"] = {"ok": False,
                                       "error": f"{type(e).__name__}: {e}"}
    finally:
        debug.close()
        # dumper closes (flushing any pending dump) BEFORE the telemetry
        # sink so its blackbox_dump event reaches events.jsonl
        blackbox.uninstall(bb)
        telemetry.uninstall(tel)
        # release any wait worker an injected hang parked (test-cleanup
        # contract; the abandoned daemon thread then idles, counted below)
        faultinject.reset()

    report["launches"] = _launches()
    report["engines"] = [{"tier": e.tier_label, "capture": e.capture,
                          **{k: getattr(e.stats, k) for k in (
                              "images", "failed", "batches", "compiles", "retries",
                              "degraded", "circuits_open", "watchdog_trips")}}
                         for e in _ENGINES]
    time.sleep(0.2)  # let released/joining threads settle before census
    alive = [t.name for t in threading.enumerate()
             if t.is_alive() and t is not threading.main_thread()]
    report["threads"] = {
        "alive": alive,
        "stager_alive": sum(1 for n in alive if n == "infer-stager"),
        "admit_alive": sum(1 for n in alive if n == "sched-admit"),
        "session_alive": sum(1 for n in alive if n == "session-router"),
        "wait_workers": sum(1 for n in alive if n == "infer-device-wait"),
        "debug_alive": sum(1 for n in alive if n == "debug-server"),
        "dumper_alive": sum(1 for n in alive if n == "blackbox-dump"),
        "ctrl_alive": sum(1 for n in alive if n == "overload-ctrl"),
        "fleet_alive": sum(1 for n in alive if n.startswith("fleet-")),
    }
    with open(spec["report_path"], "w") as f:
        json.dump(report, f, indent=1)
    return 0


# -------------------------------------------------------------- invariants


def check_invariants(spec: Dict[str, Any], report: Dict[str, Any],
                     rc: int, events: List[Dict[str, Any]],
                     schema: Dict[str, tuple],
                     reserved: set) -> List[str]:
    """All global invariants over one finished trial; returns violation
    strings (empty = seed passed). The JAX tool's checks, verbatim."""
    violations: List[str] = []
    schedule = spec["schedule"]
    if rc != 0:
        violations.append(f"clean_exit: child exited {rc}")
        return violations  # a dead child's report is not to be trusted
    faulted = report.get("faulted") or {}
    results: Dict[str, Any] = faulted.get("results") or {}
    yielded = faulted.get("yielded") or []

    # resolve exactly once
    if len(set(map(str, yielded))) != len(yielded):
        violations.append("resolve_exactly_once: duplicate source payloads")
    missing = [p for p in map(str, yielded) if p not in results]
    if missing:
        violations.append(
            f"resolve_exactly_once: {len(missing)} yielded request(s) never "
            f"resolved: {missing[:5]}")
    extra = [p for p in results if p not in set(map(str, yielded))]
    if extra:
        violations.append(
            f"resolve_exactly_once: {len(extra)} result(s) for requests "
            f"never yielded: {extra[:5]}")

    # bit identity vs the fault-free baseline (sched + cascade modes).
    # Cascade runs carry a second reference: a faulted escalation may
    # legitimately FALL BACK to the fast tier's (bit-exact) result, so a
    # completed output must match the fault-free cascade sha OR the
    # fault-free fast-only sha — anything else is corruption.
    baseline = (report.get("baseline") or {}).get("results") or {}
    alt = (report.get("baseline_fast") or {}).get("results") or {}
    for p, rec in results.items():
        if rec.get("ok") and baseline.get(p, {}).get("ok"):
            allowed = {baseline[p]["sha"]}
            if alt.get(p, {}).get("ok"):
                allowed.add(alt[p]["sha"])
            if rec["sha"] not in allowed:
                violations.append(
                    f"bit_identity: request {p} output differs from the "
                    f"fault-free run ({rec['sha']} not in "
                    f"{sorted(allowed)})")

    # failure budget: every error typed + non-lifecycle failures bounded.
    # Fleet seeds budget at HOST granularity: a killed/hung/drained-away
    # host may lose its whole in-flight window as typed FleetHostError
    # results, but a schedule with no host fault may lose NOTHING.
    injected_decode = sum(len(e.get("ordinals", []))
                          for e in schedule if e["kind"] == "decode_fail")
    injected_hang = sum(len(e.get("ordinals", []))
                        for e in schedule if e["kind"] == "hang")
    host_faults = [e for e in schedule
                   if e["kind"] in ("host_kill", "host_hang",
                                    "drain_during_failover")]
    budget = injected_decode + injected_hang * spec.get("batch", 1)
    fault_etypes = set(FAULT_ETYPES)
    if spec["mode"] == "fleet":
        fault_etypes.add("FleetHostError")
        budget = spec["n_requests"] if host_faults else 0
    hard_failures = 0
    for p, rec in results.items():
        if rec.get("ok"):
            continue
        etype = rec.get("etype", "?")
        if etype in LIFECYCLE_ETYPES:
            continue
        if etype not in fault_etypes:
            violations.append(
                f"failure_budget: request {p} failed with unexpected "
                f"error type {etype}")
        hard_failures += 1
    if hard_failures > budget:
        violations.append(
            f"failure_budget: {hard_failures} hard failure(s) exceed the "
            f"injected-fault budget of {budget}")

    # lifecycle rejections only when the lifecycle was exercised
    lifecycle = [p for p, rec in results.items()
                 if not rec.get("ok")
                 and rec.get("etype") in LIFECYCLE_ETYPES]
    lifecycle_armed = (
        any(e["kind"] in ("sigterm", "sched_stall",
                          "drain_during_failover") for e in schedule)
        or spec.get("max_pending") is not None)
    if lifecycle and not lifecycle_armed:
        violations.append(
            f"failure_budget: {len(lifecycle)} shed/drained result(s) with "
            "no overload or drain in the schedule")

    # telemetry conformance
    for ev in events:
        name = ev.get("event")
        if name not in schema:
            violations.append(f"telemetry_schema: undeclared event {name!r}")
            continue
        bad = [k for k in ev if k not in reserved and k not in schema[name]]
        if bad:
            violations.append(
                f"telemetry_schema: event {name!r} carries undeclared "
                f"key(s) {bad}")

    # thread hygiene
    threads = report.get("threads") or {}
    if threads.get("stager_alive") or threads.get("admit_alive") \
            or threads.get("session_alive"):
        violations.append(
            f"thread_leak: stager/admission/session thread(s) still alive "
            f"at exit: {threads.get('alive')}")
    if threads.get("wait_workers", 0) > injected_hang:
        violations.append(
            f"thread_leak: {threads['wait_workers']} watchdog wait "
            f"worker(s) alive, only {injected_hang} hang(s) injected")
    if threads.get("debug_alive") or threads.get("dumper_alive"):
        violations.append(
            "thread_leak: introspection thread(s) (debug-server / "
            "blackbox-dump) survived the trial: "
            f"{threads.get('alive')}")

    # crash forensics: any trial that tripped the watchdog or began a
    # drain must leave a blackbox.json with real coverage — nonzero
    # role-annotated thread stacks and ring events. Keyed on the EVENTS
    # that fired (a hang ordinal past the stream's end legitimately dumps
    # nothing). The debug server's /healthz must have answered during the
    # trial.
    forensic = [ev for ev in events
                if ev.get("event") in ("watchdog_trip", "drain_begin")]
    if forensic:
        bb_path = os.path.join(spec.get("telemetry_dir", ""),
                               "blackbox.json")
        try:
            with open(bb_path) as f:
                bb = json.load(f)
        except (OSError, ValueError):
            bb = None
        if not isinstance(bb, dict):
            violations.append(
                f"blackbox: {len(forensic)} forensic trigger event(s) "
                "fired but no readable blackbox.json was produced")
        else:
            if not bb.get("threads"):
                violations.append(
                    "blackbox: dump has no thread stacks")
            elif not any(t.get("role") not in (None, "?")
                         for t in bb["threads"]):
                violations.append(
                    "blackbox: no thread stack carries a known role")
            if not (bb.get("ring") or {}).get("events"):
                violations.append("blackbox: dump has an empty event ring")
    healthz = report.get("debug_healthz")
    if rc == 0 and report.get("faulted") is not None and (
            not isinstance(healthz, dict) or not healthz.get("ok")):
        violations.append(
            "debug_server: /healthz did not answer ok during the trial")

    # adaptive rails actually fired when their fault was REACHED: a drain
    # may legitimately cut adaptation short, so the requirement keys on
    # the injector ground-truth counters the child recorded
    adapt = (report.get("faulted") or {}).get("adapt_summary")
    if adapt is not None:
        fi = (report.get("faulted") or {}).get("fi") or {}
        if adapt.get("failed"):
            violations.append(
                f"failure_budget: adaptive run failed "
                f"{adapt['failed']} inference request(s)")
        nan_ords = [o for e in schedule if e["kind"] == "adapt_nan"
                    for o in e["ordinals"]]
        if any(o <= fi.get("adapt_attempts", 0) for o in nan_ords) \
                and not adapt.get("adapt_skips"):
            violations.append(
                "rails: adapt_nan reached but the guard never skipped")
        regress_ords = [o for e in schedule if e["kind"] == "adapt_regress"
                        for o in e["ordinals"]]
        # ordinal 1 only seeds the warmed-up-on-one-observation monitor
        if any(2 <= o <= fi.get("regress_checks", 0)
               for o in regress_ords) \
                and not (adapt.get("regressions") or adapt.get("rollbacks")):
            violations.append(
                "rails: adapt_regress reached but no regression/rollback "
                "fired")

    # the quality-observatory contract (quality seeds): a planted silent
    # degradation — one that fails no request and raises no error — must
    # be DETECTED within the spec's declared budget (user results after
    # the plant), by the detector that owns it: the canary latch for a
    # weight swap, the drift sentinel for an output-distribution shift
    # (input regress / stale warm reuse). Plants that never touch the
    # weights must not fail a single canary (the canary false-positive
    # bound), and the fault-free plant must raise NOTHING (the
    # zero-false-alarm bound). Canaries must also leave the scheduler's
    # canary census at zero — none parked, none leaked.
    if spec["mode"] == "quality":
        plant = spec.get("plant")
        plant_at = int(spec.get("plant_at") or 0)
        bound = spec.get("detect_within")
        detected = faulted.get("detected") or {}
        qsnap = faulted.get("quality") or {}
        canaries = qsnap.get("canaries") or {}
        drift_raises = [ev for ev in events
                        if ev.get("event") == "quality_drift"
                        and ev.get("state") == "raise"]
        latches = [ev for ev in events if ev.get("event") == "canary_latch"]
        if plant == "none":
            if drift_raises:
                violations.append(
                    f"quality_false_alarm: fault-free run raised "
                    f"quality_drift {len(drift_raises)} time(s)")
            if canaries.get("failures"):
                violations.append(
                    f"quality_false_alarm: fault-free run failed "
                    f"{canaries['failures']} canary check(s)")
            if latches:
                violations.append(
                    "quality_false_alarm: fault-free run latched the "
                    "canary guard")
        elif plant == "swap":
            if not latches:
                violations.append(
                    "quality_detect: wrong-checkpoint swap never latched "
                    f"the canary guard ({canaries.get('failures', 0)} "
                    f"canary failure(s) recorded)")
            elif "latch_at" in detected \
                    and detected["latch_at"] - plant_at > bound:
                violations.append(
                    f"quality_detect: canary latch took "
                    f"{detected['latch_at'] - plant_at} user results "
                    f"(budget {bound})")
        elif plant in ("regress", "stale"):
            if not drift_raises:
                violations.append(
                    f"quality_detect: planted {plant} degradation never "
                    "raised quality_drift")
            elif "drift_at" in detected \
                    and detected["drift_at"] - plant_at > bound:
                violations.append(
                    f"quality_detect: drift raise took "
                    f"{detected['drift_at'] - plant_at} user results "
                    f"(budget {bound})")
            if canaries.get("failures"):
                violations.append(
                    f"quality_canary_fp: {plant} plant touches no weights "
                    f"but {canaries['failures']} canary check(s) failed")
        if faulted.get("canary_depth_end"):
            violations.append(
                f"quality_canary_leak: {faulted['canary_depth_end']} "
                "canary request(s) still pending at serve end")

    # the overload-controller contract (ctrl seeds): the wave must degrade
    # and the calm tail must promote; every ladder step is +-1 from the
    # running position; every actuation stays inside its declared bound;
    # the promotion path (not the teardown) unwinds every rung and
    # restores every knob; and closing the loop must buy p95 strictly
    # better than the controller-off pass on the SAME wave.
    if spec["mode"] == "ctrl":
        ladder_events = [
            ev for ev in events
            if ev.get("event") in ("ctrl_degrade", "ctrl_promote")]
        degrades = [ev for ev in ladder_events
                    if ev["event"] == "ctrl_degrade"]
        promotes = [ev for ev in ladder_events
                    if ev["event"] == "ctrl_promote"]
        if not degrades:
            violations.append(
                "ctrl: the load wave never triggered a ctrl_degrade")
        if not promotes:
            violations.append(
                "ctrl: the controller never promoted back after the wave")
        pos = 0
        for ev in ladder_events:
            step = 1 if ev["event"] == "ctrl_degrade" else -1
            if ev.get("from_rung") != pos or ev.get("rung") != pos + step:
                violations.append(
                    f"ctrl_monotone: {ev['event']} stepped "
                    f"{ev.get('from_rung')}->{ev.get('rung')} while the "
                    f"ladder stood at rung {pos}")
                break
            pos = ev["rung"]
        for ev in ladder_events:
            v, lo, hi = ev.get("value"), ev.get("lo"), ev.get("hi")
            if v is None or lo is None or hi is None \
                    or not (lo <= v <= hi):
                violations.append(
                    f"ctrl_bounds: {ev['event']} actuated "
                    f"{ev.get('knob')}={v} outside its declared "
                    f"[{lo}, {hi}]")
        snap = faulted.get("controller") or {}
        if snap.get("rung") != 0 or snap.get("forced_restores"):
            violations.append(
                f"ctrl_unwind: serve ended at rung {snap.get('rung')} "
                f"with {snap.get('forced_restores')} forced restore(s) — "
                "the promotion path did not fully unwind the wave")
        knobs = faulted.get("knobs_end") or {}
        if knobs.get("cascade_threshold") != 0.5:
            violations.append(
                f"ctrl_unwind: cascade threshold ended at "
                f"{knobs.get('cascade_threshold')} (baseline 0.5)")
        bad_caps = {name: v
                    for name, v in (knobs.get("max_pending") or {}).items()
                    if v != spec.get("max_pending")}
        if bad_caps:
            violations.append(
                f"ctrl_unwind: max_pending ended at {bad_caps} (baseline "
                f"{spec.get('max_pending')})")
        p95_off = report.get("p95_off_ms")
        p95_on = report.get("p95_on_ms")
        if p95_off is None or p95_on is None or not p95_on < p95_off:
            violations.append(
                f"ctrl_p95: controller-on p95 {p95_on}ms is not strictly "
                f"better than controller-off {p95_off}ms under the same "
                "wave")
        if threads.get("ctrl_alive"):
            violations.append(
                "thread_leak: overload-ctrl thread survived the trial")

    # the replica-fleet contract (fleet seeds): zero double resolutions
    # (the generation fence is the mechanism under test — the per-payload
    # resolution counts are its ground truth), every host fault observably
    # declared down, every down-with-inflight followed by a failover
    # decision, a health blackhole opens the circuit, a
    # drain-during-failover leaves its drain bracket, and no router thread
    # outlives the trial.
    if spec["mode"] == "fleet":
        dups = faulted.get("dups") or {}
        if dups:
            violations.append(
                f"resolve_exactly_once: {len(dups)} request(s) resolved "
                f"more than once (generation fence breached): "
                f"{sorted(dups.items())[:5]}")
        down_events = [ev for ev in events
                       if ev.get("event") == "fleet_host_down"]
        failover_events = [ev for ev in events
                           if ev.get("event") == "fleet_failover"]
        circuit_opens = [ev for ev in events
                         if ev.get("event") == "fleet_circuit_open"
                         and ev.get("state") == "open"]
        fleet_drains = [ev for ev in events
                        if ev.get("event") == "fleet_drain"]
        if host_faults and not down_events:
            violations.append(
                f"fleet: {len(host_faults)} host fault(s) fired but no "
                "fleet_host_down event was emitted")
        if any(ev.get("inflight") for ev in down_events) \
                and not failover_events:
            violations.append(
                "fleet: a host went down with requests in flight but no "
                "fleet_failover decision was emitted")
        if any(e["kind"] == "health_blackhole" for e in schedule) \
                and not (circuit_opens or down_events):
            violations.append(
                "fleet: health blackhole armed but the circuit never "
                "opened and the host was never declared down")
        if any(e["kind"] == "drain_during_failover" for e in schedule):
            phases = {ev.get("phase") for ev in fleet_drains
                      if ev.get("host") is None}
            if not {"begin", "complete"} <= phases:
                violations.append(
                    f"fleet: drain-during-failover armed but the fleet "
                    f"drain bracket is incomplete (phases: "
                    f"{sorted(p for p in phases if p)})")
        if threads.get("fleet_alive"):
            violations.append(
                f"thread_leak: {threads['fleet_alive']} fleet router "
                f"thread(s) survived the trial: {threads.get('alive')}")
    return violations


# ------------------------------------------------------------ orchestration


def run_trial(spec: Dict[str, Any], out_dir: str,
              device: str = "cuda") -> Tuple[List[str], int]:
    """Run one spec in a child process on ``device`` and check every
    invariant."""
    from raft_stereo_tpu_torch.runtime.telemetry import EVENT_SCHEMA, RESERVED_KEYS

    os.makedirs(out_dir, exist_ok=True)
    tag = f"seed{spec['seed']}_{int(time.time() * 1e3) % 100000}"
    spec = dict(spec, device=str(device))
    spec["telemetry_dir"] = os.path.join(out_dir, f"tel_{tag}")
    spec["report_path"] = os.path.join(out_dir, f"report_{tag}.json")
    spec_path = os.path.join(out_dir, f"spec_{tag}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + (os.pathsep + env["PYTHONPATH"]
                                      if env.get("PYTHONPATH") else "")
    # injector env vars must not leak into the trial: the schedule is the
    # single source of faults
    for k in list(env):
        if k.startswith("RAFT_FI_"):
            env.pop(k)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", MODULE, "--child", spec_path],
            env=env, timeout=CHILD_TIMEOUT_S,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        rc = proc.returncode
        tail = proc.stdout.decode(errors="replace")[-2000:]
    except subprocess.TimeoutExpired:
        rc, tail = 124, "<child timed out>"
    wall = time.monotonic() - t0
    report: Dict[str, Any] = {}
    try:
        with open(spec["report_path"]) as f:
            report = json.load(f)
    except (OSError, ValueError):
        pass
    events: List[Dict[str, Any]] = []
    try:
        with open(os.path.join(spec["telemetry_dir"], "events.jsonl")) as f:
            events = [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError):
        pass
    violations = check_invariants(spec, report, rc, events, EVENT_SCHEMA,
                                  set(RESERVED_KEYS))
    if rc != 0 and tail:
        violations.append(f"child_output_tail: {tail[-500:]}")
    print(f"[chaos] seed {spec['seed']} ({spec['mode']}): "
          f"{'PASS' if not violations else 'FAIL'} in {wall:.1f}s "
          f"({len(spec['schedule'])} fault(s))")
    return violations, rc


def minimize_schedule(spec: Dict[str, Any], out_dir: str,
                      run=run_trial) -> List[Dict[str, Any]]:
    """Greedy ddmin over the fault schedule: repeatedly drop any entry
    whose removal keeps the trial failing. Returns the minimal failing
    schedule (possibly the original)."""
    schedule = list(spec["schedule"])
    changed = True
    while changed and len(schedule) > 1:
        changed = False
        for i in range(len(schedule)):
            candidate = schedule[:i] + schedule[i + 1:]
            trial = dict(spec, schedule=candidate)
            violations, _rc = run(trial, out_dir)
            if violations:
                schedule = candidate
                changed = True
                break
    return schedule


def run_campaign(seeds: List[int], out_dir: str, *,
                 violate: bool = False,
                 adaptive_every: int = 10,
                 cascade_every: int = 5,
                 video_every: int = 7,
                 ctrl_every: int = 9,
                 quality_every: int = 11,
                 fleet_every: int = 13,
                 minimize: bool = True,
                 device: str = "cuda") -> Dict[str, Any]:
    os.makedirs(out_dir, exist_ok=True)
    run = functools.partial(run_trial, device=device)
    summary: Dict[str, Any] = {
        "seeds": seeds, "passed": 0, "failed": [], "trials": [],
    }
    for seed in seeds:
        spec = make_spec(seed, adaptive_every=adaptive_every,
                         cascade_every=cascade_every,
                         video_every=video_every,
                         ctrl_every=ctrl_every,
                         quality_every=quality_every,
                         fleet_every=fleet_every,
                         violate=violate)
        violations, rc = run(spec, out_dir)
        trial = {"seed": seed, "mode": spec["mode"],
                 "faults": [e["kind"] for e in spec["schedule"]],
                 "violations": violations}
        summary["trials"].append(trial)
        if not violations:
            summary["passed"] += 1
            continue
        entry: Dict[str, Any] = {"seed": seed, "violations": violations}
        if minimize:
            minimal = minimize_schedule(spec, out_dir, run=run)
            entry["minimal_schedule"] = minimal
            repro = dict(spec, schedule=minimal, device=str(device))
            entry["repro"] = (
                f"python -m {MODULE} --out chaos_repro --repro "
                f"'{json.dumps(repro)}'")
            print(f"[chaos] seed {seed} FAILED — minimal repro schedule "
                  f"({len(minimal)} fault(s)):")
            print(json.dumps(minimal, indent=1))
            print(f"[chaos] repro: {entry['repro']}")
        summary["failed"].append(entry)
    summary["ok"] = not summary["failed"]
    with open(os.path.join(out_dir, "chaos.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[chaos] campaign: {summary['passed']}/{len(seeds)} seed(s) "
          f"passed -> {os.path.join(out_dir, 'chaos.json')}")
    return summary


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(
        description="Seeded chaos campaigns over the port's serving lifecycle "
        "(see README 'Serving lifecycle')."
    )
    ap.add_argument("--seeds", type=int, default=None,
                    help="campaign over seeds 0..N-1")
    ap.add_argument("--seed", type=int, default=None, help="one seed")
    ap.add_argument("--out", default="chaos_out",
                    help="output dir (chaos.json + per-trial artifacts)")
    ap.add_argument("--repro", default=None, metavar="SPEC_JSON",
                    help="run one exact spec (the printed repro)")
    ap.add_argument("--violate", action="store_true",
                    help="plant an intentional invariant violation "
                    "(harness self-test: must be caught and minimized)")
    ap.add_argument("--adaptive_every", type=int, default=10,
                    help="every Nth seed runs the adaptive-serving trial "
                    "(slower; 0 disables)")
    ap.add_argument("--cascade_every", type=int, default=5,
                    help="every Nth seed serves through the confidence-"
                    "gated CascadeServer (runtime.tiers; 0 disables)")
    ap.add_argument("--video_every", type=int, default=7,
                    help="every Nth seed serves session-tagged video "
                    "streams through the SessionServer (warm-state "
                    "resets, parked-frame drains; 0 disables)")
    ap.add_argument("--ctrl_every", type=int, default=9,
                    help="every Nth seed drives a seeded load wave "
                    "through the overload controller (runtime.controller) "
                    "and checks the control-law contract: ladder "
                    "monotonicity, bounded actuation, full unwind, p95 "
                    "strictly better than controller-off on the same wave "
                    "(0 disables)")
    ap.add_argument("--quality_every", type=int, default=11,
                    help="every Nth seed runs the quality-observatory "
                    "trial (runtime.quality): one planted silent "
                    "degradation — wrong-checkpoint swap, output "
                    "regression, stale warm reuse, or none — must be "
                    "detected within the declared budget, with zero "
                    "false alarms on the fault-free plant (0 disables)")
    ap.add_argument("--fleet_every", type=int, default=13,
                    help="every Nth seed runs a 2-host replica-fleet "
                    "trial (runtime.fleet): host SIGKILL mid-batch, "
                    "host hang, health-endpoint blackhole or drain-"
                    "during-failover, asserting exactly-once resolution "
                    "under generation fencing (0 disables; 1 forces "
                    "every seed onto the fleet)")
    ap.add_argument("--no_minimize", action="store_true",
                    help="skip schedule bisection on failures")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return run_child(args.child)
    if args.repro:
        spec = json.loads(args.repro)
        violations, rc = run_trial(spec, args.out,
                                   device=spec.get("device") or device)
        for v in violations:
            print(f"[chaos] violation: {v}")
        return 1 if violations else 0
    if args.seed is not None:
        seeds = [args.seed]
    else:
        seeds = list(range(args.seeds if args.seeds is not None else 3))
    summary = run_campaign(
        seeds, args.out, violate=args.violate,
        adaptive_every=args.adaptive_every,
        cascade_every=args.cascade_every,
        video_every=args.video_every,
        ctrl_every=args.ctrl_every,
        quality_every=args.quality_every,
        fleet_every=args.fleet_every,
        minimize=not args.no_minimize,
        device=device,
    )
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

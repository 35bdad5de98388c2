"""Batched inference engine, with each forward captured once per (bucket,
batch) as a CUDA graph (PyTorch port of ``raft_stereo_tpu/runtime/infer.py``:
its plain engine, its fault tolerance and its telemetry).

  * **Shape buckets.** Pairs are grouped by their padded shape, H and W
    rounded up to multiples of ``divis_by`` (``ops.pad.bucket_shape``; 32,
    the RAFT-Stereo family's, by default; MADNet2 serves at 128). Each
    member of a bucket is edge-padded with its own offsets, the bytes the
    per-image ``InputPadder`` gives it at that divisor, so one captured
    forward serves the bucket and results unpad per item.
  * **Fixed micro-batches.** A bucket packs into micro-batches of exactly
    ``batch`` items. A partial batch is filled up by replicating its last
    item and carries a validity count, so the filler never surfaces and the
    batch runs the same graph as a full one.
  * **One captured forward per (bucket, batch)** in a ``GraphCache``, the
    counterpart of the JAX package's ``AOTCache``: on the first batch of a
    key the forward runs once eagerly (which builds the kernels and settles
    every lazy choice), is captured into a ``torch.cuda.CUDAGraph``, and
    every batch of the key then replays it. This warm-up and capture is the
    engine's "compile". On the CPU, or with ``capture=False``, each batch
    runs the forward eagerly and a key's compile is its first use.
  * **A stager thread** decodes (a request's lazy ``inputs`` callable),
    accounts buckets and pads batch N+1 on the host while batch N
    computes, behind a queue of ``prefetch_depth`` batches. Each input slot
    is edge-padded straight into its batch buffer, one host copy a pixel
    (``BatchPadder.bands``), the bands of rows of all slots spread over a
    few threads (``STAGE_THREADS``). On the card that buffer is
    page-locked and reused (``_HostBuffers``): each slot keeps a ring of
    ``prefetch_depth + 3`` buffers of the largest batch it has staged,
    allocated when a batch outgrows them (a page-locked allocation waits
    for the card, so one made while it computes stalls the stager for a
    whole batch), and a buffer goes back to its ring once its batch's
    copies have completed; however many buckets a stream visits, a slot
    holds that many buffers. Before it stages a batch, the stager lets the
    card finish copying in the inputs of the batch last dispatched
    (``_yield_to_input_copy``, at most ``STAGE_YIELD_S``): both move bytes
    through host memory, and the copy is on the card's critical path. The
    stager's allocations and event queries cannot break a capture, which
    records in thread-local mode. The dispatch thread copies
    the staged inputs to the card on its own stream (a batch staged in
    pageable memory, a degraded sub-batch, is pinned there first:
    ``dispatch.pin``), replays, and copies the output into pinned host
    memory on the same stream; it keeps one dispatch in flight, so the host
    work on batch N's results overlaps batch N+1's compute. With
    ``copy_ahead`` a replay's host-to-card copy runs on a copy stream into
    the graph's landing buffers, as soon as the replay before has read
    them, so it overlaps that replay's compute, and the dispatch stream
    moves them card to card into the static inputs: for a forward short
    against its inputs' copy (MADNet2's, ~25 ms a 2048x2944 pair against
    ~3.3 ms of copy), at one batch of inputs more on the card.

**Fault tolerance**, the JAX engine's contract:

  * **Per-request isolation.** A decode, validation or staging failure
    becomes an ``InferResult`` whose ``error`` is set (``request_failed``),
    and the stream goes on. The stager puts its end-of-stream sentinel in
    ``finally``, so a dying stager surfaces at the consumer.
  * **Deadlines and a watchdog.** ``deadline_s`` bounds both waits the
    consumer can block on: a stager that stages nothing for that long fails
    the stream with ``InferStallError``, and a device wait (the wait on the
    batch's output copy) runs on a ``_WaitWorker`` thread, so a batch whose
    wait passes the deadline fails with ``watchdog_trip`` and the stream
    goes on; the wedged worker is abandoned for a fresh one. The watchdog
    fails the batch; it cannot cancel work a card has hung on.
  * **Retries and the circuit breaker.** A failed compile (warm-up or
    capture) or dispatch retries with exponential backoff (``retries``,
    ``infer_retry``). A bucket that keeps failing is circuit-broken
    (``bucket_circuit_open``) for the engine's life: its batches are served
    by the degraded path, one pair at a time, eagerly, on the same card and
    through the same kernels (``infer_degraded``).
  * **OOM halving.** A ``torch.cuda.OutOfMemoryError`` (at warm-up, capture,
    replay or wait) halves the micro-batch until it fits: the sub-batches
    run as graphs of the key (bucket, B/2), and the size that fit is kept as
    the bucket's cap, so later batches dispatch straight at it. A failed
    warm-up or capture leaves no entry in the ``GraphCache``.
  * **Fault injection.** ``RAFT_FI_INFER_DECODE_FAIL``, ``_COMPILE_FAIL``,
    ``_OOM`` and ``_HANG`` (``runtime.faultinject``) drive each path.

**The spatial tier.** An engine given ``spatial`` (a device list,
``parallel.mesh.spatial_mesh``) serves a forward that splits each batch's
rows over those devices (``models/raft_stereo_spatial.py``): batches are
staged to the first device and the forward shards them. Buckets pad H to
``divis_h = lcm(divis_by, num_spatial)`` (``ops.pad.spatial_divis``), as
the JAX engine pads a spatial mesh's buckets; with one shard that is
``divis_by`` and the buckets are the plain engine's. With every shard on
one device the forward is captured as any other; with shards on several
cards it runs eagerly, since one CUDA graph holds one device's work.

**The graph store** (``aot_dir``, ``runtime/aot_store.py``; the JAX
engine's persistent executable store). After each new key's ``_compile``
on the serving path the engine commits the key's capture recipe
(store-through, best-effort). An engine built on a populated store lists
the entries of its own identity (``store_identity``) and, newest first and
at most ``max_executables`` of them, captures each on zero-filled static
inputs through the same path as a first batch, before the constructor
returns (``_prewarm``): a prewarmed key emits ``aot_store_hit``, no
``bucket_compile``, and counts in ``stats.prewarmed``, never in
``stats.compiles``. A prewarm that raises leaves the entry on disk and the
key to compile on first use. The store key holds only process-stable
fields: never ``graph_key``, which holds ``id(model)``, and never a repr
with an address (``_forward_signature`` walks bytecode). A key that an OOM
halving captures (``_run_degraded``) is not stored.

**Serving hooks.** ``eager_finalize`` finalises the held dispatch as soon
as the stager queue is empty (a video session's next frame depends on this
result); ``idle_watchdog=False`` keeps the deadline on device waits but lets
a long-lived feed stay idle; ``update_variables`` swaps the served weights
in place, so every captured graph serves the new values; the engine
registers its ``snapshot`` with the installed blackbox dumper as
``engine:<tier>``, requests a dump on a watchdog trip and on a stream's
death, and passes every completed result to the quality observatory
(``runtime/quality.py``; canaries are kept out of the SLO accounting).

**Observability.** Every request carries a ``trace_id`` (the caller's or a
fresh one), which rides its spans and every event on its path
(``bucket_compile``, ``infer_batch_commit``, ``infer_retry``,
``bucket_circuit_open``, ``infer_degraded``, ``watchdog_trip``,
``request_failed``, ``stager_underrun``) and its result. ``InferStats.latency``
holds per-bucket ``LogHistogram``s of queue wait, decode, h2d, device and end
to end, fed to the installed telemetry registry too; ``publish_summary``
prints the completed/failed/degraded line and emits ``stream_summary``.
Spans, on the profiler's clock (``runtime/telemetry.py``): the stager's
``request_source`` (the caller's iterator), ``request_decode`` and
``h2d_stage``; the consumer's ``decode_wait``, ``dispatch`` (with
``bucket_compile`` and its ``graph.warmup`` and ``graph.capture`` the
first time, and ``dispatch.pin``, counted in ``InferStats.pin_s``),
``device_batch`` and ``device_wait``. Each span of a batch carries its
number (``batch``), so one batch's spans join across the two threads. With
a sink installed the forward's stage marks are armed: each full batch's
device ms by model stage lands in ``InferStats.stage_ms`` and the
``infer_stage_device_seconds{stage,bucket}`` histogram.

Results stream in micro-batch completion order: buckets interleave, and
within a batch the request order is kept. Each result carries its request's
``payload``.

Kernel launches. The kernels' ``LAUNCHES`` counters count wrapper calls,
so a replay does not move them: they count the warm-up's launches and the
capture's, and every eager launch (the degraded path). ``GraphCache``
records each graph's launches at capture and sums, over replays, the
launches the card ran (``replayed_launches``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import itertools
import logging
import math
import os
import queue
import threading
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.experiments import packed_conv
from raft_stereo_tpu_torch.ops import alt_corr, fused_update
from raft_stereo_tpu_torch.ops.pad import BatchPadder, bucket_shape, spatial_divis
from raft_stereo_tpu_torch.runtime import blackbox, faultinject, quality, telemetry

logger = logging.getLogger(__name__)

_END = object()  # stager sentinel: the request stream is exhausted
_NOT_STAGED = object()  # eager-finalize peek: nothing waiting in the queue

# A batch that waited on the stager longer than this is an underrun: the
# host failed to hide decode and padding behind device compute.
STAGER_UNDERRUN_S = 0.05


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


# The stager's copy threads, shared by the engines of a process: at most
# 8, and two cores fewer than the process may run on, since the copies run
# without the GIL and would otherwise leave the dispatch thread no core
# while it launches a batch (the card then waits on the host).
STAGE_THREADS = max(1, min(8, _cores() - 2))
# how long the stager waits at most for the card's input copy of the batch
# last dispatched before it stages the next (``_yield_to_input_copy``)
STAGE_YIELD_S = 0.25
STAGE_YIELD_POLL_S = 2e-4
# numpy dtypes the stager stages page-locked (others are pinned at dispatch)
_PINNABLE = {np.dtype(n): getattr(torch, n) for n in
             ("float32", "float16", "float64", "uint8", "int8", "int16", "int32", "int64",
              "bool")}
_stage_pool_lock = threading.Lock()
_stage_pool_of: List[Any] = [None, None]  # (pid, executor): a forked child makes its own


def _stage_pool() -> concurrent.futures.ThreadPoolExecutor:
    with _stage_pool_lock:
        if _stage_pool_of[0] != os.getpid():
            _stage_pool_of[:] = [os.getpid(), concurrent.futures.ThreadPoolExecutor(
                STAGE_THREADS, thread_name_prefix="infer-stage")]
        return _stage_pool_of[1]


class _HostBuffers:
    """An engine's page-locked batch buffers, reused: for each input slot a
    ring of ``depth`` flat buffers, all of the size of the largest batch
    the slot has staged, each lent out for one batch (``take``, stager
    thread) and returned once the device work that reads it has completed
    (``give``, consumer thread). A batch larger than the slot's buffers
    replaces its ring at once: the whole ring is allocated then, never
    while later batches compute. A buffer taken from an empty ring is
    allocated and joins the ring on its return while the ring has room;
    one smaller than its slot's ring is dropped on its return. A slot so
    holds at most ``depth`` buffers of its largest batch besides those
    lent out, whatever the number of buckets."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        self._size: Dict[int, int] = {}  # slot → bytes of each of its buffers
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _alloc(nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def take(self, slot: int, nbytes: int) -> torch.Tensor:
        """A flat uint8 buffer of at least ``nbytes`` for input slot ``slot``."""
        with self._lock:
            if nbytes > self._size.get(slot, 0):
                self._size[slot] = nbytes
                self._free[slot] = [self._alloc(nbytes) for _ in range(self.depth)]
            free, size = self._free[slot], self._size[slot]
            if free:
                return free.pop()
        return self._alloc(size)

    def give(self, buffers: Tuple[torch.Tensor, ...]) -> None:
        """Return one batch's buffers, slot by slot."""
        with self._lock:
            for slot, buf in enumerate(buffers):
                free = self._free.get(slot)
                if (free is not None and buf.numel() == self._size[slot]
                        and len(free) < self.depth):
                    free.append(buf)


def _run_bands(tasks: List[Callable[[], None]]) -> None:
    """Run a batch's band writes on the stage threads and wait for all;
    the first failure is raised once every band has ended."""
    futures = [_stage_pool().submit(t) for t in tasks]
    concurrent.futures.wait(futures)
    for f in futures:
        f.result()


class InferStallError(RuntimeError):
    """The stager staged nothing within the deadline: ``stream()`` fails
    instead of blocking its consumer."""


class _WatchdogTimeout(RuntimeError):
    """A device wait passed the deadline (fails its batch)."""


def _errstr(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e)[:200]}"


def _is_oom(e: BaseException) -> bool:
    """A device allocation failure, raised or chained (a capture that an OOM
    broke may end in another error whose context is the OOM)."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        e = e.__cause__ or e.__context__
    return False


def _released(e: BaseException) -> BaseException:
    """``e`` without its traceback (and its chain's): a kept exception must
    not keep the failed forward's frames, and with them its tensors, alive
    while the engine retries at a smaller batch."""
    seen = set()
    x = e
    while x is not None and id(x) not in seen:
        seen.add(id(x))
        x.__traceback__ = None
        x = x.__cause__ or x.__context__
    return e


def kernel_launches() -> Dict[str, int]:
    """The port's kernel launch counters, by kernel."""
    return {"alt_corr": alt_corr.LAUNCHES, "fused_update": fused_update.LAUNCHES,
            "packed_conv": packed_conv.LAUNCHES}


# ------------------------------------------------------------ graph cache

# Held by every capture in the process (``GraphCache``'s rule for several
# engines in one process).
CAPTURE_LOCK = threading.Lock()


@dataclass
class CapturedForward:
    """One forward captured at fixed input shapes: the graph, its static
    input and output buffers, the kernel launches it holds, and the
    event-record nodes its stage marks became (None: captured with no sink,
    or a forward that marks nothing)."""

    graph: Any  # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    output: torch.Tensor
    launches: Dict[str, int]
    replays: int = 0
    marks: Optional["_MarkNodes"] = None
    # ``replay(ahead=...)``: the buffers the copy stream fills, and the
    # event after the last replay's card-to-card copy out of them
    landing: Optional[Tuple[torch.Tensor, ...]] = None
    landing_read: Any = None


def _graph_event():
    """A stage mark under capture: an event-record node of the graph."""
    return torch.cuda.Event(enable_timing=True, external=True)


def _timing_event():
    """A stage mark of an eager forward on the card."""
    return torch.cuda.Event(enable_timing=True)


@functools.lru_cache(maxsize=None)
def _libcuda():
    """The CUDA driver, for the graph-node calls PyTorch does not wrap."""
    lib = ctypes.CDLL("libcuda.so.1")
    vp, st = ctypes.c_void_p, ctypes.c_size_t
    for name, args in (("cuGraphGetNodes", [vp, ctypes.POINTER(vp), ctypes.POINTER(st)]),
                       ("cuGraphNodeGetType", [vp, ctypes.POINTER(ctypes.c_int)]),
                       ("cuGraphEventRecordNodeGetEvent", [vp, ctypes.POINTER(vp)]),
                       ("cuGraphExecEventRecordNodeSetEvent", [vp, vp, vp])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


_CU_GRAPH_NODE_TYPE_EVENT_RECORD = 7


class _MarkNodes:
    """The event-record nodes a capture's stage marks became, in mark order.

    A graph's nodes record into the same events on every replay, and the
    engine replays batch N+1 before it reads batch N's times: so before each
    replay ``arm`` points the nodes of the instantiated graph at fresh
    events (``cuGraphExecEventRecordNodeSetEvent``; the change holds for
    later launches only), which are that launch's marks. The graph keeps its
    template (``keep_graph``) to name the nodes, and this object keeps alive
    every event a node names (``current``): CUDA refuses to re-point
    a node whose event was destroyed. A node that cannot be re-pointed ends
    the entry's marks, with a warning; its replays go on unmarked."""

    def __init__(self, graph, marks: List[Tuple[str, Any]]):
        cu, vp = _libcuda(), ctypes.c_void_p
        n = ctypes.c_size_t(0)
        template = vp(int(graph.raw_cuda_graph()))
        if cu.cuGraphGetNodes(template, None, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (vp * n.value)()
        if cu.cuGraphGetNodes(template, nodes, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        by_event = {}
        for node in nodes:
            kind, ev = ctypes.c_int(-1), vp()
            cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind))
            if (kind.value == _CU_GRAPH_NODE_TYPE_EVENT_RECORD
                    and not cu.cuGraphEventRecordNodeGetEvent(vp(node), ctypes.byref(ev))):
                by_event[ev.value] = node
        self.stages = [stage for stage, _ in marks]
        self.nodes = [by_event[int(ev.cuda_event)] for _, ev in marks]
        self.captured = marks  # what the template's nodes name, for the graph's life
        self.current = [ev for _, ev in marks]  # what each node of the exec names
        self.exec = int(graph.raw_cuda_graph_exec())
        self.failed = False

    @classmethod
    def of(cls, graph, marks) -> Optional["_MarkNodes"]:
        if not marks:
            return None
        try:
            return cls(graph, marks)
        except (OSError, AttributeError, KeyError, RuntimeError) as e:
            logger.warning("GraphCache: the capture's stage marks cannot be re-pointed "
                           "(%s); its batches report no stage times", _errstr(e))
            return None

    def arm(self) -> Optional[List[Tuple[str, Any]]]:
        """Fresh events for the next replay's marks, in mark order; None once
        a node could not be re-pointed."""
        if self.failed:
            return None
        cu, vp = _libcuda(), ctypes.c_void_p
        fresh = []
        for i, (stage, node) in enumerate(zip(self.stages, self.nodes)):
            ev = torch.cuda.Event(enable_timing=True)
            # torch times only events it recorded; the node records it again
            # later on the stream, and the later record is the one read
            ev.record()
            rc = cu.cuGraphExecEventRecordNodeSetEvent(vp(self.exec), vp(node),
                                                       vp(ev.cuda_event))
            if rc:
                self.failed = True
                logger.warning("GraphCache: re-pointing the %s mark failed (CUresult %d); "
                               "this graph's replays report no stage times", stage, rc)
                return None
            self.current[i] = ev
            fresh.append((stage, ev))
        return fresh


class GraphCache:
    """LRU of captured forwards, at most ``max_entries``, keyed by the caller
    (the engine: bucket shape, batch, input dtypes, iterations and model).

    Every graph of a cache draws from the cache's one memory pool: each
    capture reuses the memory earlier graphs free after their own captures,
    so sixteen graphs of large activations do not each hold their own. (A
    capture that CUDA invalidates spoils the pool for later captures: they
    start a new one, ``_end_broken_capture``.) That is safe because a
    cache's replays run one at a time on its engine's dispatch thread, and
    the caller copies each output out on that stream before the next
    replay, which may write over it. Static inputs live outside the pool.
    Eviction drops the graph and its buffers.

    **Several engines in one process** (the tiers of ``runtime/tiers.py``,
    one consumer thread each) each have their own cache and pool, so one
    engine's replays never write into another's graphs. Their captures
    follow one rule: a capture (warm-up included) holds the process-wide
    ``CAPTURE_LOCK``, so two captures never share the capture stream or
    interleave in the allocator, and it records in CUDA's thread-local
    capture mode on its own side stream. In the default global mode another
    thread's replay, copy, event query or pinned allocation during the
    capture would invalidate it; in thread-local mode only the capturing
    thread's own calls are checked, and the other engines' work runs on the
    legacy stream, which a PyTorch side stream (non-blocking) does not
    synchronise with. So engines capture while others serve, each key once
    (``captures_by_key``).

    ``get`` warms up and captures on the first call of a key (the engine's
    compile: ``faultinject.infer_compile_point`` fires there); a warm-up or
    capture that raises leaves no entry, resets its graph and, with no
    graph left, releases the pool. ``replay`` runs a captured forward.
    With a sink installed at capture, the forward's ``telemetry.mark``
    points become event-record nodes of the graph, and ``arm_marks`` gives
    each replay its own events for them. Spans: ``graph.warmup`` (the eager
    forward, to the end of its device work) and ``graph.capture``, children
    of the engine's ``bucket_compile``.
    Counters: ``captures``, ``capture_s`` (warm-up included; the capture
    alone is ``capture_s - warmup_s``), ``warmup_s``, ``hits`` and
    ``misses`` (a ``get`` that found its key, or not, failed captures
    included), ``replays``, ``evictions``, ``captures_by_key`` (a key
    captured twice was evicted while in use), and ``replayed_launches``:
    each kernel's launches at capture, summed over replays.
    """

    def __init__(self, max_entries: int = 16):
        if max_entries < 1:
            raise ValueError("GraphCache max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[Hashable, CapturedForward]" = OrderedDict()
        self._pool = None
        self.captures = 0
        self.capture_s = 0.0
        self.warmup_s = 0.0
        self.hits = 0
        self.misses = 0
        self.replays = 0
        self.evictions = 0
        self.captures_by_key: Counter = Counter()
        self.replayed_launches = {k: 0 for k in kernel_launches()}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def entry(self, key) -> CapturedForward:
        return self._entries[key]

    def items(self):
        """(key, captured forward) pairs, least recently used first."""
        return self._entries.items()

    def get(self, key, fn: Callable[..., torch.Tensor],
            inputs: Tuple[torch.Tensor, ...]) -> CapturedForward:
        """The key's captured forward, captured first from ``fn`` at the
        shapes of ``inputs`` (host or device tensors) if the key is new."""
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        faultinject.infer_compile_point(key)
        entry = self._entries[key] = self._capture(fn, inputs)
        self.captures_by_key[key] += 1
        if len(self._entries) > self.max_entries:
            old_key, old = self._entries.popitem(last=False)
            old.graph.reset()
            self.evictions += 1
            logger.info("GraphCache: evicted the graph of %s", old_key)
        return entry

    def replay(self, entry: CapturedForward, inputs: Tuple[torch.Tensor, ...],
               copied=None, ahead=None) -> torch.Tensor:
        """Copy ``inputs`` into the entry's static inputs and replay it, on
        the current stream; ``copied``, an event, is recorded once the
        copies are queued. With ``ahead``, a copy stream, the inputs are
        copied there into the entry's landing buffers once the previous
        replay has copied them out, ``copied`` is recorded there, and the
        current stream waits for it and copies them into the static inputs.
        The returned static output is valid until the next replay of any
        graph of this cache."""
        if ahead is None:
            for dst, src in zip(entry.inputs, inputs):
                dst.copy_(src, non_blocking=True)
            if copied is not None:
                copied.record()
        else:
            stream = torch.cuda.current_stream(entry.inputs[0].device)
            if entry.landing is None:
                entry.landing = tuple(torch.empty_like(x) for x in entry.inputs)
                for x in entry.landing:
                    x.record_stream(ahead)
                entry.landing_read = torch.cuda.Event()
                entry.landing_read.record(stream)
            copied = copied if copied is not None else torch.cuda.Event()
            ahead.wait_event(entry.landing_read)
            with torch.cuda.stream(ahead):
                for dst, src in zip(entry.landing, inputs):
                    dst.copy_(src, non_blocking=True)
                copied.record(ahead)
            stream.wait_event(copied)
            for dst, src in zip(entry.inputs, entry.landing):
                dst.copy_(src, non_blocking=True)
            entry.landing_read.record(stream)
        entry.graph.replay()
        entry.replays += 1
        self.replays += 1
        for k, n in entry.launches.items():
            self.replayed_launches[k] += n
        return entry.output

    def run(self, key, fn: Callable[..., torch.Tensor],
            inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """``fn(*inputs)`` through the key's graph (``get``, then ``replay``)."""
        return self.replay(self.get(key, fn, inputs), inputs)

    def arm_marks(self, entry: CapturedForward) -> Optional[List[Tuple[str, Any]]]:
        """The marks of the entry's next replay, taken before it: fresh
        events that the graph's mark nodes now record into; None for an
        entry without marks."""
        return None if entry.marks is None else entry.marks.arm()

    def _capture(self, fn, inputs) -> CapturedForward:
        """Warm up eagerly on a side stream, then capture on the pool, under
        ``CAPTURE_LOCK``."""
        with CAPTURE_LOCK:
            return self._capture_locked(fn, inputs)

    def _capture_locked(self, fn, inputs) -> CapturedForward:
        t0 = time.perf_counter()
        try:
            with telemetry.span("graph.warmup"):
                static = self._warm_up(fn, inputs)
            t_warm = time.perf_counter()
            with telemetry.span("graph.capture"), \
                    telemetry.stage_marks(_graph_event) as marks:
                entry = self._record(fn, static, marks)
        except BaseException:
            if not self._entries:
                self._pool = None
            raise
        self.captures += 1
        self.warmup_s += t_warm - t0
        self.capture_s += time.perf_counter() - t0
        return entry

    def _warm_up(self, fn, inputs) -> Tuple[torch.Tensor, ...]:
        """Static inputs on the card, and one eager forward on them on a side
        stream, waited for. It builds the kernels' libraries, sets their
        shared-memory attributes and settles cuDNN's choices, so the capture
        itself builds, allocates outside the pool and reads back nothing."""
        dev = torch.device("cuda", torch.cuda.current_device())
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in inputs)
        for dst, src in zip(static, inputs):
            dst.copy_(src, non_blocking=True)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static)
        # the capture synchronises the device as it begins: waiting here
        # costs nothing, and ends the warm-up where its device work ends
        side.synchronize()
        torch.cuda.current_stream(dev).wait_stream(side)
        return static

    def _record(self, fn, static, marks) -> CapturedForward:
        """Capture ``fn(*static)`` on the pool. ``marks`` (a ``stage_marks``
        list, or None with no sink) gathers the forward's marks, which
        become event-record nodes of the graph; such a graph keeps its
        template, to name them."""
        dev = static[0].device
        stream = torch.cuda.current_stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = (torch.cuda.CUDAGraph() if marks is None
                 else torch.cuda.CUDAGraph(keep_graph=True))
        before = kernel_launches()
        try:
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                output = fn(*static)
            if marks is not None:
                graph.instantiate()
        except BaseException:
            self._end_broken_capture(dev, stream)
            graph.reset()
            raise
        launches = {k: n - before[k] for k, n in kernel_launches().items()}
        return CapturedForward(graph, static, output, launches,
                               marks=_MarkNodes.of(graph, marks))

    def _end_broken_capture(self, dev: torch.device, stream) -> None:
        """Finish what a failed capture leaves behind. One that CUDA
        invalidated (a host read-back or a sync inside it) raises out of
        ``capture_end`` before the allocator stops routing the capture to
        the pool and before ``torch.cuda.graph`` restores the caller's
        stream; and its pool refuses every later capture ("already
        recording to mempool_id"), even once that recording is ended. So:
        end the recording, release the graph's hold on the pool, as a
        capture that ended and a ``reset`` would have, and leave the pool to
        the graphs that hold it: the next capture starts a fresh one. A
        capture that ended (a raise inside it) is not recording and keeps
        the pool. Either way the caller's stream is current again."""
        torch.cuda.set_stream(stream)
        try:
            torch._C._cuda_endAllocateToPool(dev.index, self._pool)
        except RuntimeError:
            return  # not recording: capture_end got past the allocator
        torch._C._cuda_releasePool(dev.index, self._pool)
        self._pool = None


# ------------------------------------------------------ requests, results


@dataclass
class InferRequest:
    """One inference item: ``inputs`` are [H, W, C] host arrays sharing one
    (H, W) (the image pair), or a zero-argument callable that returns them
    (the lazy decode form: it runs on the stager thread, and what it raises
    fails this request alone). ``payload`` is carried onto the result;
    ``trace_id`` names the request in every span and event on its path
    (None: the stager assigns one)."""

    payload: Any
    inputs: Any  # Tuple[np.ndarray, ...] | Callable[[], Tuple[np.ndarray, ...]]
    trace_id: Optional[str] = None

    def resolve(self) -> Tuple[np.ndarray, ...]:
        """Materialise and validate the input arrays (stager thread)."""
        raw = self.inputs() if callable(self.inputs) else self.inputs
        arrays = tuple(np.asarray(x) for x in raw)
        if not arrays:
            raise ValueError(f"request {self.payload!r} has no inputs")
        for a in arrays:
            if a.ndim != 3:
                raise ValueError(
                    f"request {self.payload!r}: expected [H, W, C] inputs, got shape {a.shape}")
        h, w = arrays[0].shape[:2]
        for k, a in enumerate(arrays[1:], start=1):
            if a.shape[:2] != (h, w):
                raise ValueError(
                    f"request {self.payload!r}: input slot {k} is {a.shape[:2]}, slot 0 is "
                    f"{(h, w)}; all slots must share one (H, W)")
        return arrays


@dataclass
class FlushRequest:
    """In-band control token: stage ``bucket``'s partial batch now (padded
    and masked, on the full batch's graph) instead of at the end of the
    stream; ``None`` flushes every pending bucket in sorted order. It
    produces no result."""

    bucket: Optional[Tuple[int, int]] = None


@dataclass
class InferResult:
    """On success ``output`` is the item's original [H, W, C'] window of the
    batched output (host numpy). On failure ``error`` holds the exception,
    ``output`` is None, and ``bucket`` is None for a failed decode.
    ``trace_id`` is the request's."""

    payload: Any
    output: Optional[np.ndarray] = None
    bucket: Optional[Tuple[int, int]] = None
    error: Optional[BaseException] = None
    trace_id: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class _FailedRequest:
    """Stager → consumer: a request that failed before dispatch."""

    payload: Any
    error: BaseException
    trace_id: Optional[str] = None


@dataclass
class _Decoded:
    """A resolved request waiting in the stager's bucket map."""

    payload: Any
    arrays: Tuple[np.ndarray, ...]
    trace_id: str = ""
    t_start: float = 0.0   # perf_counter at decode start (the e2e clock's zero)
    decode_s: float = 0.0  # the lazy decode and validation


@dataclass
class _StagedBatch:
    bucket: Tuple[int, int]
    payloads: List[Any]
    padder: BatchPadder
    arrays: Tuple[np.ndarray, ...]  # host [B, Hb, Wb, C] per input slot
    valid: int
    stage_s: float
    # on the card: the page-locked tensors ``arrays`` are views of, which
    # the dispatch copies from directly (None: pageable, pinned at dispatch),
    # and the ring's buffers they lie in
    pinned: Optional[Tuple[torch.Tensor, ...]] = None
    buffers: Optional[Tuple[torch.Tensor, ...]] = None
    wait_s: float = 0.0  # the consumer's wait for it
    # per valid item, parallel to payloads
    trace_ids: List[str] = field(default_factory=list)
    t_starts: List[float] = field(default_factory=list)
    decode_s: List[float] = field(default_factory=list)
    t_got: float = 0.0  # perf_counter when the consumer took it
    seq: int = 0  # the engine's count of staged batches: spans' ``batch``
    label: str = field(init=False)  # "HxW", for spans and histograms

    def __post_init__(self):
        self.label = f"{self.bucket[0]}x{self.bucket[1]}"


@dataclass
class _Launch:
    """A forward launched on some rows of a batch: its output (on the host,
    or being copied there), and on CUDA the events around it."""

    host: Optional[torch.Tensor] = None
    done: Any = None   # torch.cuda.Event recorded after the output copy
    start: Any = None  # torch.cuda.Event recorded before the input copy
    copied: Any = None  # torch.cuda.Event recorded after the input copy
    ms: Optional[float] = None  # start → done, once waited on
    # the forward's stage marks (``telemetry.stage_marks``; None with no
    # sink) and, once waited on, the ms of each stage
    marks: Optional[List[Tuple[str, Any]]] = None
    stage_ms: Optional[Dict[str, float]] = None
    batch: Optional[int] = None  # the staged batch's number, for spans


@dataclass
class _DispatchFailure:
    """A dispatch that raised before any wait: ``_finalize`` walks it down
    the same recovery ladder as a failed wait."""

    error: BaseException


class _WaitWorker:
    """One long-lived daemon thread running deadline-bounded device waits.

    Reused across the batches of a stream. After a watchdog trip the worker
    is wedged on the hung wait and must be abandoned (its late result must
    never be read as a later batch's), so the engine drops it and makes a
    fresh one on the next wait."""

    def __init__(self):
        self._req: "queue.Queue" = queue.Queue()
        self._res: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._loop, name="infer-device-wait",
                                       daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            fn = self._req.get()
            if fn is None:
                return
            try:
                self._res.put(("ok", fn()))
            except BaseException as e:  # noqa: BLE001 — re-raised by run()
                self._res.put(("err", e))

    def run(self, fn: Callable, timeout: float):
        """Run ``fn`` on the worker and return its result or re-raise its
        exception; ``queue.Empty`` when nothing came back within ``timeout``."""
        self._req.put(fn)
        kind, val = self._res.get(timeout=timeout)
        if kind == "err":
            raise val
        return val

    def close(self) -> None:
        """Let an idle worker exit (a wedged one stays parked: daemon)."""
        self._req.put(None)


@dataclass
class InferStats:
    """Time and volume accounting of an engine (seconds unless named)."""

    images: int = 0          # requests that yielded a result
    failed: int = 0          # requests that yielded an error result
    batches: int = 0
    padded_slots: int = 0
    decode_wait_s: float = 0.0  # consumer blocked on the stager queue
    h2d_stage_s: float = 0.0    # stager: pad into the batch buffer (host)
    # consumer: the inputs' copy into pinned memory (CUDA), 0 for a batch
    # the stager staged page-locked
    pin_s: float = 0.0
    device_batch_s: float = 0.0  # consumer blocked on device results
    stream_s: float = 0.0       # wall time inside stream(), captures included
    compile_s: float = 0.0      # new keys: warm-up and capture (CPU: first use)
    compiles: int = 0
    prewarmed: int = 0       # keys captured from the graph store at construction
    underruns: int = 0
    retries: int = 0         # compile and dispatch retry attempts
    degraded: int = 0        # batches served by halving or the per-image path
    watchdog_trips: int = 0  # stalled stager or device wait past the deadline
    circuits_open: int = 0   # buckets circuit-broken in the engine's life
    buckets: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # each full batch's device time on CUDA (ms, by CUDA events from the
    # input copy to the end of the output copy; with ``copy_ahead``, from
    # the wait for the copy stream's copy and the card-to-card copy) and
    # its valid items
    batch_ms: List[float] = field(default_factory=list)
    batch_valid: List[int] = field(default_factory=list)
    # aligned with batch_ms: each batch's device ms by model stage, from the
    # forward's stage marks ({} for a batch without: no sink at capture, or
    # a forward that marks nothing)
    stage_ms: List[Dict[str, float]] = field(default_factory=list)
    # (component, bucket label) → histogram: queue_wait, decode and e2e a
    # request, h2d and device a batch (consumer thread only)
    latency: Dict[Tuple[str, str], telemetry.LogHistogram] = field(default_factory=dict)

    def breakdown_ms(self) -> Dict[str, float]:
        """Per-batch means of the host-side waits."""
        n = max(self.batches, 1)
        return {
            "decode_wait_ms": round(self.decode_wait_s / n * 1e3, 3),
            "h2d_stage_ms": round(self.h2d_stage_s / n * 1e3, 3),
            "device_batch_ms": round(self.device_batch_s / n * 1e3, 3),
        }

    def observe_latency(self, component: str, bucket_label: str, seconds: float) -> None:
        """Record into the local histogram and the installed registry
        (``infer_<component>_seconds{bucket=...}``)."""
        key = (component, bucket_label)
        h = self.latency.get(key)
        if h is None:
            h = self.latency[key] = telemetry.LogHistogram()
        h.record(seconds)
        telemetry.observe(f"infer_{component}_seconds", seconds, bucket=bucket_label)

    def latency_summary(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """{bucket: {component: {count, p50_ms, p95_ms, p99_ms, max_ms}}}."""
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for (component, label), h in sorted(self.latency.items()):
            snap = h.snapshot()
            if not snap["count"]:
                continue
            out.setdefault(label, {})[component] = {
                "count": snap["count"],
                "p50_ms": round(snap["p50"] * 1e3, 3),
                "p95_ms": round(snap["p95"] * 1e3, 3),
                "p99_ms": round(snap["p99"] * 1e3, 3),
                "max_ms": round(snap["max"] * 1e3, 3),
            }
        return out


@dataclass(frozen=True)
class StreamSummary:
    """Completed against failed requests of one serving run, the batches
    the degraded paths served, the watchdog's trips, and the per-bucket
    latency percentiles (``InferStats.latency_summary``)."""

    completed: int
    failed: int
    degraded: int
    watchdog_trips: int = 0
    latency: Optional[Dict[str, Any]] = None
    # the installed sink's SLO posture at publish time, None without one
    slo: Optional[Dict[str, Any]] = None

    @property
    def total(self) -> int:
        return self.completed + self.failed

    @property
    def failed_frac(self) -> float:
        return self.failed / self.total if self.total else 0.0


# The last published summary: the validators own the engine, the CLI mains
# own the exit code, and this is the one-way channel between them. The
# mains reset it on entry.
_last_summary: Optional[StreamSummary] = None


def publish_summary(stats: InferStats, label: str = "serving",
                    heartbeat: bool = True) -> StreamSummary:
    """Derive, print, record and emit the run's summary: the
    completed/failed/degraded line, each bucket's end-to-end percentiles,
    and, with a sink installed, ``stream_summary`` and (unless
    ``heartbeat`` is False: a caller that owns the run's heartbeat) a
    serving heartbeat with ``metrics.prom``."""
    global _last_summary
    latency = stats.latency_summary() or None
    tel = telemetry.get()
    slo = tel.slo.snapshot() or None if tel is not None and tel.slo is not None else None
    s = StreamSummary(completed=stats.images, failed=stats.failed, degraded=stats.degraded,
                      watchdog_trips=stats.watchdog_trips, latency=latency, slo=slo)
    _last_summary = s
    line = (f"[{label}] requests: {s.completed}/{s.total} completed, {s.failed} failed, "
            f"{s.degraded} degraded batch(es)")
    if s.watchdog_trips:
        line += f", {s.watchdog_trips} watchdog trip(s)"
    print(line)
    for bucket, comps in (latency or {}).items():
        e2e = comps.get("e2e")
        if e2e:
            print(f"[{label}] latency {bucket}: e2e p50 {e2e['p50_ms']:g} / p95 "
                  f"{e2e['p95_ms']:g} / p99 {e2e['p99_ms']:g} / max {e2e['max_ms']:g} ms "
                  f"(n={e2e['count']})")
    for tier, row in (slo or {}).items():
        print(f"[{label}] slo [{tier}]: {row['hit_rate']:.1%} hit (target p95 "
              f"{row['target_p95_ms']:g} ms), budget burn {row['budget_burn']:g}x over "
              f"{row['total']} request(s)")
    telemetry.emit("stream_summary", completed=s.completed, failed=s.failed,
                   degraded=s.degraded, watchdog_trips=s.watchdog_trips)
    if tel is not None and heartbeat:
        tel.write_heartbeat(mode="serving", requests=s.completed, failed_requests=s.failed,
                            degraded=s.degraded, watchdog_trips=s.watchdog_trips)
    return s


def last_summary() -> Optional[StreamSummary]:
    return _last_summary


def reset_summary() -> None:
    global _last_summary
    _last_summary = None


def enforce_failure_budget(max_failed_frac: float) -> None:
    """``SystemExit`` when the published failed fraction exceeds the budget
    (0 by default: any failure fails the run). Nothing published (the
    per-image path) means nothing to enforce."""
    s = _last_summary
    if s is None or s.failed == 0:
        return
    if s.failed_frac > max_failed_frac:
        raise SystemExit(
            f"[serving] {s.failed}/{s.total} requests failed (fraction "
            f"{s.failed_frac:.3f} > --max_failed_frac {max_failed_frac:g})")


# ----------------------------------------------------------------- engine


class InferenceEngine:
    """Batched, pipelined inference over pairs of any shape.

    ``forward_fn(*inputs) -> [B, Hb, Wb, C']`` is the model forward on
    device tensors (inputs mirror ``InferRequest.inputs``, stacked and
    padded to the bucket, H and W multiples of ``divis_by``). On
    ``device`` CUDA with ``capture`` (the default), each
    (bucket, batch) runs as one CUDA graph from a ``GraphCache`` of
    ``max_executables`` entries; ``graph_key`` names what else the graph
    bakes in (the model and its iterations). Otherwise every batch runs
    ``forward_fn`` eagerly; the model's ``converge_eps`` exit, which reads a
    scalar back each step, must run so (``evaluate.make_engine`` passes
    ``capture=False`` for it). ``stream(requests)`` yields ``InferResult``s,
    error results included (check ``result.ok``). ``deadline_s`` bounds
    every wait the consumer can block on; ``retries`` is the compile and
    dispatch retry budget, ``retry_backoff_s`` its first backoff.

    ``eager_finalize`` finalises the held dispatch when the stager queue is
    empty instead of waiting for the next staged batch: a stream whose next
    request depends on this result (a video session) would otherwise
    deadlock against the one-deep pipeline. ``idle_watchdog=False`` lets a
    long-lived feed stay idle past ``deadline_s`` while its source lives
    (device waits keep the deadline). ``tier`` labels the engine in SLO
    accounting, quality sketches and the blackbox (``engine:<tier>``);
    ``module`` is the ``nn.Module`` whose weights ``forward_fn`` reads,
    which ``update_variables`` swaps. ``spatial`` is the spatial tier's
    device list (see the module docstring), the first of which is
    ``device``. ``aot_dir`` is the graph store's directory and
    ``aot_key_extra`` what else its keys must tell apart (the model's
    architecture and iterations: process-stable values only; see the
    module docstring).
    """

    def __init__(self, forward_fn: Callable[..., torch.Tensor], *, device,
                 batch: int = 4, prefetch_depth: int = 2, max_executables: int = 16,
                 deadline_s: Optional[float] = None, capture: bool = True,
                 graph_key: Tuple = (), retries: int = 2, retry_backoff_s: float = 0.05,
                 eager_finalize: bool = False, idle_watchdog: bool = True,
                 tier: str = "serving", module: Optional[torch.nn.Module] = None,
                 divis_by: int = 32, spatial: Optional[List[torch.device]] = None,
                 aot_dir: Optional[str] = None, aot_key_extra: Optional[Dict[str, Any]] = None,
                 copy_ahead: bool = False):
        if batch < 1:
            raise ValueError("InferenceEngine batch must be >= 1")
        if prefetch_depth < 1:
            raise ValueError("InferenceEngine prefetch_depth must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("InferenceEngine deadline_s must be > 0 or None")
        if retries < 0:
            raise ValueError("InferenceEngine retries must be >= 0")
        if divis_by < 1:
            raise ValueError("InferenceEngine divis_by must be >= 1")
        self.divis_by = int(divis_by)
        self.forward_fn = forward_fn
        self.device = torch.device(device)
        self.spatial = None if spatial is None else [torch.device(d) for d in spatial]
        if self.spatial is not None and (not self.spatial or self.spatial[0] != self.device):
            raise ValueError(f"InferenceEngine: the spatial devices {self.spatial} must start "
                             f"with the engine's device {self.device}")
        self.num_spatial = 1 if self.spatial is None else len(self.spatial)
        self.divis_h = spatial_divis(self.divis_by, self.num_spatial)
        self.batch = int(batch)
        self.prefetch_depth = int(prefetch_depth)
        self.deadline_s = deadline_s
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        # one CUDA graph holds one device's work
        self.capture = (bool(capture) and self.device.type == "cuda"
                        and len(set(self.spatial or [self.device])) == 1)
        self.graph_key = tuple(graph_key)
        self.graphs = GraphCache(max_executables)
        # replays copy their inputs on this stream, ahead (module docstring)
        self._copy_stream = torch.cuda.Stream(self.device) if copy_ahead and self.capture else None
        self.stats = InferStats()
        # degradation memory, by bucket: a broken bucket is served one pair
        # at a time; a capped one at the micro-batch that last fit
        self._broken: Dict[Tuple[int, int], str] = {}
        self._bucket_cap: Dict[Tuple[int, int], int] = {}
        self._compiled: set = set()  # eager keys past their first use
        self._batch_seq = itertools.count()  # numbers staged batches (stager)
        # staged, queued, dispatched and held batches, and the one the
        # stager fills: the ring a slot needs so the stager never allocates;
        # used on the card (``_stage_locked``)
        self._host_buffers = _HostBuffers(self.prefetch_depth + 3)
        self._stage_locked = self.device.type == "cuda"
        # the input copy of the batch last dispatched (consumer), which the
        # stager lets finish before it stages the next batch
        self._inputs_copied = None
        self._wait_worker: Optional[_WaitWorker] = None
        self.eager_finalize = bool(eager_finalize)
        self.idle_watchdog = bool(idle_watchdog)
        self.tier_label = str(tier)
        self.module = module
        # the graph store: ``is not None`` below, since an empty store is
        # falsy (it has __len__)
        self.aot_store = None
        self._aot_extra = dict(aot_key_extra or {})
        self._var_sig: Optional[str] = None
        self._fn_sig: Optional[str] = None
        if aot_dir:
            from raft_stereo_tpu_torch.runtime.aot_store import AOTStore

            self.aot_store = AOTStore(aot_dir)
        blackbox.register_provider(f"engine:{self.tier_label}", self.snapshot)
        if self.aot_store is not None:
            self._prewarm()

    def snapshot(self) -> Dict[str, Any]:
        """An introspection view (the blackbox provider): the degradation
        memory and the counts, read best-effort from the dump thread."""
        s = self.stats
        store = self.aot_store
        active = getattr(self.forward_fn, "active_shards", None)
        return {
            "tier": self.tier_label, "batch": self.batch, "deadline_s": self.deadline_s,
            "divis_by": self.divis_by, "num_spatial": self.num_spatial, "divis_h": self.divis_h,
            "active_shards": None if active is None else {
                f"{b[0]}x{b[1]}": active(b[0]) for b in list(s.buckets)},
            "retries": self.retries, "idle_watchdog": self.idle_watchdog,
            "eager_finalize": self.eager_finalize,
            "capture": self.capture, "executables": len(self.graphs),
            "cache_hits": self.graphs.hits, "cache_misses": self.graphs.misses,
            "broken_buckets": {f"{b[0]}x{b[1]}": r for b, r in dict(self._broken).items()},
            "bucket_caps": {f"{b[0]}x{b[1]}": c for b, c in dict(self._bucket_cap).items()},
            "stats": {"images": s.images, "batches": s.batches,
                      "padded_slots": s.padded_slots, "compiles": s.compiles,
                      "prewarmed": s.prewarmed,
                      "failed": s.failed, "retries": s.retries, "degraded": s.degraded,
                      "watchdog_trips": s.watchdog_trips, "circuits_open": s.circuits_open,
                      "underruns": s.underruns},
            "buckets": {f"{b[0]}x{b[1]}": n for b, n in dict(s.buckets).items()},
            "aot_store": None if store is None else {
                "root": store.root, "hits": store.hits, "misses": store.misses,
                "rejects": store.rejects, "stores": store.stores},
        }

    def update_variables(self, state_dict: Dict[str, Any]) -> None:
        """Swap the served weights in place: each tensor of ``state_dict``
        (the module's own keys, shapes and order of dims; tensors or arrays)
        is copied into the module's existing parameter or buffer. A captured
        graph reads the weights through their device addresses, so every
        graph serves the new values with no new capture; reassigning a
        parameter or loading another module would leave the graphs on the
        old ones. Call between streams or between a stream's yielded
        results: the engine dispatches on the consumer's thread, so the copy
        cannot race a dispatch."""
        if self.module is None:
            raise RuntimeError("update_variables: the engine was built without its module")
        own = self.module.state_dict()
        if set(own) != set(state_dict):
            raise KeyError(f"update_variables: missing {sorted(set(own) - set(state_dict))}, "
                           f"unexpected {sorted(set(state_dict) - set(own))}")
        new = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        for k, t in own.items():
            if tuple(new[k].shape) != tuple(t.shape):
                raise ValueError(f"update_variables: {k} is {tuple(new[k].shape)}, "
                                 f"the module's is {tuple(t.shape)}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(new[k])

    # ---------------------------------------------------------- compile

    def _key(self, bucket, arrays) -> Tuple:
        return (bucket, len(arrays[0]),
                *((tuple(a.shape), str(a.dtype)) for a in arrays), *self.graph_key)

    def _is_compiled(self, key) -> bool:
        return key in self.graphs if self.capture else key in self._compiled

    def _build(self, key, arrays) -> None:
        """A new key's "compile": on the card, its warm-up and capture into
        the ``GraphCache``; eagerly, the mark that its first use is past.
        Raises what it raises."""
        if self.capture:
            self.graphs.get(key, self.forward_fn,
                            tuple(torch.from_numpy(a).pin_memory() for a in arrays))
        else:
            faultinject.infer_compile_point(key)
            self._compiled.add(key)

    def _compile(self, key, arrays, trace_ids=None, batch: Optional[int] = None) -> None:
        """Compile a new key (``_build``) and account for it
        (``bucket_compile``). Raises what the compile raises."""
        t0 = time.perf_counter()
        with telemetry.span("bucket_compile", batch=batch, trace_ids=trace_ids):
            self._build(key, arrays)
        dt = time.perf_counter() - t0
        self.stats.compile_s += dt
        self.stats.compiles += 1
        telemetry.emit("bucket_compile", bucket=list(key[0]), batch=key[1],
                       compile_ms=round(dt * 1e3, 1),
                       cache_size=len(self.graphs) if self.capture else len(self._compiled),
                       trace_ids=trace_ids)

    def _compile_retrying(self, key, bucket, arrays, trace_ids=None,
                          batch: Optional[int] = None) -> Optional[BaseException]:
        """Compile ``key`` within the retry budget, backing off between
        attempts: None once it compiled, else the last failure. An OOM is
        raised at once (the caller halves the batch)."""
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            if attempt:
                self._note_retry("compile", attempt, bucket, last, trace_ids)
            try:
                self._compile(key, arrays, trace_ids, batch)
                return None
            except Exception as e:  # noqa: BLE001 — a compile failure retries
                if _is_oom(e):
                    raise
                last = _released(e)
                logger.warning("bucket %s compile attempt %d failed: %s", bucket,
                               attempt + 1, _errstr(e))
        return last

    def _executable(self, staged: _StagedBatch) -> Optional[Callable]:
        """A launcher of the batch's key, ``run(arrays) -> _Launch``,
        compiling the key first with retry and backoff. An OOM is raised at
        once (the caller halves the batch); a compile that fails past the
        retry budget opens the bucket's circuit and returns None."""
        key = self._key(staged.bucket, staged.arrays)
        if not self._is_compiled(key):
            if self.aot_store is not None:
                # not prewarmed: compiled here and stored through below
                self.aot_store.note_miss(self._store_key(staged.bucket, staged.arrays))
            last = self._compile_retrying(key, staged.bucket, staged.arrays, staged.trace_ids,
                                          staged.seq)
            if last is not None:
                self._open_circuit(staged.bucket, "compile", last, staged.trace_ids)
                return None
            if self.aot_store is not None:
                self._aot_save(staged.bucket, staged.arrays)
        return lambda arrays, pinned=None: self._launch(key, arrays, captured=self.capture,
                                                        batch=staged.seq, pinned=pinned)

    # ------------------------------------------------------ graph store

    def _variables_signature(self) -> str:
        """sha256[:16] of the module's state-dict names, shapes and dtypes:
        two models whose parameters differ in structure never share an
        entry. Values are left out, since ``update_variables`` swaps them
        under the same graphs."""
        if self._var_sig is None:
            import hashlib

            sig = "none" if self.module is None else ";".join(
                f"{k}:{tuple(t.shape)}:{t.dtype}" for k, t in self.module.state_dict().items())
            self._var_sig = hashlib.sha256(sig.encode()).hexdigest()[:16]
        return self._var_sig

    def _forward_signature(self) -> str:
        """sha256[:16] of the forward's code (bytecode, names, constants,
        nested code objects; the JAX engine's walk): an edited forward
        misses the store instead of serving the old math. A forward without
        ``__code__`` is walked through what it wraps (a ``functools.partial``'s
        function, a bound method's function, a module's ``forward``, an
        object's ``__call__``); never through a repr, which may hold an
        address. Model architecture and iterations are the caller's to key
        (``aot_key_extra``)."""
        if self._fn_sig is None:
            import functools
            import hashlib

            def walk(c) -> List[str]:
                consts = [x for x in c.co_consts if not hasattr(x, "co_code")]
                parts = [c.co_code.hex(), repr(c.co_names), repr(consts)]
                for x in c.co_consts:
                    if hasattr(x, "co_code"):
                        parts.extend(walk(x))
                return parts

            fn = self.forward_fn
            for _ in range(8):
                if getattr(fn, "__code__", None) is not None:
                    break
                if isinstance(fn, functools.partial):
                    fn = fn.func
                elif hasattr(fn, "__func__"):
                    fn = fn.__func__
                elif isinstance(fn, torch.nn.Module):
                    fn = type(fn).forward
                else:
                    fn = type(fn).__call__
            code = getattr(fn, "__code__", None)
            sig = ("|".join(walk(code)) if code is not None
                   else f"{type(fn).__module__}.{type(fn).__qualname__}")
            self._fn_sig = hashlib.sha256(sig.encode()).hexdigest()[:16]
        return self._fn_sig

    def store_identity(self) -> Dict[str, Any]:
        """The graph store's key less its entry fields (bucket, batch,
        inputs): the JAX ``_store_key``'s fields in the port's terms, the
        tier and ``aot_key_extra``. Every value is stable across processes;
        ``graph_key`` is not among them."""
        identity: Dict[str, Any] = {
            "kind": "infer_forward", "divis_by": self.divis_by, "divis_h": self.divis_h,
            "num_spatial": self.num_spatial, "backend": self.device.type,
            "devices": len(set(self.spatial or [self.device])), "capture": self.capture,
            "variables": self._variables_signature(), "forward": self._forward_signature(),
            "tier": self.tier_label,
        }
        identity.update(self._aot_extra)
        return identity

    def _store_key(self, bucket, arrays) -> Dict[str, Any]:
        """The store key (and recipe) of one (bucket, batch) key."""
        return {"bucket": [int(v) for v in bucket], "batch": len(arrays[0]),
                "inputs": [[[int(v) for v in a.shape], str(a.dtype)] for a in arrays],
                **self.store_identity()}

    def _aot_save(self, bucket, arrays) -> None:
        """Store-through of a key just compiled on the serving path.
        Best-effort: a failure logs, and the key captures on first use after
        a restart."""
        from raft_stereo_tpu_torch.runtime.aot_store import export_recipe

        try:
            t0 = time.perf_counter()
            key = self._store_key(bucket, arrays)
            blob = export_recipe(key)
            self.aot_store.store(key, blob,
                                 export_ms=round((time.perf_counter() - t0) * 1e3, 1))
        except Exception as e:  # noqa: BLE001 — persistence is best-effort
            logger.warning("graph store-through for bucket %s failed (%s); serving goes on",
                           bucket, _errstr(e))

    def _prewarm(self) -> None:
        """Capture the stored keys of this engine's identity, newest first
        and at most ``max_executables``, on zero-filled static inputs through
        ``_build`` (the path of a first batch: the ``GraphCache``'s warm-up
        and capture under ``CAPTURE_LOCK``; eagerly, the compiled mark). A
        hit's ``load_ms`` covers the read, the validation and the capture. A
        prewarm that raises leaves the entry on disk and the key uncompiled:
        it compiles on first use through the retry ladder."""
        for key in self.aot_store.entries(self.store_identity())[:self.graphs.max_entries]:
            bucket = key.get("bucket")
            try:
                arrays = tuple(np.zeros(shape, dtype=np.dtype(dtype))
                               for shape, dtype in key["inputs"])
                cache_key = self._key(tuple(bucket), arrays)
                if self._is_compiled(cache_key):
                    continue
                if self.aot_store.load(self._store_key(bucket, arrays),
                                       realize=lambda _r: self._build(cache_key, arrays)):
                    self.stats.prewarmed += 1
            except Exception as e:  # noqa: BLE001 — a failed prewarm compiles on first use
                logger.warning("graph store: prewarm of bucket %s batch %s failed (%s); it "
                               "compiles on first use", bucket, key.get("batch"), _errstr(e))

    def _note_retry(self, kind: str, attempt: int, bucket, error: Optional[BaseException],
                    trace_ids: Optional[List[str]] = None) -> None:
        """One retry's bookkeeping: count, emit, exponential backoff."""
        self.stats.retries += 1
        telemetry.emit("infer_retry", kind=kind, attempt=attempt, bucket=list(bucket),
                       error=_errstr(error) if error else None, trace_ids=trace_ids)
        time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))

    def _open_circuit(self, bucket, reason: str, error: Optional[BaseException],
                      trace_ids: Optional[List[str]] = None) -> None:
        if bucket in self._broken:
            return
        self._broken[bucket] = reason
        self.stats.circuits_open += 1
        logger.error("bucket %s circuit-broken (%s failed persistently: %s): its requests "
                     "are served by the degraded per-image path", bucket, reason,
                     _errstr(error) if error else "?")
        telemetry.emit("bucket_circuit_open", bucket=list(bucket), reason=reason,
                       error=_errstr(error) if error else None, trace_ids=trace_ids)

    # -------------------------------------------------- launch and wait

    def _launch(self, key, arrays: Tuple[np.ndarray, ...], captured: bool,
                batch: Optional[int] = None,
                pinned: Optional[Tuple[torch.Tensor, ...]] = None) -> _Launch:
        """Launch the forward on host ``arrays`` (one batch, or some rows of
        one): a replay of ``key``'s graph when ``captured``, else eagerly.
        ``batch`` is the staged batch's number, for spans; ``pinned``, the
        page-locked tensors ``arrays`` are views of, skips the pinned copy."""
        if self.device.type != "cuda":
            inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                           for a in arrays)
            with telemetry.stage_marks(telemetry.HostMark) as marks:
                out = self.forward_fn(*inputs).detach()
            return _Launch(host=out, marks=marks, batch=batch)
        if pinned is None:
            t0 = time.perf_counter()
            with telemetry.span("dispatch.pin", batch=batch):
                pinned = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                               for a in arrays)
            self.stats.pin_s += time.perf_counter() - t0
        launch = _Launch(start=torch.cuda.Event(enable_timing=True),
                         copied=torch.cuda.Event(), batch=batch)
        if captured:
            entry = self.graphs.get(key, self.forward_fn, pinned)
            launch.marks = self.graphs.arm_marks(entry)
            launch.start.record()
            out = self.graphs.replay(entry, pinned, copied=launch.copied,
                                     ahead=self._copy_stream)
        else:
            launch.start.record()
            inputs = tuple(x.to(self.device, non_blocking=True) for x in pinned)
            launch.copied.record()
            with telemetry.stage_marks(_timing_event) as marks:
                out = self.forward_fn(*inputs)
            launch.marks = marks
        self._inputs_copied = launch.copied
        # a static output is overwritten by the next replay: copy it out on
        # the stream now
        launch.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        launch.host.copy_(out, non_blocking=True)
        launch.done = torch.cuda.Event(enable_timing=True)
        launch.done.record()
        return launch

    def _wait_device(self, launch: _Launch, batch_size: int,
                     trace_ids: Optional[List[str]] = None) -> np.ndarray:
        """Block until a launch's output is on the host, under the deadline.

        With ``deadline_s`` the wait runs on the engine's ``_WaitWorker``: a
        wait past the deadline raises ``_WatchdogTimeout`` (the batch fails)
        and the wedged worker is abandoned. The injected hang and OOM
        (``faultinject.infer_wait_point``) fire on the same thread, where
        real device errors surface. Once the output is in, the launch's
        stage marks have all been recorded: their times are read here."""

        def wait():
            with telemetry.span("device_wait", batch=launch.batch, trace_ids=trace_ids):
                faultinject.infer_wait_point(batch_size)
                if launch.done is not None:
                    launch.done.synchronize()
                    launch.ms = launch.start.elapsed_time(launch.done)
                if launch.marks:
                    launch.stage_ms = telemetry.stage_ms(launch.marks)
                return launch.host.numpy()

        if self.deadline_s is None:
            return wait()
        if self._wait_worker is None:
            self._wait_worker = _WaitWorker()
        try:
            return self._wait_worker.run(wait, self.deadline_s)
        except queue.Empty:
            self._wait_worker = None  # wedged: never read its late result
            raise _WatchdogTimeout(
                f"device wait (micro-batch {batch_size}) exceeded the {self.deadline_s:g}s "
                f"deadline (--infer_timeout); the wait thread is abandoned and the batch "
                f"fails") from None

    def _run_degraded(self, staged: _StagedBatch, start_b: int, reason: str,
                      error: Optional[BaseException] = None) -> np.ndarray:
        """Serve a staged batch in sub-batches of ``start_b`` rows, halving
        on OOM until a sub-batch fits (1 is the floor). After an OOM
        (``reason`` ``oom``, ``oom_capped``) each sub-batch replays the
        graph of (bucket, b); an open circuit (``circuit``) runs one pair at
        a time eagerly, on the same card and kernels. A size that fit after
        an OOM becomes the bucket's cap. Returns the [rows, Hb, Wb, C'] host
        result (at least the valid rows); raises if the floor fails."""
        halving = reason != "circuit"
        b = max(1, min(int(start_b), self.batch))
        last = error
        outs: List[np.ndarray] = []
        s = 0  # rows done so far: a halving resumes here
        while s < staged.valid:  # filler rows past ``valid`` are never run alone
            # every sub-batch is exactly b rows (one graph a bucket and
            # size): near the end, the window shifts back over rows done
            start = max(0, min(s, self.batch - b))
            rows = tuple(a[start:start + b] for a in staged.arrays)
            ids = staged.trace_ids[start:start + b] or staged.trace_ids
            try:
                key = self._key(staged.bucket, rows)
                if halving and not self._is_compiled(key):
                    # not stored through: a halved key is the card's memory
                    # state, not the engine's serving plan. Its capture
                    # retries as the serving plan's does
                    failed = self._compile_retrying(key, staged.bucket, rows, ids, staged.seq)
                    if failed is not None:
                        raise failed
                host = self._wait_device(
                    self._launch(key, rows, self.capture and halving, staged.seq), b, ids)
            except _WatchdogTimeout:
                raise
            except Exception as e:  # noqa: BLE001 — halve on OOM only
                if _is_oom(e) and b > 1:
                    last = _released(e)
                    b //= 2
                    logger.warning("bucket %s: OOM; halving the micro-batch to %d",
                                   staged.bucket, b)
                    continue
                raise
            outs.append(host[s - start:])
            s = start + b
        if b < self.batch and reason.startswith("oom"):
            self._bucket_cap[staged.bucket] = b
        self.stats.degraded += 1
        telemetry.emit("infer_degraded", bucket=list(staged.bucket), micro_batch=b,
                       reason=reason, error=_errstr(last) if last else None,
                       pixels=staged.bucket[0] * staged.bucket[1], bucket_hw=staged.label,
                       trace_ids=staged.trace_ids)
        return np.concatenate(outs, axis=0)

    def _wait_retrying(self, staged: _StagedBatch, run, launch):
        """Wait for a dispatch through the recovery ladder: OOM → halving;
        another error → re-dispatch with backoff; past the budget → circuit
        and the per-image path; deadline → ``_WatchdogTimeout`` (the caller
        fails the batch). Returns ``(host rows, the launch that served them
        or None when a degraded path did)``."""
        # each degraded path runs after its ``except`` block: an error it
        # raises must not carry the OOM as its context (``_is_oom`` reads
        # the chain, so a failed capture of the halved key would pass for
        # an OOM and skip its retries)
        oom: Optional[BaseException] = None
        try:
            if isinstance(launch, _DispatchFailure):
                raise launch.error
            return self._wait_device(launch, self.batch, staged.trace_ids), launch
        except _WatchdogTimeout:
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            last = _released(e)
            if _is_oom(e):
                oom = last
        for attempt in range(1, self.retries + 1):
            if oom is not None:
                break
            self._note_retry("dispatch", attempt, staged.bucket, last, staged.trace_ids)
            try:
                launch = run(staged.arrays, staged.pinned)
                return self._wait_device(launch, self.batch, staged.trace_ids), launch
            except _WatchdogTimeout:
                raise
            except Exception as e:  # noqa: BLE001
                last = _released(e)
                if _is_oom(e):
                    oom = last
        if oom is not None:
            return self._run_degraded(staged, self.batch // 2, "oom", oom), None
        self._open_circuit(staged.bucket, "dispatch", last, staged.trace_ids)
        return self._run_degraded(staged, 1, "circuit"), None

    # ----------------------------------------------------------- stager

    def _slot_buffer(self, padder: BatchPadder, k: int, slot: List[np.ndarray]):
        """Input slot ``k``'s batch buffer: (the host array, the page-locked
        tensor it is a view of and the ring's buffer that tensor lies in,
        or None and None off the card)."""
        shape, dtype = padder.slot_shape(slot), np.result_type(*slot)
        if self._stage_locked and dtype in _PINNABLE:
            nbytes = math.prod(shape) * dtype.itemsize
            buf = self._host_buffers.take(k, nbytes)
            tensor = buf[:nbytes].view(_PINNABLE[dtype]).view(shape)
            return tensor.numpy(), tensor, buf
        return np.empty(shape, dtype), None, None

    def _yield_to_input_copy(self) -> None:
        """Wait, at most ``STAGE_YIELD_S``, for the batch last dispatched to
        finish its input copy: staging moves a batch's bytes through host
        memory, and the card's copy of the batch before reads host memory
        too; run at once they slow each other, and the copy is on the card's
        critical path (stager thread)."""
        copied = self._inputs_copied
        deadline = time.perf_counter() + STAGE_YIELD_S
        try:
            while (copied is not None and not copied.query()
                   and time.perf_counter() < deadline):
                time.sleep(STAGE_YIELD_POLL_S)
        except RuntimeError:  # a failed device: the dispatch reports it
            return

    def _stage(self, items: List[_Decoded], bucket) -> _StagedBatch:
        """Pack one bucket's items into a fixed micro-batch on the host,
        numbered by the engine's count of staged batches (stager thread)."""
        self._yield_to_input_copy()
        valid = len(items)
        items = items + [items[-1]] * (self.batch - valid)  # filler, masked by ``valid``
        trace_ids = [x.trace_id for x in items[:valid]]
        seq = next(self._batch_seq)
        t0 = time.perf_counter()
        with telemetry.span("h2d_stage", batch=seq, trace_ids=trace_ids):
            padder = BatchPadder([x.arrays[0].shape[:2] for x in items],
                                 divis_by=self.divis_by, divis_h=self.divis_h)
            inputs = [[x.arrays[k] for x in items] for k in range(len(items[0].arrays))]
            slots = [self._slot_buffer(padder, k, s) for k, s in enumerate(inputs)]
            per_item = -(-2 * STAGE_THREADS // self.batch)
            _run_bands([band for (out, _, _), s in zip(slots, inputs)
                        for band in padder.bands(out, s, per_item)])
        tensors, buffers = tuple(t for _, t, _ in slots), tuple(b for _, _, b in slots)
        locked = None not in tensors
        return _StagedBatch(bucket=bucket, payloads=[x.payload for x in items[:valid]],
                            padder=padder, arrays=tuple(a for a, _, _ in slots), valid=valid,
                            stage_s=time.perf_counter() - t0,
                            pinned=tensors if locked else None,
                            buffers=buffers if locked else None,
                            trace_ids=trace_ids, t_starts=[x.t_start for x in items[:valid]],
                            decode_s=[x.decode_s for x in items[:valid]], seq=seq)

    def _stage_put(self, put, items: List[_Decoded], bucket) -> bool:
        """Stage one micro-batch; a staging failure fails its requests only."""
        try:
            staged = self._stage(items, bucket)
        except Exception as e:  # noqa: BLE001 — isolated to the batch
            logger.warning("staging bucket %s failed (%s): failing its %d request(s)",
                           bucket, _errstr(e), len(items))
            for x in items:
                telemetry.emit("request_failed", stage="stage", bucket=list(bucket),
                               error=_errstr(e), trace_id=x.trace_id)
                if not put(_FailedRequest(x.payload, e, x.trace_id)):
                    return False
            return True
        return put(staged)

    def _stager_run(self, requests: Iterable, q: "queue.Queue", stop: threading.Event) -> None:
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            acc: Dict[Tuple[int, int], List[_Decoded]] = {}
            it = iter(requests)
            while not stop.is_set():
                # the caller's request source: a stall there shows here
                with telemetry.span("request_source"):
                    try:
                        req = next(it)
                    except StopIteration:
                        break
                if isinstance(req, FlushRequest):
                    for b in [req.bucket] if req.bucket is not None else sorted(acc):
                        items = acc.pop(b, None)
                        if items and not self._stage_put(put, items, b):
                            return
                    continue
                tid = getattr(req, "trace_id", None) or telemetry.new_trace_id()
                t_start = time.perf_counter()
                try:
                    with telemetry.span("request_decode", trace_id=tid):
                        faultinject.infer_decode_point(getattr(req, "payload", None))
                        arrays = req.resolve()  # the lazy decode runs here
                    bucket = bucket_shape(*arrays[0].shape[:2], divis_by=self.divis_by,
                                          divis_h=self.divis_h)
                except Exception as e:  # noqa: BLE001 — isolated to the request
                    telemetry.emit("request_failed", stage="decode", error=_errstr(e),
                                   trace_id=tid)
                    if not put(_FailedRequest(req.payload, e, tid)):
                        return
                    continue
                acc.setdefault(bucket, []).append(
                    _Decoded(req.payload, arrays, tid, t_start, time.perf_counter() - t_start))
                if len(acc[bucket]) == self.batch:
                    if not self._stage_put(put, acc.pop(bucket), bucket):
                        return
            for bucket in sorted(acc):  # partial buckets, in a fixed order
                if not self._stage_put(put, acc.pop(bucket), bucket):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put(e)
        finally:
            # on every exit path: a consumer never waits on a dead stager
            put(_END)

    # ----------------------------------------------------------- stream

    def stream(self, requests: Iterable) -> Iterator[InferResult]:
        """Run the engine over ``requests`` (``InferRequest``s and
        ``FlushRequest``s); yield unpadded results. One stream at a time per
        engine; the graphs, the circuit and cap state, and the stats persist
        across streams.

        A failed request or batch yields error results and the stream goes
        on; the request iterable raising, or a stager that stages nothing
        within ``deadline_s`` (``InferStallError``), fails the stream."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        thread = threading.Thread(target=self._stager_run, args=(requests, q, stop),
                                  name="infer-stager", daemon=True)
        thread.start()
        pending = None
        stalled = False
        t_stream = time.perf_counter()
        try:
            while True:
                item = _NOT_STAGED
                if self.eager_finalize and pending is not None:
                    # nothing staged: the held dispatch overlaps nothing, and
                    # the next request may depend on its result
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        yield from self._finalize(pending)
                        pending = None
                        continue
                t0 = time.perf_counter()
                if item is _NOT_STAGED:
                    with telemetry.span("decode_wait"):
                        try:
                            item = (q.get() if self.deadline_s is None
                                    else q.get(timeout=self.deadline_s))
                        except queue.Empty:
                            if not self.idle_watchdog and thread.is_alive():
                                continue  # a long-lived feed: idle, not wedged
                            stalled = True
                            self.stats.watchdog_trips += 1
                            telemetry.emit("watchdog_trip", where="stager",
                                           deadline_s=self.deadline_s,
                                           stager_alive=thread.is_alive(),
                                           batches_done=self.stats.batches)
                            # the stacks of the stall, while they still show it
                            blackbox.request_dump(
                                "watchdog_trip", f"stager stalled > {self.deadline_s:g}s "
                                f"(alive={thread.is_alive()})")
                            raise InferStallError(
                                f"stager staged nothing for {self.deadline_s:g}s "
                                f"(--infer_timeout); stager thread alive={thread.is_alive()}, "
                                f"{self.stats.batches} batch(es) done") from None
                t_got = time.perf_counter()
                wait_s = t_got - t0
                if isinstance(item, BaseException):
                    blackbox.request_dump("stream_death", _errstr(item))
                    raise item
                if item is _END:
                    break
                if isinstance(item, _FailedRequest):
                    self.stats.failed += 1
                    telemetry.inc_metric("infer_requests_total", status="failed")
                    if not quality.is_canary(item.payload):
                        telemetry.observe_slo(self.tier_label, None, ok=False)
                    logger.warning("request %r failed before dispatch: %s", item.payload,
                                   _errstr(item.error))
                    yield InferResult(payload=item.payload, error=item.error,
                                      trace_id=item.trace_id)
                    continue
                self.stats.decode_wait_s += wait_s
                if self.stats.batches > 0 and wait_s > STAGER_UNDERRUN_S:
                    self.stats.underruns += 1
                    telemetry.emit("stager_underrun", wait_ms=round(wait_s * 1e3, 1))
                item.wait_s, item.t_got = wait_s, t_got
                with telemetry.span("dispatch", batch=item.seq, trace_ids=item.trace_ids):
                    dispatched = self._dispatch(item)
                self._account(item)
                if pending is not None:
                    yield from self._finalize(pending)
                pending = dispatched
            if pending is not None:
                yield from self._finalize(pending)
                pending = None
        finally:
            stop.set()
            while True:  # unblock a stager stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            # a stager already declared stalled is abandoned (daemon thread)
            thread.join(timeout=0.1 if stalled else 5.0)
            if self._wait_worker is not None:
                self._wait_worker.close()
                self._wait_worker = None
            close = getattr(requests, "close", None)
            if not thread.is_alive() and close is not None:
                close()
            self.stats.stream_s += time.perf_counter() - t_stream

    def _dispatch(self, staged: _StagedBatch):
        """Launch a staged batch: ``(staged, run, launch)`` on its graph or
        eager key, or ``(staged, None, (micro_batch, reason[, error]))`` for
        a batch that goes straight to a degraded path (a broken or capped
        bucket: no repeated compiles, no repeated OOMs; or an OOM at its
        warm-up or capture)."""
        if staged.bucket in self._broken:
            return staged, None, (1, "circuit")
        cap = self._bucket_cap.get(staged.bucket)
        if cap is not None:
            return staged, None, (cap, "oom_capped")
        try:
            run = self._executable(staged)
        except Exception as e:  # noqa: BLE001 — an OOM at warm-up or capture
            return staged, None, (self.batch // 2, "oom", _released(e))
        if run is None:  # the compile circuit just opened
            return staged, None, (1, "circuit")
        try:
            launch = run(staged.arrays, staged.pinned)
        except Exception as e:  # noqa: BLE001 — walks the ladder at finalize
            launch = _DispatchFailure(_released(e))
        return staged, run, launch

    def _account(self, staged: _StagedBatch) -> None:
        # ``images`` is counted at finalize: a batch that fails later must
        # not count as completed
        self.stats.batches += 1
        self.stats.padded_slots += self.batch - staged.valid
        self.stats.h2d_stage_s += staged.stage_s
        self.stats.buckets[staged.bucket] = self.stats.buckets.get(staged.bucket, 0) + staged.valid

    def _finalize(self, dispatched) -> Iterator[InferResult]:
        staged, run, out = dispatched
        # device_batch: the time the consumer is blocked on device results,
        # from the wait on (not from the dispatch)
        t0 = time.perf_counter()
        try:
            with telemetry.span("device_batch", batch=staged.seq, bucket=staged.label,
                                trace_ids=staged.trace_ids):
                if run is None:
                    host, launch = self._run_degraded(staged, *out), None
                else:
                    host, launch = self._wait_retrying(staged, run, out)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — the batch fails, not the stream
            yield from self._fail_batch(staged, e)
            return
        if staged.buffers is not None:
            # the copies that read them completed before the output copy
            # this wait saw: the stager may refill them
            self._host_buffers.give(staged.buffers)
            staged.pinned = staged.buffers = None
            staged.arrays = ()
        t1 = time.perf_counter()
        device_s = t1 - t0
        self.stats.device_batch_s += device_s
        if launch is not None and launch.ms is not None:
            self.stats.batch_ms.append(launch.ms)
            self.stats.batch_valid.append(staged.valid)
            self.stats.stage_ms.append(launch.stage_ms or {})
        if launch is not None and launch.stage_ms:
            for stage, ms in launch.stage_ms.items():
                telemetry.observe("infer_stage_device_seconds", ms / 1e3, stage=stage,
                                  bucket=staged.label)
        telemetry.emit("infer_batch_commit", bucket=list(staged.bucket), valid=staged.valid,
                       padded=self.batch - staged.valid, wait_ms=round(staged.wait_s * 1e3, 1),
                       h2d_ms=round(staged.stage_s * 1e3, 1),
                       device_ms=round(device_s * 1e3, 1), trace_ids=staged.trace_ids)
        self.stats.observe_latency("h2d", staged.label, staged.stage_s)
        self.stats.observe_latency("device", staged.label, device_s)
        for i, window in enumerate(staged.padder.unpad_all(host, staged.valid)):
            self.stats.images += 1
            # decode: the stager's resolve; queue_wait: decoded → taken by
            # the consumer; e2e: decode start → result ready
            self.stats.observe_latency("decode", staged.label, staged.decode_s[i])
            self.stats.observe_latency(
                "queue_wait", staged.label,
                max(staged.t_got - staged.t_starts[i] - staged.decode_s[i], 0.0))
            self.stats.observe_latency("e2e", staged.label, t1 - staged.t_starts[i])
            telemetry.inc_metric("infer_requests_total", status="completed")
            # canaries check their golden and stay out of the SLO; user
            # results fold into the tier's drift sketch (no-ops with no
            # monitor installed)
            if not quality.is_canary(staged.payloads[i]):
                telemetry.observe_slo(self.tier_label, t1 - staged.t_starts[i])
            # a host copy of a host window (``host`` is the batch's pinned
            # read-back, synchronised in ``_wait_device``): each result owns
            # its array, and the pinned buffer goes back to the pool
            output = np.array(window)  # graftcheck: disable=GC02
            quality.observe_result(self.tier_label, staged.payloads[i], output)
            yield InferResult(payload=staged.payloads[i], output=output,
                              bucket=staged.bucket, trace_id=staged.trace_ids[i])

    def _fail_batch(self, staged: _StagedBatch, e: BaseException) -> Iterator[InferResult]:
        """Every recovery failed (or the watchdog tripped): the batch's
        requests become error results and the stream goes on."""
        if isinstance(e, _WatchdogTimeout):
            self.stats.watchdog_trips += 1
            telemetry.emit("watchdog_trip", where="device", bucket=list(staged.bucket),
                           deadline_s=self.deadline_s, error=_errstr(e),
                           trace_ids=staged.trace_ids)
            # the wedged wait worker's stack is still live for the dump
            blackbox.request_dump("watchdog_trip",
                                  f"device dispatch hung in bucket {staged.label}")
        logger.error("batch of %d request(s) in bucket %s failed: %s", staged.valid,
                     staged.bucket, _errstr(e))
        err = _released(e if isinstance(e, Exception) else RuntimeError(_errstr(e)))
        for i, payload in enumerate(staged.payloads):
            self.stats.failed += 1
            telemetry.emit("request_failed", stage="device", bucket=list(staged.bucket),
                           error=_errstr(e), trace_id=staged.trace_ids[i])
            telemetry.inc_metric("infer_requests_total", status="failed")
            if not quality.is_canary(payload):
                telemetry.observe_slo(self.tier_label, None, ok=False)
            yield InferResult(payload=payload, bucket=staged.bucket, error=err,
                              trace_id=staged.trace_ids[i])


# ------------------------------------------------- adaptive-compute results

# Aux channels an adaptive (converge_eps > 0) serving forward appends after
# the disparity channel: [iters_done, iters_total], constant over the plane
# (the exit is batch-level: every member ran the same count).
ADAPTIVE_AUX_CHANNELS = 2


def wrap_adaptive_stream(stream_fn: Callable) -> Callable:
    """Strip an adaptive forward's aux channels off every completed result
    and turn them into telemetry: the ``iters_saved`` per-bucket histogram,
    ``refine_requests_total{outcome=}``, the quality observatory's
    ``iters_done`` sensor, and a ``refine_early_exit`` event whenever the
    exit fired. Past this wrapper results keep the [H, W, 1] contract."""

    def serve(requests: Iterable) -> Iterator[InferResult]:
        for res in stream_fn(requests):
            out = res.output
            if res.ok and out is not None and out.shape[-1] > ADAPTIVE_AUX_CHANNELS:
                # host math on a host result: ``output`` is the engine's
                # already-materialized np window, never a device value
                iters_done = int(round(float(out[0, 0, -2])))  # graftcheck: disable=GC02
                iters_total = int(round(float(out[0, 0, -1])))  # graftcheck: disable=GC02
                res.output = out[..., :-ADAPTIVE_AUX_CHANNELS]
                saved = max(iters_total - iters_done, 0)
                label = f"{res.bucket[0]}x{res.bucket[1]}" if res.bucket else "?"
                telemetry.observe("iters_saved", float(saved), bucket=label)
                telemetry.inc_metric("refine_requests_total",
                                     outcome="early_exit" if saved else "full")
                if not quality.is_canary(res.payload):
                    quality.observe_iters("serving", iters_done)
                if saved:
                    telemetry.emit("refine_early_exit",
                                   bucket=list(res.bucket) if res.bucket else None,
                                   iters=iters_total, iters_done=iters_done, saved=saved,
                                   trace_id=res.trace_id)
            yield res

    return serve


# ----------------------------------------------------------------- CLI glue


@dataclass(frozen=True)
class InferOptions:
    """The serving options shared by evaluate and demo: the engine's, the
    scheduler's and the lifecycle's, adaptive compute's and the quality
    observatory's, with the JAX package's defaults."""

    batch: int = 4
    prefetch: int = 2
    max_executables: int = 16
    deadline_s: Optional[float] = 300.0
    retries: int = 2
    # the persistent graph store's directory (runtime/aot_store.py)
    aot_dir: Optional[str] = None
    sched: bool = False
    sched_max_wait: float = 2.0
    # None keeps the scheduler's blocking backpressure; an int sheds
    max_pending: Optional[int] = None
    drain_timeout: float = 30.0
    # tiered serving (runtime/tiers.py): one named tier, or the fast ->
    # quality cascade with its escalation bar; the MADNet2 fast tier's
    # checkpoint
    tier: Optional[str] = None
    cascade: bool = False
    cascade_threshold: float = 0.85
    fast_ckpt: Optional[str] = None
    # the localhost debug server, and the per-tier latency SLO
    debug_port: Optional[int] = None
    slo_p95_ms: Optional[float] = None
    slo_budget: float = 0.01
    # inert unless adaptive_iters: the allowed iteration counts, the
    # convergence exit's threshold, and video (warm-start) serving, which
    # the video modes set
    adaptive_iters: bool = False
    iter_tiers: Optional[Tuple[int, ...]] = None
    converge_eps: float = 0.0
    video: bool = False
    # the overload controller (runtime/controller.py): off by default; its
    # cadence, promotion dwell and high bands (the low bands derive)
    controller: bool = False
    controller_interval: float = 0.5
    controller_dwell: float = 2.0
    controller_burn_high: float = 1.0
    controller_depth_high: int = 8
    # the drift sentinels are on by default; canaries only with canary_every
    quality: bool = True
    quality_window: int = 32
    quality_reference: int = 64
    canary_every: int = 0
    canary_latch: int = 3
    canary_tol: float = 0.5
    golden_dir: Optional[str] = None
    # the spatial tier (evaluate's and demo's serving): None keeps it off,
    # and no spatial code runs; else the padded bucket H·W above which the
    # scheduler routes a request to the tier that splits its rows over
    # ``spatial_shards`` devices (0: every visible card; no CLI flag)
    spatial_threshold: Optional[int] = None
    spatial_shards: int = 0


def add_infer_args(parser, default_batch: int = 4) -> None:
    """Register the serving flags."""
    parser.add_argument(
        "--infer_batch", type=int, default=default_batch,
        help="micro-batch size of the batched inference engine: inputs are grouped into "
        "shape buckets, H and W padded to multiples of the model's divisor (divis_by: 32 "
        "for RAFT-Stereo, 128 for MADNet2), and packed into fixed batches of this size (a "
        "partial batch is filled up and masked, so it runs the same captured graph)")
    parser.add_argument(
        "--per_image", action="store_true",
        help="bypass the engine: one pair per forward, synchronously (the reference "
        "protocol; KITTI's per-pair FPS is defined in this mode only)")
    parser.add_argument(
        "--infer_prefetch", type=int, default=2,
        help="staged-batch queue depth of the engine's decode/pad stager thread")
    parser.add_argument(
        "--infer_timeout", type=float, default=300.0, metavar="SECONDS",
        help="deadline of every wait the engine blocks on: a stager that stages nothing "
        "for this long fails the stream, a device wait that passes it fails its batch "
        "(watchdog); <= 0 disables both")
    parser.add_argument(
        "--infer_retries", type=int, default=2,
        help="compile (warm-up and capture) and dispatch retry budget per micro-batch, "
        "with exponential backoff; past it the shape bucket is circuit-broken and served "
        "one pair at a time by the degraded path")
    parser.add_argument(
        "--aot_dir", default=None, metavar="DIR",
        help="persistent graph store: the capture recipe of every (bucket, batch) graph the "
        "engine captures is committed to DIR (CRC-manifested, atomically), and an engine "
        "built on a populated store captures every stored key before it admits a request, so "
        "a warm restart performs zero bucket compiles; corrupt or version-skewed entries are "
        "rejected (aot_store_reject) and compile on first use, never served")
    parser.add_argument(
        "--sched", action="store_true",
        help="route requests through the continuous-batching scheduler: an admission "
        "thread decodes ahead into per-shape-bucket queues and dispatches whichever "
        "bucket can form a full micro-batch first (deadline and priority break ties) "
        "instead of arrival order")
    parser.add_argument(
        "--sched_max_wait", type=float, default=2.0, metavar="SECONDS",
        help="the scheduler's anti-starvation bound: a bucket whose oldest pending "
        "request has waited this long is dispatched as a partial (masked) batch ahead of "
        "full buckets")
    parser.add_argument(
        "--max_pending", type=int, default=None, metavar="N",
        help="load shedding (scheduler runs only): a request arriving while N requests "
        "are queued is rejected at once (sched_shed reason=queue_full), and one whose "
        "deadline the bucket's EWMA service time already misses is rejected at admission "
        "(reason=deadline); rejections are typed error results (default: off, blocking "
        "backpressure)")
    parser.add_argument(
        "--drain_timeout", type=float, default=30.0, metavar="SECONDS",
        help="graceful-drain bound: on the first SIGTERM/SIGINT admission stops, pending "
        "buckets flush, in-flight batches complete, and whatever is still queued after "
        "this many seconds resolves as a typed drained error; a second signal is "
        "immediate")
    parser.add_argument(
        "--tier", default=None, metavar="NAME",
        help="serve through one named tier of the tiered registry (runtime/tiers.py): "
        "'quality' routes every request to this CLI's RAFT-Stereo model through the tiered "
        "dispatcher (outputs bitwise the untiered engine's), 'fast' to a MADNet2 tier where "
        "the CLI builds one; default: untiered serving")
    parser.add_argument(
        "--cascade", action="store_true",
        help="confidence-gated cascade: every pair runs the fast (MADNet2) tier first, a "
        "left-right photometric confidence of its disparity is computed on the host, and "
        "pairs below --cascade_threshold are escalated to the quality (RAFT-Stereo) tier; "
        "an escalated result replaces the fast one, a failed escalation falls back to it, "
        "and every request resolves exactly once")
    parser.add_argument(
        "--cascade_threshold", type=float, default=0.85, metavar="CONF",
        help="confidence in [0, 1] below which a fast result escalates (1.0 escalates "
        "everything, 0.0 accepts everything)")
    parser.add_argument(
        "--debug_port", type=int, default=None, metavar="PORT",
        help="start the introspection server on 127.0.0.1:PORT (0: an ephemeral port, "
        "printed at start): /healthz, /metrics, /debug/queues, /debug/snapshots, "
        "/debug/stacks, /debug/quality, /debug/requests/<trace_id>; read-only, loopback "
        "only, off by default")
    parser.add_argument(
        "--slo_p95_ms", type=float, default=None, metavar="MS",
        help="arm per-tier SLO accounting against this end-to-end latency target: every "
        "resolved request is a hit (completed within it) or a miss (late, failed, shed or "
        "drained); hit rate and budget burn go to the heartbeat, the summary and "
        "metrics.prom (default: off)")
    parser.add_argument(
        "--slo_budget", type=float, default=0.01, metavar="FRAC",
        help="the miss fraction the --slo_p95_ms target tolerates (the error budget)")
    parser.add_argument(
        "--controller", action="store_true",
        help="arm the overload controller (runtime/controller.py): a control thread reads "
        "the SLO budget burn and the scheduler queue depths every --controller_interval "
        "seconds and moves a degradation ladder one rung at a time (lower the cascade bar, "
        "route default traffic one iteration tier down, adapt less often, halve the "
        "admission cap), promoting back one rung per --controller_dwell of calm; every "
        "decision is a ctrl_degrade / ctrl_promote / ctrl_hold event (default: off)")
    parser.add_argument(
        "--controller_interval", type=float, default=0.5, metavar="SECONDS",
        help="the controller's cadence: sensors read and at most one rung moved each")
    parser.add_argument(
        "--controller_dwell", type=float, default=2.0, metavar="SECONDS",
        help="the calm (every sensor below its low band, continuously) one promotion needs")
    parser.add_argument(
        "--controller_burn_high", type=float, default=1.0, metavar="BURN",
        help="degrade above this windowed SLO budget burn; the promote band is half of it")
    parser.add_argument(
        "--controller_depth_high", type=int, default=8, metavar="N",
        help="degrade above this many requests pending in the deepest scheduler queue; "
        "the promote band is a quarter of it")
    parser.add_argument(
        "--adaptive_iters", action="store_true",
        help="adaptive compute: the batch-level convergence exit (--converge_eps) and "
        "video warm-start serving (demo --serve_video); without it both are inert")
    parser.add_argument(
        "--iter_tiers", default=None, metavar="N,N,...",
        help="allowed per-request refinement-iteration counts under --adaptive_iters "
        "(e.g. 7,16,32): each count gets its own engine behind one tiered dispatcher; a "
        "SchedRequest.iters pin snaps up to the nearest allowed count, a deadline <= 1s "
        "rides the smallest, everything else the largest; --valid_iters is always one of "
        "them (default: --valid_iters only)")
    parser.add_argument(
        "--converge_eps", type=float, default=0.0, metavar="EPS",
        help="batch-level convergence exit under --adaptive_iters: stop refining once "
        "the batch's largest per-sample mean |delta| falls below EPS (the forward runs "
        "eagerly, one host read a step); iterations saved are counted per bucket in the "
        "iters_saved metric and refine_early_exit events; 0 disables it")
    parser.add_argument(
        "--no_quality", action="store_true",
        help="disable the quality observatory: no drift sentinels, no canaries, no "
        "quality events or gauges")
    parser.add_argument(
        "--quality_window", type=int, default=32, metavar="N",
        help="drift-sentinel window: every N completed user results a tier closes one "
        "window, scored (PSI/KS a sensor) against the frozen reference")
    parser.add_argument(
        "--quality_reference", type=int, default=64, metavar="N",
        help="drift-sentinel reference: a tier's first N completed user results freeze "
        "as its reference distribution; no alarm can fire before")
    parser.add_argument(
        "--canary_every", type=int, default=0, metavar="N",
        help="golden canaries: one deterministic known-input request after every N user "
        "requests, through the real serving path at the lowest priority, outside the "
        "user SLO and queue-depth accounting (default 0: none)")
    parser.add_argument(
        "--canary_latch", type=int, default=3, metavar="N",
        help="consecutive canary-golden failures on one tier that latch the quality "
        "alarm (the blackbox dumps)")
    parser.add_argument(
        "--canary_tol", type=float, default=0.5, metavar="PX",
        help="canary bound (mean |disparity difference| from the golden, px) where the "
        "check is not bit-exact (bf16, the early exit); the fp32 path checks bit-exact")
    parser.add_argument(
        "--golden_dir", default=None, metavar="DIR",
        help="canary goldens (one npz per canary shape): loaded at start when present; a "
        "run that captured goldens saves them there, so the next run checks against them")
    parser.add_argument(
        "--spatial_threshold", type=int, default=None, metavar="PIXELS",
        help="megapixel serving: route requests whose padded bucket exceeds this many "
        "pixels (H*W) to the spatial tier, which splits each request's rows over the "
        "visible cards and exchanges halo rows between them (the correlation volume "
        "splits with them), instead of letting oversized buckets trip the per-image "
        "circuit fallback; the overload controller may raise the bar under saturation "
        "(megapixel work is shed first); default: off, no spatial code runs and serving "
        "is bit-identical to serving without the tier")
    parser.add_argument(
        "--max_failed_frac", type=float, default=0.0, metavar="FRAC",
        help="tolerated fraction of failed requests before the run exits non-zero "
        "(default 0: any failure fails the run); failed requests are always excluded "
        "from metrics and counted in the summary line")
    parser.add_argument(
        "--telemetry_dir", default=None, metavar="DIR",
        help="write runtime telemetry under DIR: events.jsonl (bucket_compile, "
        "infer_batch_commit, stager_underrun, request_failed, infer_retry, "
        "bucket_circuit_open, infer_degraded, watchdog_trip, each with the requests' "
        "trace ids), trace_host.json spans, a serving heartbeat.json and metrics.prom "
        "with per-bucket latency percentiles; also arms the blackbox (SIGUSR2 dumps "
        "blackbox.json there)")


def parse_iter_tiers(spec) -> Optional[Tuple[int, ...]]:
    """``"7,16,32"`` → (7, 16, 32), sorted and deduplicated; None or empty →
    None. Every count must be >= 1."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, (tuple, list)):
        tiers = tuple(int(t) for t in spec)
    else:
        try:
            tiers = tuple(int(t) for t in str(spec).split(",") if t.strip())
        except ValueError:
            raise ValueError(f"--iter_tiers expects comma-separated integers, got "
                             f"{spec!r}") from None
    if not tiers or any(t < 1 for t in tiers):
        raise ValueError(f"--iter_tiers entries must be >= 1, got {spec!r}")
    return tuple(sorted(set(tiers)))


def options_from_args(args) -> Optional[InferOptions]:
    """``None`` means the per-image path. ``--adaptive_iters`` gates its
    sub-options: without it they are inert and the options equal the
    defaults."""
    if args.per_image:
        return None
    timeout = args.infer_timeout
    adaptive = bool(getattr(args, "adaptive_iters", False))
    return InferOptions(
        batch=args.infer_batch, prefetch=args.infer_prefetch,
        deadline_s=None if timeout is None or timeout <= 0 else timeout,
        retries=args.infer_retries,
        aot_dir=getattr(args, "aot_dir", None),
        sched=getattr(args, "sched", False),
        sched_max_wait=getattr(args, "sched_max_wait", 2.0),
        max_pending=getattr(args, "max_pending", None),
        drain_timeout=getattr(args, "drain_timeout", 30.0),
        tier=getattr(args, "tier", None),
        cascade=getattr(args, "cascade", False),
        cascade_threshold=getattr(args, "cascade_threshold", 0.85),
        fast_ckpt=getattr(args, "fast_ckpt", None),
        debug_port=getattr(args, "debug_port", None),
        slo_p95_ms=getattr(args, "slo_p95_ms", None),
        slo_budget=getattr(args, "slo_budget", 0.01),
        adaptive_iters=adaptive,
        iter_tiers=parse_iter_tiers(getattr(args, "iter_tiers", None)) if adaptive else None,
        converge_eps=float(getattr(args, "converge_eps", 0.0)) if adaptive else 0.0,
        video=bool(getattr(args, "serve_video", False)) and adaptive,
        controller=bool(getattr(args, "controller", False)),
        controller_interval=getattr(args, "controller_interval", 0.5),
        controller_dwell=getattr(args, "controller_dwell", 2.0),
        controller_burn_high=getattr(args, "controller_burn_high", 1.0),
        controller_depth_high=getattr(args, "controller_depth_high", 8),
        quality=not getattr(args, "no_quality", False),
        quality_window=getattr(args, "quality_window", 32),
        quality_reference=getattr(args, "quality_reference", 64),
        canary_every=getattr(args, "canary_every", 0),
        canary_latch=getattr(args, "canary_latch", 3),
        canary_tol=getattr(args, "canary_tol", 0.5),
        golden_dir=getattr(args, "golden_dir", None),
        spatial_threshold=getattr(args, "spatial_threshold", None),
    )


def install_cli_telemetry(args) -> Optional[telemetry.Telemetry]:
    """Install a telemetry sink for a serving CLI run (``--telemetry_dir``),
    with SLO accounting armed when the args carry ``slo_p95_ms``."""
    if getattr(args, "telemetry_dir", None):
        tel = telemetry.install(telemetry.Telemetry(args.telemetry_dir))
        slo_ms = getattr(args, "slo_p95_ms", None)
        if slo_ms:
            tel.configure_slo(slo_ms, getattr(args, "slo_budget", 0.01))
        return tel
    return None


def install_cli_introspection(args) -> Callable[[], None]:
    """The forensics layer of a serving CLI run: with ``--telemetry_dir``, a
    blackbox dumper over that directory, watching SIGUSR2 (the operator's
    dump signal); with ``--debug_port``, the introspection server. Call it
    before building engines, so their snapshot hooks register with it;
    returns an idempotent teardown."""
    closers: List[Callable[[], None]] = []
    if getattr(args, "telemetry_dir", None):
        dumper = blackbox.install(blackbox.BlackboxDumper(args.telemetry_dir))
        dumper.watch_signal()
        closers.append(lambda: blackbox.uninstall(dumper))
    if getattr(args, "debug_port", None) is not None:
        from raft_stereo_tpu_torch.runtime.debug_server import DebugServer

        server = DebugServer(args.debug_port).start()
        print(f"[debug] introspection server on http://{server.host}:{server.port}",
              flush=True)
        if not getattr(args, "telemetry_dir", None):
            # providers register with the blackbox dumper, which needs a
            # run directory: without one the queue views stay empty
            logger.warning("--debug_port without --telemetry_dir: no blackbox dumper is "
                           "installed, so /debug/queues and the /healthz provider census "
                           "stay empty; pass --telemetry_dir for the full view")
        closers.append(server.close)

    def teardown() -> None:
        for close in reversed(closers):
            try:
                close()
            except Exception:  # noqa: BLE001 — teardown must not mask errors
                logger.exception("introspection teardown failed")
        closers.clear()

    return teardown

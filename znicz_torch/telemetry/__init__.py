"""The port's telemetry (port of ``znicz_tpu/telemetry/__init__.py``):
ONE process-wide metrics registry, trace ring, event journal and fleet
stores that the master server, slave client, wire codec, chaos proxy,
batcher, serving frontend, balancer, model runner, snapshotter, fused
trainer, unit engine and decision loop register into.

Surfaces:

  - ``/metrics`` on ``web_status.WebStatus``: Prometheus text of every
    registered counter, gauge and histogram (``metrics.py``); on a fleet
    coordinator the members' series too, under ``member=<origin>``;
  - ``/trace.json``: the span ring as Chrome trace-event JSON
    (``trace.py``); ``?fleet=1`` the stitched cross-process timeline;
  - ``/events.json``, ``/slo.json``, ``/fleet.json``: the journal
    (``events.py``), the SLO burn rates and the fleet rollup
    (``fleet.py``);
  - ``--profile-dir`` on the launcher: a ``torch.profiler`` capture with
    :func:`step_annotation` around each fused train-step dispatch.

``set_enabled(False)`` turns the optional layer off: spans stop
recording and the trainer's step histogram stops observing.  Service
accounting counters (bytes, jobs, refusals) always run.

Observation happens on the host around a device dispatch, never inside
code a CUDA graph captures (a captured body runs once, at capture).
"""

from __future__ import annotations

import os
import threading

from znicz_torch.core.config import root

from .events import EventJournal, FleetEventStore  # noqa: F401
from .fleet import (FleetMetricsStore, FleetTraceStore,  # noqa: F401
                    SloTracker, SpanExporter, process_identity,
                    registry_snapshot, render_fleet_prometheus)
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, Scope, registered_property,
                      weak_fn)
from .trace import NULL_SPAN, TraceRing  # noqa: F401

#: declaration table for the ``root.common.telemetry.*`` knobs (the
#: telemetry tree is process-wide, not plane-specific, so its knobs
#: live here rather than in ENGINE_DEFAULTS / serving DEFAULTS; same
#: contract — a key read anywhere below must appear here)
TELEMETRY_DEFAULTS = {
    "enabled": True,            # optional layer (spans + hot histograms)
    "trace_capacity": 16384,    # process span-ring size (events)
    "profile_steps": False,     # torch.profiler range per train step
    # -- fleet observability plane -----------------------------------------
    "events_capacity": 512,     # process event-journal ring (events)
    "span_export_capacity": 1024,   # exporter buffer (spans, drops-oldest)
    "span_export_all": False,   # export spans without a trace_id too
    "span_export_batch": 128,   # max spans per piggyback carrier
    "fleet_trace_capacity": 8192,   # coordinator stitched-span ring
    "fleet_events_capacity": 2048,  # coordinator merged-journal ring
}

_REGISTRY = MetricsRegistry()
_TRACER = None
_TRACER_LOCK = threading.Lock()
_PROFILE_STEPS = False
_IDENTITY = None
_JOURNAL = None
_EXPORTER = None
_FLEET_TRACE = None
_FLEET_EVENTS = None
_FLEET_METRICS = None
_SLO_TRACKERS = []


def registry() -> MetricsRegistry:
    """The process-wide registry (the ``/metrics`` exposition source)."""
    return _REGISTRY


def tracer() -> TraceRing:
    """The process-wide span ring (the ``/trace.json`` source).

    Created LAZILY on first use, so ``root.common.telemetry
    .trace_capacity`` / ``.enabled`` set any time before the first
    telemetry consumer is constructed (launcher overrides, test/config
    setup) take effect — merely importing a module that imports
    telemetry does not latch the config.  ``set_enabled`` toggles at
    runtime; capacity is fixed once the ring exists."""
    global _TRACER
    if _TRACER is None:
        # double-checked under a lock: components construct from
        # multiple threads (a slave thread's Client racing the main
        # thread's Server) and each caches the ring it gets — two rings
        # would leave one component deaf to set_enabled and its spans
        # missing from /trace.json for the process lifetime
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = TraceRing(
                    capacity=int(root.common.telemetry.get(
                        "trace_capacity", 16384)),
                    enabled=bool(root.common.telemetry.get("enabled",
                                                           True)))
    return _TRACER


def scope(component: str, **labels) -> Scope:
    """``registry().scope(...)`` shorthand — what components call in
    their constructors."""
    return _REGISTRY.scope(component, **labels)


def span(cat: str, name: str, **args):
    """``tracer().span(...)`` shorthand (no-op context when disabled)."""
    return tracer().span(cat, name, **args)


def enabled() -> bool:
    return tracer().enabled


def set_enabled(on: bool) -> None:
    """Toggle the optional layer (spans + hot-loop histograms) at
    runtime: a measurement's interleaved on/off windows."""
    tracer().enabled = bool(on)


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


def chrome_trace() -> dict:
    return tracer().chrome_trace()


def set_identity(role: str) -> str:
    """Name this logical process for the fleet plane (``balancer``,
    ``replica-3``, ``master``, ``slave-w1``, ``client``...).  Returns
    the full origin (``role@pid``).  Latches the journal/exporter
    origin if they already exist; call early (component constructors
    do)."""
    global _IDENTITY
    _IDENTITY = process_identity(role)
    if _JOURNAL is not None:
        _JOURNAL.origin = _IDENTITY
    if _EXPORTER is not None:
        _EXPORTER.origin = _IDENTITY
    return _IDENTITY


def identity() -> str:
    """This logical process's fleet origin (defaulted from the pid)."""
    global _IDENTITY
    if _IDENTITY is None:
        _IDENTITY = process_identity("proc")
    return _IDENTITY


def journal() -> EventJournal:
    """The process-wide structured event journal (``/events.json``
    source).  Lazy and config-sized like :func:`tracer`."""
    global _JOURNAL
    if _JOURNAL is None:
        with _TRACER_LOCK:
            if _JOURNAL is None:
                _JOURNAL = EventJournal(
                    capacity=int(root.common.telemetry.get(
                        "events_capacity", 512)),
                    origin=identity())
    return _JOURNAL


def emit(kind: str, plane: str, **fields) -> int:
    """``journal().emit(...)`` shorthand — THE idiom every state
    transition uses (the reference's ``event-journal`` lint greps the
    named decision points for exactly this call)."""
    return journal().emit(kind, plane, **fields)


def exporter() -> SpanExporter:
    """The process-wide fleet span exporter, registered as a tracer
    sink on first use.  Drained by the piggyback carriers (heartbeats,
    update messages, reply summaries)."""
    global _EXPORTER
    if _EXPORTER is None:
        ring = tracer()   # materialize OUTSIDE the lock (non-reentrant)
        with _TRACER_LOCK:
            if _EXPORTER is None:
                exp = SpanExporter(
                    origin=identity(),
                    capacity=int(root.common.telemetry.get(
                        "span_export_capacity", 1024)),
                    export_all=bool(root.common.telemetry.get(
                        "span_export_all", False)))
                ring.add_sink(exp)
                _EXPORTER = exp
    return _EXPORTER


def span_export_batch() -> int:
    return int(root.common.telemetry.get("span_export_batch", 128))


def fleet_trace() -> FleetTraceStore:
    """Coordinator-side stitched-trace store (``/trace.json?fleet=1``)."""
    global _FLEET_TRACE
    if _FLEET_TRACE is None:
        with _TRACER_LOCK:
            if _FLEET_TRACE is None:
                _FLEET_TRACE = FleetTraceStore(
                    capacity=int(root.common.telemetry.get(
                        "fleet_trace_capacity", 8192)))
    return _FLEET_TRACE


def fleet_events() -> FleetEventStore:
    """Coordinator-side merged event journal (``/events.json?fleet=1``)."""
    global _FLEET_EVENTS
    if _FLEET_EVENTS is None:
        with _TRACER_LOCK:
            if _FLEET_EVENTS is None:
                _FLEET_EVENTS = FleetEventStore(
                    capacity=int(root.common.telemetry.get(
                        "fleet_events_capacity", 2048)))
    return _FLEET_EVENTS


def fleet_metrics() -> FleetMetricsStore:
    """Coordinator-side member registry snapshots (``/metrics``
    superset + ``/fleet.json`` rollup)."""
    global _FLEET_METRICS
    if _FLEET_METRICS is None:
        with _TRACER_LOCK:
            if _FLEET_METRICS is None:
                _FLEET_METRICS = FleetMetricsStore()
    return _FLEET_METRICS


def drain_own_spans() -> int:
    """Coordinator self-ingest: spans recorded in THIS process flow
    into the fleet trace store under per-span origins derived from
    their category (``client@pid``, ``balancer@pid``...): a process
    hosting several logical roles (client + balancer share one
    interpreter) still renders them as DISTINCT fleet participants in
    the stitched timeline."""
    spans = exporter().drain(span_export_batch())
    if not spans:
        return 0
    store = fleet_trace()
    pid = os.getpid()
    n = 0
    for s in spans:
        n += store.ingest(f"{s.get('cat', 'proc')}@{pid}", [s])
    return n


def drain_own_events() -> int:
    """Coordinator self-ingest of the local journal into the merged
    fleet journal (the store's per-origin high-water dedups repeats)."""
    store = fleet_events()
    me = identity()
    return store.ingest(me, journal().since(store.cursor(me)))


def register_slo(tracker: SloTracker) -> SloTracker:
    """Expose a plane's SLO tracker on ``/slo.json`` / the web panel
    (latest tracker per plane wins — rebuilt components replace their
    predecessor like registry children do)."""
    global _SLO_TRACKERS
    _SLO_TRACKERS = [t for t in _SLO_TRACKERS if t.plane != tracker.plane]
    _SLO_TRACKERS.append(tracker)
    return tracker


def slo_trackers() -> list:
    return list(_SLO_TRACKERS)


def slo_snapshot() -> dict:
    """All registered planes' SLO state, plus the fleet-advisory
    rollup ``/readyz`` reports (never gates on)."""
    planes = {t.plane: t.snapshot() for t in _SLO_TRACKERS}
    states = [p["state"] for p in planes.values()]
    overall = ("burning" if "burning" in states
               else "warn" if "warn" in states
               else "ok" if states else "idle")
    return {"state": overall, "planes": planes}


def set_profile_steps(on: bool) -> None:
    """Arm :func:`step_annotation` (the launcher's ``--profile-dir`` does
    this, so fused train steps land as named ranges in the
    ``torch.profiler`` trace)."""
    global _PROFILE_STEPS
    _PROFILE_STEPS = bool(on)


def profile_steps() -> bool:
    return _PROFILE_STEPS or bool(
        root.common.telemetry.get("profile_steps", False))


def step_annotation(step: int, name: str = "train_step"):
    """``torch.profiler.record_function("<name>#<step>")`` around one
    train-step dispatch when step profiling is armed; the shared no-op
    context otherwise (torch's profiler is not touched on the cold
    path).  It runs on the host around the dispatch, never inside a
    captured graph's body."""
    if not profile_steps():
        return NULL_SPAN
    from torch.profiler import record_function

    return record_function(f"{name}#{int(step)}")

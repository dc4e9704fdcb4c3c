"""Trace spans (port of ``znicz_tpu/telemetry/trace.py``): a bounded
in-memory ring of complete events with explicit timestamps, exportable
as Chrome trace-event JSON (load ``/trace.json`` in Perfetto or
``chrome://tracing``).

Cross-process correlation rides the ``trace_id`` / ``job_id`` keys the
wire metadata frames carry end to end; the fleet exporter
(``telemetry/fleet.py``) turns a span's ``perf_counter`` timestamps into
wall-clock microseconds before it leaves the process.

Recording one span is two ``perf_counter()`` reads and one deque append
(``maxlen`` evicts the oldest event without a lock).  While the ring is
disabled ``span()`` returns a shared no-op context manager.

Spans are recorded on the host around a dispatch, never inside code a
CUDA graph captures: a captured body runs once, at capture.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

#: default ring capacity (events); override per-TraceRing, or via
#: root.common.telemetry.trace_capacity for the process-wide ring —
#: which is created lazily on first use, so set the override any time
#: BEFORE the first telemetry consumer (Codec/Server/trainer/...) is
#: constructed (importing telemetry alone does not latch it)
DEFAULT_CAPACITY = 16384


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_ring", "cat", "name", "args", "_t0")

    def __init__(self, ring: "TraceRing", cat: str, name: str, args):
        self._ring = ring
        self.cat = cat
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._ring.add(self.cat, self.name, self._t0,
                       time.perf_counter() - self._t0, self.args)
        return False


class TraceRing:
    """Bounded ring of complete ("X") trace events.

    Events are stored as plain tuples ``(cat, name, ts_us, dur_us, tid,
    args)``; the Chrome trace-event dicts are built only at export.
    ``deque.append`` is atomic under the GIL, so the EVENT path takes no
    lock; ``events()`` snapshots via ``list(deque)`` for the same
    reason — export never blocks recording.  The lifetime ``recorded``
    counter is the one piece that needs read-modify-write, so it rides
    its own micro-lock (spans arrive concurrently from the training,
    router, compute and snapshot-writer threads; a bare ``+=`` would
    silently drop increments).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.recorded = 0               # lifetime count (ring may evict)
        self._count_lock = threading.Lock()
        self._sinks: List = []          # fleet span exporters

    def add_sink(self, sink) -> None:
        """Register a callable fed every recorded event tuple (the fleet
        ``SpanExporter``).  Sinks must be non-blocking and non-raising;
        the empty-list check keeps the no-sink hot path at one ``if``."""
        self._sinks.append(sink)

    # -- recording -------------------------------------------------------------

    def span(self, cat: str, name: str, **args):
        """Context manager recording one complete event around its body;
        a no-op singleton while disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, cat, name, args or None)

    def add(self, cat: str, name: str, t0_s: float, dur_s: float,
            args: Optional[Dict] = None) -> None:
        """Record a complete event from an ALREADY-MEASURED interval
        (perf_counter seconds) — the workflow unit loop reuses its own
        timing instead of paying a second pair of clock reads."""
        if not self.enabled:
            return
        evt = (cat, name, int(t0_s * 1e6), max(int(dur_s * 1e6), 0),
               threading.get_ident(), args)
        self._events.append(evt)
        with self._count_lock:
            self.recorded += 1
        if self._sinks:
            for sink in self._sinks:
                sink(evt)

    def instant(self, cat: str, name: str, **args) -> None:
        """Zero-duration marker event."""
        self.add(cat, name, time.perf_counter(), 0.0, args or None)

    # -- export ----------------------------------------------------------------

    def events(self) -> List[tuple]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def chrome_trace(self) -> Dict:
        """The ring as a Chrome trace-event JSON object (Perfetto /
        chrome://tracing load it directly).  Snapshot-then-build: the
        caller can serialize and write the result with no ring state
        shared with recorders."""
        pid = os.getpid()
        out = []
        for cat, name, ts, dur, tid, args in self.events():
            ev = {"name": name, "cat": cat, "ph": "X", "ts": ts,
                  "dur": dur, "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

"""Fleet observability (port of ``znicz_tpu/telemetry/fleet.py``):
cross-process trace stitching, fleet metrics aggregation and SLO
burn-rate tracking.

  - :class:`SpanExporter` -- a bounded, drops-oldest sink on the process
    :class:`~.trace.TraceRing`.  It keeps the spans that carry a
    ``trace_id`` arg, converts their ``perf_counter`` timestamps to
    wall-clock microseconds (spans of different processes land on one
    timeline) and hands them out in small batches that ride existing
    traffic: replica heartbeats to the balancer, slave and relay updates
    to the master, serving replies back to the client.  It never blocks
    recording or the carrier: a full buffer drops the oldest span.
  - :class:`FleetTraceStore` -- the coordinator's assembly: spans
    ingested per origin (``replica-1@4711``), indexed by ``trace_id``,
    rendered as one Chrome-trace timeline (``/trace.json?fleet=1``) with
    one synthetic ``pid`` an origin.
  - :func:`registry_snapshot` / :class:`FleetMetricsStore` /
    :func:`render_fleet_prometheus` -- member registries serialized
    (counters and gauges exact; histogram rings as a capped window plus
    exact count and sum) and merged under the coordinator's families
    with a ``member=<origin>`` label; ``/fleet.json`` serves the rollup.
  - :class:`SloTracker` -- objectives per plane tracked as good/bad
    counts in time buckets, with fast- and slow-window burn rates and an
    advisory state (``ok``/``warn``/``burning``) that ``/readyz``
    reports without changing its gate.

Everything here is host-side Python over numbers the process already
measured: nothing synchronises the device.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .metrics import (EXPORT_QUANTILES, Histogram, MetricsRegistry,
                      _format_value, _render_labels)

#: cap on histogram-window samples carried per child in a registry
#: snapshot — keeps a heartbeat piggyback to a few KB while count/sum
#: stay exact (quantiles over the cap approximate the member's ring)
SNAPSHOT_WINDOW_CAP = 64


def process_identity(role: str) -> str:
    """A fleet-unique logical-process identity: ``<role>@<pid>``.  Two
    logical processes sharing an OS pid (a balancer and its replicas
    in one process) still get distinct origins."""
    return f"{role}@{os.getpid()}"


# ---------------------------------------------------------------------------
# span export (member side)
# ---------------------------------------------------------------------------

class SpanExporter:
    """Bounded drops-oldest buffer of completed spans, fed as a
    :class:`TraceRing` sink and drained by the piggyback carriers.

    ``offer`` is the hot-path side: one dict membership test for the
    ``trace_id`` filter, one deque append.  A full buffer evicts the
    oldest span (``deque(maxlen=...)``) and counts the drop — export
    pressure can never stall a heartbeat or a reply.
    """

    def __init__(self, origin: str, capacity: int = 1024,
                 export_all: bool = False) -> None:
        self.origin = origin
        self.capacity = max(1, int(capacity))
        self.export_all = bool(export_all)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.offered = 0       # lifetime spans accepted into the buffer
        self.dropped = 0       # lifetime spans evicted before a drain
        # perf_counter -> wall clock, captured once; drift over a run is
        # far below span durations and keeps conversion to one add
        self._offset_us = (time.time() - time.perf_counter()) * 1e6

    # sink signature: the raw TraceRing event tuple
    def __call__(self, evt: tuple) -> None:
        try:
            cat, name, ts_us, dur_us, tid, args = evt
            if not self.export_all and not (args and "trace_id" in args):
                return
            span = {"cat": cat, "name": name,
                    "ts": int(ts_us + self._offset_us), "dur": int(dur_us),
                    "tid": int(tid)}
            if args:
                span["args"] = dict(args)
            with self._lock:
                if len(self._buf) == self._buf.maxlen:
                    self.dropped += 1
                self._buf.append(span)
                self.offered += 1
        except Exception:
            # a broken exporter must never take the tracer down
            return

    def drain(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Remove and return up to ``limit`` oldest spans (all if None)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            n = len(self._buf) if limit is None else min(int(limit),
                                                         len(self._buf))
            for _ in range(n):
                out.append(self._buf.popleft())
        return out

    def peek_trace(self, trace_id: str, limit: int = 32
                   ) -> List[Dict[str, Any]]:
        """Non-destructive scan for one trace's spans — the reply-side
        summary (replies carry only their own request's spans; the
        heartbeat drain still delivers everything to the balancer)."""
        with self._lock:
            out = [dict(s) for s in self._buf
                   if s.get("args", {}).get("trace_id") == trace_id]
        return out[-int(limit):]

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)


# ---------------------------------------------------------------------------
# trace stitching (coordinator side)
# ---------------------------------------------------------------------------

class FleetTraceStore:
    """Spans from many origins, assembled by ``trace_id`` into one
    merged Chrome-trace timeline.  Bounded by total span count
    (drops-oldest across the whole fleet)."""

    def __init__(self, capacity: int = 8192) -> None:
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)   # (origin, span)
        self._lock = threading.Lock()
        self.ingested = 0

    def ingest(self, origin: str, spans: Iterable[Dict[str, Any]]) -> int:
        n = 0
        with self._lock:
            for s in spans or ():
                if not isinstance(s, dict):
                    continue
                self._ring.append((str(origin), s))
                self.ingested += 1
                n += 1
        return n

    def spans(self) -> List[Tuple[str, Dict[str, Any]]]:
        with self._lock:
            return list(self._ring)

    def traces(self) -> Dict[str, List[Tuple[str, Dict[str, Any]]]]:
        out: Dict[str, List[Tuple[str, Dict[str, Any]]]] = {}
        for origin, s in self.spans():
            tid = s.get("args", {}).get("trace_id")
            if tid is not None:
                out.setdefault(str(tid), []).append((origin, s))
        return out

    def trace_origins(self, trace_id: str) -> List[str]:
        seen: List[str] = []
        for origin, _ in self.traces().get(str(trace_id), ()):
            if origin not in seen:
                seen.append(origin)
        return seen

    def best_stitched(self) -> Tuple[Optional[str], List[str]]:
        """The trace crossing the most origins (the evidence that
        stitching works end to end)."""
        best: Tuple[Optional[str], List[str]] = (None, [])
        for tid, members in self.traces().items():
            origins: List[str] = []
            for origin, _ in members:
                if origin not in origins:
                    origins.append(origin)
            if len(origins) > len(best[1]):
                best = (tid, origins)
        return best

    def chrome_trace(self, trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Merged Chrome trace-event JSON: one synthetic pid per origin,
        named via ``process_name`` metadata events, spans on the shared
        wall-clock axis.  ``trace_id`` narrows to one request/job."""
        snap = self.spans()
        pids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for origin, s in snap:
            args = s.get("args") or {}
            if trace_id is not None and args.get("trace_id") != trace_id:
                continue
            pid = pids.get(origin)
            if pid is None:
                pid = pids[origin] = len(pids) + 1
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": origin}})
            ev = {"name": s.get("name", "?"), "cat": s.get("cat", "?"),
                  "ph": "X", "ts": int(s.get("ts", 0)),
                  "dur": int(s.get("dur", 0)), "pid": pid,
                  "tid": int(s.get("tid", 0))}
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "fleet": {"origins": sorted(pids),
                          "spans": len(events) - len(pids)}}

    def snapshot(self) -> Dict[str, Any]:
        snap = self.spans()
        per_origin: Dict[str, int] = {}
        trace_ids = set()
        for origin, s in snap:
            per_origin[origin] = per_origin.get(origin, 0) + 1
            tid = (s.get("args") or {}).get("trace_id")
            if tid is not None:
                trace_ids.add(str(tid))
        return {"spans": len(snap), "ingested": self.ingested,
                "origins": per_origin, "traces": len(trace_ids)}


# ---------------------------------------------------------------------------
# metrics aggregation
# ---------------------------------------------------------------------------

def _json_value(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    if f != f or f in (float("inf"), float("-inf")):   # NaN / Inf
        return None
    return v if isinstance(v, (int, bool)) else f


def registry_snapshot(reg: MetricsRegistry,
                      window_cap: int = SNAPSHOT_WINDOW_CAP
                      ) -> Dict[str, Any]:
    """Serialize a registry for piggyback: counters/gauges exact,
    histograms as lifetime ``count``/``sum`` plus a capped ring window
    (enough for coordinator-side quantiles).  JSON-clean by
    construction (NaN gauges are dropped, not shipped)."""
    fams: List[Dict[str, Any]] = []
    for fam, children in reg.collect():
        kids: List[Dict[str, Any]] = []
        for m in children:
            if isinstance(m, Histogram):
                win = m.window()
                if win.size > window_cap:
                    win = win[-window_cap:]
                kids.append({"labels": dict(m.labels),
                             "count": int(m.count),
                             "sum": float(m.sum),
                             "window": [float(x) for x in win]})
            else:
                v = _json_value(m.value)
                if v is None:
                    continue
                kids.append({"labels": dict(m.labels), "value": v})
        if kids:
            fams.append({"name": fam.name, "kind": fam.kind,
                         "help": fam.help, "children": kids})
    return {"families": fams}


class FleetMetricsStore:
    """Latest-wins member registry snapshots, keyed by origin."""

    def __init__(self) -> None:
        self._members: Dict[str, Dict[str, Any]] = {}
        self._stamp: Dict[str, float] = {}
        self._lock = threading.Lock()

    def update(self, origin: str, snapshot: Dict[str, Any]) -> None:
        if not isinstance(snapshot, dict) or "families" not in snapshot:
            return
        with self._lock:
            self._members[str(origin)] = snapshot
            self._stamp[str(origin)] = time.time()

    def members(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._members)

    def ages(self) -> Dict[str, float]:
        now = time.time()
        with self._lock:
            return {o: now - t for o, t in self._stamp.items()}

    def rollup(self) -> Dict[str, Any]:
        """Structured fleet view for ``/fleet.json``: counters summed
        across members, gauges listed per member, histogram windows
        merged into fleet quantiles."""
        members = self.members()
        fams: Dict[str, Dict[str, Any]] = {}
        for origin, snap in members.items():
            for fam in snap.get("families", []):
                name, kind = fam.get("name"), fam.get("kind")
                agg = fams.setdefault(name, {"kind": kind, "total": 0.0,
                                             "members": {}, "_win": [],
                                             "count": 0, "sum": 0.0})
                for child in fam.get("children", []):
                    if kind == "histogram":
                        agg["count"] += int(child.get("count", 0))
                        agg["sum"] += float(child.get("sum", 0.0))
                        agg["_win"].extend(child.get("window", []))
                    else:
                        v = child.get("value", 0)
                        agg["total"] += float(v)
                        agg["members"][origin] = \
                            agg["members"].get(origin, 0.0) + float(v)
        out: Dict[str, Any] = {}
        for name, agg in fams.items():
            entry: Dict[str, Any] = {"kind": agg["kind"]}
            if agg["kind"] == "histogram":
                entry["count"] = agg["count"]
                entry["sum"] = agg["sum"]
                win = np.asarray(agg["_win"], np.float64)
                if win.size:
                    entry["quantiles"] = {
                        repr(float(q)): float(np.quantile(win, q))
                        for q in EXPORT_QUANTILES}
            else:
                entry["total"] = agg["total"]
                entry["members"] = agg["members"]
            out[name] = entry
        return {"members": {o: {"age_s": round(a, 3)}
                            for o, a in self.ages().items()},
                "families": out}


def render_fleet_prometheus(reg: MetricsRegistry, store: FleetMetricsStore,
                            member_label: str = "member") -> str:
    """The coordinator's ``/metrics`` superset: every LOCAL family
    rendered exactly as ``MetricsRegistry.render_prometheus`` would
    (same order, same bytes — pre-existing series survive verbatim),
    with member children appended under the same family (one ``# TYPE``
    per name, strict-exposition clean) carrying an extra
    ``member=<origin>`` label; member-only families follow at the end."""
    members = store.members()
    # family name -> list of (labels, extra, value) member sample rows,
    # plus family metadata for names the local registry doesn't have
    rows: Dict[str, List[str]] = {}
    meta: Dict[str, Tuple[str, str]] = {}
    for origin, snap in members.items():
        for fam in snap.get("families", []):
            name = fam.get("name")
            meta.setdefault(name, (fam.get("kind", "gauge"),
                                   fam.get("help", "")))
            out = rows.setdefault(name, [])
            for child in fam.get("children", []):
                labels = dict(child.get("labels", {}))
                labels[member_label] = origin
                if "window" in child or "count" in child:
                    win = np.asarray(child.get("window", []), np.float64)
                    if win.size:
                        qs = np.quantile(win, EXPORT_QUANTILES)
                        for q, v in zip(EXPORT_QUANTILES, qs):
                            out.append(
                                f"{name}"
                                f"{_render_labels(labels, {'quantile': repr(float(q))})} "
                                f"{_format_value(float(v))}")
                    lbl = _render_labels(labels)
                    out.append(f"{name}_sum{lbl} "
                               f"{_format_value(child.get('sum', 0.0))}")
                    out.append(f"{name}_count{lbl} "
                               f"{_format_value(child.get('count', 0))}")
                else:
                    out.append(f"{name}{_render_labels(labels)} "
                               f"{_format_value(child.get('value', 0))}")
    out: List[str] = []
    seen: set = set()
    for fam, children in reg.collect():
        seen.add(fam.name)
        if fam.help:
            out.append(f"# HELP {fam.name} {fam.help}")
        kind = "summary" if fam.kind == "histogram" else fam.kind
        out.append(f"# TYPE {fam.name} {kind}")
        for m in children:
            if isinstance(m, Histogram):
                for extra, v in m.samples():
                    out.append(f"{fam.name}"
                               f"{_render_labels(m.labels, extra)} "
                               f"{_format_value(v)}")
                lbl = _render_labels(m.labels)
                out.append(f"{fam.name}_sum{lbl} {_format_value(m.sum)}")
                out.append(f"{fam.name}_count{lbl} "
                           f"{_format_value(m.count)}")
            else:
                for extra, v in m.samples():
                    out.append(f"{fam.name}"
                               f"{_render_labels(m.labels, extra)} "
                               f"{_format_value(v)}")
        out.extend(rows.get(fam.name, ()))
    for name in sorted(rows):
        if name in seen:
            continue
        kind, help_ = meta.get(name, ("gauge", ""))
        if help_:
            out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} "
                   f"{'summary' if kind == 'histogram' else kind}")
        out.extend(rows[name])
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# SLO tracking
# ---------------------------------------------------------------------------

class SloTracker:
    """Multi-window burn-rate tracking over config-declared objectives.

    Each objective is a success-ratio target (``target=0.99`` ⇒ 1%
    error budget); latency objectives declare a ``threshold`` in
    seconds and feed through :meth:`record_latency` (good ⇔ under
    threshold).  Observations land in coarse time buckets; burn rate
    over a window is ``bad_fraction / (1 - target)`` — 1.0 means the
    error budget is being consumed exactly at the sustainable rate,
    higher means it will exhaust early.  State: ``warn`` when the fast
    window burns, ``burning`` when fast AND slow do (the classic
    multi-window alert shape, immune to single-bucket blips).

    The tracker is ADVISORY by contract: ``/readyz`` carries its state
    as a new field and never gates on it.
    """

    def __init__(self, plane: str,
                 window_fast_s: float = 60.0,
                 window_slow_s: float = 600.0,
                 bucket_s: float = 5.0,
                 clock=time.time) -> None:
        self.plane = str(plane)
        self.window_fast_s = float(window_fast_s)
        self.window_slow_s = float(window_slow_s)
        self.bucket_s = max(0.001, float(bucket_s))
        self._clock = clock
        self._obj: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def add_objective(self, name: str, target: float,
                      threshold: Optional[float] = None,
                      unit: str = "") -> None:
        target = min(max(float(target), 0.0), 0.999999)
        with self._lock:
            self._obj[str(name)] = {
                "target": target, "threshold": threshold, "unit": unit,
                "buckets": deque(), "good": 0, "bad": 0}

    def objectives(self) -> List[str]:
        with self._lock:
            return list(self._obj)

    # -- feeding -------------------------------------------------------------

    def record(self, name: str, ok: bool, n: int = 1,
               now: Optional[float] = None) -> None:
        if now is None:
            now = self._clock()
        idx = int(now / self.bucket_s)
        with self._lock:
            obj = self._obj.get(str(name))
            if obj is None:
                return
            buckets = obj["buckets"]
            if buckets and buckets[-1][0] == idx:
                slot = buckets[-1]
            else:
                slot = [idx, 0, 0]
                buckets.append(slot)
                horizon = idx - int(self.window_slow_s / self.bucket_s) - 1
                while buckets and buckets[0][0] < horizon:
                    buckets.popleft()
            if ok:
                slot[1] += int(n)
                obj["good"] += int(n)
            else:
                slot[2] += int(n)
                obj["bad"] += int(n)

    def record_latency(self, name: str, seconds: float,
                       now: Optional[float] = None) -> None:
        with self._lock:
            obj = self._obj.get(str(name))
            thr = None if obj is None else obj.get("threshold")
        if thr is None:
            return
        self.record(name, float(seconds) <= float(thr), now=now)

    # -- reading -------------------------------------------------------------

    def _window_counts(self, obj: Dict[str, Any], window_s: float,
                       now: float) -> Tuple[int, int]:
        lo = int((now - window_s) / self.bucket_s)
        good = bad = 0
        for idx, g, b in obj["buckets"]:
            if idx > lo:
                good += g
                bad += b
        return good, bad

    def burn_rate(self, name: str, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        """``bad_fraction / error_budget`` over the window; None while
        the window holds no observations."""
        if now is None:
            now = self._clock()
        with self._lock:
            obj = self._obj.get(str(name))
            if obj is None:
                return None
            good, bad = self._window_counts(obj, float(window_s), now)
            budget = 1.0 - obj["target"]
        total = good + bad
        if total == 0:
            return None
        return (bad / total) / budget

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        if now is None:
            now = self._clock()
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._obj.items())
        for name, obj in items:
            with self._lock:
                fast = self._window_counts(obj, self.window_fast_s, now)
                slow = self._window_counts(obj, self.window_slow_s, now)
                target = obj["target"]
                good, bad = obj["good"], obj["bad"]
                thr = obj["threshold"]
            budget = 1.0 - target

            def _burn(counts):
                total = counts[0] + counts[1]
                if total == 0:
                    return None
                return (counts[1] / total) / budget

            fast_burn, slow_burn = _burn(fast), _burn(slow)
            if fast_burn is not None and fast_burn >= 1.0 \
                    and slow_burn is not None and slow_burn >= 1.0:
                state = "burning"
            elif fast_burn is not None and fast_burn >= 1.0:
                state = "warn"
            else:
                state = "ok"
            slow_total = slow[0] + slow[1]
            remaining = (1.0 - (slow[1] / slow_total) / budget
                         if slow_total else 1.0)
            out[name] = {"target": target, "threshold": thr,
                         "unit": obj.get("unit", ""),
                         "fast_burn": fast_burn, "slow_burn": slow_burn,
                         "state": state,
                         "budget_remaining": max(-1.0, min(1.0, remaining)),
                         "good": good, "bad": bad}
        states = [o["state"] for o in out.values()]
        overall = ("burning" if "burning" in states
                   else "warn" if "warn" in states else "ok")
        return {"plane": self.plane, "state": overall,
                "window_fast_s": self.window_fast_s,
                "window_slow_s": self.window_slow_s,
                "objectives": out}

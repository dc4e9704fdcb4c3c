"""Structured event journal (port of ``znicz_tpu/telemetry/events.py``):
the fleet's causal timeline.

The :class:`EventJournal` is a bounded, wall-clock-timestamped,
sequence-numbered ring of typed events, one per state transition
(membership, swap wave phase, quorum flip, autoscale decision, rollback,
breaker open, prefix-cache eviction, page-pressure shed), each carrying
the numbers that drove the decision.

  - ``emit`` never blocks on I/O and never raises;
  - the ring drops the *oldest* events; ``seq`` keeps counting, so a
    reader detects the gap;
  - ``seq`` is monotone per process: the fleet merge keys on ``(origin,
    seq)``, so re-delivered piggyback batches dedup exactly;
  - ``since(seq)`` is both the ``/events.json?since=`` contract and the
    heartbeat's incremental export.

:class:`FleetEventStore` is the coordinator's merge of member journals,
with its own monotone ``mseq`` cursor.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: Known event kinds.  Documentary: ``emit`` accepts any kind.
KINDS = (
    "failover",            # balancer re-dispatched in-flight work off a dead replica
    "replica_lost",        # balancer evicted a member (TTL lapse / preemption)
    "replica_joined",      # new member admitted to the fleet
    "heal",                # balancer respawned a replica to restore min_replicas
    "autoscale_up",        # autoscaler spawned a replica (carries load numbers)
    "autoscale_down",      # autoscaler retired a replica (carries load numbers)
    "swap_begin",          # canary rollover requested
    "swap_phase",          # rollover wave advanced (canary/wave/finalize)
    "swap_done",           # rollover completed fleet-wide
    "rollback",            # rollover aborted; cause carried in fields
    "quorum_degraded",     # training quorum fell below min_slaves
    "quorum_restored",     # training quorum recovered
    "replan",              # master rebuilt the relay tree (cause carried)
    "preemption",          # master rode out a dead slave/relay
    "breaker_open",        # a circuit breaker opened (peer carried)
    "prefix_evict",        # prefix cache evicted a cached block under pressure
    "page_shed",           # generation scheduler stalled/shed on page pressure
)


class EventJournal:
    """Bounded, seq-numbered, drops-oldest ring of structured events."""

    def __init__(self, capacity: int = 512,
                 origin: Optional[str] = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.capacity = max(1, int(capacity))
        self.origin = origin or ""
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0            # last assigned seq; 0 = nothing emitted
        self._dropped = 0        # lifetime count of events pushed off the ring
        self._lock = threading.Lock()

    # -- write side ------------------------------------------------------------

    def emit(self, kind: str, plane: str, **fields: Any) -> int:
        """Append one event; returns its seq.  Never raises."""
        try:
            ts = self._clock()
        except Exception:
            ts = 0.0
        evt: Dict[str, Any] = {"kind": str(kind), "plane": str(plane)}
        for k, v in fields.items():
            # keep the journal JSON-clean without paying for a deep
            # scrub: coerce non-primitive values to str at the edge
            if isinstance(v, (str, int, float, bool)) or v is None:
                evt[k] = v
            else:
                evt[k] = str(v)
        with self._lock:
            self._seq += 1
            evt["seq"] = self._seq
            evt["ts"] = ts
            if self.origin:
                evt["origin"] = self.origin
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(evt)
            return self._seq

    # -- read side -----------------------------------------------------------

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def since(self, seq: int = 0, limit: Optional[int] = None
              ) -> List[Dict[str, Any]]:
        """Events with ``seq > cursor``, oldest first (bounded copy)."""
        with self._lock:
            out = [dict(e) for e in self._ring if e["seq"] > seq]
        if limit is not None and len(out) > limit:
            out = out[-int(limit):]
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"origin": self.origin,
                    "last_seq": self._seq,
                    "dropped": self._dropped,
                    "capacity": self.capacity,
                    "events": [dict(e) for e in self._ring]}


class FleetEventStore:
    """Coordinator-side merge of member journals.

    Ingest is idempotent per ``(origin, seq)`` — piggyback batches may
    overlap when a sender retries — and the merged view carries a
    coordinator-assigned monotone ``mseq`` so ``/events.json?fleet=1``
    is cursorable exactly like a single-process journal.
    """

    def __init__(self, capacity: int = 2048) -> None:
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._mseq = 0
        self._high: Dict[str, int] = {}     # origin -> highest ingested seq
        self._lock = threading.Lock()

    def ingest(self, origin: str, events: List[Dict[str, Any]]) -> int:
        """Merge a member batch; returns how many were new."""
        if not events:
            return 0
        fresh = 0
        with self._lock:
            high = self._high.get(origin, 0)
            for e in events:
                try:
                    seq = int(e.get("seq", 0))
                except (TypeError, ValueError):
                    continue
                if seq <= high:
                    continue
                high = seq
                self._mseq += 1
                merged = dict(e)
                merged["origin"] = merged.get("origin") or origin
                merged["mseq"] = self._mseq
                self._ring.append(merged)
                fresh += 1
            self._high[origin] = high
        return fresh

    def cursor(self, origin: str) -> int:
        with self._lock:
            return self._high.get(origin, 0)

    def since(self, mseq: int = 0, limit: Optional[int] = None
              ) -> List[Dict[str, Any]]:
        with self._lock:
            out = [dict(e) for e in self._ring if e["mseq"] > mseq]
        if limit is not None and len(out) > limit:
            out = out[-int(limit):]
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"last_mseq": self._mseq,
                    "origins": dict(self._high),
                    "events": [dict(e) for e in self._ring]}

"""Dynamic request batcher (port of the classic half of
``znicz_tpu/serving/batcher.py``).

  - **Coalescing**: a bounded queue of requests drains into batches under
    ``(max_batch, max_delay_ms)`` — a batch closes once it holds
    ``max_batch`` rows, or ``max_delay_ms`` after its first row was taken.
  - **Bucket ladder**: each batch is padded up to the next rung of a fixed
    ladder (powers of two up to ``max_batch``, snapped to multiples of
    the serving mesh's ``data`` axis), so the model sees at most
    ``len(ladder)`` batch shapes.  With ``max_len`` the ladder has a
    second axis of sequence rungs (powers of two up to ``max_len``, or
    explicit ones ending at it): a request of ``len`` tokens lands on
    ``seq_bucket_for(len)``, a function of its own length only, batches
    coalesce only requests of one seq rung, and the model sees at most
    ``len(rungs) * len(seq_rungs)`` (rows, seq) shapes.
  - **Backpressure**: the queue is bounded in rows; a submit past
    ``queue_bound`` is refused at once with a :class:`Refusal`.
  - **Admission control**: per-client token-bucket rate limits and
    weighted fair queueing.  Each client gets its own subqueue;
    ``next_batch`` drains them by rows-weighted deficit round robin
    (each visit banks ``quantum`` rows, a request is taken when its
    client's deficit covers it), so one flooding client degrades only
    itself.  Every refusal is a :class:`Refusal`: the readable string,
    carrying the ``policy`` (``shed`` / ``oversized`` / ``rate_limited``
    / ``draining``) and the ``scope`` (``client`` or ``service``) that
    refused it.  Config home: ``root.common.serving.admission.*``.

**Continuous batching for generation** (:class:`GenerationScheduler`
over a paged ``GenerationRunner``): each :class:`GenSeq` is admitted into
a ``slots`` bound with a prefix-cache lookup, prefilled in bounded chunks
between decode ticks, decoded one token a tick grouped by page rung, and
released the tick it finishes; a shared page is copied before its first
divergent append.

Threading: ``submit`` may be called from any thread, ``next_batch`` from
the one compute thread; one condition variable guards the queues and the
counters.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from znicz_torch.transport.admission import AdmissionTable, TokenBucket

__all__ = ["AdmissionPolicy", "BucketLadder", "DynamicBatcher",
           "GenSeq", "GenerationScheduler", "Refusal", "Request",
           "TokenBucket"]


class BucketLadder:
    """The fixed ladder of padded batch sizes: the powers of two below
    ``max_batch`` plus ``max_batch`` itself, or explicit ``rungs`` ending
    at ``max_batch``.

    ``dp`` is the serving mesh's ``data`` axis size: every rung must
    split evenly across it, so the default rungs are snapped up to the
    next multiple of ``dp`` (then deduplicated), and explicit rungs that
    do not divide are refused here, readably, rather than at the first
    request.

    With ``max_len > 0`` the ladder is 2-D: ``seq_rungs`` are the powers
    of two below ``max_len`` plus ``max_len`` (or explicit rungs ending
    at it), and :meth:`buckets` is the (rows, seq) product.  The snapping
    to ``dp`` applies to the rows only (ranks split rows, never
    tokens)."""

    def __init__(self, max_batch: int,
                 rungs: Optional[Sequence[int]] = None, dp: int = 1,
                 max_len: int = 0,
                 seq_rungs: Optional[Sequence[int]] = None):
        self.max_batch = int(max_batch)
        self.dp = int(dp)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if self.dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if self.max_batch % self.dp:
            raise ValueError(
                f"max_batch={self.max_batch} does not divide across the "
                f"mesh's data axis (dp={self.dp}); pick a max_batch that "
                f"is a multiple of dp")
        snapped = rungs is None
        if rungs is None:
            rungs = []
            r = 1
            while r < self.max_batch:
                rungs.append(r)
                r *= 2
            rungs.append(self.max_batch)
            rungs = [-(-r // self.dp) * self.dp for r in rungs]
        rungs = sorted(set(int(r) for r in rungs))
        if not rungs or rungs[0] < 1 or rungs[-1] != self.max_batch:
            raise ValueError(
                f"bucket ladder {rungs} must be positive and end at "
                f"max_batch={self.max_batch}")
        if not snapped:
            bad = [r for r in rungs if r % self.dp]
            if bad:
                raise ValueError(
                    f"bucket ladder rungs {bad} do not divide across the "
                    f"mesh's data axis (dp={self.dp}); every rung must be "
                    f"a multiple of dp so each rank holds exactly rows/dp "
                    f"rows")
        self.rungs: List[int] = rungs
        self.max_len = int(max_len)
        if self.max_len < 0:
            raise ValueError(f"max_len must be >= 0, got {max_len}")
        self.seq_rungs: Optional[List[int]] = None
        if self.max_len == 0:
            if seq_rungs:
                raise ValueError(
                    "seq_rungs given without max_len — set "
                    "root.common.serving.seq.max_len to enable the 2-D "
                    "ladder")
            return
        if seq_rungs is None:
            seq_rungs = []
            s = 1
            while s < self.max_len:
                seq_rungs.append(s)
                s *= 2
            seq_rungs.append(self.max_len)
        seq_rungs = sorted(set(int(s) for s in seq_rungs))
        if not seq_rungs or seq_rungs[0] < 1 \
                or seq_rungs[-1] != self.max_len:
            raise ValueError(
                f"seq ladder {seq_rungs} must be positive and end at "
                f"max_len={self.max_len}")
        self.seq_rungs = seq_rungs

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n."""
        for r in self.rungs:
            if n <= r:
                return r
        raise ValueError(f"{n} rows exceed the ladder's top rung "
                         f"{self.rungs[-1]}")

    def seq_bucket_for(self, n: int) -> int:
        """Smallest seq rung >= n (2-D ladders only): a function of the
        request's own length, never of its neighbours'."""
        if self.seq_rungs is None:
            raise ValueError("ladder has no seq axis (max_len unset)")
        for s in self.seq_rungs:
            if n <= s:
                return s
        raise ValueError(f"sequence of {n} tokens exceeds the ladder's "
                         f"top seq rung {self.seq_rungs[-1]}")

    def buckets(self) -> List:
        """Every input shape the model may see (the warmup set): the
        rungs, or on a 2-D ladder every (rows, seq) pair."""
        if self.seq_rungs is None:
            return list(self.rungs)
        return [(r, s) for r in self.rungs for s in self.seq_rungs]

    @staticmethod
    def bucket_key(rows: int, seq: Optional[int] = None):
        """A bucket's stats key: the rung (1-D) or ``"RxS"`` (2-D, a
        string, so it stays a JSON key as it is)."""
        return int(rows) if seq is None else f"{int(rows)}x{int(seq)}"

    def keys(self) -> List:
        """:meth:`bucket_key` of every bucket."""
        return [self.bucket_key(*b) if isinstance(b, tuple)
                else self.bucket_key(b) for b in self.buckets()]

    def __iter__(self):
        return iter(self.rungs)

    def __repr__(self):
        if self.seq_rungs is not None:
            return f"BucketLadder({self.rungs} x seq{self.seq_rungs})"
        return f"BucketLadder({self.rungs})"


#: "no client is mid-visit" marker of the DRR drain; not None, which is
#: the shared queue's key when fairness is off
_NO_VISIT = object()


class Refusal(str):
    """A refusal reason: a readable string carrying the ``policy`` slug
    (``shed`` / ``oversized`` / ``rate_limited`` / ``draining``) and the
    ``scope`` whose limit refused: ``"client"`` (this caller's own quota
    or bound; the service is healthy) or ``"service"`` (global overload
    or shutdown).  A client's circuit breaker counts only
    service-scoped sheds as failures."""

    policy = "refused"
    scope = "service"

    def __new__(cls, policy: str, reason: str, scope: str = "service"):
        self = super().__new__(cls, reason)
        self.policy = policy
        self.scope = scope
        return self


class AdmissionPolicy:
    """Admission-control knobs (``root.common.serving.admission.*``):

      - ``rate_limit``: rows/s each client may sustain (0 = unlimited);
      - ``rate_burst``: token-bucket capacity in rows (0 = auto:
        ``max(rate_limit, max_batch)``);
      - ``fair``: per-client subqueues drained deficit-round-robin (off =
        one FIFO);
      - ``quantum``: DRR rows banked a visit (0 = auto: ``max_batch //
        4``, at least 1);
      - ``client_queue_bound``: queued rows one client may hold (0 = only
        the global ``queue_bound``);
      - ``enabled``: the master switch.
    """

    __slots__ = ("rate_limit", "rate_burst", "fair", "quantum",
                 "client_queue_bound", "enabled")

    def __init__(self, rate_limit: float = 0.0, rate_burst: float = 0.0,
                 fair: bool = True, quantum: int = 0,
                 client_queue_bound: int = 0, enabled: bool = True):
        self.rate_limit = float(rate_limit)
        self.rate_burst = float(rate_burst)
        self.fair = bool(fair)
        self.quantum = int(quantum)
        self.client_queue_bound = int(client_queue_bound)
        self.enabled = bool(enabled)


class Request:
    """One queued inference request: ``x`` is the (n, *sample) host
    array; ``reply_to`` is where the reply goes — the ROUTER envelope (a
    list of frames) of a request that came over the wire, or for an
    in-process caller a callable called with the reply dict or a
    ``concurrent.futures.Future`` whose result is set; ``req_id`` is the
    caller's correlation id, ``trace_id`` an optional correlation id
    echoed in the reply, ``client`` the admission identity (subqueue and
    bucket key).  ``deadline_s`` is the relative budget from now: it
    becomes the absolute ``t_deadline``, checked at assemble time and
    again after the compute (None = no deadline).  ``t_enqueued`` feeds
    the latency stats.  A ``solo`` request (a balancer's parity-sampled
    primary or its probe) closes a batch of its own, at the smallest
    ladder rung that holds its rows.  On a 2-D ladder ``seq_len`` is the
    request's own unpadded length (its reply is cut back to it), and
    ``seq_rung`` the seq rung the batcher gives it at submit."""

    __slots__ = ("x", "n", "reply_to", "req_id", "trace_id", "client",
                 "t_enqueued", "t_deadline", "solo", "seq_len", "seq_rung")

    def __init__(self, x, n: int, reply_to=None, req_id=None,
                 trace_id=None, client=None, deadline_s=None,
                 solo: bool = False, seq_len: Optional[int] = None):
        self.x = x
        self.n = int(n)
        self.seq_len = None if seq_len is None else int(seq_len)
        self.seq_rung: Optional[int] = None
        self.reply_to = reply_to
        self.req_id = req_id
        self.trace_id = trace_id
        self.client = client
        self.solo = bool(solo)
        self.t_enqueued = time.perf_counter()
        self.t_deadline = (None if deadline_s is None
                           else self.t_enqueued + float(deadline_s))


class DynamicBatcher:
    """Bounded request queues + the coalescing and admission policy
    (module docstring).  ``submit`` returns None on acceptance or a
    :class:`Refusal`.  The counters of :data:`COUNTERS` read as
    attributes of the same names."""

    #: counters: name -> meaning
    COUNTERS = {
        "submitted": "accepted requests",
        "shed": "refused: queue at bound",
        "oversized": "refused: n > max_batch",
        "rate_limited": "refused: client over its rate limit",
        "batches": "batches closed",
        "batched_requests": "requests inside closed batches",
        "batched_rows": "real rows inside closed batches",
        "padded_rows": "pad rows added by the ladder",
        "real_cells": "real cells (rows x own tokens) inside closed "
                      "batches",
        "padded_cells": "pad cells the (2-D) ladder added: bucket area "
                        "less real cells",
        "solo_batches": "batches of one solo request",
    }

    #: solo batches remembered as (req_id, rows, rung), newest last
    SOLO_WINDOW = 256

    #: per-client accounting table bound (client ids are ephemeral)
    MAX_CLIENT_STATS = 32

    #: token-bucket table bound: past it, refilled buckets are swept and
    #: the oldest evicted
    MAX_BUCKETS = 1024

    def __init__(self, max_batch: int = 32, max_delay_ms: float = 5.0,
                 queue_bound: int = 256,
                 ladder: Optional[BucketLadder] = None,
                 admission: Optional[AdmissionPolicy] = None):
        self.ladder = ladder or BucketLadder(max_batch)
        self.max_batch = self.ladder.max_batch
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.queue_bound = int(queue_bound)
        #: per-client subqueues (key None: the shared FIFO when fairness
        #: is off or admission disabled)
        self._queues: "collections.OrderedDict[object, collections.deque]" \
            = collections.OrderedDict()
        self._rr: collections.deque = collections.deque()  # DRR rotation
        self._deficit: Dict[object, float] = {}
        self._visiting = _NO_VISIT          # quantum banks once a visit
        self._client_rows: Dict[object, int] = {}
        #: bounded per-client admission accounting
        self.clients: "collections.OrderedDict[str, Dict]" \
            = collections.OrderedDict()
        self._rows = 0                      # rows currently queued
        self._cond = threading.Condition()
        self._closed = False
        self._wakes = 0                     # wake() calls: end a wait
        self._counts: Dict[str, int] = dict.fromkeys(self.COUNTERS, 0)
        keys = self.ladder.keys()
        self._bucket_hits: Dict = dict.fromkeys(keys, 0)
        self._real_cells = dict.fromkeys(keys, 0)
        self._pad_cells = dict.fromkeys(keys, 0)
        #: the rung each solo request was served at: (req_id, rows, rung)
        self.solo_rungs: collections.deque = collections.deque(
            maxlen=self.SOLO_WINDOW)
        self.set_admission(admission or AdmissionPolicy())

    # -- counters --------------------------------------------------------------

    @property
    def bucket_hits(self) -> Dict:
        """{bucket key: batches closed at that bucket}."""
        with self._cond:
            return dict(self._bucket_hits)

    def pad_ratio(self) -> Dict:
        """{bucket key: pad cells / real cells} of the batches each
        bucket closed (a cell is a row, or a row's token on a 2-D
        ladder); buckets that closed none are left out."""
        with self._cond:
            real, pad = dict(self._real_cells), dict(self._pad_cells)
        return {r: round(pad[r] / n, 4) for r, n in real.items() if n}

    # -- admission -------------------------------------------------------------

    def set_admission(self, policy: AdmissionPolicy) -> None:
        """Install (or swap) the admission policy.  Auto knobs resolve
        against this batcher; token buckets restart.  Queued requests
        drain under the rotation regardless."""
        with self._cond:
            self.admission = policy
            self._rate_burst = policy.rate_burst or max(
                policy.rate_limit, float(self.max_batch))
            self._quantum = policy.quantum or max(1, self.max_batch // 4)
            self._table = AdmissionTable(policy.rate_limit,
                                         self._rate_burst,
                                         max_peers=self.MAX_BUCKETS)

    @property
    def _client_bound(self) -> int:
        """The effective per-client queued-rows cap, derived live."""
        return self.admission.client_queue_bound or self.queue_bound

    def _client_stat(self, client) -> Dict:
        key = str(client)
        st = self.clients.get(key)
        if st is None:
            while len(self.clients) >= self.MAX_CLIENT_STATS:
                self.clients.popitem(last=False)    # oldest first seen
            st = self.clients[key] = {
                "requests": 0, "rows": 0, "accepted": 0,
                "rate_limited": 0, "shed": 0}
        return st

    def admission_stats(self) -> Dict:
        adm = self.admission
        with self._cond:
            active = sum(1 for q in self._queues.values() if q)
            clients = {k: dict(v) for k, v in self.clients.items()}
            rate_limited = self._counts["rate_limited"]
        return {
            "enabled": adm.enabled,
            "fair": adm.fair,
            "rate_limit_rows_per_s": adm.rate_limit,
            "rate_burst_rows": self._rate_burst,
            "quantum_rows": self._quantum,
            "client_queue_bound": self._client_bound,
            "rate_limited": rate_limited,
            "active_clients": active,
            "clients": clients,
        }

    # -- producer side ---------------------------------------------------------

    def submit(self, req: Request) -> Optional[Refusal]:
        adm = self.admission
        lad = self.ladder
        with self._cond:
            if req.n < 1 or req.n > self.max_batch:
                self._counts["oversized"] += 1
                return Refusal(
                    "oversized",
                    f"request of {req.n} rows exceeds max_batch="
                    f"{self.max_batch} (split it client-side)",
                    scope="client")
            if lad.seq_rungs is not None:
                if req.seq_len is None or not 1 <= req.seq_len \
                        <= lad.max_len:
                    self._counts["oversized"] += 1
                    return Refusal(
                        "oversized",
                        f"sequence length {req.seq_len} outside the seq "
                        f"ladder (1..{lad.max_len})", scope="client")
                req.seq_rung = lad.seq_bucket_for(req.seq_len)
            if self._closed:
                return Refusal("draining", "service is shutting down")
            key = None
            took = 0
            if adm.enabled:
                st = self._client_stat(req.client)
                st["requests"] += 1
                st["rows"] += req.n
                if adm.rate_limit > 0:
                    if not self._table.try_take(req.client, req.n):
                        self._counts["rate_limited"] += 1
                        st["rate_limited"] += 1
                        return Refusal(
                            "rate_limited",
                            f"client over its rate limit "
                            f"({adm.rate_limit:g} rows/s, burst "
                            f"{self._rate_burst:g}) — rate_limited",
                            scope="client")
                    took = req.n
                if adm.fair:
                    key = req.client
                    # with client_queue_bound 0 the global check below
                    # subsumes this one
                    if (adm.client_queue_bound > 0
                            and self._client_rows.get(key, 0) + req.n
                            > self._client_bound):
                        self._counts["shed"] += 1
                        st["shed"] += 1
                        if took:
                            self._table.refund(req.client, took)
                        return Refusal(
                            "shed",
                            f"client queue at its fair-share bound "
                            f"({self._client_rows.get(key, 0)} rows "
                            f"queued, bound {self._client_bound}) — shed",
                            scope="client")
            if self._rows + req.n > self.queue_bound:
                self._counts["shed"] += 1
                if adm.enabled:
                    st["shed"] += 1
                if took:
                    self._table.refund(req.client, took)
                return Refusal(
                    "shed",
                    f"queue at bound ({self._rows} rows queued, "
                    f"bound {self.queue_bound}) — shed")
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = collections.deque()
                self._rr.append(key)
            q.append(req)
            self._rows += req.n
            self._client_rows[key] = self._client_rows.get(key, 0) + req.n
            if adm.enabled:
                st["accepted"] += 1
            self._counts["submitted"] += 1
            self._cond.notify()
            return None

    @property
    def queue_depth(self) -> int:
        """Rows currently queued (not yet taken into a batch)."""
        return self._rows

    def close(self) -> None:
        """Refuse new work and wake every waiter; ``next_batch`` drains
        what is queued and then returns None forever."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wake(self) -> None:
        """End a ``next_batch`` wait for its first request at once: it
        returns None (the compute loop's cue that another plane, the
        generation scheduler, has work)."""
        with self._cond:
            self._wakes += 1
            self._cond.notify_all()

    # -- consumer side ---------------------------------------------------------

    def _pop(self, key, idx: int = 0) -> Request:
        """Dequeue entry ``idx`` (default the head) of ``key``'s subqueue
        (cond held)."""
        q = self._queues[key]
        if idx:
            q.rotate(-idx)
            req = q.popleft()
            q.rotate(idx)
        else:
            req = q.popleft()
        self._rows -= req.n
        if key in self._client_rows:
            self._client_rows[key] -= req.n
        return req

    @staticmethod
    def _match(q, space: int, solo_ok: bool, seq_rung) -> int:
        """Index of the request of subqueue ``q`` to take, or -1.  With no
        pinned ``seq_rung`` only the head is considered (FIFO); with one
        (a 2-D batch being built) the scan reaches past requests of other
        seq rungs only, and the first of the rung is taken if it fits
        ``space`` rows (and, when solo, ``solo_ok``), else the scan ends:
        one rung drains in arrival order."""
        for idx, req in enumerate(q):
            if seq_rung is not None and req.seq_rung != seq_rung:
                continue
            ok = req.n <= space and (solo_ok or not req.solo)
            return idx if ok else -1
        return -1

    def _take_one(self, space: int, solo_ok: bool = True,
                  seq_rung: Optional[int] = None) -> Optional[Request]:
        """One request under deficit round robin, or None when nothing
        queued fits ``space`` rows (requests are never split; cond held).
        A solo request fits only when ``solo_ok`` (it opens a batch,
        never joins one); with ``seq_rung`` only requests of that seq
        rung fit (:meth:`_match`).  A visited client banks ``quantum``
        rows once a visit and keeps its turn while its deficit covers the
        request; a client whose queue empties is retired."""
        rr = self._rr
        if self._rows == 0 or not rr:
            return None
        if len(rr) == 1:
            # one subqueue: plain FIFO, no deficit bookkeeping
            idx = self._match(self._queues[rr[0]], space, solo_ok, seq_rung)
            return self._pop(rr[0], idx) if idx >= 0 else None
        # one scan a take: the queues do not change under the lock until
        # _pop, so each client's matched index holds through the rotation
        matches = {key: idx for key, q in self._queues.items() if q
                   for idx in (self._match(q, space, solo_ok, seq_rung),)
                   if idx >= 0}
        if not matches:
            return None                     # nothing fits: close batch
        cap = float(max(self._quantum, self.max_batch))
        while True:
            key = rr[0]
            q = self._queues.get(key)
            if not q:
                rr.popleft()                # retire the idle client
                self._deficit.pop(key, None)
                self._queues.pop(key, None)
                self._client_rows.pop(key, None)
                if self._visiting == key:
                    self._visiting = _NO_VISIT
                continue
            if self._visiting != key:
                self._visiting = key
                self._deficit[key] = min(
                    self._deficit.get(key, 0.0) + self._quantum, cap)
            idx = matches.get(key, -1)
            if idx >= 0 and self._deficit.get(key, 0.0) >= q[idx].n:
                self._deficit[key] -= q[idx].n
                return self._pop(key, idx)
            # nothing fits (space, rung), or its deficit is not yet
            # banked: this visit ends, the next client's turn
            rr.rotate(-1)
            self._visiting = _NO_VISIT

    def next_batch(self, timeout: float = 0.2,
                   wait_fill: bool = True) -> Optional[List[Request]]:
        """The next coalesced batch, or None when nothing arrived within
        ``timeout``.  Blocks up to ``timeout`` for the first request; from
        then on the ``max_delay_ms`` window runs, folding in further
        requests until ``max_batch`` rows are reached.  A request that
        does not fit stays queued (requests are never split).
        ``wait_fill=False`` skips the window and takes only what is
        already queued — the pipelined grab while the previous batch is
        on the device.  A solo request is a batch alone: it closes at
        once when it comes first, and stays queued otherwise.  On a 2-D
        ladder the first request pins the batch's seq rung, and only
        requests of that rung join it; :meth:`wake` ends the wait for the
        first request (None)."""
        with self._cond:
            deadline = time.perf_counter() + max(timeout, 0.0)
            wakes = self._wakes
            while self._rows == 0:
                if self._closed or self._wakes != wakes:
                    return None
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            first = self._take_one(self.max_batch)
            if first is None:               # pragma: no cover - defensive
                return None
            batch = [first]
            rows = first.n
            seq_rung = first.seq_rung
            flush_at = time.perf_counter() + self.max_delay_s
            while rows < self.max_batch and not first.solo:
                req = self._take_one(self.max_batch - rows, solo_ok=False,
                                     seq_rung=seq_rung)
                if req is not None:
                    batch.append(req)
                    rows += req.n
                    continue
                if self._rows:
                    break                   # queued but nothing fits
                remaining = flush_at - time.perf_counter()
                if not wait_fill or remaining <= 0 or self._closed:
                    break
                self._cond.wait(remaining)
            bucket = self.ladder.bucket_for(rows)
            if seq_rung is None:
                key, real, area = self.ladder.bucket_key(bucket), rows, \
                    bucket
            else:
                key = self.ladder.bucket_key(bucket, seq_rung)
                real = sum(r.n * r.seq_len for r in batch)
                area = bucket * seq_rung
            self._counts["batches"] += 1
            self._counts["batched_requests"] += len(batch)
            self._counts["batched_rows"] += rows
            self._counts["padded_rows"] += bucket - rows
            self._counts["real_cells"] += real
            self._counts["padded_cells"] += area - real
            self._bucket_hits[key] += 1
            self._real_cells[key] += real
            self._pad_cells[key] += area - real
            if first.solo:
                self._counts["solo_batches"] += 1
                self.solo_rungs.append((first.req_id, rows, bucket))
        return batch

    # -- stats -----------------------------------------------------------------

    def occupancy(self) -> Optional[float]:
        """Mean real rows per closed batch / max_batch (None before the
        first batch); 1.0 means every batch left full."""
        with self._cond:
            b, rows = self._counts["batches"], self._counts["batched_rows"]
        if not b:
            return None
        return rows / (b * self.max_batch)

    def stats(self) -> Dict:
        with self._cond:
            out = dict(self._counts)
            out["bucket_hits"] = dict(self._bucket_hits)
            out["queue_depth"] = self._rows
        occ = self.occupancy()
        out.update(max_batch=self.max_batch,
                   max_delay_ms=self.max_delay_s * 1e3,
                   queue_bound=self.queue_bound,
                   pad_ratio=self.pad_ratio(),
                   seq_rungs=(None if self.ladder.seq_rungs is None
                              else list(self.ladder.seq_rungs)),
                   mean_occupancy=None if occ is None else round(occ, 4),
                   admission=self.admission_stats())
        return out


def _counter_property(name: str):
    def get(self) -> int:
        with self._cond:
            return self._counts[name]

    return property(get, doc=DynamicBatcher.COUNTERS[name])


for _name in DynamicBatcher.COUNTERS:
    setattr(DynamicBatcher, _name, _counter_property(_name))
del _name


# -- generation ---------------------------------------------------------------

_log = logging.getLogger("znicz_torch.serving")


class GenSeq:
    """One generation request through its life: pending (its prompt
    queued), active (holding a page table; prefilling in
    ``prefill_chunk`` token chunks, then decoding a token a tick),
    finished.  ``prefilled`` counts the prompt positions whose keys and
    values are cached (a prefix hit starts it above 0); ``t`` is the
    cache fill once decoding starts; ``pages`` is the request's page
    table, host ints.

    Sampling is per sequence and seeded on both paths: the in-graph
    sampler keys on ``seed_val``, the host path on a seeded
    ``np.random.Generator``; neighbours share nothing."""

    __slots__ = ("prompt", "prompt_len", "max_new", "temperature",
                 "top_k", "rng", "seed_val", "stream", "return_logits",
                 "return_logprobs", "reply_to", "req_id", "trace_id",
                 "client", "t_enqueued", "t_deadline", "pages",
                 "prefilled", "t", "tokens", "logits", "logprobs",
                 "gen", "t_last", "order", "t_admitted", "t_first")

    def __init__(self, prompt, max_new: int, temperature: float = 0.0,
                 top_k: int = 0, seed=None, stream: bool = False,
                 return_logits: bool = False,
                 return_logprobs: bool = False, reply_to=None,
                 req_id=None, trace_id=None, client=None,
                 deadline_s=None):
        self.prompt = np.asarray(prompt).reshape(-1)
        self.prompt_len = int(self.prompt.shape[0])
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.rng = (np.random.default_rng(seed)
                    if self.temperature > 0 else None)
        self.seed_val = (int(seed) & 0xFFFFFFFF if seed is not None
                         else int(np.random.default_rng()
                                  .integers(0, 2**32)))
        self.stream = bool(stream)
        self.return_logits = bool(return_logits)
        self.return_logprobs = bool(return_logprobs)
        self.reply_to = reply_to
        self.req_id = req_id
        self.trace_id = trace_id
        self.client = client
        self.t_enqueued = time.perf_counter()
        self.t_deadline = (None if deadline_s is None
                           else self.t_enqueued + float(deadline_s))
        self.pages: List[int] = []      # the request's page table
        self.prefilled = 0              # prompt positions cached so far
        self.t = 0                      # cache fill (positions written)
        self.tokens: List[int] = []     # emitted so far
        self.logits = [] if return_logits else None
        self.logprobs = [] if return_logprobs else None
        self.gen = None                 # generation stamp
        self.t_last = None              # last emit (inter-token)
        self.order = 0                  # arrival index (FIFO grouping)
        self.t_admitted = None          # admission (queue wait's end)
        self.t_first = None             # first token (TTFT's end)

    def sample(self, row) -> int:
        """The next token from one (vocab,) logits row on the host
        (``on_device_sampling`` off): the argmax at temperature 0 (a tie
        to the lowest id, the in-graph argmax's choice), else seeded
        softmax sampling over the optional top-k cut."""
        if self.temperature <= 0:
            return int(np.argmax(row))
        z = row.astype(np.float64) / self.temperature
        if self.top_k > 0 and self.top_k < z.shape[0]:
            cut = np.partition(z, -self.top_k)[-self.top_k]
            z = np.where(z >= cut, z, -np.inf)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self.rng.choice(z.shape[0], p=p))


def _host_logp(row, token: int) -> float:
    """log p(token) under one (vocab,) logits row in float64 on the host:
    ``return_logprobs`` when the logits were fetched anyway."""
    z = row.astype(np.float64)
    z -= z.max()
    return float(z[token] - np.log(np.exp(z).sum()))


class GenerationScheduler:
    """Continuous batching over a paged ``GenerationRunner``.  ``submit``
    queues from the router thread; ``step`` (the frontend's compute loop)
    runs one round on the compute thread:

      1. expire pending and active sequences past their deadline (the
         tokens so far ship in the ``deadline`` reply);
      2. admit pending requests into the ``slots`` bound, each with a
         prefix-cache lookup: a prompt sharing indexed full pages starts
         with them claimed (read-only, refcounted) and only its tail to
         prefill;
      3. one decode tick: every prefilled sequence's next token, grouped
         by page rung in FIFO chunks of the top decode rung; a sequence
         that finishes releases its pages in the round, one at the
         context window finishes ``truncated``;
      4. one prefill batch: up to a prefill rung of prefilling sequences
         each advance ``prefill_chunk`` tokens, so a long prompt costs a
         bounded chunk between decode ticks.  Pages are allocated (and a
         shared page about to be appended into copied) here on the host;
         a dry pool stalls a row a tick, never the batch.

    Fetches follow ``on_device_sampling``: on, a tick fetches (b,)
    sampled tokens (and log-probabilities when asked); off, (b, vocab)
    logits sampled on the host.  The executables are the same either
    way, so greedy tokens are bit-identical across the knob.

    ``step`` returns the replies to ship: streamed partials (opt-in) and
    finals.  A resent request matching an in-flight ``(client, req_id)``
    is absorbed: the original generation answers it.  The counters of
    :data:`COUNTERS` read as attributes of the same names."""

    COUNTERS = {
        "gen_submitted": "accepted generate requests",
        "gen_refused": "refused generate requests (policy in the reply)",
        "gen_dedup": "resent generate requests matched to an in-flight "
                     "generation (answered by the original)",
        "prefill_batches": "prefill chunk dispatches",
        "prefill_seqs": "sequences whose prefill completed",
        "prefill_tokens": "prompt tokens computed by prefill chunks "
                          "(prefix-cache hits skip theirs)",
        "decode_batches": "decode tick dispatches",
        "decode_tokens": "tokens emitted by decode ticks",
        "generated_tokens": "tokens emitted in all (prefill's first and "
                            "every decode's)",
        "cow_copies": "shared prefix pages copied at the first divergent "
                      "append",
        "fetch_bytes": "bytes fetched device -> host by generation ticks "
                       "(tokens or logits)",
        "gen_finished": "generations completed to max_new_tokens",
        "gen_truncated": "generations finished at the context window",
        "gen_timed_out": "generations abandoned at their deadline "
                         "(partial tokens shipped)",
    }

    #: samples kept a latency window (inter-token, and TTFT with its
    #: queue-wait and compute parts)
    INTER_TOKEN_WINDOW = 8192
    TTFT_WINDOW = 2048

    def __init__(self, gen_runner, max_new_cap: int = 256,
                 pending_bound: int = 64, decode_tick_ms: float = 0.0,
                 on_device_sampling: bool = True, replica_id: str = ""):
        self.gen = gen_runner
        self.max_new_cap = int(max_new_cap)
        self.pending_bound = int(pending_bound)
        self.decode_tick_s = float(decode_tick_ms) / 1e3
        self.on_device = bool(on_device_sampling)
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._active: List[GenSeq] = []
        #: in-flight (client, req_id) pairs: the resend dedup set
        self._inflight = set()
        self._closed = False
        self._order = 0
        self._next_tick = 0.0
        self._counts: Dict[str, int] = dict.fromkeys(self.COUNTERS, 0)
        #: latency windows (s): name -> bounded deque
        self._windows = {
            "inter_token": collections.deque(maxlen=self.INTER_TOKEN_WINDOW),
            "ttft": collections.deque(maxlen=self.TTFT_WINDOW),
            "queue_wait": collections.deque(maxlen=self.TTFT_WINDOW),
            "compute": collections.deque(maxlen=self.TTFT_WINDOW)}
        #: page-pressure episode latch: log the transition once
        self._page_pressure = False
        self._t_shed_log = 0.0          # queue-shed log rate limit

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += int(n)

    def _observe(self, window: str, seconds: float) -> None:
        with self._lock:
            self._windows[window].append(seconds)

    # -- producer side (router thread) ------------------------------------------

    def submit(self, seq: GenSeq) -> Optional[Refusal]:
        """Queue one generation, or refuse it readably.  A resend of an
        in-flight (client, req_id) is absorbed (None: the original
        answers it)."""
        if seq.prompt_len < 1 or seq.prompt_len > self.gen.max_ctx:
            self._inc("gen_refused")
            return Refusal(
                "oversized",
                f"prompt of {seq.prompt_len} tokens outside the context "
                f"window (1..{self.gen.max_ctx})", scope="client")
        if seq.max_new < 1 or seq.max_new > self.max_new_cap:
            self._inc("gen_refused")
            return Refusal(
                "oversized",
                f"max_new_tokens={seq.max_new} outside 1.."
                f"{self.max_new_cap} "
                f"(root.common.serving.generate.max_new_tokens)",
                scope="client")
        key = (seq.client, seq.req_id)
        with self._lock:
            if self._closed:
                return Refusal("draining", "service is shutting down")
            if seq.req_id is not None and key in self._inflight:
                self._counts["gen_dedup"] += 1
                return None
            if len(self._pending) >= self.pending_bound:
                self._counts["gen_refused"] += 1
                now = time.perf_counter()
                if now - self._t_shed_log > 1.0:
                    # the shed episode, at most once a second
                    self._t_shed_log = now
                    _log.warning(
                        "page_shed reason=queue_bound replica=%s pending=%d "
                        "bound=%d active=%d", self.replica_id,
                        len(self._pending), self.pending_bound,
                        len(self._active))
                return Refusal(
                    "shed",
                    f"generation queue at bound ({len(self._pending)} "
                    f"pending, bound {self.pending_bound}) — shed")
            seq.order = self._order
            self._order += 1
            self._pending.append(seq)
            self._inflight.add(key)
            self._counts["gen_submitted"] += 1
            return None

    def in_flight(self, client, req_id) -> bool:
        """Is this (client, req_id) queued or generating?  The frontend
        answers a resend of one with a heartbeat partial, so the client's
        resend timer refreshes and nothing runs twice."""
        with self._lock:
            return (client, req_id) in self._inflight

    def close(self) -> None:
        with self._lock:
            self._closed = True

    # -- consumer side (compute thread) -----------------------------------------

    def work_available(self) -> bool:
        return bool(self._pending or self._active)

    def work_ready(self, now: Optional[float] = None) -> bool:
        """True when :meth:`step` would dispatch now (admissions pending,
        sequences mid-prefill, or the decode tick due): the compute loop's
        busy/idle hint."""
        if self._pending:
            return True
        if not self._active:
            return False
        if any(s.prefilled < s.prompt_len for s in self._active):
            return True
        now = time.perf_counter() if now is None else now
        return now >= self._next_tick

    def _retire(self, seq: GenSeq) -> None:
        """Drop a sequence from the live sets (its pages are the
        caller's: the compute thread owns the pool)."""
        with self._lock:
            if seq in self._active:
                self._active.remove(seq)
            self._inflight.discard((seq.client, seq.req_id))

    def _release(self, seq: GenSeq) -> None:
        """Return every page reference the request holds; shared prefix
        pages survive on the index's own."""
        if seq.pages:
            self.gen.release_pages(seq.pages)
            seq.pages = []

    def _final(self, seq: GenSeq, replies, truncated: Optional[str] = None,
               counter: str = "gen_finished") -> None:
        self._release(seq)
        self._retire(seq)
        self._inc(counter)
        rep = {"ok": True, "req_id": seq.req_id,
               "replica_id": self.replica_id,
               "tokens": np.asarray(seq.tokens, np.int32),
               "gen": seq.gen, "prompt_len": seq.prompt_len,
               "trace_id": seq.trace_id,
               "timing_ms": self._timing_ms(seq)}
        if truncated:
            rep["truncated"] = truncated
        if seq.logits is not None:
            rep["logits"] = (np.stack(seq.logits) if seq.logits
                             else np.zeros((0, 0), np.float32))
        if seq.logprobs is not None:
            rep["logprobs"] = np.asarray(seq.logprobs, np.float32)
        replies.append((seq.reply_to, rep))

    @staticmethod
    def _timing_ms(seq: GenSeq) -> Dict[str, Optional[float]]:
        """Where the request's wall time went, ms (None where a phase
        never happened)."""
        def ms(a, b):
            return None if a is None or b is None \
                else round((b - a) * 1e3, 3)

        return {"queue_wait": ms(seq.t_enqueued, seq.t_admitted),
                "ttft": ms(seq.t_enqueued, seq.t_first),
                "compute": ms(seq.t_admitted, seq.t_first),
                "total": ms(seq.t_enqueued, seq.t_last)}

    def _expire(self, seq: GenSeq, replies) -> None:
        self._release(seq)
        self._retire(seq)
        self._inc("gen_timed_out")
        replies.append((seq.reply_to, {
            "ok": False, "timed_out": True, "req_id": seq.req_id,
            "replica_id": self.replica_id, "policy": "deadline",
            "tokens": np.asarray(seq.tokens, np.int32),
            "gen": seq.gen, "trace_id": seq.trace_id,
            "error": "deadline expired mid-generation "
                     f"({len(seq.tokens)} of {seq.max_new} tokens "
                     "emitted — shipped partial)"}))

    def _emit(self, seq: GenSeq, token: int, row, logp, now: float,
              replies) -> None:
        seq.tokens.append(int(token))
        if seq.logits is not None:
            seq.logits.append(row.copy())
        if seq.logprobs is not None:
            seq.logprobs.append(logp)
        if seq.t_last is not None:
            self._observe("inter_token", now - seq.t_last)
        else:
            # the first token: TTFT and its queue-wait / compute split
            seq.t_first = now
            self._observe("ttft", now - seq.t_enqueued)
            self._observe("compute", now - (seq.t_admitted
                                            if seq.t_admitted is not None
                                            else seq.t_enqueued))
        seq.t_last = now
        self._inc("generated_tokens")
        if seq.stream and seq.reply_to is not None:
            replies.append((seq.reply_to, {
                "ok": True, "partial": True, "req_id": seq.req_id,
                "replica_id": self.replica_id, "token": int(token),
                "i": len(seq.tokens) - 1, "trace_id": seq.trace_id}))

    # -- page bookkeeping ---------------------------------------------------------

    def _page_writable(self, seq: GenSeq, idx: int) -> bool:
        """Make slot ``idx`` of the request's page table privately
        writable: allocate at the boundary, copy a shared (refcount > 1)
        page.  False under allocation pressure: the caller stalls the row
        a tick (its pages are kept, it retries next round)."""
        if idx == len(seq.pages):
            page = self.gen.alloc_page()
            if page is None:
                return False
            seq.pages.append(page)
            return True
        page = seq.pages[idx]
        if self.gen.page_ref[page] > 1:
            fresh = self.gen.alloc_page()
            if fresh is None:
                return False
            self.gen.copy_page(page, fresh)
            self.gen.decref(page)
            seq.pages[idx] = fresh
            self._inc("cow_copies")
        return True

    def _ensure_chunk(self, seq: GenSeq) -> bool:
        """Make every page the next prefill chunk writes writable."""
        ps = self.gen.page_size
        t0 = seq.prefilled
        end = min(t0 + self.gen.prefill_chunk, seq.prompt_len)
        for idx in range(t0 // ps, -(-end // ps)):
            if not self._page_writable(seq, idx):
                return False
        return True

    # -- fetches ------------------------------------------------------------------

    def _fetch(self, chunk, out):
        """One dispatch's device -> host transfer under
        ``on_device_sampling``: tokens (and log-probabilities when a row
        asks) on, logits off or when a row asks for them.
        ``fetch_bytes`` counts the padded transfer.  Returns host
        ``(tokens, logps, logits)`` of the real rows (None where not
        fetched)."""
        tok_dev, logp_dev, logits_dev, _ = out
        n = len(chunk)
        need_logits = ((not self.on_device)
                       or any(s.return_logits for s in chunk))
        need_logp = (self.on_device
                     and any(s.return_logprobs for s in chunk))
        toks = logps = logits = None
        if self.on_device:
            full = tok_dev.cpu().numpy()
            self._inc("fetch_bytes", full.nbytes)
            toks = full[:n]
        if need_logp:
            full = logp_dev.cpu().numpy()
            self._inc("fetch_bytes", full.nbytes)
            logps = full[:n]
        if need_logits:
            full = logits_dev.cpu().numpy()
            self._inc("fetch_bytes", full.nbytes)
            logits = full[:n]
        return toks, logps, logits

    def _emit_row(self, seq: GenSeq, i: int, fetched, now: float,
                  replies) -> None:
        """Emit row ``i`` of a fetched dispatch (sampled on the host when
        the device's tokens were not fetched)."""
        toks, logps, logits = fetched
        row = None if logits is None else logits[i]
        token = int(toks[i]) if toks is not None else seq.sample(row)
        logp = None
        if seq.return_logprobs:
            logp = (float(logps[i]) if logps is not None
                    else _host_logp(row, token))
        self._emit(seq, token, row, logp, now, replies)

    def step(self):
        """One scheduling round (class docstring).  Returns ``(worked,
        replies)``: whether anything was dispatched, and the
        ``(reply_to, payload)`` pairs to ship."""
        replies: List = []
        worked = False
        now = time.perf_counter()
        # 1. deadlines, pending first (never prefill doomed work)
        with self._lock:
            doomed_p = [s for s in self._pending
                        if s.t_deadline is not None and now > s.t_deadline]
            for s in doomed_p:
                self._pending.remove(s)
            doomed_a = [s for s in self._active
                        if s.t_deadline is not None and now > s.t_deadline]
        for s in doomed_p + doomed_a:
            self._expire(s, replies)
        # 2. admission into the slots; the prefix lookup claims shared
        # full pages, so a hit starts with only its tail to prefill
        admitted: List[GenSeq] = []
        with self._lock:
            while (self._pending
                   and len(self._active) + len(admitted) < self.gen.slots):
                admitted.append(self._pending.popleft())
            self._active.extend(admitted)
        for seq in admitted:
            seq.t_admitted = now
            self._observe("queue_wait", now - seq.t_enqueued)
            if self.gen.prefix is not None:
                pages, covered = self.gen.prefix.lookup(seq.prompt)
                seq.pages = pages
                # full coverage still recomputes the last prompt token (a
                # 1-token chunk): the continuation needs its logits, and
                # that write copies the shared page
                seq.prefilled = min(covered, seq.prompt_len - 1)
        # 3. one decode tick over the prefilled sequences, grouped by page
        # rung: dispatched here, fetched after the prefill dispatch
        chunks = []
        stalled = 0             # rows page pressure held back this round
        if self._active and now >= self._next_tick:
            groups: Dict[int, List[GenSeq]] = {}
            ticked = False
            for seq in sorted([s for s in self._active
                               if s.prefilled >= s.prompt_len],
                              key=lambda s: s.order):
                ticked = True
                if seq.t >= self.gen.max_ctx:
                    self._final(seq, replies, truncated="context window "
                                "exhausted", counter="gen_truncated")
                    continue
                if not self._page_writable(seq, seq.t
                                           // self.gen.page_size):
                    stalled += 1
                    continue            # page pressure: stall a tick
                groups.setdefault(
                    self.gen._page_rung(max(len(seq.pages), 1)),
                    []).append(seq)
            # every chunk of the tick is dispatched before any is fetched:
            # chunk N computes while chunk N-1 is emitted
            chunk_max = self.gen.decode_rungs[-1]
            for rung in sorted(groups):
                grp = groups[rung]
                for lo in range(0, len(grp), chunk_max):
                    chunk = grp[lo:lo + chunk_max]
                    out = self.gen.decode_async(
                        [s.pages for s in chunk],
                        [s.tokens[-1] for s in chunk],
                        [s.t for s in chunk],
                        [s.temperature for s in chunk],
                        [s.top_k for s in chunk],
                        [s.seed_val for s in chunk])
                    chunks.append((chunk, out))
                    self._inc("decode_batches")
                    self._inc("decode_tokens", len(chunk))
                    worked = True
            if ticked and self.decode_tick_s > 0:
                self._next_tick = now + self.decode_tick_s
        # 4. one prefill batch: up to a prefill rung of prefilling
        # sequences advance one bounded chunk, dispatched between the
        # decode dispatches and their fetches
        batch: List[GenSeq] = []
        for seq in sorted([s for s in self._active
                           if s.prefilled < s.prompt_len],
                          key=lambda s: s.order):
            if len(batch) >= self.gen.prefill_rungs[-1]:
                break
            if self._ensure_chunk(seq):
                batch.append(seq)
            else:
                stalled += 1
        pf = None
        t0s: List[int] = []
        nn: List[int] = []
        if batch:
            c = self.gen.prefill_chunk
            x = np.zeros((len(batch), c), np.int64)
            for i, seq in enumerate(batch):
                t0 = seq.prefilled
                n_new = min(c, seq.prompt_len - t0)
                x[i, :n_new] = seq.prompt[t0:t0 + n_new]
                t0s.append(t0)
                nn.append(n_new)
            pf = self.gen.prefill_async(
                x, t0s, nn, [s.pages for s in batch],
                [s.temperature for s in batch],
                [s.top_k for s in batch],
                [s.seed_val for s in batch])
            self._inc("prefill_batches")
            self._inc("prefill_tokens", sum(nn))
            worked = True
        # fetch and emit: the decode chunks first (the oldest dispatches),
        # then the prefill batch's completions
        for chunk, out in chunks:
            fetched = self._fetch(chunk, out)
            t_emit = time.perf_counter()
            for i, seq in enumerate(chunk):
                seq.t += 1
                seq.gen = out[3]
                self._emit_row(seq, i, fetched, t_emit, replies)
                if len(seq.tokens) >= seq.max_new:
                    self._final(seq, replies)
        if pf is not None:
            fetched = self._fetch(batch, pf)
            t_emit = time.perf_counter()
            for i, seq in enumerate(batch):
                seq.prefilled = t0s[i] + nn[i]
                if seq.prefilled < seq.prompt_len:
                    continue        # a mid-prompt chunk: sample discarded
                seq.t = seq.prompt_len
                seq.gen = pf[3]
                if self.gen.prefix is not None:
                    self.gen.prefix.register(seq.prompt, seq.pages)
                self._inc("prefill_seqs")
                self._emit_row(seq, i, fetched, t_emit, replies)
                if len(seq.tokens) >= seq.max_new:
                    self._final(seq, replies)
        self._note_page_pressure(stalled)
        return worked, replies

    def _note_page_pressure(self, stalled: int) -> None:
        """Log the page-pressure transition: the first round whose
        allocations held rows back after a clean round, once an
        episode."""
        if stalled and not self._page_pressure:
            _log.warning("page_shed reason=page_pressure replica=%s "
                         "stalled_rows=%d kv_occupancy=%.4f active=%d",
                         self.replica_id, stalled, self.gen.occupancy(),
                         len(self._active))
        self._page_pressure = bool(stalled)

    def _abandon(self, reply) -> List:
        """Retire every queued and live generation, its pages released,
        each answered with ``reply(seq)``."""
        replies: List = []
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
            active = list(self._active)
        for seq in pending + active:
            self._release(seq)
            self._retire(seq)
            replies.append((seq.reply_to, reply(seq)))
        return replies

    def drain(self) -> List:
        """Abandon every queued and live generation (service shutdown):
        a readable ``draining`` reply each, pages released."""
        def reply(seq):
            self._inc("gen_refused")
            return {"ok": False, "rejected": True, "req_id": seq.req_id,
                    "replica_id": self.replica_id, "policy": "draining",
                    "trace_id": seq.trace_id,
                    "error": "service is shutting down — generation "
                             "abandoned"}

        return self._abandon(reply)

    def fail(self, exc: BaseException) -> List:
        """Close the scheduler and answer every queued and live generation
        with the failure that ended the compute loop."""
        self.close()
        return self._abandon(lambda seq: {
            "ok": False, "req_id": seq.req_id, "replica_id": self.replica_id,
            "policy": "error", "trace_id": seq.trace_id,
            "error": f"compute loop died: {exc!r}"})

    # -- stats --------------------------------------------------------------------

    def _quantiles(self, window: str) -> Dict[str, Optional[float]]:
        with self._lock:
            w = np.asarray(self._windows[window])
        return {f"{window}_p{q}_ms": (None if w.size == 0 else
                                      round(float(np.percentile(w, q)) * 1e3,
                                            3))
                for q in (50, 99)}

    def inter_token_quantiles(self) -> Dict[str, Optional[float]]:
        return self._quantiles("inter_token")

    def ttft_quantiles(self) -> Dict[str, Optional[float]]:
        """TTFT and its queue-wait / compute split, p50 and p99 in ms
        (None on an empty window)."""
        out: Dict[str, Optional[float]] = {}
        for window in ("ttft", "queue_wait", "compute"):
            out.update(self._quantiles(window))
        return out

    def stats(self) -> Dict:
        with self._lock:
            out = {"pending": len(self._pending),
                   "active": len(self._active)}
            out.update(self._counts)
        out.update({"max_new_tokens": self.max_new_cap,
                    "pending_bound": self.pending_bound,
                    "decode_tick_ms": self.decode_tick_s * 1e3,
                    "on_device_sampling": self.on_device})
        out.update(self.inter_token_quantiles())
        out.update(self.ttft_quantiles())
        out.update(self.gen.stats())
        return out


def _gen_counter_property(name: str):
    def get(self) -> int:
        with self._lock:
            return self._counts[name]

    return property(get, doc=GenerationScheduler.COUNTERS[name])


for _name in GenerationScheduler.COUNTERS:
    setattr(GenerationScheduler, _name, _gen_counter_property(_name))
del _name

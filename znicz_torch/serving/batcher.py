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

Continuous batching for generation comes with ROADMAP A.8 (generation
serving).

Threading: ``submit`` may be called from any thread, ``next_batch`` from
the one compute thread; one condition variable guards the queues and the
counters.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence

from znicz_torch.transport.admission import AdmissionTable, TokenBucket

__all__ = ["AdmissionPolicy", "BucketLadder", "DynamicBatcher", "Refusal",
           "Request", "TokenBucket"]


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
        requests of that rung join it."""
        with self._cond:
            deadline = time.perf_counter() + max(timeout, 0.0)
            while self._rows == 0:
                if self._closed:
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

"""Dynamic request batcher (port of the classic half of
``znicz_tpu/serving/batcher.py``).

  - **Coalescing**: a bounded queue of requests drains into batches under
    ``(max_batch, max_delay_ms)`` — a batch closes once it holds
    ``max_batch`` rows, or ``max_delay_ms`` after its first row was taken.
  - **Bucket ladder**: each batch is padded up to the next rung of a fixed
    ladder (powers of two up to ``max_batch``), so the model sees at most
    ``len(ladder)`` batch shapes.
  - **Backpressure**: the queue is bounded in rows; a submit past
    ``queue_bound`` is refused at once with a :class:`Refusal`.

Admission control (rate limits, fair queueing), deadlines, the 2-D
sequence ladder and generation come in later slices.

Threading: ``submit`` may be called from any thread, ``next_batch`` from
the one compute thread; one condition variable guards the queue.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence


class BucketLadder:
    """The fixed ladder of padded batch sizes: the powers of two below
    ``max_batch`` plus ``max_batch`` itself, or explicit ``rungs`` ending
    at ``max_batch``."""

    def __init__(self, max_batch: int,
                 rungs: Optional[Sequence[int]] = None):
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if rungs is None:
            rungs = []
            r = 1
            while r < self.max_batch:
                rungs.append(r)
                r *= 2
            rungs.append(self.max_batch)
        rungs = sorted(set(int(r) for r in rungs))
        if not rungs or rungs[0] < 1 or rungs[-1] != self.max_batch:
            raise ValueError(
                f"bucket ladder {rungs} must be positive and end at "
                f"max_batch={self.max_batch}")
        self.rungs: List[int] = rungs

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n."""
        for r in self.rungs:
            if n <= r:
                return r
        raise ValueError(f"{n} rows exceed the ladder's top rung "
                         f"{self.rungs[-1]}")

    def buckets(self) -> List[int]:
        """Every batch shape the model may see (the warmup set)."""
        return list(self.rungs)

    def __repr__(self):
        return f"BucketLadder({self.rungs})"


class Refusal(str):
    """A refusal reason: a readable string carrying the ``policy`` slug
    (``shed`` / ``oversized`` / ``draining``) so a caller can react per
    policy without parsing prose."""

    policy = "refused"

    def __new__(cls, policy: str, reason: str):
        self = super().__new__(cls, reason)
        self.policy = policy
        return self


class Request:
    """One queued inference request: ``x`` is the (n, *sample) host
    array; ``reply_to`` receives the reply dict — a callable, or a
    ``concurrent.futures.Future`` whose result is set; ``req_id`` is the
    caller's correlation id.  ``t_enqueued`` feeds the latency stats."""

    __slots__ = ("x", "n", "reply_to", "req_id", "t_enqueued")

    def __init__(self, x, n: int, reply_to=None, req_id=None):
        self.x = x
        self.n = int(n)
        self.reply_to = reply_to
        self.req_id = req_id
        self.t_enqueued = time.perf_counter()


class DynamicBatcher:
    """Bounded request queue + the coalescing policy (module docstring).
    ``submit`` returns None on acceptance or a :class:`Refusal`."""

    COUNTERS = ("submitted", "shed", "oversized", "batches",
                "batched_requests", "batched_rows", "padded_rows")

    def __init__(self, max_batch: int = 32, max_delay_ms: float = 5.0,
                 queue_bound: int = 256,
                 ladder: Optional[BucketLadder] = None):
        self.ladder = ladder or BucketLadder(max_batch)
        self.max_batch = self.ladder.max_batch
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.queue_bound = int(queue_bound)
        self._queue: "collections.deque[Request]" = collections.deque()
        self._rows = 0                      # rows currently queued
        self._cond = threading.Condition()
        self._closed = False
        self.counts: Dict[str, int] = dict.fromkeys(self.COUNTERS, 0)
        self.bucket_hits: Dict[int, int] = dict.fromkeys(self.ladder.rungs,
                                                         0)

    # -- producer side ---------------------------------------------------------

    def submit(self, req: Request) -> Optional[Refusal]:
        with self._cond:
            if req.n < 1 or req.n > self.max_batch:
                self.counts["oversized"] += 1
                return Refusal(
                    "oversized", f"request of {req.n} rows exceeds "
                    f"max_batch={self.max_batch} (split it client-side)")
            if self._closed:
                return Refusal("draining", "service is shutting down")
            if self._rows + req.n > self.queue_bound:
                self.counts["shed"] += 1
                return Refusal(
                    "shed", f"queue at bound ({self._rows} rows queued, "
                    f"bound {self.queue_bound}) — shed")
            self._queue.append(req)
            self._rows += req.n
            self.counts["submitted"] += 1
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

    def _take(self, space: int) -> Optional[Request]:
        """The queue's head if it fits ``space`` rows (cond held).
        Requests are never split, and never overtake one another."""
        if self._queue and self._queue[0].n <= space:
            req = self._queue.popleft()
            self._rows -= req.n
            return req
        return None

    def next_batch(self, timeout: float = 0.2,
                   wait_fill: bool = True) -> Optional[List[Request]]:
        """The next coalesced batch, or None when nothing arrived within
        ``timeout``.  Blocks up to ``timeout`` for the FIRST request; from
        then on the ``max_delay_ms`` window runs, folding in further
        requests until ``max_batch`` rows are reached.  ``wait_fill=False``
        skips the window and takes only what is already queued — the
        pipelined grab while the previous batch is on the device."""
        with self._cond:
            deadline = time.perf_counter() + max(timeout, 0.0)
            while self._rows == 0:
                if self._closed:
                    return None
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            first = self._take(self.max_batch)
            batch = [first]
            rows = first.n
            flush_at = time.perf_counter() + self.max_delay_s
            while rows < self.max_batch:
                req = self._take(self.max_batch - rows)
                if req is not None:
                    batch.append(req)
                    rows += req.n
                    continue
                if self._rows:
                    break                   # queued but does not fit
                remaining = flush_at - time.perf_counter()
                if not wait_fill or remaining <= 0 or self._closed:
                    break
                self._cond.wait(remaining)
            bucket = self.ladder.bucket_for(rows)
            self.counts["batches"] += 1
            self.counts["batched_requests"] += len(batch)
            self.counts["batched_rows"] += rows
            self.counts["padded_rows"] += bucket - rows
            self.bucket_hits[bucket] += 1
        return batch

    # -- stats -----------------------------------------------------------------

    def stats(self) -> Dict:
        with self._cond:
            out = dict(self.counts)
            out["bucket_hits"] = dict(self.bucket_hits)
            out["queue_depth"] = self._rows
        out.update(max_batch=self.max_batch,
                   max_delay_ms=self.max_delay_s * 1e3,
                   queue_bound=self.queue_bound)
        b = out["batches"]
        out["mean_occupancy"] = (None if not b else
                                 out["batched_rows"] / (b * self.max_batch))
        return out

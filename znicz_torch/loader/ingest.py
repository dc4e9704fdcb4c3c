"""The host ingest engine: a parallel image decode with a bounded
prefetch cache, and a stager that assembles segments ahead of the device
(port of ``znicz_tpu/loader/ingest.py``).

  - :class:`DecodePool`: N threads decode rows by global index.  PIL's
    decoders and resize release the GIL, so threads add decode rate
    without copying arrays between processes.  ``submit(indices)`` starts
    the decode of rows a later segment needs; ``take(indices)`` serves a
    segment, from the cache where a row was submitted, decoding the rest
    in the pool at once.  Entries leave the cache when taken, and
    ``max_outstanding_rows`` caps it.  Decoding is pure, so pooled rows
    are the serial rows bit for bit, whatever the order of arrival.
  - :class:`DeviceStager`: ``depth`` threads run ``assemble(idx_rows)``
    (the host gather, the copy into pinned memory and the asynchronous
    copy to the device) for segments the trainer predicts, while the
    current one runs; ``take`` hands the trainer the staged segment, or
    assembles it inline when it was not predicted.
  - :func:`measure_decode_rate`: a source's decode rate in images/s.

``FusedTrainer`` keeps a lookahead of minibatches whose indices are
known, submits their rows to the pool and their segments to the stager,
so decode and copy overlap the device's work.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

#: the default cap on cached and in-flight prefetched rows: 8192 rows of
#: 227x227x3 uint8 are 1.2 GiB of host memory
DEFAULT_MAX_OUTSTANDING_ROWS = 8192


def default_workers() -> int:
    """Decode threads when neither the source nor the caller names a
    count: ``root.common.engine.decode_workers``, else one a CPU, at most
    16."""
    from znicz_torch.core.config import root

    cfg = root.common.engine.get("decode_workers", None)
    if cfg is not None:
        return int(cfg)
    return min(os.cpu_count() or 1, 16)


class DecodePool:
    """``workers`` threads that run ``decode_row(i) -> np.ndarray`` (pure:
    the same ``i`` gives the same bytes), with a cache of submitted rows
    bounded at ``max_outstanding_rows``.  ``submit`` may run on the
    training thread while ``take`` runs on a stager thread: the cache is
    guarded by a lock."""

    def __init__(self, decode_row: Callable[[int], np.ndarray],
                 workers: Optional[int] = None,
                 max_outstanding_rows: int = DEFAULT_MAX_OUTSTANDING_ROWS):
        self._decode_row = decode_row
        self._workers = workers
        self._ex: Optional[ThreadPoolExecutor] = None
        self._futures: Dict[int, object] = {}
        self._lock = threading.Lock()
        self.max_outstanding_rows = int(max_outstanding_rows)
        #: prefetch_hits: rows take() found submitted; decode_misses: rows
        #: it had to decode then
        self.stats = {"prefetch_hits": 0, "decode_misses": 0,
                      "rows_decoded": 0, "rows_prefetched": 0}

    @property
    def workers(self) -> int:
        if self._workers is None:
            self._workers = default_workers()
        return max(1, int(self._workers))

    def _executor(self) -> ThreadPoolExecutor:
        if self._ex is None:
            self._ex = ThreadPoolExecutor(self.workers,
                                          thread_name_prefix="znicz-decode")
        return self._ex

    def submit(self, indices) -> int:
        """Start decoding rows a later ``take`` will consume; rows already
        cached are skipped, and past the cap the rest are dropped (``take``
        decodes them then).  Returns the count newly submitted."""
        ex = self._executor()
        n = 0
        with self._lock:
            for i in np.unique(np.asarray(indices)):
                i = int(i)
                if i in self._futures:
                    continue
                if len(self._futures) >= self.max_outstanding_rows:
                    break
                self._futures[i] = ex.submit(self._decode_row, i)
                n += 1
            self.stats["rows_prefetched"] += n
        return n

    def take(self, indices) -> np.ndarray:
        """The rows of ``indices`` in order (a padded tail repeats its
        last index: each distinct row decodes once)."""
        ex = self._executor()
        local: Dict[int, object] = {}
        futs = []
        with self._lock:
            for i in np.asarray(indices).reshape(-1):
                i = int(i)
                f = local.get(i)
                if f is None:
                    f = self._futures.pop(i, None)
                    if f is None:
                        self.stats["decode_misses"] += 1
                        f = ex.submit(self._decode_row, i)
                    else:
                        self.stats["prefetch_hits"] += 1
                    local[i] = f
                futs.append(f)
            self.stats["rows_decoded"] += len(futs)
        return np.stack([f.result() for f in futs])

    @property
    def outstanding_rows(self) -> int:
        with self._lock:
            return len(self._futures)

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._ex = None
        with self._lock:
            self._futures.clear()


class DeviceStager:
    """``depth`` threads that stage predicted segments ahead.

    ``submit(idx_rows)`` starts ``assemble(idx_rows)`` for a segment the
    trainer expects (False when it is pending already or ``depth`` are
    outstanding).  ``take(idx_rows)`` returns the staged segment of
    exactly these rows: a pending one is a hit (the wait for it is
    observed), anything else is assembled inline, a miss.  A
    prediction still pending from one miss to the next is stale and is
    dropped (an eviction); a single miss drops nothing, since at a cold
    start the right predictions wait behind it.  The key of a segment is
    its stacked index rows, so a wrong prediction is dropped, never
    served.

    Telemetry (the ``ingest`` scope): the hits, misses and evictions are
    ``stage_hits``, ``stage_misses`` and ``stage_evictions``, the waits
    and assemblies the ``ingest_wait_ms`` and ``h2d_copy_ms`` rings,
    ``staging_occupancy`` the segments pending; each assembly is an
    ``ingest/stage`` span and each wait an ``ingest/wait`` span."""

    def __init__(self, assemble: Callable[[List[np.ndarray]], object],
                 depth: int = 2):
        from znicz_torch import telemetry

        self._assemble = assemble
        self.depth = max(1, int(depth))
        self._ex: Optional[ThreadPoolExecutor] = None
        self._pending: Dict[bytes, object] = {}
        self._stale: set = set()
        _sc = telemetry.scope("ingest")
        self._tracer = telemetry.tracer()
        self._m = {name: _sc.counter(name, help) for name, help in (
            ("stage_hits", "take() segments served by a background-staged "
                           "future"),
            ("stage_misses", "take() segments assembled inline (not "
                             "predicted, or capacity-dropped)"),
            ("stage_evictions", "pending predictions dropped on a take() "
                                "miss (stale: their slot and buffers are "
                                "reclaimed)"))}
        #: the training thread's wait per hit and the assembly time per
        #: segment (host gather to the copy's launch), in ms
        self._m_wait_ms = _sc.histogram(
            "ingest_wait_ms", "training-thread wait per staged segment "
            "(ms)", size=2048)
        self._m_h2d_ms = _sc.histogram(
            "h2d_copy_ms", "host gather + copy launch per staged segment "
            "(ms), measured on the stager thread", size=2048)
        self._m_occupancy = _sc.gauge(
            "staging_occupancy", "staged segments in flight or ready "
            "(the ping-pong bound: depth)")

    @staticmethod
    def key_of(idx_rows) -> bytes:
        mat = np.stack([np.asarray(r, np.int32) for r in idx_rows])
        return mat.shape[0].to_bytes(4, "little") + mat.tobytes()

    def _executor(self) -> ThreadPoolExecutor:
        if self._ex is None:
            # one thread a buffer: two neighbouring segments' assemblies
            # overlap each other as well as the device's work
            self._ex = ThreadPoolExecutor(self.depth,
                                          thread_name_prefix="znicz-stage")
        return self._ex

    def _timed_assemble(self, idx_rows):
        t0 = time.perf_counter()
        out = self._assemble(idx_rows)
        dt = time.perf_counter() - t0
        self._m_h2d_ms.observe(dt * 1e3)
        if self._tracer.enabled:
            self._tracer.add("ingest", "stage", t0, dt,
                             {"steps": len(idx_rows)})
        return out

    def submit(self, idx_rows) -> bool:
        key = self.key_of(idx_rows)
        if key in self._pending or len(self._pending) >= self.depth:
            return False
        self._pending[key] = self._executor().submit(self._timed_assemble,
                                                     list(idx_rows))
        self._m_occupancy.set(len(self._pending))
        return True

    def take(self, idx_rows):
        key = self.key_of(idx_rows)
        fut = self._pending.pop(key, None)
        if fut is None:
            stale = self._stale & set(self._pending)
            for k in stale:
                del self._pending[k]
            if stale:
                self._m["stage_evictions"].inc(len(stale))
            self._stale = set(self._pending)
            self._m_occupancy.set(len(self._pending))
            self._m["stage_misses"].inc()
            return self._timed_assemble(list(idx_rows))
        self._stale.discard(key)
        self._m_occupancy.set(len(self._pending))
        self._m["stage_hits"].inc()
        t0 = time.perf_counter()
        out = fut.result()
        dt = time.perf_counter() - t0
        self._m_wait_ms.observe(dt * 1e3)
        if self._tracer.enabled:
            self._tracer.add("ingest", "wait", t0, dt,
                             {"steps": len(idx_rows)})
        return out

    @property
    def outstanding(self) -> int:
        return len(self._pending)

    def quiesce(self) -> None:
        """Wait until every pending assembly has finished; each stays
        pending for its ``take`` (an error surfaces there)."""
        for fut in list(self._pending.values()):
            fut.exception()

    def stats(self) -> Dict[str, object]:
        waits, assembles = self._m_wait_ms.window(), self._m_h2d_ms.window()
        return {**{name: int(m.value) for name, m in self._m.items()},
                "outstanding": len(self._pending),
                "wait_ms_p50": (float(np.median(waits))
                                if waits.size else None),
                "wait_ms_max": (float(np.max(waits))
                                if waits.size else None),
                "assemble_ms_p50": (float(np.median(assembles))
                                    if assembles.size else None)}

    def close(self) -> None:
        """Drop pending work; a running assembly finishes on its thread
        and its result is discarded."""
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._ex = None
        self._pending.clear()
        self._stale.clear()


def measure_decode_rate(source, n: int = 256,
                        workers: Optional[int] = None) -> float:
    """Images/s of a file source's decode: ``n`` rows through its own
    gather (pooled where it has a pool), decoded twice and the second
    pass timed, so the page cache is as warm as in training."""
    n = min(int(n), len(source))
    idx = np.arange(n, dtype=np.int32)
    if workers is not None and hasattr(source, "with_workers"):
        source = source.with_workers(workers)
    source.gather(idx)
    t0 = time.perf_counter()
    source.gather(idx)
    return n / max(time.perf_counter() - t0, 1e-9)

"""Inference service frontend (port of the in-process core of
``znicz_tpu/serving/frontend.py``): dynamic batcher + model runner + the
compute loop.

Requests enter where the reference's ZMQ receive loop hands them over:
:meth:`InferenceServer.submit` of a :class:`~.batcher.Request`.  Replies go
to the request's ``reply_to`` — a callable called with the reply dict, or
a ``concurrent.futures.Future`` whose result is set to it::

    {"ok": True, "req_id": ..., "gen": 1, "y": ndarray (n, *out)}
    {"ok": False, "req_id": ..., "policy": "shed", "error": "..."}

ONE compute thread drives the ping-pong: it coalesces a batch, assembles
it into a pinned host buffer, stages it (async H2D on a side stream) and
dispatches the forward; while the device computes batch N it coalesces
and stages what is already queued as batch N+1, and only then reads
batch N's result.  Pad rows never leave the server: each reply is a copy
of its own rows.

``InferenceServer(workflow, snapshot=path)`` serves the snapshot's
parameters from the start.  :meth:`InferenceServer.swap_async` moves
the service to another snapshot on a background thread
(``ModelRunner.swap``): the old generation serves until the warmed flip,
and a failed swap is logged and counted while it serves on.  Each reply
carries the generation (``"gen"``) whose parameters computed it.

The ZMQ ROUTER with the wire-v3 codec, the CLI ``--serve`` flag,
deadlines and admission control come in later slices.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from znicz_torch.core.config import root

from .batcher import BucketLadder, DynamicBatcher, Refusal, Request
from .model import ModelRunner

#: serving config home: ``root.common.serving.*``
DEFAULTS = {"max_batch": 32, "max_delay_ms": 5.0, "queue_bound": 256}


def _cfg(name: str, override):
    if override is not None:
        return override
    return root.common.serving.get(name, DEFAULTS[name])


def _deliver(req: Request, reply: Dict) -> None:
    to = req.reply_to
    if to is None:
        return
    if isinstance(to, Future):
        if not to.done():
            to.set_result(reply)
    else:
        to(reply)


class InferenceServer:
    """Serve a built workflow's frozen forward to in-process callers.
    Drive it with :meth:`start` / :meth:`submit` / :meth:`stop`."""

    #: latency samples kept for the quantiles
    LATENCY_WINDOW = 65536

    def __init__(self, workflow, max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_bound: Optional[int] = None,
                 ladder: Optional[BucketLadder] = None,
                 warmup: bool = True, snapshot: str = ""):
        self.log = logging.getLogger("znicz_torch.serving")
        self.runner = ModelRunner(workflow, snapshot=snapshot)
        max_batch = int(_cfg("max_batch", max_batch))
        self.batcher = DynamicBatcher(
            max_batch=max_batch,
            max_delay_ms=float(_cfg("max_delay_ms", max_delay_ms)),
            queue_bound=int(_cfg("queue_bound", queue_bound)),
            ladder=ladder or BucketLadder(max_batch))
        self.warmup = bool(warmup)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._latencies: List[float] = []
        self.served = 0
        self.refused = 0
        #: the exception that ended the compute loop, if one did
        self.error: Optional[BaseException] = None
        self._swap_gate = threading.Lock()
        self._swap_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "InferenceServer":
        """Warm every ladder rung on the calling thread (a failure raises
        here), then start the compute thread."""
        if self.warmup:
            self.runner.warmup(self.batcher.ladder)
        self._thread = threading.Thread(target=self._compute_loop,
                                        daemon=True, name="znicz-serve")
        self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        """Refuse new work, drain what is queued, join the compute
        thread."""
        self._stop.set()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("compute thread did not stop within "
                                   f"{timeout}s")
            self._thread = None

    # -- snapshot rollover -----------------------------------------------------

    def swap_async(self, path: str) -> threading.Thread:
        """Start moving the service to the snapshot at ``path`` on a
        background thread (``ModelRunner.swap`` through every rung of the
        ladder); the old generation serves until the warmed flip.  Raises
        ``RuntimeError`` while another swap runs."""
        with self._swap_gate:
            if (self._swap_thread is not None
                    and self._swap_thread.is_alive()):
                raise RuntimeError("swap already in progress")
            t = threading.Thread(target=self._swap, args=(path,),
                                 daemon=True, name="znicz-swap")
            self._swap_thread = t
            t.start()
        return t

    def _swap(self, path: str) -> None:
        try:
            meta = self.runner.swap(path, self.batcher.ladder)
            self.log.info("snapshot rollover -> generation %d (%s, epoch "
                          "%s)", self.runner.generation, path,
                          meta.get("epoch"))
        except Exception:
            # counted by the runner (swap_failures); the old generation
            # serves on
            self.log.exception("snapshot swap from %r failed; generation "
                               "%d unchanged", path, self.runner.generation)

    # -- producer side ---------------------------------------------------------

    def submit(self, req: Request) -> Optional[Refusal]:
        """Queue ``req``; a refusal is returned AND delivered to
        ``reply_to``."""
        if self.error is not None:
            refusal = Refusal("draining",
                              f"compute loop died: {self.error!r}")
        else:
            refusal = self.batcher.submit(req)
        if refusal is not None:
            with self._lock:
                self.refused += 1
            _deliver(req, {"ok": False, "req_id": req.req_id,
                           "policy": refusal.policy, "error": str(refusal)})
        return refusal

    # -- the compute thread ----------------------------------------------------

    def _assemble(self, batch: List[Request]):
        """Coalesced requests -> their batch staged for the device: their
        rows in order, zero pad rows up to the ladder rung."""
        rows = sum(r.n for r in batch)
        bucket = self.batcher.ladder.bucket_for(rows)
        buf = self.runner.host_buffer(self.runner.bucket_shape(bucket))
        x = buf.numpy()
        off = 0
        for r in batch:
            x[off:off + r.n] = np.asarray(r.x, self.runner.dtype).reshape(
                (r.n,) + self.runner.sample_shape)
            off += r.n
        x[off:] = 0
        return self.runner.stage(buf)

    def _finish(self, live: List[Request], y_dev, gen: int) -> None:
        y = y_dev.cpu().numpy()             # the sync point
        now = time.perf_counter()
        off = 0
        lat = []
        for r in live:
            # each reply owns a copy of its rows: pad rows stay here
            _deliver(r, {"ok": True, "req_id": r.req_id, "gen": gen,
                         "y": np.array(y[off:off + r.n])})
            lat.append(now - r.t_enqueued)
            off += r.n
        with self._lock:
            self.served += len(live)
            self._latencies.extend(lat)
            del self._latencies[:-self.LATENCY_WINDOW]

    def _fail(self, live: List[Request], exc: BaseException) -> None:
        for r in live:
            _deliver(r, {"ok": False, "req_id": r.req_id,
                         "policy": "error", "error": repr(exc)})

    def _compute_loop(self) -> None:
        queued: Optional[List[Request]] = None   # staged, not dispatched
        staged = None
        live: List[Request] = []                 # dispatched, unanswered
        try:
            while True:
                if queued is None:
                    queued = self.batcher.next_batch(timeout=0.05)
                    if queued is None:
                        if self._stop.is_set():
                            return
                        continue
                    staged = self._assemble(queued)
                live, x_dev = queued, staged
                queued = staged = None
                y_dev, gen = self.runner.infer_staged(x_dev)
                # while the device computes batch N, stage what is
                # already queued as N+1 (no coalescing window here: it
                # would hold N's finished replies hostage)
                queued = self.batcher.next_batch(timeout=0.0,
                                                 wait_fill=False)
                if queued is not None:
                    staged = self._assemble(queued)
                self._finish(live, y_dev, gen)
                live = []
        except Exception as exc:     # the thread's boundary: record, answer
            self.log.exception("inference compute loop died")
            self.error = exc
            self._stop.set()
            self.batcher.close()
            self._fail(live + (queued or []), exc)
            while True:
                batch = self.batcher.next_batch(timeout=0.0)
                if batch is None:
                    break
                self._fail(batch, exc)

    # -- stats -----------------------------------------------------------------

    def latency_quantiles(self) -> Dict[str, Optional[float]]:
        """p50/p99 request latency (enqueue -> result on the host), ms."""
        with self._lock:
            lat = np.asarray(self._latencies)
        if not lat.size:
            return {"p50_ms": None, "p99_ms": None}
        return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3)}

    def stats(self) -> Dict:
        with self._lock:
            out = {"served": self.served, "refused": self.refused}
        out.update(self.latency_quantiles())
        out.update(self.runner.stats())
        out["batcher"] = self.batcher.stats()
        return out

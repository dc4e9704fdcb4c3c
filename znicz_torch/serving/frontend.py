"""Inference service frontend (port of ``znicz_tpu/serving/frontend.py``):
ZMQ ROUTER + wire-v3 codec + dynamic batcher + model runner.

Clients connect DEALER sockets (``serving/client.py``), many requests in
flight each; every request and reply is a wire-v3 multipart
(``parallel/wire.py``): one metadata frame plus one zero-copy buffer
frame a tensor.  The ROUTER envelope rides the batcher untouched and is
put back in front of the reply, so replies route in any order::

    {"cmd": "infer", "x": (n, *sample), "req_id", "client",
     "deadline_ms", "trace_id"}
    -> {"ok": True, "req_id", "trace_id", "gen", "replica_id",
        "y": (n, *out)}
    -> {"ok": False, "rejected": True, "policy", "scope", "error", ...}
    -> {"ok": False, "timed_out": True, "policy": "deadline", ...}

Control commands: ``ping``, ``stats``, ``swap`` (a snapshot ``path``:
the rollover runs on a background thread and the reply acknowledges the
start) and ``rollback``; an unknown command is answered with an error.

In-process callers keep :meth:`InferenceServer.submit` of a
:class:`~.batcher.Request` whose ``reply_to`` is a callable or a
``concurrent.futures.Future``: its reply is delivered to it, not to the
ROUTER.

Threading:

  - the ROUTER thread (``serve()``, started by :meth:`start`) owns the
    ROUTER socket and the codec: it binds, warms every ladder rung, then
    decodes requests, queues them on the batcher, answers control
    commands inline, refuses undecodable frames (``bad_frames``) and
    sends the replies the compute thread queued;
  - ONE compute thread coalesces a batch, assembles it into a pinned
    host buffer, stages it (async H2D on a side stream) and dispatches
    the forward; while the device computes batch N it coalesces and
    stages what is already queued as batch N+1, and only then reads
    batch N's result.  It queues replies for the ROUTER thread and pokes
    an inproc PUSH->PULL pair (both ends on ``zmq.Context.instance()``)
    to wake it; no socket is shared across threads.

Fault model: an undecodable frame is answered with a routable
``bad_frame`` reply and counted, never fatal; every admission refusal
(shed / oversized / rate_limited) is answered with its reason, ``policy``
and ``scope``; a request whose deadline (the client's ``deadline_ms``
budget, capped by ``request_ttl_s``) is spent is refused at ingress,
answered ``timed_out`` at assemble time, and a result computed past it is
dropped (``expired_results``), never shipped.  Pad rows never leave the
server: each reply owns a copy of its rows.  ``max_requests`` ends the
serve loop once that many requests were answered.

The runner captures one CUDA graph a ladder rung on the card
(``capture``; see ``serving/model.py``).  On a serving mesh
(``root.common.serving.mesh.{data,model}``, one process a rank) this
server runs on rank 0 and the other ranks call ``ModelRunner.follow()``;
the ladder's rungs are snapped to multiples of the ``data`` axis, and
stopping the server stops the other ranks.  The seeded chaos harness
(``parallel/chaos.py``: ``ChaosProxy``, ``FloodProcess``, compute stalls
through ``runner.inject_compute_faults``) can be put in front of it.

The fleet heartbeat (``announce``) and the replica balancer, then the AOT
executable cache, come with the rest of ROADMAP A.6, sequence and
generation serving with A.8, exemplars and SLOs with telemetry (A.9).
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from znicz_torch.core.config import check_serving_keys, root

from .batcher import (AdmissionPolicy, BucketLadder, DynamicBatcher,
                      Refusal, Request)
from .model import ModelRunner

#: the serving keys the port reads (``root.common.serving.*``), with the
#: reference's defaults; ``core/config.UNPORTED_SERVING_KEYS`` refuses
#: the reference's others
DEFAULTS = {"max_batch": 32, "max_delay_ms": 5.0, "queue_bound": 256,
            "request_ttl_s": 5.0, "max_requests": None,
            "admission": {"enabled": True, "rate_limit": 0.0,
                          "rate_burst": 0.0, "fair": True, "quantum": 0,
                          "client_queue_bound": 0},
            "mesh": {"data": 1, "model": 1}}


def _cfg(name: str, override):
    if override is not None:
        return override
    return root.common.serving.get(name, DEFAULTS[name])


def _admission_from_config() -> AdmissionPolicy:
    d = DEFAULTS["admission"]
    adm = root.common.serving.admission
    return AdmissionPolicy(
        rate_limit=float(adm.get("rate_limit", d["rate_limit"])),
        rate_burst=float(adm.get("rate_burst", d["rate_burst"])),
        fair=bool(adm.get("fair", d["fair"])),
        quantum=int(adm.get("quantum", d["quantum"])),
        client_queue_bound=int(adm.get("client_queue_bound",
                                       d["client_queue_bound"])),
        enabled=bool(adm.get("enabled", d["enabled"])))


class InferenceServer:
    """Serve a built workflow's frozen forward over ZMQ and to in-process
    callers.

    ``bind`` may use a wildcard port (``tcp://127.0.0.1:*``); the resolved
    address is in ``endpoint`` once serving starts.  Drive it blocking
    (:meth:`serve`) or on a background thread (:meth:`start` /
    :meth:`stop`).  ``max_requests`` makes the serve loop return after
    answering that many requests."""

    #: serving counters: name -> meaning
    COUNTERS = {
        "requests_in": "decoded infer requests",
        "served": "answered with a result",
        "timed_out": "answered timed_out (deadline/TTL)",
        "rejected": "answered shed/oversized/rate_limited/draining",
        "expired_results": "computed results dropped: deadline passed "
                           "post-compute",
        "serve_errors": "fatal serve-loop failures surfaced to start()",
    }

    #: latency samples kept for the quantiles
    LATENCY_WINDOW = 8192

    #: how long the final replies may take to leave once serving ends
    CLOSE_LINGER_MS = 2000

    def __init__(self, workflow, bind: str = "tcp://127.0.0.1:*",
                 snapshot: str = "", max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_bound: Optional[int] = None,
                 request_ttl_s: Optional[float] = None,
                 ladder: Optional[BucketLadder] = None,
                 max_requests: Optional[int] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 warmup: bool = True, replica_id: Optional[str] = None,
                 capture: Optional[bool] = None):
        import uuid

        from znicz_torch.parallel import wire

        check_serving_keys()
        self.log = logging.getLogger("znicz_torch.serving")
        self.bind = bind
        self.replica_id = replica_id or f"replica-{uuid.uuid4().hex[:6]}"
        self.endpoint: Optional[str] = None      # resolved at serve()
        self.runner = ModelRunner(workflow, snapshot=snapshot,
                                  capture=capture)
        if self.runner.rank != 0:
            raise RuntimeError(
                f"rank {self.runner.rank} of a serving mesh does not "
                f"serve: call ModelRunner(workflow).follow() there")
        max_batch = int(_cfg("max_batch", max_batch))
        # every rung splits evenly over the mesh's data axis: an explicit
        # ladder that cannot is refused here, not at the first request
        dp = self.runner.data_parallel
        if ladder is None:
            ladder = BucketLadder(max_batch, dp=dp)
        elif dp > 1 and ladder.dp != dp:
            ladder = BucketLadder(ladder.max_batch, ladder.rungs, dp=dp)
        self.batcher = DynamicBatcher(
            max_batch=max_batch,
            max_delay_ms=float(_cfg("max_delay_ms", max_delay_ms)),
            queue_bound=int(_cfg("queue_bound", queue_bound)),
            ladder=ladder,
            admission=admission or _admission_from_config())
        self.request_ttl_s = float(_cfg("request_ttl_s", request_ttl_s))
        self.max_requests = None if max_requests is None \
            else int(max_requests)
        self.warmup = bool(warmup)
        self.codec = wire.Codec(owner="serving")    # router thread only
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = dict.fromkeys(self.COUNTERS, 0)
        self._latencies: List[float] = []
        self.started_at: Optional[float] = None
        #: an object with ``decide_transport(i)`` and ``seed``: the serve
        #: loop's ingress fault hook (TransportLoop.inject_faults)
        self.transport_chaos = None
        self._transport = None
        self._outbound: "queue.Queue" = queue.Queue()
        self._wake_addr = f"inproc://znicz-torch-serve-wake-{id(self)}"
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._serve_error: Optional[BaseException] = None
        #: the exception that ended the compute loop, if one did
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._compute_thread: Optional[threading.Thread] = None
        self._swap_gate = threading.Lock()
        self._swap_thread: Optional[threading.Thread] = None

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    @property
    def bad_frames(self) -> int:
        return self.codec.bad_frames

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "InferenceServer":
        """Start :meth:`serve` on a thread and return once it serves:
        bound, every ladder rung warmed, the compute thread running.  A
        failure on the way (a bind conflict, a bad snapshot, a warmup
        error) raises here with its real cause."""
        self._thread = threading.Thread(target=self.serve, daemon=True,
                                        name="znicz-serve")
        self._thread.start()
        self._ready.wait()
        if self._serve_error is not None:
            raise RuntimeError(
                f"inference server failed on {self.bind}: "
                f"{self._serve_error!r}") from self._serve_error
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until a started server exits (``max_requests`` reached,
        :meth:`stop` called, or a fatal error)."""
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self, timeout: float = 60.0) -> None:
        """Refuse new work, drain what is queued, join the threads."""
        self._stop.set()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("serve thread did not stop within "
                                   f"{timeout}s")
            self._thread = None

    @property
    def draining(self) -> bool:
        """True once stop() (or a fatal error) began winding the service
        down: queued work still drains, new work is refused."""
        return self._stop.is_set()

    def alive(self) -> bool:
        """Liveness: the serve loop has not died on an error and its
        thread (when started) still runs."""
        return self._serve_error is None and (
            self._thread is None or self._thread.is_alive())

    def ready(self) -> bool:
        """Readiness: up, not draining, not mid-rollover."""
        return (self._ready.is_set() and self._serve_error is None
                and not self._stop.is_set() and not self.runner.swapping)

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

    # -- in-process producer ---------------------------------------------------

    def submit(self, req: Request) -> Optional[Refusal]:
        """Queue ``req`` from this process; a refusal is returned AND
        delivered to ``reply_to``."""
        if self.error is not None:
            refusal = Refusal("draining",
                              f"compute loop died: {self.error!r}")
        else:
            refusal = self.batcher.submit(req)
        if refusal is not None:
            self._inc("rejected")
            self._deliver(req, {"ok": False, "req_id": req.req_id,
                                "policy": refusal.policy,
                                "error": str(refusal)})
        return refusal

    def _deliver(self, req: Request, reply: Dict) -> None:
        """Hand ``reply`` to the request's ``reply_to``: a ROUTER
        envelope goes to the router thread's outbound queue (the caller
        pokes it), a Future gets its result, a callable is called."""
        to = req.reply_to
        if to is None:
            return
        if isinstance(to, list):
            self._outbound.put((to, reply))
        elif isinstance(to, Future):
            if not to.done():
                to.set_result(reply)
        else:
            to(reply)

    # -- the ROUTER loop -------------------------------------------------------

    def serve(self) -> None:
        """Blocking serve; a failure (bind conflict, warmup error) is
        recorded for ``start()`` to raise with its real cause, and always
        unblocks a waiting ``start()``."""
        try:
            self._serve()
        except BaseException as exc:
            self._serve_error = exc
            self._inc("serve_errors")
            raise
        finally:
            self._ready.set()

    def _serve(self) -> None:
        from znicz_torch.transport import TransportLoop

        loop = self._transport = TransportLoop(
            "serving", stop=self._stop, instance=self.replica_id)
        if self.transport_chaos is not None:
            loop.inject_faults(self.transport_chaos)
        sock = None
        try:
            sock = loop.bind_router(self.bind)
            self.endpoint = loop.resolved_endpoint(sock)
            # the compute thread pokes this pair when it queues replies,
            # so they ship on the next wake, not after the poll timeout
            wake_r = loop.bind_pull(self._wake_addr)
            if self.warmup:
                # every rung before the first request: cuDNN's choices,
                # kernel builds and allocator growth happen here
                self.runner.warmup(self.batcher.ladder)
            self.started_at = time.perf_counter()
            self._compute_thread = threading.Thread(
                target=self._compute_loop, daemon=True, name="znicz-infer")
            self._compute_thread.start()
            loop.register(sock,
                          lambda frames: self._handle(sock, frames),
                          drain=True)
            loop.register(wake_r, lambda _token: None, drain=True)

            def tick() -> None:
                self._drain_outbound(sock)
                if self.max_requests is not None and self._answered() \
                        >= self.max_requests:
                    loop.stop()

            loop.add_tick(tick)
            self._ready.set()
            loop.run(poll_ms=5)
        finally:
            self._stop.set()
            self.batcher.close()
            if self._compute_thread is not None:
                self._compute_thread.join(timeout=60)
            if sock is not None:
                self._drain_outbound(sock)  # the final replies
            loop.close(linger_ms=self.CLOSE_LINGER_MS)
            self.runner.close()             # a mesh's other ranks stop

    def _answered(self) -> int:
        with self._lock:
            return (self._counts["served"] + self._counts["timed_out"]
                    + self._counts["rejected"])

    def _drain_outbound(self, sock) -> None:
        while True:
            try:
                envelope, rep = self._outbound.get_nowait()
            except queue.Empty:
                break
            # copy=False: result frames are memoryviews of arrays the
            # reply dicts own, never written after the encode
            sock.send_multipart(list(envelope) + self.codec.encode(rep),
                                copy=False)

    def _reply(self, sock, envelope, rep: Dict) -> None:
        rep["replica_id"] = self.replica_id
        sock.send_multipart(list(envelope) + self.codec.encode(rep))

    def _handle(self, sock, frames: List[bytes]) -> None:
        from znicz_torch.parallel import wire

        envelope, payload = wire.split_envelope(frames)
        if not envelope and frames:
            # a bare DEALER whose metadata frame is garbage: no delimiter,
            # no magic; on a ROUTER the first frame is the peer identity,
            # so peel it and the refusal stays routable
            envelope, payload = list(frames[:1]), list(frames[1:])
        try:
            req, _ = self.codec.decode(payload)
            if not isinstance(req, dict):
                raise wire.WireError(
                    f"decodes to {type(req).__name__}, not a request dict")
        except Exception as exc:
            self.log.warning("refused undecodable request (%d frames): %s "
                             "— bad_frames=%d", len(frames), exc,
                             self.codec.bad_frames + 1)
            sock.send_multipart(
                list(envelope)
                + self.codec.refusal(exc, legacy=False,
                                     replica_id=self.replica_id))
            return
        cmd = req.get("cmd")
        rid = req.get("req_id")
        if cmd == "ping":
            self._reply(sock, envelope,
                        {"ok": True, "pong": True, "req_id": rid})
            return
        if cmd == "stats":
            self._reply(sock, envelope,
                        {"ok": True, "stats": self.stats(), "req_id": rid})
            return
        if cmd == "swap":
            path = req.get("path")
            if not isinstance(path, str) or not path:
                self._reply(sock, envelope,
                            {"ok": False, "req_id": rid,
                             "error": "swap needs a snapshot 'path'"})
                return
            try:
                self.swap_async(path)
            except RuntimeError as exc:
                self._reply(sock, envelope,
                            {"ok": False, "req_id": rid, "error": str(exc)})
                return
            self._reply(sock, envelope,
                        {"ok": True, "swap_started": True, "req_id": rid,
                         "generation": self.runner.generation})
            return
        if cmd == "rollback":
            # disk-free and instant: inline on this thread
            try:
                gen = self.runner.rollback()
            except RuntimeError as exc:
                self._reply(sock, envelope,
                            {"ok": False, "req_id": rid, "error": str(exc)})
                return
            self._reply(sock, envelope,
                        {"ok": True, "rolled_back": True, "req_id": rid,
                         "generation": gen})
            return
        if cmd != "infer":
            self._reply(sock, envelope,
                        {"ok": False, "req_id": rid,
                         "error": f"unknown cmd {cmd!r}"})
            return
        x = req.get("x")
        if not isinstance(x, np.ndarray) or x.ndim < 1:
            self._reply(sock, envelope,
                        {"ok": False, "req_id": rid,
                         "error": "infer request carries no tensor 'x'"})
            return
        if x.ndim == len(self.runner.sample_shape):
            x = x[None]                     # a single sample
        if tuple(x.shape[1:]) != self.runner.sample_shape:
            self._reply(sock, envelope,
                        {"ok": False, "req_id": rid,
                         "error": f"sample shape {tuple(x.shape[1:])} != "
                                  f"model input {self.runner.sample_shape}"})
            return
        if not np.can_cast(x.dtype, self.runner.dtype, casting="same_kind"):
            # the assemble cast would wrap or truncate such samples into
            # garbage: refuse them as a wrong shape is refused
            self._reply(sock, envelope,
                        {"ok": False, "req_id": rid,
                         "error": f"sample dtype {x.dtype} cannot safely "
                                  f"cast to the model's storage dtype "
                                  f"{self.runner.dtype}"})
            return
        self._inc("requests_in")
        client = self._client_id(req, envelope)
        # the client's budget becomes a local absolute deadline here
        # (budgets cross the wire, never timestamps: clocks differ),
        # capped by request_ttl_s
        deadline_s = self._deadline_s(req)
        if deadline_s <= 0:
            self._inc("timed_out")
            self._reply(sock, envelope,
                        {"ok": False, "timed_out": True, "req_id": rid,
                         "policy": "deadline",
                         "trace_id": req.get("trace_id"),
                         "error": f"deadline budget "
                                  f"{req.get('deadline_ms')}ms already "
                                  f"expended — refused at ingress"})
            return
        reason = self.batcher.submit(
            Request(x, x.shape[0], reply_to=list(envelope), req_id=rid,
                    trace_id=req.get("trace_id"), client=client,
                    deadline_s=deadline_s))
        if reason is not None:
            self._inc("rejected")
            self._reply(sock, envelope,
                        {"ok": False, "rejected": True, "req_id": rid,
                         "policy": reason.policy, "scope": reason.scope,
                         "trace_id": req.get("trace_id"),
                         "error": str(reason)})

    def _client_id(self, req, envelope) -> str:
        """Admission identity: the ``client`` metadata when the peer
        ships one (the InferenceClient does), else a digest of the ROUTER
        envelope."""
        client = req.get("client")
        if isinstance(client, str) and client:
            return client
        return "peer-%08x" % (zlib.crc32(
            b"".join(bytes(f) for f in envelope)) & 0xFFFFFFFF)

    def _deadline_s(self, req) -> float:
        """The request's relative deadline: the client's ``deadline_ms``
        capped by ``request_ttl_s``.  A non-finite budget is garbage and
        leaves the TTL (a NaN deadline would pass every expiry check)."""
        deadline_s = self.request_ttl_s
        budget_ms = req.get("deadline_ms")
        if budget_ms is not None:
            try:
                budget_s = float(budget_ms) / 1e3
            except (TypeError, ValueError):
                budget_s = float("nan")
            if math.isfinite(budget_s):
                deadline_s = min(budget_s, deadline_s)
        return deadline_s

    # -- the compute thread ----------------------------------------------------

    def _expire(self, r: Request, error: str, expired: bool) -> None:
        """Answer ``r`` timed_out (compute thread)."""
        self._inc("timed_out")
        if expired:
            self._inc("expired_results")
        self._deliver(r, {"ok": False, "timed_out": True,
                          "req_id": r.req_id, "replica_id": self.replica_id,
                          "policy": "deadline", "trace_id": r.trace_id,
                          "error": error})

    def _assemble(self, batch: List[Request]):
        """Coalesced requests -> (live requests, their batch staged for
        the device: their rows in order, zero pad rows up to the ladder
        rung).  Requests past their deadline are answered ``timed_out``
        here, never computed; None when the whole batch expired."""
        now = time.perf_counter()
        live = []
        for r in batch:
            if r.t_deadline is not None and now > r.t_deadline:
                self._expire(r, f"request expired before compute "
                                f"(deadline budget spent queueing; ttl cap "
                                f"{self.request_ttl_s:g}s)", False)
            else:
                live.append(r)
        if not live:
            return None
        rows = sum(r.n for r in live)
        bucket = self.batcher.ladder.bucket_for(rows)
        buf = self.runner.host_buffer(self.runner.bucket_shape(bucket))
        x = buf.numpy()
        off = 0
        for r in live:
            # a copy into the pinned buffer: a request's rows may be a
            # read-only view of its ZMQ frame
            x[off:off + r.n] = np.asarray(r.x, self.runner.dtype).reshape(
                (r.n,) + self.runner.sample_shape)
            off += r.n
        x[off:] = 0
        return live, self.runner.stage(buf)

    def _finish(self, live: List[Request], y_dev, gen: int) -> None:
        y = y_dev.cpu().numpy()             # the sync point
        now = time.perf_counter()
        off = 0
        lat = []
        for r in live:
            if r.t_deadline is not None and now > r.t_deadline:
                # a late result is dropped, never shipped
                self._expire(r, "result ready past the deadline — dropped, "
                                "not shipped", True)
                off += r.n
                continue
            # each reply owns a copy of its rows (its frames go out with
            # copy=False): pad rows stay here
            self._deliver(r, {"ok": True, "req_id": r.req_id,
                              "trace_id": r.trace_id, "gen": gen,
                              "replica_id": self.replica_id,
                              "y": np.array(y[off:off + r.n])})
            lat.append(now - r.t_enqueued)
            off += r.n
        with self._lock:
            self._counts["served"] += len(lat)
            self._latencies.extend(lat)
            del self._latencies[:-self.LATENCY_WINDOW]

    def _fail(self, live: List[Request], exc: BaseException) -> None:
        for r in live:
            self._deliver(r, {"ok": False, "req_id": r.req_id,
                              "replica_id": self.replica_id,
                              "policy": "error", "error": repr(exc)})

    def _compute_loop(self) -> None:
        import zmq

        wake = zmq.Context.instance().socket(zmq.PUSH)
        wake.setsockopt(zmq.LINGER, 0)
        wake.connect(self._wake_addr)

        def poke():
            try:
                wake.send(b"", zmq.NOBLOCK)
            except zmq.Again:           # the router has wakes queued
                pass

        staged = None                    # (live, staged batch) to dispatch
        live: List[Request] = []         # dispatched, unanswered
        try:
            while True:
                if staged is None:
                    batch = self.batcher.next_batch(timeout=0.05)
                    if batch is None:
                        if self._stop.is_set():
                            return
                        continue
                    staged = self._assemble(batch)
                    if staged is None:
                        poke()          # timed_out replies queued
                        continue
                live, x_dev = staged
                staged = None
                y_dev, gen = self.runner.infer_staged(x_dev)
                # while the device computes batch N, stage what is already
                # queued as N+1 (no coalescing window here: it would hold
                # N's finished replies hostage)
                nxt = self.batcher.next_batch(timeout=0.0, wait_fill=False)
                if nxt is not None:
                    staged = self._assemble(nxt)
                self._finish(live, y_dev, gen)
                live = []
                poke()
        except Exception as exc:     # the thread's boundary: record, answer
            self.log.exception("inference compute loop died")
            self.error = exc
            self._stop.set()
            self.batcher.close()
            self._fail(live + (staged[0] if staged else []), exc)
            while True:
                batch = self.batcher.next_batch(timeout=0.0)
                if batch is None:
                    break
                self._fail(batch, exc)
            poke()
        finally:
            wake.close(0)

    # -- stats -----------------------------------------------------------------

    def qps(self) -> Optional[float]:
        served = self.served
        if self.started_at is None or not served:
            return None
        return served / max(time.perf_counter() - self.started_at, 1e-9)

    def latency_quantiles(self) -> Dict[str, Optional[float]]:
        """p50/p99/mean request latency (enqueue -> result on the host),
        ms, over the last ``LATENCY_WINDOW`` requests."""
        with self._lock:
            lat = np.asarray(self._latencies)
        if not lat.size:
            return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
        a = lat * 1e3
        return {"p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "mean_ms": float(np.mean(a))}

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self._counts)
        qps = self.qps()
        out.update(endpoint=self.endpoint, replica_id=self.replica_id,
                   ready=self.ready(), draining=self.draining,
                   generation=self.runner.generation,
                   bad_frames=self.codec.bad_frames,
                   bytes_in=self.codec.bytes_in,
                   bytes_out=self.codec.bytes_out,
                   qps=None if qps is None else round(qps, 2))
        out.update(self.latency_quantiles())
        out.update(self.runner.stats())
        out["batcher"] = self.batcher.stats()
        return out


def _counter_property(name: str):
    def get(self) -> int:
        with self._lock:
            return self._counts[name]

    return property(get, doc=InferenceServer.COUNTERS[name])


for _name in InferenceServer.COUNTERS:
    setattr(InferenceServer, _name, _counter_property(_name))
del _name

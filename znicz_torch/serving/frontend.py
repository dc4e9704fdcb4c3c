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

Generation (``root.common.serving.generate.enabled``)::

    {"cmd": "generate", "x": (len,) token ids, "max_new_tokens",
     "temperature", "top_k", "seed", "stream", "return_logits",
     "return_logprobs", "req_id", "client", "deadline_ms", "trace_id"}
    -> {"ok": True, "partial": True, "token", "i", ...}   (``stream``)
    -> {"ok": True, "tokens": (n,) int32, "gen", "prompt_len",
        "timing_ms", ["truncated"], ["logits"], ["logprobs"], ...}

runs on the continuous-batching ``GenerationScheduler`` over the
runner's paged ``GenerationRunner``, driven by the same compute thread
as scoring: with generation work ready the scoring queue is polled
without a wait, an accepted generation ends an idle wait on it
(``DynamicBatcher.wake``; the reference lets the 50-ms poll run out),
and each round's replies are shipped by the ROUTER thread.  A resend of
an in-flight generation is answered with a heartbeat partial (no
token), so the client's resend timer refreshes.

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

Fleet membership: with ``announce`` (a ``ReplicaBalancer`` endpoint,
``serving/balancer.py``) the ROUTER thread owns one DEALER onto the
balancer and sends :meth:`InferenceServer.heartbeat_payload` on it every
``root.common.serving.balance.heartbeat_s`` (the first beat before the
first poll): readiness, queue depth, generation, snapshot path, capacity
and the per-rung p99 the balancer's dispatch and hedging read.  On a
serving mesh only rank 0 serves, so only rank 0 beats.

The build cache (``root.common.serving.aot_cache.{enabled,dir}``,
``serving/aot_cache.py``) is armed before the warmup: the kernel
libraries come from ``aot_cache/`` next to the snapshot (or ``dir``)
where it holds them, and the warm proof (``ModelRunner.warm_proof``,
kept as ``warm_report``) must hold before the server becomes ready; a
failed proof fails ``start()``.  The heartbeat carries ``warm_source``,
``warm_hits`` and ``warm_misses``.  With generation the warmup also
enters the generation family, and the proof expects
``len(ladder.buckets()) + executables()``.  Exemplars, SLOs and the
heartbeat's fleet trace, event and metric keys come with telemetry
(A.9).

**Variable-length requests** (``root.common.serving.seq.{max_len,
rungs}``; ``max_len`` defaults to the workflow's ``serving_seq_len``,
charlm's trained window).  With a ``max_len`` the ladder is 2-D: a
request ``x`` is ``(n, len, *sample[1:])`` with ``1 <= len <= max_len``
(a bare ``(len,)`` is one row), the batcher coalesces only requests of
one seq rung, ``_assemble`` pads each request on the right with pad id 0
up to the rung, and its reply (the model's output keeps the seq axis)
is cut back to ``(n, len, ...)``.  A ``max_len`` past the trained
length, and non-causal attention (pad keys would take probability mass
from real positions), are refused when the server is built.
"""

from __future__ import annotations

import collections
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
                      GenerationScheduler, GenSeq, Refusal, Request)
from .model import ModelRunner

#: the serving keys the port reads (``root.common.serving.*``), with the
#: reference's defaults; ``core/config.UNPORTED_SERVING_KEYS`` refuses
#: the reference's others
DEFAULTS = {"max_batch": 32, "max_delay_ms": 5.0, "queue_bound": 256,
            "request_ttl_s": 5.0, "max_requests": None,
            "admission": {"enabled": True, "rate_limit": 0.0,
                          "rate_burst": 0.0, "fair": True, "quantum": 0,
                          "client_queue_bound": 0},
            "mesh": {"data": 1, "model": 1},
            # variable-length requests: with max_len > 0 the ladder has
            # a seq axis (powers of two up to max_len, or ``rungs``
            # ending at it); a sequence sample declares its window
            "seq": {"max_len": 0, "rungs": None},
            # generation over a paged KV pool (off by default): the decode
            # budget cap, the page (tokens; the sharing granularity), the
            # pool (0: slots x pages a full context), the prompt tokens a
            # tick prefills a request (0: page_size, which makes prefix
            # hits bit-exact), prefix sharing, in-graph sampling, the
            # concurrency bound, the decode pacing (0: free-running) and
            # the pending queue's bound
            "generate": {"enabled": False, "max_new_tokens": 256,
                         "page_size": 16, "num_pages": 0,
                         "prefill_chunk": 0, "prefix_cache": True,
                         "on_device_sampling": True, "slots": 8,
                         "decode_tick_ms": 0.0, "pending_bound": 64},
            # the build cache (serving/aot_cache.py): kernel libraries
            # kept next to the snapshot (``dir`` overrides the place)
            "aot_cache": {"enabled": False, "dir": ""},
            # the replica fleet (serving/balancer.py reads them through a
            # local alias): heartbeat cadence and TTL'd membership,
            # hedged-retry timing, exactly-once failover budgets, the
            # canary rollover's verdict thresholds and the autoscaler's
            # load band
            "balance": {"heartbeat_s": 0.25, "replica_ttl_s": 1.5,
                        "min_replicas": 1, "hedge": True,
                        "hedge_floor_s": 0.05, "hedge_cap_s": 2.0,
                        "hedge_p99_mult": 1.5,
                        "failover_timeout_s": 1.0, "failover_tries": 3,
                        "park_bound": 256, "canary_fraction": 0.34,
                        "canary_requests": 30, "canary_p99_mult": 3.0,
                        "canary_timeout_s": 30.0, "parity_every": 4,
                        "heal_backoff_s": 30.0,
                        "autoscale": False, "autoscale_max": 8,
                        "autoscale_high_load": 4.0,
                        "autoscale_low_load": 0.5,
                        "autoscale_up_after": 2,
                        "autoscale_down_after": 8,
                        "autoscale_eval_s": 0.5,
                        "autoscale_cooldown_s": 5.0,
                        "autoscale_drain_timeout_s": 10.0,
                        "autoscale_boot_deadline_s": 60.0}}


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
    answering that many requests.  ``announce`` (a balancer endpoint)
    makes the ROUTER thread heartbeat this replica into that fleet;
    ``replica_id`` is the id every reply and heartbeat carries."""

    #: serving counters: name -> meaning
    COUNTERS = {
        "requests_in": "decoded infer requests",
        "served": "answered with a result",
        "timed_out": "answered timed_out (deadline/TTL)",
        "rejected": "answered shed/oversized/rate_limited/draining",
        "expired_results": "computed results dropped: deadline passed "
                           "post-compute",
        "serve_errors": "fatal serve-loop failures surfaced to start()",
        "heartbeats_out": "fleet heartbeats sent to the balancer",
    }

    #: latency samples kept for the quantiles
    LATENCY_WINDOW = 8192

    #: latency samples kept a ladder rung, for the heartbeat's p99s
    BUCKET_WINDOW = 512

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
                 capture: Optional[bool] = None,
                 announce: Optional[str] = None):
        import uuid

        from znicz_torch.parallel import wire

        check_serving_keys()
        self.log = logging.getLogger("znicz_torch.serving")
        self.bind = bind
        #: the balancer endpoint this replica heartbeats into (None: none)
        self.announce = announce
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
        # the seq axis: the config's max_len (an explicit 0 forces
        # fixed-shape serving), else the window the workflow declares
        d_seq = DEFAULTS["seq"]
        sq = root.common.serving.seq
        declared = int(getattr(workflow, "serving_seq_len", 0) or 0)
        seq_max_len = int(sq.get("max_len", declared or d_seq["max_len"])
                          or 0)
        seq_rungs = sq.get("rungs", d_seq["rungs"])
        if ladder is None:
            ladder = BucketLadder(max_batch, dp=dp, max_len=seq_max_len,
                                  seq_rungs=seq_rungs)
        elif dp > 1 and ladder.dp != dp:
            ladder = BucketLadder(ladder.max_batch, ladder.rungs, dp=dp,
                                  max_len=ladder.max_len,
                                  seq_rungs=ladder.seq_rungs)
        #: the longest request (None: fixed-shape requests)
        self.seq_max_len: Optional[int] = ladder.max_len or None
        if self.seq_max_len is not None:
            self._check_seq_model(workflow)
        self.batcher = DynamicBatcher(
            max_batch=max_batch,
            max_delay_ms=float(_cfg("max_delay_ms", max_delay_ms)),
            queue_bound=int(_cfg("queue_bound", queue_bound)),
            ladder=ladder,
            admission=admission or _admission_from_config())
        self.request_ttl_s = float(_cfg("request_ttl_s", request_ttl_s))
        #: the generation plane (None: generation disabled)
        self.gen_sched: Optional[GenerationScheduler] = \
            self._generation_from_config()
        self.max_requests = None if max_requests is None \
            else int(max_requests)
        self.warmup = bool(warmup)
        d_aot = DEFAULTS["aot_cache"]
        aot = root.common.serving.aot_cache
        self._aot_enabled = bool(aot.get("enabled", d_aot["enabled"]))
        self._aot_dir = str(aot.get("dir", d_aot["dir"]) or "")
        #: the boot's warm proof (ModelRunner.warm_proof), recorded once
        #: the warmup finished; in cache mode readiness waits on it
        self.warm_report: Optional[Dict] = None
        self.codec = wire.Codec(owner="serving")    # router thread only
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = dict.fromkeys(self.COUNTERS, 0)
        self._latencies: List[float] = []
        #: per ladder rung, recent enqueue -> compute-done latencies (s)
        self._lat_bucket = {r: collections.deque(maxlen=self.BUCKET_WINDOW)
                            for r in self.batcher.ladder}
        d_bal = DEFAULTS["balance"]
        bal = root.common.serving.balance
        self.heartbeat_s = float(bal.get("heartbeat_s",
                                         d_bal["heartbeat_s"]))
        self.started_at: Optional[float] = None
        #: serve() entry -> ready, warmup included (s)
        self.boot_to_ready_s: Optional[float] = None
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

    def _generation_from_config(self) -> Optional[GenerationScheduler]:
        """``root.common.serving.generate``: a paged ``GenerationRunner``
        (the pool sized for every slot to hold a full context unless
        ``num_pages`` says otherwise, the prefill chunk a page unless
        ``prefill_chunk`` says otherwise) under a
        :class:`GenerationScheduler`; None when disabled."""
        d_gen = DEFAULTS["generate"]
        gn = root.common.serving.generate

        def knob(name):
            return gn.get(name, d_gen[name])

        if not bool(knob("enabled")):
            return None
        if self.seq_max_len is None:
            raise ValueError(
                "generation serving rides the variable-length plane (the "
                "context window IS the seq window) — set root.common."
                "serving.seq.max_len alongside root.common.serving."
                "generate.enabled")
        page_size = int(knob("page_size"))
        slots = int(knob("slots"))
        num_pages = int(knob("num_pages"))
        if num_pages <= 0:
            # every slot can hold a full context: admission and
            # allocation cannot deadlock
            num_pages = slots * (-(-self.seq_max_len // page_size))
        chunk = int(knob("prefill_chunk"))
        if chunk <= 0:
            # chunks aligned with pages: a prefix hit replays the grid a
            # cold prefill runs (bit-exact reuse)
            chunk = page_size
        gr = self.runner.enable_generation(
            page_size=page_size, num_pages=num_pages, slots=slots,
            prefill_chunk=chunk, prefix_cache=bool(knob("prefix_cache")))
        return GenerationScheduler(
            gr, max_new_cap=int(knob("max_new_tokens")),
            pending_bound=int(knob("pending_bound")),
            decode_tick_ms=float(knob("decode_tick_ms")),
            on_device_sampling=bool(knob("on_device_sampling")),
            replica_id=self.replica_id)

    def _check_seq_model(self, workflow) -> None:
        """Refuse a ``max_len`` past the trained length (positions there
        have no embedding) and non-causal attention (pad keys would take
        probability mass from the real positions, so a reply would
        depend on its rung)."""
        from znicz_torch.attention import MultiHeadAttention

        trained = int(self.runner.sample_shape[0]) \
            if self.runner.sample_shape else 0
        if trained and self.seq_max_len > trained:
            raise ValueError(
                f"root.common.serving.seq.max_len={self.seq_max_len} "
                f"exceeds the model's trained sequence length {trained} "
                f"(positions past the trained window have no embedding)")
        non_causal = [f.name for f in workflow.forwards
                      if isinstance(f, MultiHeadAttention) and not f.causal]
        if non_causal:
            raise ValueError(
                f"variable-length serving needs causal attention, but "
                f"unit(s) {non_causal} attend bidirectionally — padded "
                f"tails would leak probability mass into real positions. "
                f"Make the unit causal, or serve fixed-shape "
                f"(root.common.serving.seq.max_len=0)")

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
        if self.gen_sched is not None:
            self.gen_sched.close()
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

        t_boot = time.perf_counter()
        loop = self._transport = TransportLoop(
            "serving", stop=self._stop, instance=self.replica_id)
        if self.transport_chaos is not None:
            loop.inject_faults(self.transport_chaos)
        sock = None
        next_hb = [0.0]
        try:
            sock = loop.bind_router(self.bind)
            self.endpoint = loop.resolved_endpoint(sock)
            # the compute thread pokes this pair when it queues replies,
            # so they ship on the next wake, not after the poll timeout
            wake_r = loop.bind_pull(self._wake_addr)
            # fleet membership: a DEALER onto the balancer, owned by this
            # thread like the codec; its acks are drained and discarded
            hb = loop.connect_dealer(self.announce) if self.announce \
                else None
            if self._aot_enabled:
                # armed before any warm dispatch: the warmup loads the
                # kernel libraries the cache holds and stores the others
                self.runner.enable_aot_cache(self._aot_dir)
            if self.warmup:
                # every rung before the first request: cuDNN's choices,
                # kernel builds and allocator growth happen here
                self.runner.warmup(self.batcher.ladder)
                expected = len(self.batcher.ladder.buckets())
                if self.gen_sched is not None:
                    # the generation family after the ladder
                    self.gen_sched.gen.warmup()
                    expected += self.gen_sched.gen.executables()
                self.warm_report = self.runner.warm_proof(expected)
                if self.runner.aot_enabled and not self.warm_report["ok"]:
                    # lands in _serve_error: ready() stays False and
                    # start() raises the cause
                    raise RuntimeError(
                        f"AOT warmup proof failed — refusing to become "
                        f"ready on a partial family: {self.warm_report}")
            self.started_at = time.perf_counter()
            self._compute_thread = threading.Thread(
                target=self._compute_loop, daemon=True, name="znicz-infer")
            self._compute_thread.start()
            loop.register(sock,
                          lambda frames: self._handle(sock, frames),
                          drain=True)
            loop.register(wake_r, lambda _token: None, drain=True)
            if hb is not None:
                loop.register(hb, lambda _ack: None, drain=True)

            def tick() -> None:
                self._drain_outbound(sock)
                if self.max_requests is not None and self._answered() \
                        >= self.max_requests:
                    loop.stop()
                    return
                now = time.perf_counter()
                if hb is not None and now >= next_hb[0]:
                    next_hb[0] = now + self.heartbeat_s
                    beat = self.codec.encode(self.heartbeat_payload())
                    hb.send_multipart([b""] + beat, copy=False)
                    self._inc("heartbeats_out")

            loop.add_tick(tick)
            self.boot_to_ready_s = time.perf_counter() - t_boot
            self._ready.set()
            tick()                      # the first heartbeat, pre-poll
            loop.run(poll_ms=5)
        finally:
            self._stop.set()
            self.batcher.close()
            if self.gen_sched is not None:
                self.gen_sched.close()
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
        if cmd == "generate":
            self._handle_generate(sock, envelope, req, rid)
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
        seq_len = None
        if self.seq_max_len is not None:
            # axis 1 is the request's own length (1..max_len: a longer
            # one gets the batcher's oversized refusal)
            if x.ndim != 1 + len(self.runner.sample_shape) or \
                    tuple(x.shape[2:]) != self.runner.sample_shape[1:]:
                self._reply(sock, envelope, {
                    "ok": False, "req_id": rid,
                    "error": f"sequence request shape {x.shape} does not "
                             f"match (n, len<= {self.seq_max_len}, "
                             f"*{self.runner.sample_shape[1:]})"})
                return
            seq_len = int(x.shape[1])
        elif tuple(x.shape[1:]) != self.runner.sample_shape:
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
                    deadline_s=deadline_s, solo=bool(req.get("solo")),
                    seq_len=seq_len))
        if reason is not None:
            self._inc("rejected")
            self._reply(sock, envelope,
                        {"ok": False, "rejected": True, "req_id": rid,
                         "policy": reason.policy, "scope": reason.scope,
                         "trace_id": req.get("trace_id"),
                         "error": str(reason)})

    def _handle_generate(self, sock, envelope, req, rid) -> None:
        """The ``generate`` request kind: a 1-D token prompt in,
        ``max_new_tokens`` tokens out, streamed a token at a time
        (``stream``) or whole; queued on the scheduler, answered from the
        compute loop."""
        if self.gen_sched is None:
            self._reply(sock, envelope, {
                "ok": False, "req_id": rid,
                "error": "generation serving is disabled — start the "
                         "service with root.common.serving.generate."
                         "enabled=True"})
            return
        x = req.get("x")
        if not isinstance(x, np.ndarray) or x.ndim != 1 or x.size < 1 \
                or not np.issubdtype(x.dtype, np.number):
            self._reply(sock, envelope, {
                "ok": False, "req_id": rid,
                "error": "generate request needs a non-empty 1-D numeric "
                         "token prompt 'x'"})
            return
        self._inc("requests_in")
        deadline_s = self._deadline_s(req)
        if deadline_s <= 0:
            self._inc("timed_out")
            self._reply(sock, envelope, {
                "ok": False, "timed_out": True, "req_id": rid,
                "policy": "deadline", "trace_id": req.get("trace_id"),
                "error": f"deadline budget {req.get('deadline_ms')}ms "
                         f"already expended — refused at ingress"})
            return
        client = self._client_id(req, envelope)
        dup = rid is not None and self.gen_sched.in_flight(client, rid)
        try:
            seq = GenSeq(
                x, max_new=int(req.get("max_new_tokens", 0) or 0),
                temperature=float(req.get("temperature", 0.0) or 0.0),
                top_k=int(req.get("top_k", 0) or 0),
                seed=req.get("seed"),
                stream=bool(req.get("stream", False)),
                return_logits=bool(req.get("return_logits", False)),
                return_logprobs=bool(req.get("return_logprobs", False)),
                reply_to=list(envelope), req_id=rid,
                trace_id=req.get("trace_id"), client=client,
                deadline_s=deadline_s)
        except (TypeError, ValueError) as exc:
            self._reply(sock, envelope, {
                "ok": False, "req_id": rid,
                "error": f"bad generate parameters: {exc}"})
            return
        reason = self.gen_sched.submit(seq)
        if reason is None and not dup:
            # an idle compute loop waits on the scoring queue: end the wait
            # so the generation is admitted now, not at the poll's end
            self.batcher.wake()
        if reason is None and dup:
            # a resend of an in-flight generation: a heartbeat partial
            # refreshes the client's resend timer (a generation outlives
            # the resend window routinely)
            self._reply(sock, envelope, {
                "ok": True, "partial": True, "heartbeat": True,
                "req_id": rid, "trace_id": req.get("trace_id")})
            return
        if reason is not None:
            self._inc("rejected")
            self._reply(sock, envelope, {
                "ok": False, "rejected": True, "req_id": rid,
                "policy": reason.policy, "scope": reason.scope,
                "trace_id": req.get("trace_id"), "error": str(reason)})
        # accepted: the tokens come from the compute loop's rounds

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
        rung; on a 2-D ladder each row padded on the right with pad id 0
        up to the batch's seq rung).  Requests past their deadline are
        answered ``timed_out`` here, never computed; None when the whole
        batch expired."""
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
        seq = live[0].seq_rung
        buf = self.runner.host_buffer(self.runner.bucket_shape(
            bucket if seq is None else (bucket, seq)))
        x = buf.numpy()
        tail = self.runner.sample_shape[1:]
        off = 0
        for r in live:
            # a copy into the pinned buffer: a request's rows may be a
            # read-only view of its ZMQ frame
            rx = np.asarray(r.x, self.runner.dtype)
            if seq is None:
                x[off:off + r.n] = rx.reshape((r.n,)
                                              + self.runner.sample_shape)
            else:
                x[off:off + r.n, :r.seq_len] = rx.reshape(
                    (r.n, r.seq_len) + tail)
                x[off:off + r.n, r.seq_len:] = 0
            off += r.n
        x[off:] = 0
        return live, self.runner.stage(buf)

    def _finish(self, live: List[Request], y_dev, gen: int) -> None:
        y = y_dev.cpu().numpy()             # the sync point
        now = time.perf_counter()
        # the batch's ladder rung: its ring feeds the heartbeat's p99s
        ring = self._lat_bucket[self.batcher.ladder.bucket_for(
            sum(r.n for r in live))]
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
            # copy=False): pad rows stay here, and pad tokens too
            yr = y[off:off + r.n]
            if r.seq_rung is not None:
                yr = yr[:, :r.seq_len]
            self._deliver(r, {"ok": True, "req_id": r.req_id,
                              "trace_id": r.trace_id, "gen": gen,
                              "replica_id": self.replica_id,
                              "y": np.array(yr)})
            lat.append(now - r.t_enqueued)
            off += r.n
        with self._lock:
            ring.extend(now - r.t_enqueued for r in live)
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

        gs = self.gen_sched

        def gen_step() -> bool:
            # one continuous-batching round; its replies go to the router
            worked, replies = gs.step()
            self._ship_gen(replies, poke)
            return worked or bool(replies)

        staged = None                    # (live, staged batch) to dispatch
        live: List[Request] = []         # dispatched, unanswered
        try:
            while True:
                if staged is None:
                    # with generation work ready the scoring queue gets a
                    # zero-wait poll: the decode cadence does not wait out
                    # the coalescing window
                    timeout = 0.0 if (gs is not None
                                      and gs.work_ready()) else 0.05
                    batch = self.batcher.next_batch(timeout=timeout)
                    if batch is None:
                        if self._stop.is_set():
                            if gs is not None:
                                self._ship_gen(gs.drain(), poke)
                            return
                        if gs is not None and not gen_step() \
                                and timeout == 0.0:
                            # ready but stalled: do not spin on the pool
                            time.sleep(0.001)
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
                if gs is not None and gs.work_ready():
                    gen_step()          # interleaved under mixed traffic
        except Exception as exc:     # the thread's boundary: record, answer
            self.log.exception("inference compute loop died")
            self.error = exc
            self._stop.set()
            self.batcher.close()
            if gs is not None:
                self._ship_gen(gs.fail(exc))
            self._fail(live + (staged[0] if staged else []), exc)
            while True:
                batch = self.batcher.next_batch(timeout=0.0)
                if batch is None:
                    break
                self._fail(batch, exc)
            poke()
        finally:
            wake.close(0)

    def _ship_gen(self, replies, poke=None) -> None:
        """Queue generation replies for the router thread.  Finals count
        into ``served`` / ``timed_out`` / ``rejected`` (so toward
        ``max_requests``); streamed partials are progress, not answers."""
        for env, rep in replies:
            if env is None:
                continue
            if not rep.get("partial"):
                if rep.get("ok"):
                    self._inc("served")
                elif rep.get("timed_out"):
                    self._inc("timed_out")
                else:
                    self._inc("rejected")
            self._outbound.put((env, rep))
        if replies and poke is not None:
            poke()

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

    def p99_ms_by_bucket(self) -> Dict[int, float]:
        """``{ladder rung: p99 ms}`` over each rung's recent window (the
        per-rung latency the heartbeat carries)."""
        with self._lock:
            rings = {r: np.asarray(ring) for r, ring in
                     self._lat_bucket.items() if ring}
        return {r: round(float(np.percentile(w, 99)) * 1e3, 3)
                for r, w in rings.items()}

    def heartbeat_payload(self) -> Dict:
        """One fleet heartbeat: the replica's identity and endpoint, its
        readiness, queue depth, generation and snapshot path, its capacity
        (``device_count``: dp x mp on a serving mesh, else 1) and per-rung
        p99, and where its kernel libraries came from
        (``ModelRunner.warm_source`` and the cache's hits and misses).
        The reference's fleet-observability keys (``origin``, ``spans``, ``events``,
        ``metrics``) are not sent: a balancer ignores keys a beat lacks."""
        mesh = self.runner.mesh_shape
        return {"cmd": "heartbeat",
                "replica_id": self.replica_id,
                "endpoint": self.endpoint,
                "ready": self.ready(),
                "draining": self.draining,
                "swapping": self.runner.swapping,
                "gen": self.runner.generation,
                "snapshot_path": self.runner.snapshot_path,
                "queue_depth": self.batcher.queue_depth,
                "served": self.served,
                "device_count": (int(np.prod(list(mesh.values())))
                                 if mesh else 1),
                "mesh": mesh,
                "warm_source": self.runner.warm_source,
                "warm_hits": int(self.runner._warm["hits"]),
                "warm_misses": int(self.runner._warm["misses"]),
                "boot_s": self.boot_to_ready_s,
                "p99_ms_by_bucket": self.p99_ms_by_bucket()}

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
        out.update(p99_ms_by_bucket=self.p99_ms_by_bucket(),
                   announce=self.announce,
                   boot_to_ready_s=self.boot_to_ready_s)
        out.update(self.runner.stats())
        out["warm_report"] = self.warm_report
        out["batcher"] = self.batcher.stats()
        if self.gen_sched is not None:
            out["generate"] = self.gen_sched.stats()
        return out


def _counter_property(name: str):
    def get(self) -> int:
        with self._lock:
            return self._counts[name]

    return property(get, doc=InferenceServer.COUNTERS[name])


for _name in InferenceServer.COUNTERS:
    setattr(InferenceServer, _name, _counter_property(_name))
del _name

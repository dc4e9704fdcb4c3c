"""Replica balancer (port of ``znicz_tpu/serving/balancer.py``): fleet
serving over N ``InferenceServer`` replicas.

One ROUTER front socket faces both planes:

  - **clients** (``InferenceClient`` DEALERs) send the same wire-v3
    requests they would send a single replica: to them the balancer is
    an ``InferenceServer``;
  - **replicas** heartbeat into it (``--serve ... --announce`` /
    ``InferenceServer(announce=...)``) with their readiness, queue depth,
    generation, snapshot path and per-rung p99 on every beat.  Membership
    is TTL'd: a replica that stops beating is evicted and its in-flight
    requests fail over at once.

Per live replica the balancer holds one DEALER onto the replica's own
ROUTER bind (the data plane).  Requests are **peeked, never decoded**:
:func:`wire.peek_message` reads the metadata skeleton without touching a
tensor byte, the client's ``req_id`` is rewritten to a balancer-unique id
(two clients may both be on request 1), and the same frames are
forwarded: the balancer moves buffers, never arrays.

**Exactly-once failover**: every accepted request lives in a ledger entry
that carries its rewritten frames.  A replica that dies, flaps or sits on
a request past ``failover_timeout_s`` gets the entry re-dispatched (the
same bytes) to a healthy replica; late duplicate replies are dropped by
the ledger (the first reply wins), so the client sees one answer or one
readable refusal (``policy: failover`` once ``failover_tries`` is spent,
``deadline`` once its budget is), never two and never silence.  The
ledger balances by construction: ``accepted == replied + refused +
in_flight``.

**Hedged retries**: after a hedge delay derived from the balancer's own
reply p99 (``max(hedge_floor_s, hedge_p99_mult * p99)`` capped at
``hedge_cap_s``), a still-unanswered request is raced on a second
replica; the first reply wins and the loser is deduped.  ``hedges`` and
``hedge_wins`` count the races and how often the hedge paid.

**Canary rollover**: one ``swap`` command drives the whole fleet through
a canary -> full wave, keyed on snapshot paths (the invariant healing
keeps), never on predicted generation numbers, which drift across
rollback-retry and restart-heal cycles.  Canaries warm off-rotation (the
swap sent, the path flip confirmed by heartbeats, every phase bounded by
``canary_timeout_s``), then serve a fixed share of traffic while the
balancer compares their p99 with the old generation's and, unless the
swap was sent with ``parity: false``, probes reply parity: every
``parity_every``-th old-generation dispatch is duplicated to a canary and
the tensor frames compared bit for bit.  A p99 or parity regression, or a
starved canary, rolls the wave back: canaries serve their kept previous
generation again (``rollback``: instant, no disk read, the generation
stamp restored), and the losing generation's p99, parity and counts are
kept in ``rollover_history``.  A clean canary promotes the rest of the
fleet one replica at a time, each warmed off-rotation, so the fleet never
dips below quorum mid-wave.  A replica that restarts with its boot
snapshot is **healed**: its heartbeat's ``snapshot_path`` is off the
fleet's path, so the balancer swaps it back off-rotation.

**Autoscaler** (:meth:`ReplicaBalancer.enable_autoscale`): spawn and
drain-then-retire against a capacity-weighted load band with hysteresis,
never below ``min_replicas`` nor past ``autoscale_max``.

**Fleet observability**: the balancer is the serving fleet's
coordinator.  Its counters are the ``balancer`` scope's registry counters
(with the ``ready_replicas`` and ``in_flight`` gauges), its state
transitions journal events (``replica_joined``, ``replica_lost``,
``failover``, ``heal``, ``autoscale_up``/``_down``, ``swap_begin``,
``swap_phase``, ``swap_done``, ``rollback``), and it names itself
``balancer`` in the fleet.  A heartbeat's ``spans``, ``events`` and
``metrics`` go into the process's fleet trace, event and metric stores
(``/trace.json?fleet=1``, ``/events.json?fleet=1``, the merged
``/metrics``), a reply's span summary into the trace store, and the
balancer's own spans and events join them every 0.25 s.  Each answered
request is a ``balancer/request`` span carrying its ``trace_id``, the
replicas it was sent to, the replica and generation that answered, its
parity probe and whether it was served solo.

Deliberate differences from the reference:

  - a parity-sampled primary and its probe carry ``"solo": true``: each
    replica serves such a request alone, at the smallest ladder rung
    that holds its rows (``DynamicBatcher.next_batch``), so the two
    halves compared bit for bit ride the same rung.  The reference
    co-batches the primary; on the card cuDNN and cuBLAS choose kernels
    by batch size, and rows served at two rungs differ in their last
    bits (ROADMAP C.9);
  - a replica's service-scoped ``draining`` refusal (it was stopped
    between the dispatch and the request's arrival) is retried on another
    replica, as a service-scoped shed is, and counted in
    ``sheds_retried``; the reference forwards it to the client, so a
    replica stopped under traffic could refuse a request the fleet could
    answer (ROADMAP C.10);
  - the ``request`` span also names every replica the request went to,
    the answering generation, its probe and its solo mark: what a
    stitched trace of one reply must say.

Config home: ``root.common.serving.balance.*`` (declared in the serving
DEFAULTS, read through a local alias); CLI: ``python -m znicz_torch
--balance [BIND] --replicas ep1,ep2,...`` (README "Replica fleet").
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from znicz_torch import telemetry
from znicz_torch.core.config import check_serving_keys, root
from znicz_torch.telemetry.metrics import registered_property

from .frontend import DEFAULTS


class _Entry:
    """One ledger entry: an accepted request's rewritten frames and its
    dispatch history, everything exactly-once needs."""

    __slots__ = ("rid", "client_rid", "envelope", "frames", "t_accept",
                 "deadline", "t_sent", "targets", "tries", "hedged",
                 "hedge_target", "held", "probe_rid", "kind",
                 "primary_rid", "trace_id", "solo")

    def __init__(self, rid: int, client_rid, envelope, frames,
                 deadline: float, kind: str = "infer", trace_id=None):
        self.rid = rid
        self.client_rid = client_rid
        self.envelope = envelope
        self.frames = frames
        self.t_accept = time.perf_counter()
        self.deadline = deadline            # absolute, local clock
        self.t_sent: Optional[float] = None
        self.targets: List[str] = []        # replica_ids, dispatch order
        self.tries = 0
        self.hedged = False
        self.hedge_target: Optional[str] = None
        #: replicas whose dispatch-count reservation this entry holds,
        #: released exactly once each (a failover releases its old
        #: target; retirement must not release it again)
        self.held: set = set()
        self.probe_rid: Optional[int] = None    # parity probe spawned
        self.primary_rid: Optional[int] = None  # set on probe entries
        self.kind = kind                    # "infer" | "probe"
        #: the client's correlation id (peeked at accept): the key of the
        #: request's stitched fleet trace
        self.trace_id = trace_id
        self.solo = False                   # marked for a parity probe


def _cfg_balance() -> Dict:
    """The resolved ``root.common.serving.balance.*`` knob set."""
    d = DEFAULTS["balance"]
    bal = root.common.serving.balance
    return {k: type(d[k])(bal.get(k, d[k])) if not isinstance(d[k], bool)
            else bool(bal.get(k, d[k])) for k in d}


class ReplicaBalancer:
    """Health-checked least-loaded balancer over N replica processes.

    ``bind`` may use a wildcard port; the resolved address is in
    ``endpoint`` once serving starts.  ``replicas`` (optional) is the
    static endpoint list to pre-connect data sockets to; membership
    always comes from heartbeats, so a replica not on the list joins the
    moment it announces.  Drive with ``start()``/``stop()``;
    ``max_requests`` ends the loop after that many answered requests.
    ``knobs`` override ``root.common.serving.balance.*`` by name."""

    #: balancer counters: name -> meaning
    COUNTERS = {
        "accepted": "infer requests accepted into the ledger",
        "replied": "ok replies forwarded to clients",
        "refused": "refusals forwarded/issued to clients",
        "failovers": "in-flight requests re-dispatched (same bytes) "
                     "after a replica died/flapped/timed out",
        "hedges": "hedged second dispatches raced",
        "hedge_wins": "races the hedge replica answered first",
        "dup_replies_dropped": "late duplicate replies deduped by the "
                               "ledger",
        "sheds_retried": "service-scoped replica sheds retried on "
                         "another replica",
        "heartbeats": "replica heartbeats received",
        "replicas_lost": "TTL membership evictions",
        "rollovers": "canary waves promoted fleet-wide",
        "rollbacks": "canary waves auto-rolled-back on regression",
        "heals": "restarted replicas re-swapped onto the fleet path",
        "parity_checks": "shadow parity probes compared",
        "parity_mismatches": "probes whose tensor frames differed",
        "replica_bad_frames": "replica-side bad-frame refusals "
                              "(unattributable; failover timer recovers)",
        "scale_ups": "autoscaler spawn actions issued",
        "scale_downs": "autoscaler drain-then-retire actions completed",
        "scale_drain_timeouts": "retiring replicas whose drain exceeded "
                                "autoscale_drain_timeout_s (retired "
                                "anyway; in-flight work fails over)",
    }

    def __init__(self, bind: str = "tcp://127.0.0.1:*",
                 replicas: Tuple[str, ...] = (),
                 min_replicas: Optional[int] = None,
                 max_requests: Optional[int] = None, **knobs):
        from znicz_torch.parallel import wire

        check_serving_keys()
        self.bind = bind
        self.endpoint: Optional[str] = None
        self.static_replicas = tuple(replicas)
        self.max_requests = max_requests
        self.knobs = _cfg_balance()
        unknown = sorted(set(knobs) - set(self.knobs))
        if unknown:
            raise TypeError(f"unknown balance knobs {unknown}")
        self.knobs.update(knobs)
        if min_replicas is not None:
            self.knobs["min_replicas"] = int(min_replicas)
        self.codec = wire.Codec(owner="balancer")   # serve-thread only
        _sc = telemetry.scope("balancer")
        self._m = {name: _sc.counter(name, help)
                   for name, help in self.COUNTERS.items()}
        _sc.gauge("ready_replicas", "heartbeat-live, ready members",
                  fn=telemetry.weak_fn(self, lambda b: b.ready_count()))
        _sc.gauge("in_flight", "ledger entries awaiting a reply",
                  fn=telemetry.weak_fn(self, lambda b: b.in_flight))
        # the fleet coordinator: heartbeats and replies carry the fleet's
        # spans, events and metric snapshots into the process's stores
        self._tracer = telemetry.tracer()
        telemetry.set_identity("balancer")
        self._t_obs_drain = 0.0         # the self-ingest's rate limit (s)
        # state below is serve-thread-written and stats()-read: every
        # mutation happens under _lock (reentrant: helpers lock their own
        # bodies and are also called under the serve loop's hold)
        self._lock = threading.RLock()
        #: replica_id -> heartbeat view (endpoint, last_seen, ready, gen,
        #: queue_depth, p99_ms_by_bucket, swapping, snapshot_path, ...)
        self._members: Dict[str, Dict] = {}
        self._inflight: Dict[int, _Entry] = {}      # infer ledger
        self._probes: Dict[int, _Entry] = {}        # parity probes
        self._ctrl: Dict[int, Dict] = {}            # swap/rollback cmds
        self._dispatch_counts: Dict[str, int] = {}  # per-replica in flight
        self._parked: List[_Entry] = []     # accepted, no ready replica
        self._lat: List[float] = []         # recent reply latencies (s)
        self._rollover: Optional[Dict] = None
        self.rollover_history: List[Dict] = []
        self._fleet_path: Optional[str] = None      # last promoted path
        self._healing: Dict[str, float] = {}        # replica -> t sent
        self._parity_buf: Dict[int, Dict] = {}      # probe_rid -> frames
        # the autoscaler (armed by enable_autoscale), serve-thread-mutated
        # under _lock like the membership state above
        self._scaler: Optional[Dict] = None     # {"spawn", "retire"}
        #: replica_id -> drain start: retired after in-flight drains
        self._retiring: Dict[str, float] = {}
        #: spawn timestamps awaiting a new member's announcement
        self._scale_pending: List[float] = []
        self._scale_known: set = set()      # member ids already seen
        self._scale_streak = {"high": 0, "low": 0}
        self._scale_last = {"action": 0.0, "eval": 0.0}
        self._rid = 0
        self._rr = 0                        # least-loaded tie-breaker
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._serve_error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.started_at: Optional[float] = None
        #: an object with ``decide_transport(i)`` and ``seed``: the serve
        #: loop's ingress fault hook (TransportLoop.inject_faults)
        self.transport_chaos = None
        self._transport = None
        self.log = logging.getLogger("znicz_torch.balancer")

    def _inc(self, name: str) -> None:
        self._m[name].inc()

    # -- membership views ----------------------------------------------------

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._inflight) + len(self._parked)

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for m in self._members.values() if m["ready"])

    def member_count(self) -> int:
        with self._lock:
            return len(self._members)

    @property
    def min_replicas(self) -> int:
        return int(self.knobs["min_replicas"])

    def degraded(self) -> bool:
        """True below the ``min_replicas`` quorum."""
        return self.ready_count() < self.min_replicas

    def ledger(self) -> Dict[str, int]:
        """The no-silent-loss invariant, one dict: ``accepted == replied +
        refused + in_flight`` at every instant (parity probes and control
        commands are tracked apart and never enter it)."""
        with self._lock:
            in_flight = len(self._inflight) + len(self._parked)
            accepted = self.accepted
            replied = self.replied
            refused = self.refused
        return {"accepted": accepted, "replied": replied,
                "refused": refused, "in_flight": in_flight,
                "balanced": accepted == replied + refused + in_flight}

    def stats(self) -> Dict:
        now = time.perf_counter()
        with self._lock:
            members = [
                {"replica_id": rid,
                 "endpoint": m["endpoint"],
                 "ready": m["ready"],
                 "gen": m["gen"],
                 "queue_depth": m["queue_depth"],
                 "in_flight": self._dispatch_counts.get(rid, 0),
                 "last_heartbeat_s": round(now - m["last_seen"], 3),
                 "swapping": m["swapping"],
                 "snapshot_path": m["snapshot_path"],
                 "in_rotation": rid not in self._rotation_out(),
                 "device_count": m.get("device_count", 1),
                 "mesh": m.get("mesh"),
                 "warm_source": m.get("warm_source"),
                 "warm_hits": m.get("warm_hits", 0),
                 "warm_misses": m.get("warm_misses", 0),
                 "boot_s": m.get("boot_s"),
                 "retiring": rid in self._retiring,
                 "healing": rid in self._healing,
                 "p99_ms_by_bucket": dict(m["p99_ms_by_bucket"])}
                for rid, m in sorted(self._members.items())]
            autoscale = {"enabled": self._scaler is not None
                         and bool(self.knobs["autoscale"]),
                         "max": int(self.knobs["autoscale_max"]),
                         "pending_spawns": len(self._scale_pending),
                         "retiring": sorted(self._retiring),
                         "servable": len(self._servable_ids())}
            roll = None
            if self._rollover is not None:
                r = self._rollover
                roll = {"phase": r["phase"], "path": r["path"],
                        "canary": list(r["canary"]),
                        "old_gen": r["old_gen"], "new_gen": r["new_gen"],
                        "parity": r["parity"],
                        "parity_mismatches": r["mismatches"],
                        "canary_samples": len(r["lat_new"]),
                        "old_samples": len(r["lat_old"])}
            history = list(self.rollover_history)
            counts = {name: m.value for name, m in self._m.items()}
            hedge_ms = round(self._hedge_delay() * 1e3, 2)
        ready = sum(1 for m in members if m["ready"])
        out = {"endpoint": self.endpoint,
               "replicas": members,
               "ready_replicas": ready,
               "total_replicas": len(members),
               "min_replicas": self.min_replicas,
               "degraded": ready < self.min_replicas,
               "static_replicas": list(self.static_replicas),
               "fleet_path": self._fleet_path,
               "autoscale": autoscale,
               "rollover": roll,
               "rollover_history": history,
               "hedge_delay_ms": hedge_ms,
               "ledger": self.ledger(),
               "bad_frames": self.codec.bad_frames}
        out.update(counts)
        return out

    def _rotation_out(self) -> set:
        """Replica_ids held out of dispatch (warming during a rollover
        wave).  Lock held by callers."""
        if self._rollover is None:
            return set()
        return set(self._rollover["warming"])

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaBalancer":
        self._thread = threading.Thread(target=self.serve, daemon=True,
                                        name="znicz-balancer")
        self._thread.start()
        if not self._ready.wait(timeout=60):
            raise RuntimeError(
                f"balancer failed to come up on {self.bind} within 60s")
        if self._serve_error is not None:
            raise RuntimeError(
                f"balancer failed on {self.bind}: "
                f"{self._serve_error!r}") from self._serve_error
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def alive(self) -> bool:
        return self._serve_error is None and (
            self._thread is None or self._thread.is_alive())

    def serve(self) -> None:
        try:
            self._serve()
        except BaseException as exc:
            with self._lock:
                self._serve_error = exc
            raise
        finally:
            self._ready.set()

    # -- the serve loop ------------------------------------------------------

    def _serve(self) -> None:
        from znicz_torch.transport import TransportLoop

        loop = self._transport = TransportLoop(
            "balancer", stop=self._stop, instance=self.bind)
        if self.transport_chaos is not None:
            loop.inject_faults(self.transport_chaos)
        #: endpoint -> data DEALER (serve-thread-owned, like the codec;
        #: reply routing rides each socket's registered closure)
        data: Dict[str, object] = {}
        try:
            front = loop.bind_router(self.bind)
            self.endpoint = loop.resolved_endpoint(front)
            self.started_at = time.perf_counter()

            def data_sock(endpoint: str):
                sock = data.get(endpoint)
                if sock is None:
                    sock = loop.connect_dealer(endpoint)
                    data[endpoint] = sock
                    # replica replies drain before new client requests
                    # (priority 0 < the front's 10): a reply frees its
                    # ledger slot, so dispatch weighs current loads
                    loop.register(
                        sock,
                        lambda frames, _ep=endpoint:
                        self._handle_replica(_ep, frames),
                        drain=True, priority=0)
                return sock

            def drop_unused_data_socks(live_endpoints) -> None:
                # endpoint churn (a wildcard-bind replica gets a fresh
                # port a restart): a socket no member references would
                # otherwise leak an fd and a poller registration
                for ep in [ep for ep in data
                           if ep not in live_endpoints
                           and ep not in self.static_replicas]:
                    loop.unregister(data.pop(ep))   # also closes it

            for ep in self.static_replicas:
                data_sock(ep)
            self._data_sock = data_sock     # serve-thread closures for
            self._front = front             # the helpers below
            self._drop_unused_data_socks = drop_unused_data_socks
            loop.register(front, self._handle_front, drain=True,
                          priority=10)

            def tick() -> None:
                with self._lock:
                    answered = self.replied + self.refused
                if self.max_requests is not None and \
                        answered >= self.max_requests:
                    loop.stop()
                    return
                with self._lock:
                    self._tick_membership()
                    self._tick_inflight()
                    self._tick_rollover()
                # outside the hold above: the autoscaler decides under the
                # lock but runs spawn/retire callbacks unlocked (a process
                # spawn may block for seconds; the ledger keeps ticking)
                self._tick_autoscale()
                # the fleet self-ingest: the balancer's own spans and
                # events join the stores it coordinates (rate-limited;
                # the stores lock internally)
                t = time.perf_counter()
                if t - self._t_obs_drain > 0.25:
                    self._t_obs_drain = t
                    telemetry.drain_own_spans()
                    telemetry.drain_own_events()

            loop.add_tick(tick)
            self._ready.set()
            loop.run(poll_ms=5)
        finally:
            self._stop.set()
            loop.close()

    # -- front plane: clients and heartbeats ---------------------------------

    def _send_front(self, envelope: List[bytes], frames: List) -> None:
        self._front.send_multipart(list(envelope) + list(frames),
                                   copy=False)

    def _refuse_client(self, entry: _Entry, policy: str,
                       error: str) -> None:
        """The one readable refusal an accepted request may end in (lock
        held)."""
        self._inc("refused")
        if entry.probe_rid is not None:
            # the shadow probe's buffered reply dies with the primary: a
            # refused request proves no parity either way
            self._parity_buf.pop(entry.probe_rid, None)
        self._send_front(entry.envelope, self.codec.encode(
            {"ok": False, "req_id": entry.client_rid, "lb": True,
             "policy": policy, "scope": "service",
             "timed_out": policy == "deadline", "error": error}))

    def _handle_front(self, frames: List[bytes]) -> None:
        from znicz_torch.parallel import wire

        envelope, payload = wire.split_envelope(frames)
        if not envelope and frames:
            envelope, payload = list(frames[:1]), list(frames[1:])
        try:
            skel = wire.peek_message(payload)
        except wire.WireError as exc:
            self.log.warning("refused undecodable front message: %s", exc)
            self._send_front(envelope, self.codec.refusal(
                exc, legacy=False, lb=True))
            return
        self.codec.count_message_in(payload)
        cmd = skel.get("cmd")
        rid = skel.get("req_id")
        if cmd == "heartbeat":
            self._handle_heartbeat(skel)
            self._send_front(envelope, self.codec.encode(
                {"ok": True, "hb": True}))
            return
        if cmd == "ping":
            self._send_front(envelope, self.codec.encode(
                {"ok": True, "pong": True, "req_id": rid, "lb": True}))
            return
        if cmd == "stats":
            self._send_front(envelope, self.codec.encode(
                {"ok": True, "stats": self.stats(), "req_id": rid,
                 "lb": True}))
            return
        if cmd == "swap":
            self._handle_swap(envelope, skel)
            return
        if cmd not in ("infer", "generate"):
            self._send_front(envelope, self.codec.encode(
                {"ok": False, "req_id": rid, "lb": True,
                 "error": f"unknown cmd {cmd!r}"}))
            return
        if cmd == "generate" and skel.get("stream"):
            # the ledger is first-reply-wins: a streamed generation's
            # partials would retire the entry on token 1 and drop the rest
            self._send_front(envelope, self.codec.encode(
                {"ok": False, "req_id": rid, "lb": True,
                 "error": "balancer cannot relay streamed generation "
                          "(first-reply-wins ledger needs ONE final "
                          "reply) — set stream=False or connect to a "
                          "replica directly"}))
            return
        # -- accept one request into the ledger
        deadline_s = float(self.knobs["failover_tries"]) \
            * float(self.knobs["failover_timeout_s"])
        budget_ms = skel.get("deadline_ms")
        if budget_ms is not None:
            try:
                budget_s = float(budget_ms) / 1e3
            except (TypeError, ValueError):
                budget_s = float("nan")
            if np.isfinite(budget_s) and budget_s > 0:
                deadline_s = budget_s
        with self._lock:
            self._rid += 1
            lb_rid = self._rid
            rewritten = wire.restamp_message(payload, req_id=lb_rid)
            tid = skel.get("trace_id")
            entry = _Entry(lb_rid, rid, list(envelope), rewritten,
                           time.perf_counter() + deadline_s,
                           trace_id=None if tid is None else str(tid))
            self._inc("accepted")
            if not self._dispatch(entry):
                if len(self._parked) >= int(self.knobs["park_bound"]):
                    self._refuse_client(
                        entry, "shed",
                        f"no ready replica and the park queue is at "
                        f"its bound ({self.knobs['park_bound']}) — shed")
                    return
                self._parked.append(entry)

    def _handle_heartbeat(self, skel: Dict) -> None:
        self._inc("heartbeats")
        replica_id = str(skel.get("replica_id") or "")
        endpoint = skel.get("endpoint")
        if not replica_id or not isinstance(endpoint, str) \
                or not endpoint:
            return                          # a malformed beat: ignored
        self._data_sock(endpoint)
        with self._lock:
            prev = self._members.get(replica_id)
            self._members[replica_id] = {
                "endpoint": endpoint,
                "last_seen": time.perf_counter(),
                "ready": bool(skel.get("ready")),
                "gen": int(skel.get("gen") or 0),
                "queue_depth": int(skel.get("queue_depth") or 0),
                "swapping": bool(skel.get("swapping")),
                "draining": bool(skel.get("draining")),
                "snapshot_path": skel.get("snapshot_path") or "",
                # capacity: a mesh replica advertises its device count;
                # a beat without it counts 1
                "device_count": max(1, int(skel.get("device_count")
                                           or 1)),
                "mesh": skel.get("mesh") if isinstance(
                    skel.get("mesh"), dict) else None,
                "p99_ms_by_bucket": dict(
                    skel.get("p99_ms_by_bucket") or {}),
                "warm_source": skel.get("warm_source"),
                "warm_hits": int(skel.get("warm_hits") or 0),
                "warm_misses": int(skel.get("warm_misses") or 0),
                "boot_s": skel.get("boot_s"),
            }
            if prev is None:
                telemetry.emit("replica_joined", "serving",
                               replica=replica_id, endpoint=endpoint,
                               members=len(self._members))
            if prev is not None and prev["endpoint"] != endpoint:
                # an in-place endpoint change (a wildcard-bind restart
                # faster than the TTL): reap the old endpoint's socket
                # now; the eviction path never sees it
                self._drop_unused_data_socks(
                    {m["endpoint"] for m in self._members.values()})
            self._maybe_heal(replica_id)
        # the fleet observability piggyback, ingested outside the
        # membership lock (the fleet stores lock internally)
        origin = str(skel.get("origin") or replica_id)
        if skel.get("spans"):
            telemetry.fleet_trace().ingest(origin, skel["spans"])
        if skel.get("events"):
            telemetry.fleet_events().ingest(origin, skel["events"])
        if skel.get("metrics"):
            telemetry.fleet_metrics().update(origin, skel["metrics"])

    def _maybe_heal(self, replica_id: str) -> None:
        """A replica whose snapshot disagrees with the promoted fleet path
        (it restarted with its boot snapshot) is swapped back
        off-rotation, which keeps generation stamps in lockstep under
        restarts (lock held)."""
        if self._fleet_path is None or self._rollover is not None:
            return
        m = self._members[replica_id]
        if m["snapshot_path"] == self._fleet_path:
            self._healing.pop(replica_id, None)
            return
        if not m["ready"] or m["swapping"]:
            return
        # debounce: heartbeats beat far faster than a swap completes, and
        # a re-heal a beat would walk the generation counter away
        now = time.perf_counter()
        t_sent = self._healing.get(replica_id)
        if t_sent is not None and now - t_sent < float(
                self.knobs["heal_backoff_s"]):
            return
        self._healing[replica_id] = now
        self._inc("heals")
        telemetry.emit("heal", "serving", replica=replica_id,
                       snapshot=m["snapshot_path"], fleet=self._fleet_path)
        self.log.info("heal: %s snapshot %r != fleet %r", replica_id,
                      m["snapshot_path"], self._fleet_path)
        self._send_ctrl(replica_id, {"cmd": "swap",
                                     "path": self._fleet_path})

    # -- dispatch ------------------------------------------------------------

    def _candidates(self, exclude=()) -> List[str]:
        """Ready, in-rotation members, least-loaded first (heartbeat
        queue depth + balancer-tracked in-flight, normalised by the
        replica's device count: equal raw depths on a 1-device and an
        8-device replica are not equal waits); round-robin tie-break.
        Lock held."""
        out = []
        stale = []
        rotation_out = self._rotation_out()
        heal_gate = self._rollover is None \
            and self._fleet_path is not None
        for rid, m in self._members.items():
            if not m["ready"] or rid in exclude or rid in rotation_out \
                    or rid in self._retiring:
                # retiring = drain-then-retire: its in-flight work
                # finishes, but new work never lands on a replica the
                # autoscaler is about to kill
                continue
            load = (m["queue_depth"]
                    + self._dispatch_counts.get(rid, 0)) \
                / m.get("device_count", 1)
            if heal_gate and m["snapshot_path"] != self._fleet_path:
                # awaiting a heal: it would answer with stale parameters
                # and an off-wave generation stamp, a last resort only
                stale.append((load, rid))
                continue
            out.append((load, rid))
        if not out:
            # a fully stale fleet (a mass restart) still serves: stale
            # but consistent beats silence, and the heals are on the way
            out = stale
        if not out:
            return []
        out.sort(key=lambda t: t[0])
        best = [rid for load, rid in out if load == out[0][0]]
        self._rr += 1
        first = best[self._rr % len(best)]
        rest = [rid for _, rid in out if rid != first]
        return [first] + rest

    def _send_to(self, replica_id: str, frames: List) -> bool:
        """Ship frames to one replica's data DEALER (lock held)."""
        m = self._members.get(replica_id)
        if m is None:
            return False
        sock = self._data_sock(m["endpoint"])
        sock.send_multipart([b""] + list(frames), copy=False)
        return True

    def _dispatch(self, entry: _Entry, exclude=(), pool=None) -> bool:
        """Send an entry to the best candidate (optionally restricted to
        ``pool``); False when nobody is ready (lock held)."""
        from znicz_torch.parallel import wire

        with self._lock:
            roll = self._rollover
            if (pool is None and entry.kind == "infer" and roll is not None
                    and roll["phase"] == "canary"):
                # the canary's fixed share (the wave's judged traffic):
                # every stride-th accept goes to the canary pool, the rest
                # to the old pool, least-loaded inside each; an empty or
                # unready pool falls back to anyone ready
                roll["steer"] += 1
                pool = roll["canary"] if roll["steer"] % roll["stride"] == 0 \
                    else (roll["old"] or None)
                if pool is not None:
                    cands = self._candidates(exclude=exclude)
                    steered = [c for c in cands if c in pool]
                    cands = steered or cands
                else:
                    cands = self._candidates(exclude=exclude)
            else:
                cands = self._candidates(exclude=exclude)
                if pool is not None:
                    cands = [c for c in cands if c in pool] or []
            if not cands:
                return False
            target = cands[0]
            # the canary phase: parity-probe a sample of old-generation
            # traffic.  A sampled primary is marked solo before it ships,
            # and its probe copies the mark: each is served alone at the
            # smallest rung that holds its rows, so both halves ride the
            # same rung (cuDNN and cuBLAS choose kernels by batch size)
            roll = self._rollover
            probe = False
            if (roll is not None and roll["phase"] == "canary"
                    and entry.kind == "infer" and roll["parity"]
                    and target not in roll["canary"]):
                roll["old_dispatches"] += 1
                probe = (roll["old_dispatches"] % int(
                    self.knobs["parity_every"]) == 0
                    and entry.probe_rid is None
                    and bool(self._probe_pool()))
                if probe:
                    entry.frames = wire.restamp_message(entry.frames,
                                                        solo=True)
                    entry.solo = True
            if not self._send_to(target, entry.frames):
                return False
            entry.targets.append(target)
            entry.t_sent = time.perf_counter()
            entry.tries += 1
            if entry.kind == "probe":
                # shadow work: a probe in flight must not bias real
                # traffic away from the canary it probes
                self._probes[entry.rid] = entry
            else:
                self._dispatch_counts[target] = \
                    self._dispatch_counts.get(target, 0) + 1
                entry.held.add(target)
                self._inflight[entry.rid] = entry
            if probe:
                self._spawn_probe(entry)
            return True

    def _release(self, entry: _Entry) -> None:
        """Drop an entry's dispatch-count reservations (lock held)."""
        if entry.kind == "probe":
            return                          # never counted (see dispatch)
        for target in entry.held:
            n = self._dispatch_counts.get(target, 0)
            if n > 0:
                self._dispatch_counts[target] = n - 1
        entry.held = set()

    def _probe_pool(self) -> List[str]:
        """The ready canaries a parity probe may go to (lock held)."""
        return [r for r in self._rollover["canary"] if r in self._members
                and self._members[r]["ready"]]

    def _spawn_probe(self, primary: _Entry) -> None:
        """Duplicate a request to a canary replica as a shadow parity
        probe, never forwarded to the client (lock held)."""
        from znicz_torch.parallel import wire

        pool = self._probe_pool()
        if not pool or primary.probe_rid is not None:
            return
        self._rid += 1
        probe_rid = self._rid
        frames = wire.restamp_message(primary.frames, req_id=probe_rid)
        probe = _Entry(probe_rid, None, [], frames,
                       primary.deadline, kind="probe",
                       trace_id=primary.trace_id)
        probe.solo = True
        probe.primary_rid = primary.rid
        if self._dispatch(probe, pool=pool):
            primary.probe_rid = probe_rid
            self._parity_buf[probe_rid] = {}

    # -- replica plane: replies ----------------------------------------------

    @staticmethod
    def _tensor_bytes(frames: List[bytes]) -> bytes:
        """A reply's raw tensor frames, concatenated: the parity key
        (metadata differs across generations by design; the answer must
        not)."""
        return b"".join(bytes(f) for f in frames[1:])

    def _handle_replica(self, endpoint: str, frames: List[bytes]) -> None:
        from znicz_torch.parallel import wire

        _, payload = wire.split_envelope(frames)
        if not payload:
            payload = list(frames)
        try:
            skel = wire.peek_message(payload)
        except wire.WireError:
            # a reply corrupted between replica and balancer: the failover
            # timer recovers the request; nothing to attribute
            self._inc("replica_bad_frames")
            return
        self.codec.count_message_in(payload)
        rid = skel.get("req_id")
        with self._lock:
            if rid in self._ctrl:
                self._ctrl.pop(rid)["on_reply"](skel)
                return
            if skel.get("bad_frame") and rid is None:
                # the replica could not decode our forwarded frames
                # (corrupted in flight): the failover timer re-ships them
                self._inc("replica_bad_frames")
                return
            if rid in self._probes:
                self._finish_probe(self._probes.pop(rid), skel, payload)
                return
            entry = self._inflight.get(rid)
            if entry is None:
                self._inc("dup_replies_dropped")
                return
            ok = bool(skel.get("ok"))
            policy = skel.get("policy")
            scope = skel.get("scope", "service")
            retryable = ((not ok and policy in ("shed", "draining")
                          and scope == "service")
                         or bool(skel.get("bad_frame")))
            if retryable and entry.tries < int(
                    self.knobs["failover_tries"]) \
                    and time.perf_counter() < entry.deadline:
                # a service-scoped shed, a draining replica's refusal (it
                # was stopped between our dispatch and its arrival), or a
                # bad frame with our rid from one replica is not the
                # fleet's answer: the same bytes to another replica
                self._inc("sheds_retried")
                replica = str(skel.get("replica_id") or "")
                self._inflight.pop(rid)
                self._release(entry)
                if not self._dispatch(entry, exclude={replica}):
                    self._parked.append(entry)
                return
            self._forward_reply(entry, skel, payload)

    def _forward_reply(self, entry: _Entry, skel: Dict,
                       payload: List[bytes]) -> None:
        """The first reply wins: the client's req_id stamped back on, the
        tensor frames forwarded untouched, the entry retired (lock
        held)."""
        from znicz_torch.parallel import wire

        with self._lock:
            self._inflight.pop(entry.rid, None)
            self._release(entry)
            ok = bool(skel.get("ok"))
            out = wire.restamp_message(payload, req_id=entry.client_rid,
                                       lb=True)
            self._send_front(entry.envelope, out)
            self._inc("replied" if ok else "refused")
            replica = str(skel.get("replica_id") or "")
            if self._tracer.enabled and entry.trace_id:
                # the balancer's hop in the stitched fleet timeline
                self._tracer.add(
                    "balancer", "request", entry.t_accept,
                    time.perf_counter() - entry.t_accept,
                    {"trace_id": entry.trace_id,
                     "req_id": entry.client_rid, "lb_rid": entry.rid,
                     "replica": replica, "targets": list(entry.targets),
                     "tries": entry.tries, "gen": skel.get("gen"),
                     "solo": entry.solo, "probe_rid": entry.probe_rid,
                     "ok": ok})
            if skel.get("spans") and skel.get("origin"):
                # a generation final carries the replica's span summary:
                # stitched now (before its next heartbeat)
                telemetry.fleet_trace().ingest(str(skel["origin"]),
                                               skel["spans"])
            if entry.hedge_target is not None \
                    and replica == entry.hedge_target:
                self._inc("hedge_wins")
            if entry.t_sent is not None and ok:
                lat = time.perf_counter() - entry.t_accept
                self._lat.append(lat)
                if len(self._lat) > 512:
                    del self._lat[:256]
                roll = self._rollover
                if roll is not None and roll["phase"] == "canary":
                    if replica in roll["canary"]:
                        roll["lat_new"].append(lat)
                    elif replica in roll["old"]:
                        roll["lat_old"].append(lat)
            # parity: the primary's half, kept until the probe's lands
            if entry.probe_rid is not None \
                    and entry.probe_rid in self._parity_buf:
                buf = self._parity_buf[entry.probe_rid]
                buf["primary"] = (self._tensor_bytes(payload), ok)
                self._compare_parity(entry.probe_rid)

    def _finish_probe(self, probe: _Entry, skel: Dict,
                      payload: List[bytes]) -> None:
        self._release(probe)
        if self._tracer.enabled and probe.trace_id:
            # the shadow half of a parity pair: same trace_id as its
            # primary, never forwarded
            self._tracer.add(
                "balancer", "probe", probe.t_accept,
                time.perf_counter() - probe.t_accept,
                {"trace_id": probe.trace_id, "lb_rid": probe.rid,
                 "primary_rid": probe.primary_rid,
                 "replica": str(skel.get("replica_id") or ""),
                 "targets": list(probe.targets), "gen": skel.get("gen"),
                 "solo": True, "ok": bool(skel.get("ok"))})
        buf = self._parity_buf.get(probe.rid)
        if buf is None:
            return
        buf["probe"] = (self._tensor_bytes(payload), bool(skel.get("ok")))
        self._compare_parity(probe.rid)

    def _compare_parity(self, probe_rid: int) -> None:
        buf = self._parity_buf.get(probe_rid)
        if buf is None or "primary" not in buf or "probe" not in buf:
            return
        del self._parity_buf[probe_rid]
        (primary_bytes, primary_ok) = buf["primary"]
        (probe_bytes, probe_ok) = buf["probe"]
        if not (primary_ok and probe_ok):
            return                          # refusals prove nothing
        self._inc("parity_checks")
        roll = self._rollover
        if roll is not None:
            roll["checks"] += 1
        if primary_bytes != probe_bytes:
            self._inc("parity_mismatches")
            if roll is not None:
                roll["mismatches"] += 1

    # -- timers --------------------------------------------------------------

    def _hedge_delay(self) -> float:
        """The hedge delay (s): ``hedge_p99_mult`` x the balancer's own
        reply p99, clamped to ``[hedge_floor_s, hedge_cap_s]`` (the floor
        until 20 replies: the cold start)."""
        lo = float(self.knobs["hedge_floor_s"])
        hi = float(self.knobs["hedge_cap_s"])
        if len(self._lat) < 20:
            return lo
        p99 = float(np.percentile(np.asarray(self._lat[-256:]), 99))
        return min(max(p99 * float(self.knobs["hedge_p99_mult"]), lo), hi)

    def _tick_membership(self) -> None:
        """TTL eviction and immediate failover of the dead replica's
        in-flight entries (lock held)."""
        with self._lock:
            now = time.perf_counter()
            ttl = float(self.knobs["replica_ttl_s"])
            # a control command whose replica died before answering would
            # otherwise sit in _ctrl forever
            for crid in [crid for crid, c in self._ctrl.items()
                         if now - c["t"] > 10 * ttl]:
                del self._ctrl[crid]
            dead = [rid for rid, m in self._members.items()
                    if now - m["last_seen"] > ttl]
            for rid in dead:
                self._inc("replicas_lost")
                self._evict_member(rid, f"no heartbeat for >{ttl}s")

    def _evict_member(self, rid: str, why: str) -> None:
        """Drop one member from the fleet now (lock held): fail over its
        in-flight entries, clear its heal state, drop a parity probe it
        was answering, prune its data socket when no other member shares
        the endpoint.  Shared by TTL eviction and the autoscaler's retire:
        a retired replica must not linger as servable capacity until its
        TTL."""
        with self._lock:
            if self._members.pop(rid, None) is None:
                return
            self._healing.pop(rid, None)
            self._drop_unused_data_socks(
                {m["endpoint"] for m in self._members.values()})
            self.log.warning("replica_lost: %s evicted (%s); failing over "
                             "its in-flight requests (%d members)", rid,
                             why, len(self._members))
            telemetry.emit("replica_lost", "serving", replica=rid,
                           why=why, members=len(self._members))
            for entry in list(self._inflight.values()):
                if entry.targets and entry.targets[-1] == rid:
                    self._failover(entry, exclude={rid})
            for probe in list(self._probes.values()):
                if probe.targets and probe.targets[-1] == rid:
                    self._probes.pop(probe.rid)
                    self._release(probe)
                    self._parity_buf.pop(probe.rid, None)

    def _failover(self, entry: _Entry, exclude=()) -> None:
        """Re-dispatch the same bytes to another replica, or refuse
        readably once the try budget is spent (lock held)."""
        with self._lock:
            self._inflight.pop(entry.rid, None)
            self._release(entry)
            if entry.tries >= int(self.knobs["failover_tries"]):
                self._refuse_client(
                    entry, "failover",
                    f"request failed over {entry.tries} times "
                    f"(replicas tried: {entry.targets}) — giving up")
                return
            self._inc("failovers")
            telemetry.emit("failover", "serving",
                           req_id=entry.client_rid, tries=entry.tries,
                           targets=list(entry.targets))
            # exclude every replica already tried (primary, hedge, earlier
            # failovers): the try budget spreads across the fleet, and
            # parking is the fallback when nobody untried is ready
            if not self._dispatch(entry, exclude=set(exclude)
                                  | set(entry.targets)):
                self._parked.append(entry)

    def _tick_inflight(self) -> None:
        """Deadlines, failover timeouts, hedges, parked dispatch (lock
        held)."""
        with self._lock:
            now = time.perf_counter()
            failover_after = float(self.knobs["failover_timeout_s"])
            hedge_after = self._hedge_delay() if self.knobs["hedge"] \
                else None
            for entry in list(self._inflight.values()):
                if now > entry.deadline:
                    self._inflight.pop(entry.rid, None)
                    self._release(entry)
                    self._refuse_client(
                        entry, "deadline",
                        "deadline budget spent awaiting the fleet "
                        f"(replicas tried: {entry.targets})")
                    continue
                if entry.t_sent is None:
                    continue
                waited = now - entry.t_sent
                if waited > failover_after:
                    self._failover(entry)
                    continue
                if (hedge_after is not None and not entry.hedged
                        and waited > hedge_after):
                    pool = self._candidates(exclude=set(entry.targets))
                    if pool:
                        target = pool[0]
                        if self._send_to(target, entry.frames):
                            entry.targets.append(target)
                            entry.hedged = True
                            entry.hedge_target = target
                            entry.tries += 1
                            self._dispatch_counts[target] = \
                                self._dispatch_counts.get(target, 0) + 1
                            entry.held.add(target)
                            self._inc("hedges")
            for probe in list(self._probes.values()):
                if now > probe.deadline:
                    self._probes.pop(probe.rid, None)
                    self._release(probe)
                    self._parity_buf.pop(probe.rid, None)
            if self._parked:
                parked, self._parked = self._parked, []
                for entry in parked:
                    if now > entry.deadline:
                        self._refuse_client(
                            entry, "deadline",
                            "deadline budget spent parked — no replica "
                            "became ready in time")
                        continue
                    if not self._dispatch(entry):
                        self._parked.append(entry)

    # -- the autoscaler ------------------------------------------------------

    def enable_autoscale(self, spawn, retire, **overrides) -> None:
        """Arm the autoscaler: ``spawn()`` must start one new replica
        announcing to this balancer (the ``--serve --announce`` path);
        ``retire(replica_id)`` must end one.  Both run outside the
        balancer's lock (they may block on a process's start or end).
        ``overrides`` set ``autoscale_*`` knobs by name."""
        with self._lock:
            self.knobs.update(overrides)
            self.knobs["autoscale"] = True
            self._scaler = {"spawn": spawn, "retire": retire}
            self._scale_known = set(self._members)

    def _servable_ids(self) -> List[str]:
        """Members that carry real capacity now (lock held): ready, in
        rotation, not draining toward retirement, and not mid-heal (a
        replica inside its heal window serves stale parameters and is
        about to swap: counting it as capacity would let scale-down
        retire the last healthy replica while the heal is in flight)."""
        rotation_out = self._rotation_out()
        return [rid for rid, m in self._members.items()
                if m["ready"] and rid not in rotation_out
                and rid not in self._retiring
                and rid not in self._healing]

    def _tick_autoscale(self) -> None:
        """One autoscaler evaluation: reconcile pending spawns with
        announcements, finish drains, and hold the fleet inside the load
        band with hysteresis: scale up after ``autoscale_up_after``
        consecutive high evaluations (parked requests count as high),
        drain-then-retire after ``autoscale_down_after`` low ones, never
        below the ``min_replicas`` quorum, one action a cooldown.
        Decisions are made under the lock; spawn and retire run after it
        is released."""
        actions = []
        with self._lock:
            if self._scaler is None or not bool(self.knobs["autoscale"]):
                return
            now = time.perf_counter()
            # 1. reconcile: a newly announced member consumes the oldest
            # pending spawn; spawns past the boot deadline are forgotten
            # (the process died before announcing)
            fresh = set(self._members) - self._scale_known
            for _ in fresh:
                if self._scale_pending:
                    self._scale_pending.pop(0)
            self._scale_known = set(self._members)
            boot_deadline = float(self.knobs["autoscale_boot_deadline_s"])
            late = [t for t in self._scale_pending
                    if now - t > boot_deadline]
            if late:
                self._scale_pending = [t for t in self._scale_pending
                                       if now - t <= boot_deadline]
                self.log.warning(
                    "autoscale: %d spawned replica(s) never announced "
                    "within %gs — abandoning the reservation(s)",
                    len(late), boot_deadline)
            # 2. finish drains: a retiring replica ends once its in-flight
            # work is gone (or the drain timeout is spent: the failover
            # ledger recovers what was left)
            drain_timeout = float(self.knobs["autoscale_drain_timeout_s"])
            for rid, t0 in list(self._retiring.items()):
                m = self._members.get(rid)
                drained = m is None or (
                    self._dispatch_counts.get(rid, 0) == 0
                    and m["queue_depth"] == 0)
                if not drained and now - t0 > drain_timeout:
                    self._inc("scale_drain_timeouts")
                    self.log.warning(
                        "autoscale: %s drain exceeded %gs — retiring "
                        "anyway (in-flight work fails over)", rid,
                        drain_timeout)
                    drained = True
                if drained:
                    del self._retiring[rid]
                    self._inc("scale_downs")
                    self.log.info("autoscale: retiring %s", rid)
                    actions.append(("retire", rid))
                    # evict now, not at the TTL: a retired replica that
                    # lingers as ready would count as servable capacity
                    self._evict_member(rid, "autoscale retire")
            # 3. the band, at its own (slower) cadence
            if now - self._scale_last["eval"] \
                    >= float(self.knobs["autoscale_eval_s"]):
                self._scale_last["eval"] = now
                servable = self._servable_ids()
                if servable:
                    load = sum(
                        (self._members[r]["queue_depth"]
                         + self._dispatch_counts.get(r, 0))
                        / self._members[r].get("device_count", 1)
                        for r in servable) / len(servable)
                else:
                    # no servable capacity with work waiting is the
                    # hardest "high"
                    load = float("inf") if (self._parked
                                            or self._inflight) else 0.0
                high = bool(self._parked) \
                    or load > float(self.knobs["autoscale_high_load"])
                low = not self._parked and not high \
                    and load < float(self.knobs["autoscale_low_load"])
                self._scale_streak["high"] = \
                    self._scale_streak["high"] + 1 if high else 0
                self._scale_streak["low"] = \
                    self._scale_streak["low"] + 1 if low else 0
                cooling = now - self._scale_last["action"] \
                    < float(self.knobs["autoscale_cooldown_s"])
                total = len(self._members) + len(self._scale_pending)
                if (self._scale_streak["high"]
                        >= int(self.knobs["autoscale_up_after"])
                        and not cooling
                        and total < int(self.knobs["autoscale_max"])):
                    self._scale_pending.append(now)
                    self._scale_last["action"] = now
                    self._scale_streak["high"] = 0
                    self._inc("scale_ups")
                    self.log.info(
                        "autoscale_up: load %.2f, %d parked, %d members, "
                        "%d pending", load, len(self._parked),
                        len(self._members), len(self._scale_pending))
                    telemetry.emit(
                        "autoscale_up", "serving",
                        load=round(load, 3) if np.isfinite(load)
                        else "inf",
                        parked=len(self._parked),
                        members=len(self._members),
                        pending=len(self._scale_pending))
                    actions.append(("spawn", None))
                elif (self._scale_streak["low"]
                        >= int(self.knobs["autoscale_down_after"])
                        and not cooling
                        and not self._scale_pending
                        and not self._retiring
                        and len(servable) - 1 >= self.min_replicas):
                    # scale down only above quorum, and only from the
                    # servable set; drain first (_candidates stops
                    # routing to it this instant)
                    victim = min(servable, key=lambda r: (
                        self._members[r]["queue_depth"]
                        + self._dispatch_counts.get(r, 0)))
                    self._retiring[victim] = now
                    self._scale_last["action"] = now
                    self._scale_streak["low"] = 0
                    self.log.info(
                        "autoscale_down: draining %s (load %.2f, %d "
                        "servable)", victim, load, len(servable))
                    telemetry.emit(
                        "autoscale_down", "serving", victim=victim,
                        load=round(load, 3), servable=len(servable))
        for kind, arg in actions:
            # unlocked on purpose: a process's start or end may block,
            # and the serve loop's ledger must keep ticking meanwhile
            try:
                if kind == "spawn":
                    self._scaler["spawn"]()
                else:
                    self._scaler["retire"](arg)
            except Exception:
                self.log.exception("autoscale: %s callback failed (%s)",
                                   kind, arg)

    # -- the canary rollover -------------------------------------------------

    def _send_ctrl(self, replica_id: str, msg: Dict,
                   on_reply=None) -> None:
        """One control command (swap/rollback) to one replica over its
        data socket, tracked outside the infer ledger (lock held)."""
        self._rid += 1
        msg = dict(msg, req_id=self._rid)
        self._ctrl[self._rid] = {
            "replica_id": replica_id, "cmd": msg["cmd"],
            "t": time.perf_counter(),
            "on_reply": on_reply or (lambda skel: None)}
        self._send_to(replica_id, self.codec.encode(msg))

    def _handle_swap(self, envelope: List[bytes], skel: Dict) -> None:
        path = skel.get("path")
        rid = skel.get("req_id")
        parity = bool(skel.get("parity", True))
        with self._lock:
            if not isinstance(path, str) or not path:
                self._send_front(envelope, self.codec.encode(
                    {"ok": False, "req_id": rid, "lb": True,
                     "error": "swap needs a snapshot 'path'"}))
                return
            if self._rollover is not None:
                self._send_front(envelope, self.codec.encode(
                    {"ok": False, "req_id": rid, "lb": True,
                     "error": "rollover already in progress "
                              f"(phase {self._rollover['phase']})"}))
                return
            ready = [r for r, m in self._members.items() if m["ready"]]
            if not ready:
                self._send_front(envelope, self.codec.encode(
                    {"ok": False, "req_id": rid, "lb": True,
                     "error": "no ready replicas to roll over"}))
                return
            # the wave is keyed on snapshot paths, never on predicted
            # generation numbers: per-replica counters are high-water
            # marks that a rollback-then-retry or a restart-then-heal
            # legitimately desynchronises
            paths = {self._members[r]["snapshot_path"] for r in ready}
            if len(paths) != 1:
                self._send_front(envelope, self.codec.encode(
                    {"ok": False, "req_id": rid, "lb": True,
                     "error": f"fleet snapshot paths not uniform "
                              f"({sorted(paths)}) — healing in "
                              f"progress; retry shortly"}))
                return
            old_path = paths.pop()
            if path == old_path:
                self._send_front(envelope, self.codec.encode(
                    {"ok": False, "req_id": rid, "lb": True,
                     "error": f"fleet already serves snapshot "
                              f"{path!r}"}))
                return
            old_gen = max(self._members[r]["gen"] for r in ready)
            n_canary = max(1, int(round(
                float(self.knobs["canary_fraction"]) * len(ready))))
            n_canary = min(n_canary, len(ready))
            canary = sorted(ready)[:n_canary]
            self._rollover = {
                "path": path, "parity": parity,
                "phase": "warm_canary",
                "canary": canary, "old": [r for r in sorted(ready)
                                          if r not in canary],
                # generations are informational (history); new_gen is
                # read off the first warmed canary's heartbeat
                "old_gen": old_gen, "new_gen": None,
                "old_path": old_path,
                "t_start": time.perf_counter(),
                "t_canary": None,
                "t_phase": time.perf_counter(),
                "warming": set(),           # out of rotation now
                "sent": set(),              # swap/rollback sent
                "done": set(),              # confirmed flipped
                "errors": [],               # (replica, refusal reason)
                "checks": 0,                # parity probes compared
                "lat_old": [], "lat_new": [],
                "old_dispatches": 0, "mismatches": 0,
                "steer": 0,
                "stride": max(1, int(round(len(ready) / n_canary))),
            }
            self.log.info("swap_begin: rollover to %r, canary %s (of %d "
                          "ready), parity %s", path, canary, len(ready),
                          parity)
            telemetry.emit("swap_begin", "serving", path=path,
                           canary=list(canary), ready=len(ready))
            self._send_front(envelope, self.codec.encode(
                {"ok": True, "swap_started": True, "req_id": rid,
                 "lb": True, "canary": canary, "generation": old_gen}))

    def _warm_one(self, roll: Dict, replica_id: str, cmd: Dict) -> bool:
        """Drive one replica through an off-rotation swap or rollback;
        True once its heartbeat confirms the flip (keyed on the snapshot
        path it reports, never on a predicted generation).  A refused
        command (a broken snapshot, nothing kept) lands in
        ``roll["errors"]`` for the phase machine (lock held)."""
        if replica_id in roll["done"]:
            return True
        m = self._members.get(replica_id)
        if m is None:
            return False                    # died mid-warm: caller acts
        if replica_id not in roll["sent"]:
            roll["warming"].add(replica_id)
            roll["sent"].add(replica_id)

            def on_reply(skel, _rid=replica_id):
                # runs under the serve thread's lock (the reply handler)
                if self._rollover is roll and not skel.get("ok"):
                    roll["errors"].append((_rid, str(skel.get("error"))))
            self._send_ctrl(replica_id, cmd, on_reply=on_reply)
            return False
        want = roll["path"] if cmd["cmd"] == "swap" else roll["old_path"]
        if m["snapshot_path"] == want and m["ready"] \
                and not m["swapping"]:
            if cmd["cmd"] == "swap" and roll["new_gen"] is None:
                roll["new_gen"] = m["gen"]  # observed, not predicted
            roll["warming"].discard(replica_id)
            roll["done"].add(replica_id)
            return True
        return False

    def _finish_rollover(self, result: str, reason: str) -> None:
        """Record the wave (the losing side's counts kept) and clear the
        state machine (lock held)."""
        roll = self._rollover
        self._rollover = None
        record = {
            "result": result, "reason": reason, "path": roll["path"],
            "old_gen": roll["old_gen"], "new_gen": roll["new_gen"],
            "canary": roll["canary"],
            "parity_mismatches": roll["mismatches"],
            "canary_samples": len(roll["lat_new"]),
            "old_samples": len(roll["lat_old"]),
            "canary_p99_ms": None, "old_p99_ms": None,
            "elapsed_s": round(time.perf_counter() - roll["t_start"], 3),
        }
        if roll["lat_new"]:
            record["canary_p99_ms"] = round(float(np.percentile(
                np.asarray(roll["lat_new"]), 99)) * 1e3, 3)
        if roll["lat_old"]:
            record["old_p99_ms"] = round(float(np.percentile(
                np.asarray(roll["lat_old"]), 99)) * 1e3, 3)
        self.rollover_history.append(record)
        if result == "promoted":
            self._fleet_path = roll["path"]
            self._inc("rollovers")
            telemetry.emit("swap_done", "serving", path=roll["path"],
                           new_gen=roll["new_gen"],
                           elapsed_s=record["elapsed_s"])
        elif result == "rolled_back":
            # the fleet's intended path is the pre-wave one: pinning it
            # arms the heal loop against rollback stragglers too
            self._fleet_path = roll["old_path"]
            self._inc("rollbacks")
            telemetry.emit("rollback", "serving", path=roll["path"],
                           reason=reason, elapsed_s=record["elapsed_s"])
        self.log.warning("rollover to %r %s: %s", roll["path"], result,
                         reason)

    def _enter_phase(self, roll: Dict, phase: str) -> None:
        """A phase transition: fresh sent/warming/done sets and the phase
        timer every timeout below is held against (lock held)."""
        roll["phase"] = phase
        roll["sent"], roll["warming"] = set(), set()
        roll["done"] = set()
        roll["t_phase"] = time.perf_counter()
        telemetry.emit("swap_phase", "serving", phase=phase,
                       path=roll["path"])

    def _abort_to_rollback(self, roll: Dict, reason: str) -> None:
        """A warm-phase abort: whatever already flipped rolls back, then
        the wave finishes rolled_back (lock held)."""
        flipped = list(roll["done"])
        telemetry.emit("rollback", "serving", path=roll["path"],
                       reason=reason, flipped=len(flipped))
        roll["reason"] = reason
        roll["canary"] = flipped            # only these need undoing
        if not flipped:
            self._finish_rollover("rolled_back", reason)
            return
        self._enter_phase(roll, "rollback")

    def _tick_rollover(self) -> None:
        """Advance the canary state machine one step (lock held).  Every
        phase is bounded by ``canary_timeout_s`` against ``t_phase``: a
        replica that never warms, a refused command or a stuck rollback
        must never wedge the wave."""
        roll = self._rollover
        if roll is None:
            return
        timeout = float(self.knobs["canary_timeout_s"])
        stuck = time.perf_counter() - roll["t_phase"] > timeout
        if roll["phase"] == "warm_canary":
            done = [r for r in roll["canary"]
                    if self._warm_one(roll, r,
                                      {"cmd": "swap",
                                       "path": roll["path"]})]
            lost = [r for r in roll["canary"] if r not in self._members]
            if lost or roll["errors"] or stuck:
                # a canary died, refused the swap (a broken snapshot) or
                # never confirmed: survivors that flipped roll back
                reason = (f"canary {lost} died while warming" if lost
                          else f"swap refused: {roll['errors']}"
                          if roll["errors"]
                          else f"canary warm timed out after "
                               f"{timeout:g}s")
                self._abort_to_rollback(roll, reason)
                return
            if len(done) == len(roll["canary"]):
                self._enter_phase(roll, "canary")
                roll["t_canary"] = time.perf_counter()
            return
        if roll["phase"] == "canary":
            verdict = self._canary_verdict(roll)
            if verdict is None:
                return
            ok, reason = verdict
            if not ok:
                roll["reason"] = reason
                self._enter_phase(roll, "rollback")
                return
            self._enter_phase(roll, "promote")
            roll["queue"] = [r for r in roll["old"]
                             if r in self._members]
            return
        if roll["phase"] == "promote":
            # one replica at a time, each warmed off-rotation, so the
            # fleet never dips below quorum mid-wave.  A replica that
            # dies, refuses or times out is skipped: the wave promotes,
            # and healing (toward the new fleet path) retries it
            roll["queue"] = [r for r in roll["queue"]
                             if r in self._members]
            skip = {r for r, _ in roll["errors"]}
            if skip:
                roll["queue"] = [r for r in roll["queue"]
                                 if r not in skip]
                for r in skip:
                    roll["warming"].discard(r)
                self.log.warning("promote: skipping %s (refused: %s) — "
                                 "healing will retry", sorted(skip),
                                 roll["errors"])
                roll["errors"] = []
            if not roll["queue"]:
                self._finish_rollover("promoted", "canary verdict clean")
                return
            head = roll["queue"][0]
            if self._warm_one(roll, head, {"cmd": "swap",
                                           "path": roll["path"]}):
                roll["queue"].pop(0)
                roll["t_phase"] = time.perf_counter()  # per replica
            elif stuck:
                roll["warming"].discard(head)
                roll["queue"].pop(0)
                roll["t_phase"] = time.perf_counter()
                self.log.warning("promote: %s never confirmed within "
                                 "%gs — skipped; healing will retry",
                                 head, timeout)
            return
        if roll["phase"] == "rollback":
            done = [r for r in roll["canary"]
                    if r not in self._members
                    or self._warm_one(roll, r, {"cmd": "rollback"})]
            if len(done) == len(roll["canary"]) or stuck:
                stragglers = [r for r in roll["canary"] if r not in done]
                reason = roll.get("reason", "regression")
                if stragglers:
                    # a straggler still on the new path disagrees with the
                    # (unchanged) fleet path, so healing swaps it back
                    reason += (f" (rollback stragglers {stragglers} "
                               f"left to healing)")
                self._finish_rollover("rolled_back", reason)
            return

    def _canary_verdict(self, roll: Dict) -> Optional[Tuple[bool, str]]:
        """(ok, reason) once the canary has enough evidence; None to keep
        watching (lock held)."""
        if roll["parity"] and roll["mismatches"] > 0:
            return False, (f"reply parity broken: "
                           f"{roll['mismatches']} mismatching "
                           f"shadow probes")
        lost = [r for r in roll["canary"] if r not in self._members]
        if lost:
            return False, f"canary {lost} died while serving"
        need = int(self.knobs["canary_requests"])
        # an all-canary fleet (one replica, or canary_fraction ~1) has no
        # old pool: the p99 comparison is vacuous, parity and health judge
        have_old = bool(roll["old"])
        if len(roll["lat_new"]) >= need and (
                not have_old or len(roll["lat_old"]) >= 1):
            if roll["lat_old"]:
                p99_new = float(np.percentile(
                    np.asarray(roll["lat_new"]), 99))
                p99_old = float(np.percentile(
                    np.asarray(roll["lat_old"]), 99))
                mult = float(self.knobs["canary_p99_mult"])
                if p99_new > p99_old * mult:
                    return False, (f"canary p99 {p99_new * 1e3:.1f}ms "
                                   f"> {mult}x old "
                                   f"{p99_old * 1e3:.1f}ms")
            if roll["parity"] and have_old and roll["checks"] == 0:
                # promote only after a parity probe completed
                # (canary_timeout_s is the backstop; with no old pool
                # there is nothing to probe against)
                return None
            return True, "clean"
        if time.perf_counter() - roll["t_canary"] > float(
                self.knobs["canary_timeout_s"]):
            # starvation is not evidence of health
            return False, (f"canary starved: only "
                           f"{len(roll['lat_new'])} samples inside "
                           f"{self.knobs['canary_timeout_s']}s")
        return None


for _name, _help in ReplicaBalancer.COUNTERS.items():
    setattr(ReplicaBalancer, _name, registered_property(_name, _help))
del _name, _help

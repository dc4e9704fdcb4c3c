"""The relay tree of the master/slave plane (port of
``znicz_tpu/parallel/relay.py``): aggregation in O(log N) hops instead of
the star's O(N).

In the star the master decodes every slave's update, so its ingress
bytes and decode work grow with the fleet.  A :class:`Relay` is a node of
a reduction tree.  To its children (slaves or lower relays) it speaks
the master's protocol: the same register handshake and job/update
commands, so the unchanged ``Client`` dials it.  To its upstream (the
master or a higher relay) it is one slave that speaks two batched
extensions of the same wire:

  - **job batching**: ``{"cmd": "job", "count": k, "leaves": n}`` fetches
    up to k jobs under one params broadcast, which the relay re-serves to
    its children as they ask; ``leaves`` is the subtree's live leaf count,
    which the master's quorum counts;
  - **update aggregation**: each child delta is checked at the edge
    (finite values, shapes learned from the first accepted delta, a norm
    within ``quarantine_norm_mult`` x the running median), summed in
    float32 and flushed upward as one delta re-encoded per ``wire_dtype``
    through the relay's own ``wire.DeltaEncoder`` (its error-feedback
    residuals belong to the relay), with a per-contributor manifest (ids,
    job ids, steps, metrics) that keeps the master's books per leaf.

A flush leaves once as many direct children have reported as the relay
has (at most ``fanout``), or once the oldest buffered contribution is
``relay_flush_s`` old.  A relay holds no training state: jobs queued or
contributions buffered when it dies come back through the master's
reaper, and its children fall back to the upstream it advertised in its
register reply.  A relay whose upstream is gone re-homes to that
upstream's own advertised upstream (one rung up the tree), and goes
silent when there is none.

Telemetry: the counters (``COUNTERS``, the reference's names and help)
are the ``relay`` scope's registry counters (labelled by ``bind``), read
as attributes without the ``relay_`` prefix, with the ``relay_children``
and ``relay_queue_depth`` gauges; each child message is a
``relay/handle:<cmd>`` span and each delivered flush a ``relay/flush``
span naming its contributors' trace ids.  The relay names itself in the
fleet, and each flush carries its own spans and journal events upstream,
and, under ``fwd_obs``, those its children piggybacked on their updates
(each under the child's origin, a bounded drop-oldest buffer between
flushes), so a leaf two hops down reaches the master's stores as itself.
A bind of ``tcp://127.0.0.1:*`` picks its port when it binds;
:attr:`Relay.endpoint` is the resolved address once :meth:`Relay.start`
returns, and is what the relay advertises upstream as its ``bind``.
"""

from __future__ import annotations

import logging
import pickle
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from znicz_torch import telemetry
from znicz_torch.core.config import root
from znicz_torch.telemetry.metrics import registered_property

log = logging.getLogger("znicz_torch.relay")


def parse_relay_spec(spec: str,
                     default_bind: str = "tcp://*:5571") -> Tuple[str, str]:
    """``--relay UPSTREAM[:BIND]`` -> (upstream, bind).  BIND is a whole
    endpoint (``tcp://host:5570:tcp://*:5571``) or a bare port
    (``tcp://host:5570:5571`` -> ``tcp://*:5571``); a plain endpoint binds
    ``default_bind``.  Anything else raises, naming the accepted forms."""
    m = re.match(r"^(\w+://[^:/]+:\d+)$", spec)
    if m:
        return m.group(1), default_bind
    m = re.match(r"^(\w+://[^:/]+:\d+):(\d+)$", spec)
    if m:
        return m.group(1), f"tcp://*:{m.group(2)}"
    m = re.match(r"^(\w+://[^:/]+:\d+):(\w+://.+)$", spec)
    if m:
        return m.group(1), m.group(2)
    raise ValueError(
        f"unparseable --relay spec {spec!r}; expected "
        "UPSTREAM, UPSTREAM:PORT or UPSTREAM:BIND_ENDPOINT "
        "(e.g. tcp://host:5570:5571)")


def plan_tree(n_slaves: int, fanout: int, master_endpoint: str,
              host: str = "127.0.0.1", base_port: int = 15700) -> Dict:
    """The relay tiers a fleet of ``n_slaves`` needs at ``fanout``, as
    endpoints: ``{"relays": [{"bind", "upstream"}, ...],
    "slave_endpoints": [one a slave], "levels": n}``, the top tier (the
    master's children) first, so that starting them in order brings the
    tree up parents before children.  Ports count up from
    ``base_port``."""
    n_slaves = int(n_slaves)
    fanout = int(fanout)
    if n_slaves < 1:
        raise ValueError(f"n_slaves must be >= 1, got {n_slaves}")
    if fanout < 2:
        # ceil(n / 1) never shrinks: a chain aggregates nothing
        raise ValueError(f"tree fanout must be >= 2, got {fanout}")
    # tier sizes bottom up, each ceil(below / fanout), until a tier fits
    # under the master
    tiers_up: List[int] = []
    below = n_slaves
    while below > fanout:
        below = -(-below // fanout)
        tiers_up.append(below)
    if not tiers_up and n_slaves > 1:
        tiers_up.append(1)                   # one relay proves the hop
    port = int(base_port)
    relays: List[Dict[str, str]] = []
    binds_by_tier: List[List[str]] = []
    for count in reversed(tiers_up):         # top tier first
        binds = []
        for _ in range(count):
            binds.append(f"tcp://{host}:{port}")
            port += 1
        binds_by_tier.append(binds)
        upstreams = (binds_by_tier[-2] if len(binds_by_tier) > 1
                     else [master_endpoint])
        for i, bind in enumerate(binds):
            relays.append({"bind": bind,
                           "upstream": upstreams[i % len(upstreams)]})
    leaves = binds_by_tier[-1] if binds_by_tier else [master_endpoint]
    slave_endpoints = [leaves[i % len(leaves)] for i in range(n_slaves)]
    return {"relays": relays, "slave_endpoints": slave_endpoints,
            "levels": len(binds_by_tier)}


class Relay:
    """One node of the reduction tree: :meth:`serve` blocks (or
    :meth:`start` serves on a thread) until the upstream reports training
    done, or :meth:`stop`.

    A relay needs no workflow.  The first child's handshake is passed
    upstream under the relay's own id (the master's check is the one
    judge of the whole subtree) and the credentials it passed are kept;
    later children are checked against them here, refused in the master's
    words."""

    #: relay counters: name -> meaning (the reference's); each is read as
    #: an attribute without the ``relay_`` prefix
    COUNTERS = {
        "relay_bytes_in": "wire bytes received (children + upstream)",
        "relay_bytes_out": "wire bytes sent (children + upstream)",
        "relay_refusals": "child deltas refused at the edge",
        "relay_bad_frames": "undecodable child frames refused",
        "relay_flushes": "aggregated updates flushed upstream",
        "relay_contributions": "child update contributions accepted",
        "relay_jobs_served": "jobs served to children",
        "relay_upstream_reconnects": "fresh-socket retries upstream",
        "relay_rehomes": "upstream re-homes to the advertised fallback",
        "relay_jobs_expired": "queued jobs dropped unserved: deadline "
                              "budget spent (master re-queues them)",
    }

    def __init__(self, upstream: str, bind: str,
                 relay_id: Optional[str] = None,
                 fanout: Optional[int] = None,
                 flush_s: Optional[float] = None,
                 recv_timeout: float = 15.0,
                 max_reconnects: Optional[int] = None,
                 wire_dtype: Optional[str] = None,
                 child_ttl: Optional[float] = None):
        from znicz_torch.core.config import check_engine_knobs
        from znicz_torch.parallel import wire
        from znicz_torch.transport import Endpoint, RetryPolicy

        check_engine_knobs()
        eng = root.common.engine
        self.upstream = upstream
        self.bind = bind
        #: the resolved address of :attr:`bind` once serving
        self.endpoint = bind
        self.relay_id = relay_id or f"relay-{uuid.uuid4().hex[:8]}"
        #: the flush threshold (direct children a round) and the job-batch
        #: factor
        self.fanout = int(eng.get("tree_fanout", 2)
                          if fanout is None else fanout)
        #: the oldest a buffered contribution gets before a partial flush
        self.flush_s = float(eng.get("relay_flush_s", 0.05)
                             if flush_s is None else flush_s)
        self.recv_timeout = float(recv_timeout)
        self.max_reconnects = int(eng.get("slave_reconnects", 8)
                                  if max_reconnects is None
                                  else max_reconnects)
        self.quarantine_norm_mult = float(eng.get("quarantine_norm_mult",
                                                  25.0))
        #: a child silent this long leaves the table (a dead sibling must
        #: not hold the flush threshold up); a re-register brings it back
        self.child_ttl = float(eng.get("relay_child_ttl", 30.0)
                               if child_ttl is None else child_ttl)
        #: the summed delta's upward encoding, with the relay's own
        #: error-feedback residuals
        self.wire_dtype = wire.canonical_wire_dtype(
            eng.get("wire_dtype", "float32")
            if wire_dtype is None else wire_dtype)
        self._enc = wire.DeltaEncoder(self.wire_dtype)

        #: one lock for every field the serve thread writes and the
        #: introspection reads
        self._lock = threading.Lock()
        sc = telemetry.scope("relay", bind=str(bind))
        self._m = {name: sc.counter(name, help)
                   for name, help in self.COUNTERS.items()}
        sc.gauge("relay_children", "children registered at this relay",
                 fn=telemetry.weak_fn(self, lambda r: len(r._children)))
        sc.gauge("relay_queue_depth", "jobs queued for children",
                 fn=telemetry.weak_fn(self, lambda r: len(r._jobq)))
        self._tracer = telemetry.tracer()
        # the relay's spans and events ride its flushes upstream; the
        # master ingests them under this origin
        telemetry.set_identity(self.relay_id)
        self._exporter = telemetry.exporter()
        self._obs_ev_seq = 0
        #: children's piggybacked obs payloads awaiting the next flush
        self._obs_fwd: List[dict] = []
        self._children: Dict[str, float] = {}       # id -> last seen
        self._cred: Optional[Tuple[Any, Any]] = None  # (version, digest)
        self._cred_reply: Dict = {}                 # the kept ok register
        self._jobq: List[Tuple[dict, Any]] = []     # (entry, params)
        self._buffer: List[dict] = []               # contributor entries
        self._buffer_msgs = 0                       # direct child messages
        self._sum: Dict[str, Dict[str, np.ndarray]] = {}
        #: shapes learned from the first accepted delta, kept for the
        #: relay's life: the sum is empty at each window's start, and a
        #: wrong-shaped child arriving first must be refused itself
        self._shapes: Dict[str, Dict[str, tuple]] = {}
        self._sum_t0: Optional[float] = None
        self._done = False
        #: wait damping: after an upstream "wait" (an epoch's tail) the
        #: children's polls are answered here for a while, growing with
        #: consecutive waits, so the subtree does not re-ask the master
        #: once a poll
        self._wait_until = 0.0
        self._wait_streak = 0
        #: the upstream the upstream advertised at register time: where
        #: the relay re-homes once its reconnect budget is spent
        self._upstream_fallback: Optional[str] = None
        #: subtree leaf counts a child reported (a slave counts 1)
        self._child_leaves: Dict[str, int] = {}
        self._delta_norms: List[float] = []         # accepted, per child
        self._uregistered = False
        self._ufails = 0
        self._urefusals = 0             # consecutive bad_frame replies
        self._last_evict = 0.0
        #: a FaultSchedule for the serve loop's ingress hook
        self.transport_chaos = None
        self._transport = None
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._serve_error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._uep = Endpoint(
            self.upstream, recv_timeout_s=self.recv_timeout,
            retry=RetryPolicy.for_relay_upstream(
                self.max_reconnects, jitter_key=f"{self.relay_id}/backoff"),
            count_out=lambda n: self._inc("relay_bytes_out", n),
            count_in=lambda n: self._inc("relay_bytes_in", n))

    def _inc(self, name: str, n: int = 1) -> None:
        self._m[name].inc(int(n))

    # -- introspection -----------------------------------------------------------

    @property
    def children(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._children)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._jobq)

    @property
    def complete(self) -> bool:
        with self._lock:
            return self._done

    def stats(self) -> dict:
        """The relay's row: topology, queue, flush buffer and counters."""
        now = time.time()
        with self._lock:
            children = [{"id": sid, "last_seen_s": round(now - seen, 1)}
                        for sid, seen in sorted(self._children.items())]
            out = {
                "id": self.relay_id, "bind": self.bind,
                "endpoint": self.endpoint, "upstream": self.upstream,
                "fanout": self.fanout, "wire_dtype": self.wire_dtype,
                "children": children, "queue_depth": len(self._jobq),
                "buffered_contributions": len(self._buffer),
                "complete": self._done,
                "leaves": sum(int(self._child_leaves.get(sid, 1))
                              for sid in self._children)}
            out.update({name[len("relay_"):]: m.value
                        for name, m in self._m.items()})
        return out

    # -- the edge check (the master's quarantine, at the relay) ----------------

    def _validate_delta(self, deltas: Dict, n_delta: int) -> Optional[str]:
        """Why a child delta must never touch the partial sum: a leaf of
        another shape than the relay learned or the sum holds, a
        non-finite value, or a norm (per contributor) beyond
        ``quarantine_norm_mult`` x the running median of accepted ones
        (once 5 are known).  Never raises: a payload too broken to
        inspect is itself the reason."""
        try:
            total = 0.0
            for name, layer in deltas.items():
                for k, arr in (layer or {}).items():
                    a = np.asarray(arr, np.float64)
                    want = self._shapes.get(name, {}).get(k)
                    if want is not None and tuple(a.shape) != want:
                        return (f"shape {tuple(a.shape)} != {want} "
                                f"for {name}.{k}")
                    have = self._sum.get(name, {}).get(k)
                    if have is not None and have.shape != a.shape:
                        return (f"shape {tuple(a.shape)} != aggregate "
                                f"{tuple(have.shape)} for {name}.{k}")
                    if not np.all(np.isfinite(a)):
                        return "non-finite values"
                    total += float(np.dot(a.ravel(), a.ravel()))
        except Exception as exc:
            return f"undecodable delta payload: {exc!r}"
        # a lower relay's aggregate of n deltas carries n contributors'
        # worth of norm
        norm = float(np.sqrt(total)) / max(1, int(n_delta))
        with self._lock:
            if len(self._delta_norms) >= 5:
                med = float(np.median(self._delta_norms))
                if med > 0.0 and norm > self.quarantine_norm_mult * med:
                    return (f"norm {norm:.3g} > "
                            f"{self.quarantine_norm_mult:g} x median "
                            f"{med:.3g}")
            self._delta_norms.append(norm)
            del self._delta_norms[:-64]
        return None

    def _accumulate(self, deltas: Dict) -> None:
        """Add a checked delta to the float32 sum."""
        with self._lock:
            for name, layer in deltas.items():
                dst = self._sum.setdefault(name, {})
                shp = self._shapes.setdefault(name, {})
                for k, arr in (layer or {}).items():
                    a = np.asarray(arr, np.float32)
                    shp.setdefault(k, tuple(a.shape))
                    if k in dst:
                        dst[k] = dst[k] + a
                    else:
                        dst[k] = a.astype(np.float32, copy=True)
            if self._sum_t0 is None:
                self._sum_t0 = time.time()

    # -- the children's commands -------------------------------------------------

    def _register_msg(self, version, digest) -> dict:
        return {"cmd": "register", "id": self.relay_id, "version": version,
                "workflow_digest": digest, "relay": True,
                "fanout": self.fanout, "bind": self.endpoint}

    def _child_register(self, req: dict, sid: str) -> dict:
        v, digest = req.get("version"), req.get("workflow_digest")
        with self._lock:
            cred = self._cred
        if cred is None:
            # the first child's credentials register the relay upstream
            rep = self._upstream_rpc(self._register_msg(v, digest),
                                     is_register=True)
            if rep is None:
                return {"ok": False, "error": "relay upstream unreachable"}
            if not rep.get("ok"):
                return {"ok": False, "error": rep.get("error")}
            with self._lock:
                self._cred = (v, digest)
                self._cred_reply = {
                    k: rep.get(k)
                    for k in ("version", "class_lengths", "resumed",
                              "epoch")}
                # a relay upstream names its own upstream, the master
                # none: the rung this relay re-homes to
                self._upstream_fallback = rep.get("upstream")
            self._uregistered = True
        else:
            cv, cd = cred
            if v != cv:
                return {"ok": False, "error":
                        f"protocol version mismatch: master speaks "
                        f"{cv}, slave sent {v!r}"}
            if digest != cd:
                return {"ok": False, "error":
                        f"workflow digest mismatch: master runs {cd}, "
                        f"slave runs {digest!r} — same trainable graph "
                        f"(layer names/shapes/hyperparameters) required"}
        with self._lock:
            self._children[sid] = time.time()
            reply = dict(self._cred_reply)
            upstream = self.upstream    # moves when the relay re-homes
        reply.update({"ok": True, "upstream": upstream})
        return reply

    def _live_leaves(self) -> int:
        """The subtree's leaves: the sum of what each live child last
        reported (a slave counts 1)."""
        with self._lock:
            return sum(int(self._child_leaves.get(sid, 1))
                       for sid in self._children)

    def _child_job(self, req: dict, sid: str) -> dict:
        from znicz_torch.transport import local_deadline, remaining_ms

        k = max(1, min(int(req.get("count", 1) or 1), 64))
        with self._lock:
            # a lower relay reports its subtree, a slave counts 1
            try:
                self._child_leaves[sid] = max(0, int(req.get("leaves", 1)))
            except (TypeError, ValueError):
                self._child_leaves[sid] = 1
            done, have = self._done, len(self._jobq)
            damped = not have and time.time() < self._wait_until
        if done:
            return {"done": True}
        if damped:
            return {"wait": True}
        if have == 0:
            rep = self._upstream_rpc(
                {"cmd": "job", "id": self.relay_id,
                 "count": k * self.fanout, "leaves": self._live_leaves(),
                 "prefetch": bool(req.get("prefetch"))})
            if rep is None:
                return {"wait": True}       # upstream fault: child re-asks
            if rep.get("done"):
                self._flush()               # drain before the drain ends
                with self._lock:
                    self._done = True
                    self._jobq.clear()
                return {"done": True}
            jobs = rep.get("jobs")
            if jobs is None and "job" in rep:
                jobs = [{key: rep.get(key)
                         for key in ("job_id", "job", "trace_id", "train",
                                     "step")}]
            if not jobs:
                # an upstream wait: damp the subtree's polls
                with self._lock:
                    self._wait_streak += 1
                    damp = min(0.05 * (2 ** min(self._wait_streak - 1, 4)),
                               0.5)
                    self._wait_until = time.time() + damp
                return {"wait": True}
            params = rep.get("params")
            now = time.monotonic()
            with self._lock:
                self._wait_streak = 0
                for j in jobs:
                    entry = dict(j)
                    # the budget the master stamped becomes a local
                    # deadline at receipt: it burns while the job queues
                    entry["_deadline_t"] = local_deadline(
                        entry.get("deadline_ms"), now=now)
                    self._jobq.append((entry, params))
        now = time.monotonic()
        take: List[Tuple[dict, Any]] = []
        expired = 0
        with self._lock:
            while self._jobq and len(take) < k:
                entry, params = self._jobq.pop(0)
                deadline = entry.pop("_deadline_t", None)
                if deadline is not None and now > deadline:
                    # the master re-queues it: serving it would burn a
                    # child's compute on wasted work
                    expired += 1
                    continue
                if deadline is not None:
                    entry["deadline_ms"] = remaining_ms(deadline, now)
                take.append((entry, params))
        if expired:
            self._inc("relay_jobs_expired", expired)
        if not take:
            return {"wait": True}
        self._inc("relay_jobs_served", len(take))
        if int(req.get("count", 1) or 1) <= 1:
            entry, params = take[0]
            return dict(entry, params=params)
        # one params payload for the batch: the freshest fetch's
        return {"jobs": [e for e, _ in take], "params": take[-1][1]}

    def _child_update(self, req: dict, sid: str) -> dict:
        self._buffer_child_obs(req, sid)
        deltas = req.get("deltas")
        contributors = req.get("contributors")
        if contributors is not None:
            # a lower relay's aggregate: its manifest is adopted whole
            entries = [dict(e) for e in contributors]
            n_delta = sum(1 for e in entries if e.get("delta"))
        else:
            entries = [{"id": sid, "job_id": req.get("job_id"),
                        "trace_id": req.get("trace_id"),
                        "step": req.get("step"),
                        "metrics": req.get("metrics")}]
            n_delta = 1 if deltas else 0
            if deltas:
                entries[0]["delta"] = True
        if deltas:
            reason = self._validate_delta(deltas, max(1, n_delta))
            if reason:
                # refused here: the sum stays clean, the child hears the
                # master's wording, and the manifest carries the refusal
                # so that the master counts it and re-queues the job.
                # Only the entries with a delta are refused; a delta-less
                # sibling (eval metrics) passes
                refused = [{"id": e.get("id", sid),
                            "job_id": e.get("job_id"), "refused": reason}
                           for e in entries if e.get("delta")]
                passed = [e for e in entries if not e.get("delta")]
                with self._lock:
                    self._buffer.extend(refused + passed)
                    self._buffer_msgs += 1
                    if self._sum_t0 is None:
                        self._sum_t0 = time.time()
                self._inc("relay_refusals", len(refused))
                self._inc("relay_contributions", len(passed))
                self._maybe_flush()
                return {"ok": False, "quarantined": True,
                        "error": f"delta quarantined: {reason}"}
            self._accumulate(deltas)
        with self._lock:
            self._buffer.extend(entries)
            self._buffer_msgs += 1
            if self._sum_t0 is None:
                self._sum_t0 = time.time()
            done = self._done
        self._inc("relay_contributions", len(entries))
        self._maybe_flush()
        return {"ok": True, "complete": done}

    def _handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        sid = req.get("id", "?")
        with self._lock:
            known = sid in self._children
            if known:
                self._children[sid] = time.time()
        if cmd == "register":
            return self._child_register(req, sid)
        if cmd in ("job", "update") and not known:
            return {"ok": False, "unregistered": True,
                    "error": f"slave {sid!r} is not registered"}
        if cmd == "job":
            return self._child_job(req, sid)
        if cmd == "update":
            return self._child_update(req, sid)
        return {"error": f"unknown cmd {cmd!r}"}

    # -- the flush ---------------------------------------------------------------

    def _flush_due(self) -> bool:
        with self._lock:
            if not self._buffer:
                return False
            if self._buffer_msgs >= max(1, min(len(self._children),
                                               self.fanout)):
                return True
            return (self._sum_t0 is not None
                    and time.time() - self._sum_t0 >= self.flush_s)

    def _maybe_flush(self) -> None:
        if self._flush_due():
            self._flush()

    def _evict_children(self) -> None:
        """Drop children silent past ``child_ttl`` (checked at most once a
        second); their work comes back through the master's reaper, and a
        returning child registers again on its ``unregistered`` reply."""
        if self.child_ttl <= 0:
            return
        now = time.time()
        with self._lock:
            if now - self._last_evict < 1.0:
                return
            self._last_evict = now
            for sid in [s for s, seen in self._children.items()
                        if now - seen > self.child_ttl]:
                del self._children[sid]
                self._child_leaves.pop(sid, None)

    def _flush_message(self, entries: List[dict],
                       summed: Optional[Dict]) -> dict:
        """The aggregated update: the contributor manifest and the summed
        delta, re-encoded per ``wire_dtype`` with this relay's
        error-feedback residuals."""
        return {"cmd": "update", "id": self.relay_id,
                "contributors": entries,
                "deltas": self._enc.encode(summed) if summed else None}

    def _flush(self, final: bool = False) -> None:
        """Ship the buffered contributions upstream as one aggregated
        update.  ``final`` (the serve loop's last act) allows one delivery
        attempt after :meth:`stop`."""
        from znicz_torch.parallel import wire

        with self._lock:
            if not self._buffer:
                return
            entries, self._buffer = self._buffer, []
            self._buffer_msgs = 0
            summed, self._sum = self._sum, {}
            self._sum_t0 = None
        t0 = time.perf_counter() if self._tracer.enabled else None
        msg = self._flush_message(entries, summed)
        # the relay's own spans and events, and its children's, ride the
        # flush (added here: _flush_message's output stays the
        # deterministic message shape, and the exporter's drain is
        # one-shot)
        msg.update(self._obs_payload())
        with self._lock:
            fwd, self._obs_fwd = self._obs_fwd, []
        if fwd:
            msg["fwd_obs"] = fwd
        frames, _ = wire.encode_message(msg)
        rep = self._upstream_rpc(frames=frames, one_shot=final)
        if rep is not None:
            # only a delivered flush counts; an undelivered one's jobs
            # come back through the master's reaper
            self._inc("relay_flushes")
            if rep.get("complete"):
                with self._lock:
                    self._done = True
        if t0 is not None:
            self._tracer.add("relay", "flush", t0, time.perf_counter() - t0,
                             {"contributors": len(entries),
                              "trace_ids": [e.get("trace_id")
                                            for e in entries
                                            if e.get("trace_id")][:8],
                              "delivered": rep is not None})

    def _buffer_child_obs(self, req: dict, sid: str) -> None:
        """Hold a child's piggybacked spans and events (and what a lower
        relay forwarded) for the next flush, each under its leaf's
        origin; bounded drop-oldest, so a flush-starved window sheds
        telemetry, never deltas."""
        fwd = []
        if req.get("spans") or req.get("events"):
            fwd.append({"origin": str(req.get("origin") or sid),
                        "spans": req.get("spans") or [],
                        "events": req.get("events") or []})
        fwd.extend(f for f in (req.get("fwd_obs") or [])
                   if isinstance(f, dict))
        if not fwd:
            return
        with self._lock:
            self._obs_fwd.extend(fwd)
            del self._obs_fwd[:-32]

    def _obs_payload(self) -> dict:
        """This relay's piggyback for one flush: a bounded batch of its
        exported spans and its fresh journal events, under its fleet
        origin; empty when there is nothing to ship."""
        out: dict = {}
        spans = self._exporter.drain(telemetry.span_export_batch())
        if spans:
            out["spans"] = spans
        ev = telemetry.journal().since(
            self._obs_ev_seq, limit=telemetry.span_export_batch())
        if ev:
            self._obs_ev_seq = ev[-1]["seq"]
            out["events"] = ev
        if out:
            out["origin"] = telemetry.identity()
        return out

    # -- the upstream link -------------------------------------------------------

    def _upstream_rpc(self, msg: Optional[dict] = None,
                      frames: Optional[List] = None,
                      is_register: bool = False,
                      one_shot: bool = False) -> Optional[dict]:
        """One exchange with the upstream on the transport ``Endpoint``: a
        timeout or an undecodable reply drops the socket, backs off on the
        relay's curve, reconnects fresh (registering again with the kept
        credentials before anything else) and resends the same frames.
        None once the reconnect budget is spent with nowhere to re-home
        (the caller treats the upstream as gone).  ``one_shot`` allows
        one attempt after :meth:`stop`."""
        from znicz_torch.parallel import wire
        from znicz_torch.transport import TransportFault

        if frames is None:
            frames, _ = wire.encode_message(msg)
        attempts = 0
        while not self._stop.is_set() or (one_shot and attempts == 0):
            attempts += 1
            try:
                if not self._uregistered and not is_register:
                    cred = self._cred
                    if cred is None:
                        return None     # nothing to register as yet
                    reg, _ = wire.encode_message(
                        self._register_msg(*cred))
                    rep = self._uep.rpc(reg)
                    if rep.get("bad_frame"):
                        if self._count_refusal():
                            return None
                        continue
                    if not rep.get("ok"):
                        log.warning("%s: upstream refused re-registration: "
                                    "%s", self.relay_id, rep.get("error"))
                        self._stop.set()
                        return None
                    with self._lock:
                        # the (maybe new) upstream's own advertisement
                        self._upstream_fallback = rep.get("upstream")
                    self._uregistered = True
                rep = self._uep.rpc(frames)
                self._ufails = 0
                if rep.get("bad_frame"):
                    # alive, but it never decoded our frame: resend the
                    # same bytes, on a bounded budget
                    if self._count_refusal():
                        return None
                    continue
                self._urefusals = 0
                if rep.get("unregistered") and not is_register:
                    self._uregistered = False   # the master restarted
                    continue
                return rep
            except TransportFault as exc:
                self._ufails += 1
                self._inc("relay_upstream_reconnects")
                self._uregistered = False
                if self._ufails > self.max_reconnects:
                    with self._lock:
                        fallback = self._upstream_fallback
                        if fallback and fallback != self.upstream:
                            # one rung up the tree; the register there
                            # records that rung's advertisement
                            self.upstream = fallback
                            self._upstream_fallback = None
                        else:
                            fallback = None
                    if fallback:
                        self._uep.endpoint = fallback
                        self._inc("relay_rehomes")
                        self._ufails = 0
                        log.warning("%s: upstream gone after %d retries — "
                                    "re-homing to its advertised upstream "
                                    "%s", self.relay_id, self.max_reconnects,
                                    fallback)
                        continue
                    log.warning("%s: upstream %s gone for good after %d "
                                "retries (%r) — relay going silent so "
                                "children fall back", self.relay_id,
                                self.upstream, self._ufails - 1, exc)
                    self._stop.set()
                    return None
                self._uep.backoff(self._ufails)
        return None

    def _count_refusal(self) -> bool:
        """The bounded ``bad_frame`` budget: True once spent (an upstream
        that refuses every frame must not spin the relay forever)."""
        self._urefusals += 1
        if self._urefusals <= max(3, self.max_reconnects):
            time.sleep(0.05)
            return False
        log.warning("%s: upstream refused %d consecutive frames "
                    "(bad_frame) — relay going silent", self.relay_id,
                    self._urefusals)
        self._stop.set()
        return True

    # -- the serve loop ----------------------------------------------------------

    def _reply_frames(self, frames: List[bytes]) -> List:
        """Decode and dispatch one child message.  Never raises: garbage
        is counted and refused in v2 framing, as the master refuses it."""
        from znicz_torch.parallel import wire
        from znicz_torch.transport import bad_frame_reply

        self._inc("relay_bytes_in", sum(len(f) for f in frames))
        try:
            req, info = wire.decode_message(frames)
            if not isinstance(req, dict):
                raise wire.WireError(
                    f"decodes to {type(req).__name__}, not a request dict")
        except Exception as exc:
            out = [pickle.dumps(bad_frame_reply(exc))]
            self._inc("relay_bad_frames")
            self._inc("relay_bytes_out", len(out[0]))
            return out
        try:
            with self._tracer.span("relay", f"handle:{req.get('cmd')}",
                                   bind=self.bind, child=req.get("id")):
                rep = self._handle(req)
        except Exception as exc:
            self._inc("relay_bad_frames")
            log.exception("%s: refused malformed request %r", self.relay_id,
                          req.get("cmd"))
            rep = {"ok": False, "bad_frame": True,
                   "error": f"malformed request: {exc!r}"}
        if info.get("legacy"):
            out = [pickle.dumps(rep)]
        else:
            out, _ = wire.encode_message(rep)
        self._inc("relay_bytes_out",
                  sum(f.nbytes if isinstance(f, memoryview) else len(f)
                      for f in out))
        return out

    def serve(self, linger: float = 3.0) -> None:
        """Serve until the upstream reports done (then answer ``linger``
        seconds more, so late children hear ``done``) or :meth:`stop`: the
        transport loop's REP dispatch of :meth:`_reply_frames` and one tick
        for the flush window, child eviction and the linger.  The loop
        keeps its own stop flag, so a linger's end leaves the final flush
        its whole retry budget."""
        from znicz_torch.transport import TransportLoop

        loop = TransportLoop("relay", instance=self.bind)
        state = {"deadline": None}

        def tick() -> None:
            if self._stop.is_set():
                loop.stop()
                return
            with self._lock:
                done = self._done and not self._buffer
            if done and state["deadline"] is None:
                state["deadline"] = time.time() + linger
            if state["deadline"] is not None \
                    and time.time() > state["deadline"]:
                loop.stop()
                return
            self._maybe_flush()
            self._evict_children()

        try:
            try:
                sock = loop.bind_rep(self.bind)
                self.endpoint = loop.resolved_endpoint(sock)
            except BaseException as exc:
                self._serve_error = exc
                raise
            finally:
                self._ready.set()
            loop.register(sock, self._reply_frames, reply=True)
            if self.transport_chaos is not None:
                loop.inject_faults(self.transport_chaos)
            self._transport = loop
            loop.add_tick(tick)
            loop.run(poll_ms=20)
        finally:
            # one delivery attempt even after stop(): a clean shutdown
            # should not drop a window a healthy upstream would take
            self._flush(final=True)
            loop.close()
            self._uep.close()

    def start(self, linger: float = 3.0) -> "Relay":
        """Serve on a thread; return once bound (:attr:`endpoint`
        resolved).  A bind failure raises here with its cause."""
        self._ready.clear()
        self._serve_error = None
        self._thread = threading.Thread(
            target=self.serve, kwargs={"linger": linger}, daemon=True,
            name=f"relay-{self.bind}")
        self._thread.start()
        self._ready.wait()
        if self._serve_error is not None:
            raise RuntimeError(f"relay failed to bind {self.bind}: "
                               f"{self._serve_error!r}") \
                from self._serve_error
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join a started relay's thread; True once it exited."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


for _name, _help in Relay.COUNTERS.items():
    setattr(Relay, _name[len("relay_"):],
            registered_property(_name, _help))
del _name, _help

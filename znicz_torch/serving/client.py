"""Inference client (port of ``znicz_tpu/serving/client.py``): a DEALER
peer of the serving frontend.

DEALER, not REQ: many requests may be in flight at once, replies arrive
in completion order, and there is no lockstep state to wedge, so a lost
frame needs no reconnect: the client re-sends the SAME encoded frames
after ``resend_after_s`` (inference is pure: a duplicate compute is
wasted work, not an error; duplicate replies are dropped by ``req_id``).

Overload safety:

  - every request ships a ``deadline_ms`` budget in the wire-v3
    metadata; the server refuses or drops the request once it is spent;
  - the resend loop is capped (``max_resends``: a counted, readable
    give-up);
  - a rolling-window circuit breaker (the transport core's): enough
    failures (give-ups, service-scoped sheds, bad frames) in the recent
    window open it and ``submit`` fails fast with
    :class:`CircuitOpenError`; after a capped-exponential backoff one
    half-open probe goes through, and its outcome closes or re-opens the
    breaker.  Per-client refusals (``rate_limited``, ``oversized``,
    ``deadline``, a shed with ``scope: client``) do not count: the
    service is alive and answering.

Behind a balancer the breaker is per endpoint: a reply carrying the
balancer's ``lb`` stamp files its outcome into the window of the
``replica_id`` stamped on it (``replica_breakers()``), not into the
whole-service breaker.

A sequence service takes ``(n, len)`` requests as they are and answers
``(n, len, ...)``.  A generating one (``--generate``) also takes
``submit_generate``/``generate``: a 1-D prompt in, its tokens out; with
``stream`` each token arrives as a partial reply and ``on_token(token,
i)`` fires for it.  A partial (a token, or the heartbeat a resend of an
in-flight generation is answered with) refreshes the request's resend
timer: the service is working on it.
"""

from __future__ import annotations

import collections
import itertools
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from znicz_torch.parallel import wire
from znicz_torch.transport import (CircuitBreaker,            # noqa: F401
                                   CircuitOpenError, RetryPolicy)


class InferenceError(RuntimeError):
    """The service answered with a refusal (bad frame / shed /
    rate_limited / deadline / shape); the reply dict is ``.reply``
    (``.reply.get("policy")`` names the refusing policy)."""

    def __init__(self, reply: dict):
        super().__init__(str(reply.get("error") or reply))
        self.reply = reply


class InferenceClient:
    """One-thread client.  ``infer(x)`` is the synchronous call;
    ``submit(x)``/``result(req_id)``/``collect()`` the pipelined form
    (keep W requests in flight, collect in any order).  Not thread-safe:
    one instance a thread.  The counters of :data:`COUNTERS` read as
    attributes of the same names."""

    #: client counters: name -> meaning
    COUNTERS = {
        "resends": "re-sent requests (lost/ignored)",
        "bad_replies": "undecodable replies",
        "errors": "service refusals received",
        "give_ups": "requests abandoned at max_resends/timeout",
        "breaker_opens": "circuit breaker transitions to open",
        "breaker_short_circuits": "requests refused locally: breaker open",
        "breaker_probes": "half-open probe requests sent",
        "replica_breaker_opens": "per-endpoint breaker windows opened "
                                 "(balancer replies, keyed replica_id)",
    }

    #: per-endpoint breaker table bound: oldest-first eviction past it
    MAX_REPLICA_BREAKERS = 64

    def __init__(self, endpoint: str, timeout: float = 10.0,
                 resend_after_s: float = 1.0, max_resends: int = 8,
                 deadline_s: Optional[float] = None,
                 client_id: Optional[str] = None,
                 breaker_window: int = 16, breaker_failures: int = 8,
                 breaker_reset_s: float = 0.5,
                 breaker_backoff_cap_s: float = 30.0):
        import zmq

        #: prefix of this client's trace_ids (the server echoes them)
        self._tag = uuid.uuid4().hex[:6]
        #: admission identity shipped as ``client`` metadata: the
        #: server's rate limit and fair queue key on it
        self.client_id = client_id or self._tag
        self.endpoint = endpoint
        self.timeout = float(timeout)
        self.resend_after_s = float(resend_after_s)
        self.max_resends = int(max_resends)
        #: the deadline budget shipped with each request; ``timeout`` by
        #: default (past it the answer is worthless anyway)
        self.deadline_s = (float(timeout) if deadline_s is None
                           else float(deadline_s))
        self._counts: Dict[str, int] = dict.fromkeys(self.COUNTERS, 0)
        events = {"open": "breaker_opens",
                  "short_circuit": "breaker_short_circuits",
                  "probe": "breaker_probes"}
        # breaker_failures=0 disables the breaker
        self._breaker = CircuitBreaker(
            window=int(breaker_window), threshold=int(breaker_failures),
            backoff=RetryPolicy.for_breaker(float(breaker_reset_s),
                                            float(breaker_backoff_cap_s)),
            on_event=lambda name: self._inc(events[name]), peer=endpoint)
        # per-endpoint windows behind a balancer, keyed by the reply's
        # replica_id stamp
        self._brk_replicas: "collections.OrderedDict[str, collections.deque]" \
            = collections.OrderedDict()
        self._brk_replica_open: Dict[str, bool] = {}
        self._ids = itertools.count(1)
        #: req_id -> [frames, t_last_sent, resends]
        self._pending: Dict[int, List] = {}
        self._results: Dict[int, dict] = {}
        #: req_id -> on_token callback of a streamed generation
        self._on_token: Dict[int, object] = {}
        self._sock = zmq.Context.instance().socket(zmq.DEALER)
        self._sock.setsockopt(zmq.LINGER, 0)
        self._sock.connect(endpoint)

    def _inc(self, name: str, n: int = 1) -> None:
        self._counts[name] += n

    # -- pipelined API ---------------------------------------------------------

    def _send(self, msg: dict) -> int:
        """Encode and send one request; returns its req_id.  The payload
        rides behind an empty delimiter frame, so even a request whose
        metadata frame is corrupted in flight keeps a routable envelope
        and its refusal finds the way back."""
        rid = next(self._ids)
        msg["req_id"] = rid
        msg.setdefault("trace_id", f"{self._tag}-{rid}")
        msg.setdefault("client", self.client_id)
        payload, _ = wire.encode_message(msg)
        frames = [b""] + payload
        self._sock.send_multipart(frames, copy=False)
        self._pending[rid] = [frames, time.perf_counter(), 0]
        return rid

    # -- circuit breaker -------------------------------------------------------

    @property
    def breaker_state(self) -> str:
        """``closed`` / ``open`` / ``half_open``."""
        return self._breaker.state

    def _replica_record(self, replica: str, ok: bool) -> None:
        """File one lb-stamped outcome into ``replica``'s own window
        (observational: no admit gate, only state and an opens count)."""
        if not self._breaker.enabled:
            return
        win = self._brk_replicas.get(replica)
        if win is None:
            while len(self._brk_replicas) >= self.MAX_REPLICA_BREAKERS:
                evicted, _ = self._brk_replicas.popitem(last=False)
                self._brk_replica_open.pop(evicted, None)
            win = self._brk_replicas[replica] = collections.deque(
                maxlen=self._breaker.window)
        win.append(bool(ok))
        was_open = self._brk_replica_open.get(replica, False)
        now_open = (len(win) >= self._breaker.threshold
                    and win.count(False) >= self._breaker.threshold)
        self._brk_replica_open[replica] = now_open
        if now_open and not was_open:
            self._inc("replica_breaker_opens")

    def breaker_state_for(self, replica: str) -> str:
        """``open``/``closed`` of one replica's per-endpoint window."""
        return "open" if self._brk_replica_open.get(replica, False) \
            else "closed"

    def replica_breakers(self) -> Dict[str, Dict]:
        """Per-replica window state behind a balancer."""
        return {r: {"state": "open" if self._brk_replica_open.get(r)
                    else "closed",
                    "failures": win.count(False), "window": len(win)}
                for r, win in self._brk_replicas.items()}

    def submit(self, x: np.ndarray,
               deadline_s: Optional[float] = None) -> int:
        """Send one inference request; returns its ``req_id``.
        ``deadline_s`` overrides the default budget for this request (<= 0:
        ship none, the server's TTL governs).  Raises
        :class:`CircuitOpenError` without touching the wire while the
        breaker is open."""
        return self._submit({"cmd": "infer", "x": np.ascontiguousarray(x)},
                            deadline_s)

    def _submit(self, msg: dict, deadline_s: Optional[float]) -> int:
        """Send a data-plane request through the breaker with its
        deadline budget; returns its req_id."""
        self._breaker.admit()
        budget = self.deadline_s if deadline_s is None else float(deadline_s)
        if budget > 0:
            msg["deadline_ms"] = budget * 1e3
        try:
            rid = self._send(msg)
        except Exception:
            # no probe hit the wire: free the admit() reservation
            self._breaker.release_probe()
            raise
        self._breaker.arm_probe(rid)
        return rid

    def _command(self, cmd: str, timeout: Optional[float] = None,
                 **fields) -> dict:
        """A control command (bypasses the breaker)."""
        return self.result(self._send(dict(fields, cmd=cmd)),
                           timeout=timeout)

    def ping(self, timeout: Optional[float] = None) -> dict:
        return self._command("ping", timeout)

    def stats(self, timeout: Optional[float] = None) -> dict:
        """The server's live ``stats()`` dict."""
        return self._command("stats", timeout)["stats"]

    def swap(self, path: str, timeout: Optional[float] = None) -> dict:
        """Start a snapshot rollover; the reply acknowledges the start
        (``swap_started`` and the still-live generation): poll
        ``stats()["generation"]`` for the flip."""
        return self._command("swap", timeout, path=path)

    def rollback(self, timeout: Optional[float] = None) -> dict:
        """Serve again the generation the last swap displaced."""
        return self._command("rollback", timeout)

    def _pump(self, wait_s: float) -> None:
        """Receive every reply available (waiting up to ``wait_s`` for
        the first) and file each under its req_id; undecodable stacks are
        counted and dropped (the resend timer recovers the request)."""
        import zmq

        if not self._sock.poll(max(0, int(wait_s * 1000))):
            return
        while True:
            try:
                raw = self._sock.recv_multipart(zmq.NOBLOCK)
            except zmq.Again:
                return
            try:
                # strip the delimiter the request's envelope carried
                _, payload = wire.split_envelope(raw)
                rep, _ = wire.decode_message(payload or raw)
                if not isinstance(rep, dict):
                    raise wire.WireError(
                        f"reply decodes to {type(rep).__name__}")
            except Exception:
                self._inc("bad_replies")
                continue
            rid = rep.get("req_id")
            if rep.get("partial"):
                # a streamed token or a dedup heartbeat: progress, not the
                # answer; the resend timer restarts (re-sending the prompt
                # would only cost dedup work) and a token goes to the
                # caller's callback
                entry = self._pending.get(rid)
                if entry is not None:
                    entry[1] = time.perf_counter()
                    entry[2] = 0
                    cb = self._on_token.get(rid)
                    if cb is not None and "token" in rep:
                        cb(rep.get("token"), rep.get("i"))
                continue
            if rid in self._pending:
                del self._pending[rid]
                self._on_token.pop(rid, None)
                self._results[rid] = rep
                # breaker failures: service-scoped sheds and a balancer's
                # failover give-up; ok replies and per-client refusals
                # are healthy
                ok = bool(rep.get("ok")) or not (
                    (rep.get("policy") == "shed"
                     and rep.get("scope") != "client")
                    or rep.get("policy") == "failover")
                replica = rep.get("replica_id")
                if rep.get("lb") and isinstance(replica, str) \
                        and rid != self._breaker.probe:
                    # a balancer's reply: a failure belongs to the stamped
                    # replica's window (the half-open probe is exempt);
                    # successes feed the service window too
                    self._replica_record(replica, ok)
                    if ok:
                        self._breaker.record(rid, True)
                else:
                    self._breaker.record(rid, ok)
            elif rep.get("bad_frame"):
                # the service could not decode one of our requests: a
                # service-path failure; it carries no req_id, so the
                # resend timer re-ships the same bytes
                self._breaker.record(None, False)
            # else: a duplicate (a resend raced the original): dropped

    def _maybe_resend(self) -> None:
        now = time.perf_counter()
        for rid, entry in list(self._pending.items()):
            frames, t_sent, n = entry
            if now - t_sent < self.resend_after_s:
                continue
            if n >= self.max_resends:
                # the capped resend loop: a give-up filed as the
                # request's own reply (raising here would pin it on
                # whichever request's result() is pumping)
                del self._pending[rid]
                self._on_token.pop(rid, None)
                self._inc("give_ups")
                self._breaker.record(rid, False)
                waited = now - t_sent + n * self.resend_after_s
                self._results[rid] = {
                    "ok": False, "gave_up": True, "req_id": rid,
                    "error": f"req {rid}: no reply after {n} resends "
                             f"over {waited:.1f}s — giving up (max_resends="
                             f"{self.max_resends}); service at "
                             f"{self.endpoint} unreachable?"}
                continue
            # the same encoded frames: bytes, not a re-encode
            self._sock.send_multipart(frames, copy=False)
            entry[1] = now
            entry[2] = n + 1
            self._inc("resends")

    def result(self, req_id: int, timeout: Optional[float] = None) -> dict:
        """Block until ``req_id``'s reply lands (resending past the resend
        timer); raises :class:`InferenceError` on a refusal, TimeoutError
        when the service never answers."""
        deadline = time.perf_counter() + (self.timeout if timeout is None
                                          else float(timeout))
        while req_id not in self._results:
            if time.perf_counter() > deadline:
                self._pending.pop(req_id, None)
                self._on_token.pop(req_id, None)
                self._inc("give_ups")
                self._breaker.record(req_id, False)
                raise TimeoutError(f"req {req_id}: no reply within "
                                   f"{self.timeout:g}s")
            self._pump(0.05)
            self._maybe_resend()
        rep = self._results.pop(req_id)
        if rep.get("gave_up"):
            raise TimeoutError(str(rep.get("error")))
        if not rep.get("ok"):
            self._inc("errors")
            raise InferenceError(rep)
        return rep

    def collect(self, wait_s: float = 0.0) -> List[dict]:
        """Drain the replies available now; refusals are returned, not
        raised."""
        self._pump(wait_s)
        self._maybe_resend()
        out = list(self._results.values())
        self._results.clear()
        return out

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    # -- synchronous API -------------------------------------------------------

    def infer(self, x: np.ndarray, timeout: Optional[float] = None,
              deadline_s: Optional[float] = None) -> np.ndarray:
        """One request, one result: the (n, *out) rows for the (n,
        *sample) input (a bare sample comes back with its 1-row axis)."""
        return self.result(self.submit(x, deadline_s=deadline_s),
                           timeout=timeout)["y"]

    # -- generation ------------------------------------------------------------

    def submit_generate(self, prompt: np.ndarray, max_new_tokens: int,
                        temperature: float = 0.0, top_k: int = 0,
                        seed: Optional[int] = None, stream: bool = False,
                        return_logits: bool = False,
                        return_logprobs: bool = False,
                        deadline_s: Optional[float] = None,
                        on_token=None) -> int:
        """Send one ``generate`` request; returns its ``req_id``.  With
        ``stream`` the service ships each token as it lands and
        ``on_token(token, i)`` fires from whichever pump drains it; the
        final reply (the whole token array) still comes through
        :meth:`result`.  ``return_logprobs`` asks for each token's
        log-probability, ``return_logits`` for its logits row.  Send a
        ``seed`` with ``temperature > 0`` when a resend must give the
        same tokens (sampling is seeded a sequence)."""
        msg = {"cmd": "generate",
               "x": np.ascontiguousarray(np.asarray(prompt).reshape(-1)),
               "max_new_tokens": int(max_new_tokens)}
        if temperature:
            msg["temperature"] = float(temperature)
        if top_k:
            msg["top_k"] = int(top_k)
        if seed is not None:
            msg["seed"] = int(seed)
        if stream:
            msg["stream"] = True
        if return_logits:
            msg["return_logits"] = True
        if return_logprobs:
            msg["return_logprobs"] = True
        rid = self._submit(msg, deadline_s)
        if on_token is not None:
            self._on_token[rid] = on_token
        return rid

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: Optional[int] = None, stream: bool = False,
                 return_logits: bool = False,
                 return_logprobs: bool = False,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None, on_token=None) -> dict:
        """One generation, synchronously: the final reply, with
        ``tokens`` (int32), ``gen`` (the generation that produced them),
        ``prompt_len``, ``timing_ms``, and ``logits`` / ``logprobs`` when
        asked.  Size ``timeout`` to the whole generation."""
        return self.result(
            self.submit_generate(prompt, max_new_tokens,
                                 temperature=temperature, top_k=top_k,
                                 seed=seed, stream=stream,
                                 return_logits=return_logits,
                                 return_logprobs=return_logprobs,
                                 deadline_s=deadline_s, on_token=on_token),
            timeout=timeout)

    def close(self) -> None:
        self._sock.close(0)


def _counter_property(name: str):
    return property(lambda self: self._counts[name],
                    doc=InferenceClient.COUNTERS[name])


for _name in InferenceClient.COUNTERS:
    setattr(InferenceClient, _name, _counter_property(_name))
del _name

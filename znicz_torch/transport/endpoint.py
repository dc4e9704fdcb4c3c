"""The client fault model of a REQ-style peer link (port of
``znicz_tpu/transport/endpoint.py``):

  - **fresh-socket reconnect**: a timed-out REQ socket is stuck in a
    broken state and never reused; every fault closes it and the next
    call connects a fresh one (REQ_RELAXED + REQ_CORRELATE, so stale
    replies are discarded);
  - **capped-exp backoff with jitter**: :class:`~.retry.RetryPolicy`;
  - **resend-same-bytes**: :meth:`Endpoint.rpc` takes encoded frames, so
    a caller that keeps them re-sends bytes after a reconnect;
  - **circuit breaker**: with a :class:`~.retry.CircuitBreaker` attached
    a failing peer is refused locally (:class:`~.retry.CircuitOpenError`)
    until the breaker's backoff admits a probe;
  - **deadline propagation**: :func:`local_deadline` /
    :func:`remaining_ms` turn wire ``deadline_ms`` budgets (never
    timestamps: clocks differ) into local absolute deadlines and back.

Faults surface as :class:`PeerTimeout` or :class:`BadReply`, both
:class:`TransportFault`; any decoded reply counts as the peer alive.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

from .retry import CircuitBreaker, CircuitOpenError, RetryPolicy

__all__ = ["TransportFault", "PeerTimeout", "BadReply", "Endpoint",
           "CircuitOpenError", "local_deadline", "remaining_ms"]


class TransportFault(Exception):
    """A transport-layer fault on one exchange; the socket has already
    been closed (fresh-socket discipline) when this reaches the
    caller."""


class PeerTimeout(TransportFault):
    """The peer never answered within the receive timeout."""


class BadReply(TransportFault):
    """The reply frame stack did not decode to a dict (truncated or
    corrupt) — handled exactly like a timeout: fresh socket, backoff,
    re-register."""


def local_deadline(budget_ms, now: Optional[float] = None,
                   cap_s: Optional[float] = None) -> Optional[float]:
    """A wire ``deadline_ms`` BUDGET -> a local absolute deadline
    (``time.monotonic`` clock), ``cap_s`` bounding it; None for an
    absent/garbage/non-finite budget (a broken peer must not disable
    deadlines with one bad float)."""
    if budget_ms is None:
        return None
    try:
        budget_s = float(budget_ms) / 1e3
    except (TypeError, ValueError):
        return None
    if not math.isfinite(budget_s):
        return None
    if cap_s is not None:
        budget_s = min(budget_s, float(cap_s))
    return (time.monotonic() if now is None else now) + budget_s


def remaining_ms(deadline: Optional[float],
                 now: Optional[float] = None) -> Optional[float]:
    """A local absolute deadline -> the remaining wire budget in ms
    (what a relay re-stamps on a job it re-serves); None when no
    deadline, <= 0 when expired."""
    if deadline is None:
        return None
    return (deadline - (time.monotonic() if now is None else now)) * 1e3


class Endpoint:
    """One fault-modeled REQ link to a REP-style peer (module
    docstring).  NOT thread-safe — one instance per thread (the
    prefetcher gets its own, sharing only the lock-guarded breaker).

    ``endpoint`` is mutable: re-homing/fallback flips it and the next
    call connects there (the old socket is already closed by the fault
    that motivated the move)."""

    def __init__(self, endpoint: str, recv_timeout_s: float = 15.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 count_out: Optional[Callable[[int], None]] = None,
                 count_in: Optional[Callable[[int], None]] = None):
        self.endpoint = str(endpoint)
        self.recv_timeout_s = float(recv_timeout_s)
        self.retry = retry or RetryPolicy.for_training_client()
        self.breaker = breaker
        self._count_out = count_out
        self._count_in = count_in
        self._sock = None

    # -- socket lifecycle ------------------------------------------------------

    def _connect(self):
        import zmq

        sock = zmq.Context.instance().socket(zmq.REQ)
        # duplicate tolerance: RELAXED lets a fresh request follow a
        # failed cycle; CORRELATE stamps request ids so a duplicated or
        # stale reply (chaos proxy, restarted master) is DISCARDED
        # instead of being returned for the NEXT request
        sock.setsockopt(zmq.REQ_RELAXED, 1)
        sock.setsockopt(zmq.REQ_CORRELATE, 1)
        sock.setsockopt(zmq.RCVTIMEO, int(self.recv_timeout_s * 1000))
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(self.endpoint)
        return sock

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def reset(self) -> None:
        """Close the socket (EFSM: unusable after any fault); the next
        :meth:`rpc` connects fresh."""
        if self._sock is not None:
            self._sock.close(0)
            self._sock = None

    def close(self) -> None:
        self.reset()

    # -- the exchange ----------------------------------------------------------

    def rpc(self, frames: List) -> dict:
        """One REQ/REP exchange of already-encoded frames (the resend
        path re-sends these exact bytes).  Raises
        :class:`CircuitOpenError` locally while the breaker is open
        (no wire traffic), :class:`PeerTimeout`/:class:`BadReply` on a
        transport fault (socket already reset)."""
        import zmq

        from znicz_torch.parallel import wire

        if self.breaker is not None:
            self.breaker.admit()
            token = object()
            self.breaker.arm_probe(token)
        else:
            token = None
        try:
            if self._sock is None:
                self._sock = self._connect()
            if self._count_out is not None:
                self._count_out(sum(
                    f.nbytes if isinstance(f, memoryview) else len(f)
                    for f in frames))
            self._sock.send_multipart(frames, copy=False)
            raw = self._sock.recv_multipart()
        except zmq.Again:
            self.reset()
            if self.breaker is not None:
                self.breaker.record(token, False)
            raise PeerTimeout(
                f"no reply from {self.endpoint} within "
                f"{self.recv_timeout_s:g}s") from None
        except Exception:
            # connect/send faults beyond a starved receive (bad
            # endpoint string after a re-home, terminated context,
            # EINTR): the socket state is unknown AND the armed
            # half-open probe must not leak — an un-recorded probe
            # would wedge the shared breaker in "probe still in
            # flight" forever
            self.reset()
            if self.breaker is not None:
                self.breaker.record(token, False)
            raise
        if self._count_in is not None:
            self._count_in(sum(len(f) for f in raw))
        try:
            rep, _ = wire.decode_message(raw)
            if not isinstance(rep, dict):
                raise TypeError(f"reply decodes to {type(rep).__name__}")
        except Exception as exc:
            self.reset()
            if self.breaker is not None:
                self.breaker.record(token, False)
            raise BadReply(str(exc)) from None
        # ANY decoded reply = the peer is alive (a bad_frame refusal is
        # an answering peer; content-level refusals are not transport
        # failures)
        if self.breaker is not None:
            self.breaker.record(token, True)
        return rep

    def rpc_message(self, msg: dict) -> dict:
        """Encode + :meth:`rpc` (callers that need resend-same-bytes
        keep their own frames and call :meth:`rpc` directly)."""
        from znicz_torch.parallel import wire

        frames, _ = wire.encode_message(msg)
        return self.rpc(frames)

    # -- retry pacing ----------------------------------------------------------

    def backoff(self, failures: int) -> float:
        """Sleep the n-th consecutive failure's jittered delay."""
        return self.retry.sleep(failures)

    def spent(self, failures: int) -> bool:
        return self.retry.spent(failures)

    def breaker_wait(self, cap_s: float = 1.0) -> float:
        """Sleep until the breaker's next probe window (bounded) — what
        a retrying caller does with :class:`CircuitOpenError` instead
        of spinning or burning its failure budget.  The 0.2s floor
        covers the half-open case: ``remaining()`` is 0 while another
        thread's probe is in flight (its duration is unknowable —
        bounded only by that socket's recv timeout), and a 10ms floor
        would spin the refused caller at 100Hz for the whole probe."""
        wait = min(max(self.breaker.remaining() if self.breaker
                       else 0.0, 0.2), float(cap_s))
        time.sleep(wait)
        return wait

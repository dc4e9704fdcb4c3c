"""Retry, backoff and circuit breaker (port of
``znicz_tpu/transport/retry.py``): the one backoff curve, each plane's
constants kept, and the rolling-window breaker every client rides.

:class:`RetryPolicy` is capped exponential backoff with deterministic
jitter; the ``for_*`` presets keep the training client's, the relay's
and the serving breaker's constants.  :class:`CircuitBreaker` opens once
the recent window holds enough failures, refuses calls locally
(:class:`CircuitOpenError`) until its backoff admits one half-open
probe, and closes or re-opens on that probe's outcome.  All its state is
lock-guarded.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional


class CircuitOpenError(RuntimeError):
    """The circuit breaker is open: the call was refused LOCALLY
    (fail-fast, no wire traffic) because the peer recently failed too
    often.  Retry after the breaker's backoff."""


class RetryPolicy:
    """Capped exponential backoff with deterministic jitter — the ONE
    backoff curve.

    ``delay(n)`` for the n-th consecutive failure (1-based) is
    ``min(cap, base * 2**min(n-1, exp_cap))``; ``jittered(n)``
    multiplies by ``0.5 + U[0, 1)`` from a per-owner deterministic RNG
    (``jitter_key``), exactly the training client's historical fleet
    de-synchronization; ``jitter=False`` gives the serving breaker's
    un-jittered doubling.  ``spent(n)`` is the give-up test
    (``n > max_attempts``; ``max_attempts=None`` never gives up).
    """

    def __init__(self, base: float, cap: float,
                 max_attempts: Optional[int] = None, exp_cap: int = 16,
                 jitter: bool = True, jitter_key: str = ""):
        self.base = float(base)
        self.cap = float(cap)
        self.max_attempts = None if max_attempts is None \
            else int(max_attempts)
        self.exp_cap = int(exp_cap)
        self.jitter = bool(jitter)
        self._rng = random.Random(jitter_key or None)

    # -- the per-plane constants ----------------------------------------------

    @classmethod
    def for_training_client(cls, base: float = 0.25, cap: float = 5.0,
                            max_attempts: Optional[int] = 8,
                            jitter_key: str = "") -> "RetryPolicy":
        """The training client's reconnect curve: base 0.25s
        doubling to a 5s cap, exponent capped at 16, jittered per
        slave."""
        return cls(base, cap, max_attempts, exp_cap=16,
                   jitter_key=jitter_key)

    @classmethod
    def for_relay_upstream(cls, max_attempts: Optional[int] = 8,
                           jitter_key: str = "") -> "RetryPolicy":
        """The relay's upstream curve: base 0.05s
        doubling to a 2s cap, exponent capped at 5, jittered per
        relay."""
        return cls(0.05, 2.0, max_attempts, exp_cap=5,
                   jitter_key=jitter_key)

    @classmethod
    def for_breaker(cls, reset_s: float = 0.5,
                    cap_s: float = 30.0) -> "RetryPolicy":
        """The serving client's breaker backoff:
        ``reset_s`` doubling to ``cap_s``, no jitter."""
        return cls(reset_s, cap_s, None, exp_cap=16, jitter=False)

    def delay(self, failures: int) -> float:
        return min(self.cap,
                   self.base * (2 ** min(max(0, int(failures) - 1),
                                         self.exp_cap)))

    def jittered(self, failures: int) -> float:
        d = self.delay(failures)
        return d * (0.5 + self._rng.random()) if self.jitter else d

    def sleep(self, failures: int) -> float:
        """Back off for the n-th consecutive failure; returns the
        slept delay."""
        d = self.jittered(failures)
        time.sleep(d)
        return d

    def spent(self, failures: int) -> bool:
        return (self.max_attempts is not None
                and int(failures) > self.max_attempts)


class CircuitBreaker:
    """Rolling-outcome-window circuit breaker: ``record(token, ok)``
    files outcomes; once the recent window holds >= ``threshold``
    failures the breaker OPENS and ``admit()`` raises
    :class:`CircuitOpenError` until the :class:`RetryPolicy` backoff
    expires, when exactly ONE half-open probe is admitted
    (``arm_probe(token)`` marks it; its outcome closes or re-opens the
    breaker).  ``threshold=0`` disables — every method is a cheap no-op,
    so planes toggle the feature per config without code forks.

    ``on_event(name)`` receives ``"open"`` / ``"short_circuit"`` /
    ``"probe"`` so each plane counts transitions in its own
    counters.  Thread-safe: one lock guards all state (the training
    client's prefetcher thread shares the main loop's breaker), and
    ``admit()`` RESERVES the half-open probe slot atomically — two
    threads racing past the backoff cannot both send a probe (the
    winner arms via :meth:`arm_probe`; a caller whose send dies
    between admit and arm must :meth:`release_probe`).

    ``consecutive=True`` trips on ``threshold`` failures IN A ROW
    instead of threshold-among-window — the training client's
    reconnect semantics (any success resets the count), so
    a sustained-but-survivable fault rate keeps making progress and
    only a DEAD peer opens the breaker.  The serving client keeps the
    density semantics."""

    #: reservation sentinel: admit() holds the half-open probe slot
    #: with this until arm_probe()/release_probe() resolves it
    _RESERVED = object()

    def __init__(self, window: int = 16, threshold: int = 8,
                 backoff: Optional[RetryPolicy] = None,
                 on_event: Optional[Callable[[str], None]] = None,
                 peer: str = "", consecutive: bool = False):
        import collections

        self._outcomes = collections.deque(maxlen=max(int(window), 1))
        #: rolling-window length (readable: sibling windows — the
        #: serving client's per-replica tables — size themselves off it)
        self.window = self._outcomes.maxlen
        # clamp: a threshold above the window could never be reached
        # (count(False) <= maxlen) — the breaker would be silently
        # disarmed while the operator believes it is armed
        self.threshold = min(int(threshold), self.window)
        self.backoff = backoff or RetryPolicy.for_breaker()
        self.peer = peer
        self.consecutive = bool(consecutive)
        self._on_event = on_event or (lambda name: None)
        self._lock = threading.Lock()
        self._state = "closed"
        self._until = 0.0
        self._opens = 0                 # consecutive opens: backoff curve
        self._streak = 0                # consecutive failures (mode above)
        self._probe: Optional[object] = None

    @property
    def state(self) -> str:
        """``closed`` / ``open`` / ``half_open`` (open flips to
        half_open lazily, at the first post-backoff admit)."""
        with self._lock:
            return self._state

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    @property
    def probe(self):
        """The armed half-open probe's token (None when none or merely
        reserved) — owners that must exempt the probe from other
        accounting key on it."""
        with self._lock:
            return None if self._probe is self._RESERVED \
                else self._probe

    def failure_counts(self):
        """(failures, window length) of the rolling window."""
        with self._lock:
            return self._outcomes.count(False), len(self._outcomes)

    def remaining(self) -> float:
        """Seconds until the next half-open probe is admitted (0 when
        not open) — what a retrying caller sleeps instead of spinning
        on :class:`CircuitOpenError`."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(0.0, self._until - time.perf_counter())

    def admit(self) -> None:
        """Call-side gate: fail fast while open; after the backoff,
        let exactly ONE probe through (half-open).  Passing RESERVES
        the probe slot atomically (two threads racing past the backoff
        cannot both probe); the admitted caller must resolve the
        reservation with :meth:`arm_probe` — or
        :meth:`release_probe` if its send dies first."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self._state == "open":
                now = time.perf_counter()
                if now < self._until:
                    self._on_event("short_circuit")
                    raise CircuitOpenError(
                        f"circuit open to {self.peer}: "
                        f"{self._outcomes.count(False)} failures in the "
                        f"last {len(self._outcomes)} outcomes; next "
                        f"probe in {self._until - now:.2f}s")
                self._state = "half_open"
                self._probe = None
            if self._state == "half_open":
                if self._probe is not None:
                    self._on_event("short_circuit")
                    raise CircuitOpenError(
                        f"circuit half-open to {self.peer}: probe "
                        f"still in flight")
                self._probe = self._RESERVED

    def arm_probe(self, token) -> bool:
        """Mark ``token`` as the half-open probe (resolving
        ``admit()``'s reservation); True when it was armed."""
        if self.threshold <= 0:
            return False
        with self._lock:
            if self._state == "half_open" \
                    and self._probe is self._RESERVED:
                self._probe = token
                self._on_event("probe")
                return True
        return False

    def release_probe(self) -> None:
        """Release an UNARMED reservation (the caller's send failed
        between admit and arm — no probe ever hit the wire, so the
        slot must not stay wedged)."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self._probe is self._RESERVED:
                self._probe = None

    def _open(self) -> None:
        # caller holds the lock
        self._state = "open"
        self._opens += 1
        self._until = time.perf_counter() + self.backoff.delay(
            self._opens)
        self._on_event("open")
        # the journal's breaker_open transition with the numbers that
        # drove it (on_event above only counts)
        from znicz_torch import telemetry

        telemetry.emit(
            "breaker_open", "transport", peer=self.peer,
            failures=self._outcomes.count(False),
            window=len(self._outcomes), opens=self._opens,
            backoff_s=round(self._until - time.perf_counter(), 3))

    def record(self, token, ok: bool) -> None:
        """File one outcome.  The armed probe's outcome closes (window
        cleared, backoff reset) or re-opens (doubled backoff) the
        breaker; ordinary outcomes feed the rolling window (density
        mode) or the failure streak (``consecutive`` mode)."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self._state == "half_open" and token is not None \
                    and token == self._probe:
                self._probe = None
                if ok:
                    self._state = "closed"
                    self._outcomes.clear()
                    self._streak = 0
                    self._opens = 0
                else:
                    self._open()
                return
            self._outcomes.append(bool(ok))
            self._streak = 0 if ok else self._streak + 1
            if self._state != "closed":
                return
            tripped = (self._streak >= self.threshold
                       if self.consecutive
                       else (len(self._outcomes) >= self.threshold
                             and self._outcomes.count(False)
                             >= self.threshold))
            if tripped:
                self._open()

"""Admission primitives shared by every ingress (port of
``znicz_tpu/transport/admission.py``).

:class:`TokenBucket` is the serving batcher's per-client rate limiter.
:class:`AdmissionTable` is the bounded per-peer bucket table: buckets
built lazily, a lossless sweep of refilled-to-capacity buckets (one is
indistinguishable from a fresh one) at the bound, oldest-first eviction
past it.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict


class TokenBucket:
    """Per-client rate limiter: ``rate`` units/s refill into a bucket of
    ``burst`` capacity; a submit takes its unit count or is refused."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = time.perf_counter()

    def try_take(self, n: int) -> bool:
        now = time.perf_counter()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def refund(self, n: int) -> None:
        """Return ``n`` taken tokens (a later admission stage refused the
        request): a shed must not also burn the client's rate budget."""
        self.tokens = min(self.burst, self.tokens + n)

    def is_full(self, now: float) -> bool:
        """True when the bucket has refilled to capacity (the state of a
        fresh bucket)."""
        return min(self.burst,
                   self.tokens + (now - self.t_last) * self.rate) \
            >= self.burst


class AdmissionTable:
    """Bounded ``{peer_id: TokenBucket}``: ``try_take`` builds buckets
    lazily; at the bound full buckets are swept first, then the oldest
    entry goes (a returning peer gets a fresh full bucket)."""

    def __init__(self, rate: float, burst: float = 0.0,
                 max_peers: int = 4096):
        self.rate = float(rate)
        #: 0 = auto: one second of the sustained rate
        self.burst = float(burst) if burst else max(self.rate, 1.0)
        self.max_peers = int(max_peers)
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()

    @property
    def enabled(self) -> bool:
        return self.rate > 0.0

    def try_take(self, peer: str, n: int = 1) -> bool:
        """True when ``peer`` may pass ``n`` units now; always True while
        the limiter is off (rate <= 0)."""
        if not self.enabled:
            return True
        bucket = self._buckets.get(peer)
        if bucket is None:
            if len(self._buckets) >= self.max_peers:
                now = time.perf_counter()
                full = [p for p, b in self._buckets.items()
                        if b.is_full(now)]
                for p in full:
                    del self._buckets[p]
                while len(self._buckets) >= self.max_peers:
                    self._buckets.popitem(last=False)
            bucket = self._buckets[peer] = TokenBucket(self.rate,
                                                       self.burst)
        return bucket.try_take(n)

    def refund(self, peer: str, n: int) -> None:
        """Return ``n`` taken units (a later stage refused the request); a
        no-op for an unknown or swept peer."""
        bucket = self._buckets.get(peer)
        if bucket is not None:
            bucket.refund(n)

    def snapshot(self) -> Dict[str, float]:
        """{peer: tokens remaining}."""
        return {p: round(b.tokens, 2) for p, b in self._buckets.items()}

    def __len__(self) -> int:
        return len(self._buckets)

"""The transport core of the port (port of ``znicz_tpu/transport/``): the
one event loop and client fault model the ZMQ planes ride.

  - :class:`TransportLoop` (core.py): poller-driven ROUTER/PULL/DEALER
    dispatch, bind conventions, idle ticks, per-plane message counts and
    the ingress fault hook;
  - :class:`RetryPolicy` / :class:`CircuitBreaker` (retry.py): the one
    backoff curve and the rolling-window breaker, each plane's constants
    kept;
  - :class:`Endpoint` (endpoint.py): fresh-socket reconnect,
    resend-same-bytes, breaker fail-fast and the deadline-budget helpers
    of a REQ-style client link;
  - :class:`TokenBucket` / :class:`AdmissionTable` (admission.py): the
    per-peer admission primitive.
"""

from .admission import AdmissionTable, TokenBucket        # noqa: F401
from .core import (TransportLoop, bad_frame_reply,        # noqa: F401
                   corrupt_message, corrupt_payload)
from .endpoint import (BadReply, Endpoint, PeerTimeout,   # noqa: F401
                       TransportFault, local_deadline, remaining_ms)
from .retry import (CircuitBreaker, CircuitOpenError,     # noqa: F401
                    RetryPolicy)

__all__ = ["AdmissionTable", "TokenBucket", "TransportLoop",
           "bad_frame_reply", "corrupt_message", "corrupt_payload",
           "BadReply", "Endpoint", "PeerTimeout", "TransportFault",
           "local_deadline", "remaining_ms", "CircuitBreaker",
           "CircuitOpenError", "RetryPolicy"]

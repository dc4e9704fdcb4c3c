"""Live plot streaming (port of ``znicz_tpu/graphics.py``).

Plotters stream their data snapshots, not figures: a client re-renders
each with the plotter class's own ``draw``, the renderer the offline
path uses, so a figure kind has one renderer.

  - :class:`GraphicsServer`: the process-wide XPUB publisher.  XPUB
    sees the subscription handshakes, so :meth:`~GraphicsServer.
    wait_for_subscribers` can wait out pub/sub's slow joiner.
  - :class:`GraphicsClient`: a SUB loop rendering payloads to PNGs in a
    directory; ``python -m znicz_torch.graphics <endpoint> <outdir>``.
  - ``plotting_units.Plotter.run`` publishes whenever a server is
    active, and renders offline otherwise.

A payload is a pickled dict ``{"kind": "figure", "cls": <Plotter
subclass name>, "name": <unit name>, "data": {...}}``; ``{"kind":
"end"}`` ends a client.  Payloads are pickles, so the client takes them
from a loopback endpoint only, unless told otherwise.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

_server: Optional["GraphicsServer"] = None


class GraphicsServer:
    """XPUB publisher of plotter snapshots; :meth:`start` installs the
    process-wide instance the plotters publish to."""

    def __init__(self, endpoint: str = "tcp://127.0.0.1:*"):
        import zmq

        from znicz_torch.network_common import bind_with_retry

        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.XPUB)
        bind_with_retry(self._sock, endpoint)
        self.endpoint = self._sock.getsockopt_string(zmq.LAST_ENDPOINT)
        self._subscribers = 0
        self.published = 0

    # -- lifecycle -------------------------------------------------------------

    @classmethod
    def start(cls, endpoint: str = "tcp://127.0.0.1:*") -> "GraphicsServer":
        global _server
        if _server is None:
            _server = cls(endpoint)
        return _server

    @classmethod
    def active(cls) -> Optional["GraphicsServer"]:
        return _server

    @classmethod
    def stop(cls) -> None:
        global _server
        if _server is not None:
            _server.publish({"kind": "end"})
            _server.close()
            _server = None

    def close(self) -> None:
        self._sock.close(linger=500)

    # -- the publishing side ---------------------------------------------------

    def _pump_subscriptions(self, timeout_ms: int = 0) -> None:
        import zmq

        while self._sock.poll(timeout_ms, zmq.POLLIN):
            msg = self._sock.recv()
            if msg[:1] == b"\x01":
                self._subscribers += 1
            elif msg[:1] == b"\x00":
                self._subscribers -= 1
            timeout_ms = 0

    def wait_for_subscribers(self, n: int = 1, timeout: float = 10.0) -> bool:
        """Block until at least ``n`` subscribers joined; False when
        ``timeout`` seconds passed first."""
        deadline = time.monotonic() + timeout
        while self._subscribers < n:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            self._pump_subscriptions(int(left * 1000))
        return True

    def publish(self, payload: dict) -> None:
        self._pump_subscriptions()
        self._sock.send(pickle.dumps(payload, pickle.HIGHEST_PROTOCOL))
        self.published += 1


def _is_loopback(endpoint: str) -> bool:
    """True for ``ipc://`` and ``inproc://`` endpoints and ``tcp://`` on a
    loopback host."""
    from znicz_torch.network_common import is_loopback_host

    if endpoint.startswith(("ipc://", "inproc://")):
        return True
    if endpoint.startswith("tcp://"):
        return is_loopback_host(
            endpoint[len("tcp://"):].rsplit(":", 1)[0].strip("[]"))
    return False


class GraphicsClient:
    """Receives plotter snapshots and renders PNGs with the plotter
    classes' own ``draw``."""

    def __init__(self, endpoint: str, out_dir: str,
                 allow_remote: bool = False):
        import zmq

        # unpickling a payload from another host would run its code
        if not allow_remote and not _is_loopback(endpoint):
            raise ValueError(
                f"GraphicsClient endpoint {endpoint!r} is not loopback; "
                "payloads are pickled (code-execution risk from untrusted "
                "publishers). Pass allow_remote=True only for trusted hosts.")
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.SUB)
        self._sock.connect(endpoint)
        self._sock.setsockopt(zmq.SUBSCRIBE, b"")
        self.received = 0

    def render(self, payload: dict) -> Optional[str]:
        from znicz_torch import plotting_units

        cls = getattr(plotting_units, payload["cls"], None)
        if not isinstance(cls, type) or \
                not issubclass(cls, plotting_units.Plotter):
            return None
        path = os.path.join(self.out_dir, f"{payload['name']}.png")
        cls.render_png(payload["data"], path)
        return path

    def run(self, max_figures: int = 0, timeout: float = 0.0,
            idle_timeout: Optional[float] = None) -> int:
        """Render until the ``end`` payload, ``max_figures`` figures or
        ``timeout`` seconds; returns the figures rendered.
        ``idle_timeout`` bounds each wait, so the client ends when its
        publisher died without the ``end`` payload: 600 s when no
        ``timeout`` is given, else off (0 is never)."""
        import zmq

        if idle_timeout is None:
            idle_timeout = 0.0 if timeout else 600.0
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            wait = idle_timeout if idle_timeout else None
            if deadline is not None:
                left = deadline - time.monotonic()
                wait = left if wait is None else min(left, wait)
            if wait is not None and (
                    wait <= 0
                    or not self._sock.poll(int(wait * 1000), zmq.POLLIN)):
                break
            payload = pickle.loads(self._sock.recv())
            if payload.get("kind") == "end":
                break
            if payload.get("kind") == "figure":
                if self.render(payload) is not None:
                    self.received += 1
                    if max_figures and self.received >= max_figures:
                        break
        return self.received

    def close(self) -> None:
        self._sock.close(linger=0)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m znicz_torch.graphics",
        description="live graphics client: renders a GraphicsServer's "
                    "plots into a directory")
    parser.add_argument("endpoint")
    parser.add_argument("out_dir")
    parser.add_argument("--max-figures", type=int, default=0)
    parser.add_argument("--timeout", type=float, default=0.0)
    parser.add_argument("--idle-timeout", type=float, default=None,
                        help="end after this long with no message "
                             "(default: 600 without --timeout, else off; "
                             "0 = never)")
    args = parser.parse_args(argv)
    client = GraphicsClient(args.endpoint, args.out_dir)
    try:
        count = client.run(max_figures=args.max_figures,
                           timeout=args.timeout,
                           idle_timeout=args.idle_timeout)
    finally:
        client.close()
    print(f"rendered {count} figures -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""ZMQ socket conventions shared by every plane of the port (port of
``bind_with_retry``, ``make_poller`` and ``is_loopback_host`` of
``znicz_tpu/network_common.py``).  The workflow digest and the training
handshake come with the distributed training plane (ROADMAP A.7)."""

from __future__ import annotations

import time


def bind_with_retry(sock, endpoint: str, attempts: int = 40,
                    delay_s: float = 0.05) -> None:
    """Bind a ZMQ socket, retrying only the EADDRINUSE race a restarted
    peer has with its predecessor's port release; any other bind error is
    permanent and raises at once."""
    import zmq

    for attempt in range(attempts):
        try:
            sock.bind(endpoint)
            return
        except zmq.error.ZMQError as exc:
            if exc.errno != zmq.EADDRINUSE or attempt == attempts - 1:
                raise
            time.sleep(delay_s)


def make_poller(*sockets):
    """A ``zmq.Poller`` with every socket registered POLLIN (the
    transport loop's registration convention)."""
    import zmq

    poller = zmq.Poller()
    for sock in sockets:
        poller.register(sock, zmq.POLLIN)
    return poller


def is_loopback_host(host: str) -> bool:
    """The loopback guard for services that take pickled payloads."""
    return host in ("127.0.0.1", "localhost", "::1", "0.0.0.0")

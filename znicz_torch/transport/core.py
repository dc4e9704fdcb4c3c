"""The transport loop (port of ``znicz_tpu/transport/core.py``).

Every ZMQ plane has one shape: create sockets, bind with the EADDRINUSE
retry, register them POLLIN, then loop {poll -> drain ready sockets ->
idle ticks} until told to stop.  :class:`TransportLoop` is that shape:
the poller, the socket factories, the dispatch order, the ticks, the
plane's message count and the ingress fault hook.

:func:`bad_frame_reply` is the one home of the ``bad_frame`` refusal
payload every plane answers undecodable traffic with.

Fault injection: ``inject_faults(schedule)`` takes any object with
``decide_transport(i) -> (action, _)`` and a ``seed``; each inbound
message gets one decision: ``drop`` discards it, ``corrupt`` mutates one
payload frame (never the routing envelope) so the plane's own refusal
path answers.  On a lockstep REP socket a drop would wedge the state
machine, so drops become corrupts there.  Faults are counted per action
(:meth:`TransportLoop.fault_counts`).

Telemetry: the message and fault counts are the ``transport`` scope's
``transport_messages`` and ``transport_faults`` series, labelled by
``plane`` (and ``instance``: a bind, endpoint or replica id, so two
loops of one plane in one process do not shadow each other's series).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional


def bad_frame_reply(exc) -> dict:
    """The shared ``bad_frame`` refusal payload."""
    return {"ok": False, "bad_frame": True, "error": f"bad frame: {exc}"}


def corrupt_payload(payload: bytes) -> bytes:
    """Deterministic frame corruption: truncate to a third and flip the
    first byte (a torn pickle, or a tensor frame whose length no longer
    matches its manifest entry); an empty frame grows a poison byte."""
    if not payload:
        return b"\xff"
    cut = max(1, len(payload) // 3)
    head = bytearray(payload[:cut])
    head[0] ^= 0xFF
    return bytes(head)


def corrupt_message(frames: List[bytes], pick_seed) -> List[bytes]:
    """Corrupt exactly one payload frame of a multipart message, picked
    as a pure function of ``pick_seed``, never the routing envelope, so a
    refusal can still be routed back."""
    import numpy as np

    from znicz_torch.parallel.wire import split_envelope

    envelope, payload = split_envelope(frames)
    if not payload:                     # nothing to corrupt
        return frames
    pick = int(np.random.default_rng(pick_seed).integers(len(payload)))
    payload[pick] = corrupt_payload(payload[pick])
    return envelope + payload


class _Entry:
    """One registered socket: its handler and dispatch discipline."""

    __slots__ = ("sock", "handler", "reply", "drain", "priority", "seq")

    def __init__(self, sock, handler, reply: bool, drain: bool,
                 priority: int, seq: int):
        self.sock = sock
        self.handler = handler
        self.reply = reply              # REP lockstep: send handler()'s
        self.drain = drain              # NOBLOCK-drain all queued msgs
        self.priority = priority
        self.seq = seq


class TransportLoop:
    """Poller-driven serve loop every plane rides::

        loop = TransportLoop("serving", stop=stop_event)
        sock = loop.bind_router(endpoint)
        loop.register(sock, handler, drain=True)
        loop.add_tick(idle_fn)
        loop.run(poll_ms=5)             # blocks until stop()
        loop.close()                    # in the caller's finally

    Handlers receive the raw multipart frame list.  ``reply=True`` is REP
    lockstep: the handler returns the reply frames and the loop sends
    them.  ``drain=True`` NOBLOCK-drains every queued message a wake
    (ROUTER/DEALER); such handlers send their own replies.  ``priority``
    orders dispatch within one wake (lower first).  Sockets may be
    registered and unregistered while the loop runs.  One thread runs
    the loop and owns its sockets."""

    def __init__(self, plane: str,
                 stop: Optional[threading.Event] = None,
                 instance: str = ""):
        self.plane = str(plane)
        self.instance = str(instance)
        self._stop = stop if stop is not None else threading.Event()
        self._entries: List[_Entry] = []
        self._ticks: List[Callable[[], None]] = []
        self._poller = None
        self._ctx = None
        self._owned: List[object] = []      # sockets this loop created
        self._seq = 0
        self._chaos = None
        self._chaos_no = 0
        from znicz_torch import telemetry

        labels = {"plane": self.plane}
        if instance:
            labels["instance"] = self.instance
        _sc = telemetry.scope("transport")
        self._m_messages = _sc.counter(
            "transport_messages",
            "messages dispatched by the transport loop", **labels)
        self._m_faults: Dict[str, object] = {
            action: _sc.counter(
                "transport_faults", "ingress faults injected by the "
                "transport loop's built-in hook", action=action,
                **labels)
            for action in ("drop", "corrupt")}

    # -- socket factories ------------------------------------------------------

    def _context(self):
        import zmq

        if self._ctx is None:
            self._ctx = zmq.Context.instance()
        return self._ctx

    def _bound(self, kind: int, endpoint: str):
        import zmq

        from znicz_torch.network_common import bind_with_retry

        sock = self._context().socket(kind)
        sock.setsockopt(zmq.LINGER, 0)
        try:
            bind_with_retry(sock, endpoint)
        except Exception:
            sock.close(0)
            raise
        self._owned.append(sock)
        return sock

    def _connected(self, kind: int, endpoint: str):
        import zmq

        sock = self._context().socket(kind)
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(endpoint)
        self._owned.append(sock)
        return sock

    def bind_rep(self, endpoint: str):
        import zmq

        return self._bound(zmq.REP, endpoint)

    def bind_router(self, endpoint: str):
        import zmq

        return self._bound(zmq.ROUTER, endpoint)

    def bind_pull(self, endpoint: str):
        import zmq

        return self._bound(zmq.PULL, endpoint)

    def connect_dealer(self, endpoint: str):
        import zmq

        return self._connected(zmq.DEALER, endpoint)

    @staticmethod
    def resolved_endpoint(sock) -> str:
        """The concrete address of a (possibly wildcard) bind."""
        import zmq

        return sock.getsockopt(zmq.LAST_ENDPOINT).decode()

    # -- registration ----------------------------------------------------------

    def register(self, sock, handler, *, reply: bool = False,
                 drain: bool = False, priority: int = 100) -> None:
        self._seq += 1
        self._entries.append(_Entry(sock, handler, reply, drain,
                                    priority, self._seq))
        self._entries.sort(key=lambda e: (e.priority, e.seq))
        if self._poller is not None:
            import zmq

            self._poller.register(sock, zmq.POLLIN)

    def unregister(self, sock, close: bool = True) -> None:
        self._entries = [e for e in self._entries if e.sock is not sock]
        if self._poller is not None:
            self._poller.unregister(sock)
        if close:
            sock.close(0)
            if sock in self._owned:
                self._owned.remove(sock)

    def add_tick(self, fn: Callable[[], None]) -> None:
        """Idle work run once a lap after socket dispatch (a tick may
        call :meth:`stop`)."""
        self._ticks.append(fn)

    # -- the ingress fault hook -------------------------------------------------

    def inject_faults(self, schedule) -> None:
        """Install a fault hook: every inbound message gets one
        ``schedule.decide_transport(i)`` decision.  ``None`` uninstalls."""
        self._chaos = schedule
        self._chaos_no = 0

    @property
    def messages(self) -> int:
        """Messages dispatched by this loop."""
        return int(self._m_messages.value)

    def fault_counts(self) -> Dict[str, int]:
        """{action: count} injected by the hook on this loop."""
        return {action: int(c.value)
                for action, c in self._m_faults.items()}

    def _apply_chaos(self, frames: List[bytes],
                     entry: _Entry) -> Optional[List[bytes]]:
        """One ingress decision; None = message dropped."""
        if self._chaos is None:
            return frames
        i = self._chaos_no
        self._chaos_no += 1
        action, _ = self._chaos.decide_transport(i)
        if action == "drop" and entry.reply:
            action = "corrupt"          # a REP drop would wedge lockstep
        if action == "drop":
            self._m_faults["drop"].inc()
            return None
        if action == "corrupt":
            self._m_faults["corrupt"].inc()
            return corrupt_message(frames,
                                   (self._chaos.seed, i, 0xC0DE))
        return frames

    # -- lifecycle -------------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    @property
    def stopping(self) -> bool:
        return self._stop.is_set()

    def run(self, poll_ms: int = 20,
            timeout_fn: Optional[Callable[[], int]] = None) -> None:
        """Blocks until :meth:`stop` (or the shared stop event).  One lap
        = poll (``timeout_fn()`` ms when given, else ``poll_ms``) ->
        dispatch ready sockets in priority order -> run ticks."""
        import zmq

        from znicz_torch.network_common import make_poller

        self._poller = make_poller(*[e.sock for e in self._entries])
        try:
            while not self._stop.is_set():
                timeout = timeout_fn() if timeout_fn is not None \
                    else poll_ms
                events = dict(self._poller.poll(timeout))
                if events:
                    for entry in list(self._entries):
                        if entry.sock not in events:
                            continue
                        if entry.reply:
                            self._dispatch_rep(entry)
                        elif entry.drain:
                            while True:
                                try:
                                    frames = entry.sock.recv_multipart(
                                        zmq.NOBLOCK)
                                except zmq.Again:
                                    break
                                self._dispatch(entry, frames)
                        else:
                            self._dispatch(
                                entry, entry.sock.recv_multipart())
                for tick in self._ticks:
                    tick()
        finally:
            self._poller = None

    def _dispatch_rep(self, entry: _Entry) -> None:
        """REP lockstep: recv one message, send the handler's reply."""
        frames = entry.sock.recv_multipart()
        self._m_messages.inc()
        frames = self._apply_chaos(frames, entry)
        entry.sock.send_multipart(entry.handler(frames), copy=False)

    def _dispatch(self, entry: _Entry, frames: List[bytes]) -> None:
        self._m_messages.inc()
        frames = self._apply_chaos(frames, entry)
        if frames is not None:
            entry.handler(frames)

    def close(self, linger_ms: int = 0) -> None:
        """Close every socket this loop's factories created, giving queued
        outgoing messages ``linger_ms`` to leave (idempotent)."""
        for sock in self._owned:
            sock.close(linger_ms)
        self._owned = []
        self._entries = []

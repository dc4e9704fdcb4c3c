"""A loader fed by another process over ZeroMQ (port of
``znicz_tpu/loader/zmq_loader.py``): a loader-like unit that PULLs
pickled minibatch dicts from a socket, for pipelines where another
process produces the data.

A message is a pickled dict ``{"data": ndarray, "labels": ndarray|None,
"class": 0|1|2, "size": int, "last": bool}`` with the optional
``class_ended`` and ``class_lengths``; ``{"end": True}`` ends the stream
(``finished``).  The socket is created at ``initialize``: with ``bind``
it binds ``endpoint`` (a wildcard port is resolved into
:attr:`ZeroMQLoader.endpoint`), else it connects to it.  A feeder silent
for ``recv_timeout`` seconds raises instead of blocking forever.
"""

from __future__ import annotations

import pickle

from znicz_torch.core.units import Unit
from znicz_torch.loader.base import TRAIN
from znicz_torch.memory import Array


class ZeroMQLoader(Unit):
    def __init__(self, workflow=None, name=None,
                 endpoint: str = "tcp://127.0.0.1:*", bind: bool = True,
                 recv_timeout: float = 30.0, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.endpoint = endpoint
        self.bind = bool(bind)
        self.recv_timeout = float(recv_timeout)
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_class = TRAIN
        self.minibatch_size = 0
        self.last_minibatch = False
        # the loader attributes a Decision links (a stream's class
        # lengths are unknown until a sender names them)
        self.class_ended = False
        self.epoch_ended = False
        self.epoch_number = 0
        self.class_lengths = [0, 0, 0]
        self.finished = False
        self._socket = None

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        import zmq

        from znicz_torch.network_common import bind_with_retry

        self._socket = zmq.Context.instance().socket(zmq.PULL)
        self._socket.setsockopt(zmq.RCVTIMEO, int(self.recv_timeout * 1000))
        self._socket.setsockopt(zmq.LINGER, 0)
        if self.bind:
            bind_with_retry(self._socket, self.endpoint)
            self.endpoint = self._socket.getsockopt(
                zmq.LAST_ENDPOINT).decode()
        else:
            self._socket.connect(self.endpoint)
        for arr in (self.minibatch_data, self.minibatch_labels):
            arr.initialize(device)

    def run(self):
        import zmq

        if self.last_minibatch:
            self.epoch_number += 1
            self.last_minibatch = False
        self.epoch_ended = False
        try:
            msg = self._socket.recv()
        except zmq.Again:
            raise RuntimeError(
                f"{self.name}: no minibatch from {self.endpoint} within "
                f"{self.recv_timeout}s — feeder process dead or absent")
        rec = pickle.loads(msg)
        if rec.get("end"):
            self.finished = True
            self.last_minibatch = True
            self.epoch_ended = True
            self.class_ended = True
            return
        self.minibatch_data.mem = rec["data"]
        if rec.get("labels") is not None:
            self.minibatch_labels.mem = rec["labels"]
        self.minibatch_class = int(rec.get("class", TRAIN))
        self.minibatch_size = int(rec.get("size", len(rec["data"])))
        self.last_minibatch = bool(rec.get("last", False))
        self.class_ended = bool(rec.get("class_ended", self.last_minibatch))
        self.epoch_ended = self.last_minibatch
        if rec.get("class_lengths") is not None:
            self.class_lengths = [int(x) for x in rec["class_lengths"]]

    def stop(self):
        if self._socket is not None:
            self._socket.close(0)
            self._socket = None

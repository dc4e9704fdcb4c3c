"""Minibatch stream capture and replay (port of
``znicz_tpu/loader/saver.py``).

:class:`MinibatchesSaver`, a unit linked after a loader, appends every
minibatch it is run on (data, labels, class, size) to a gzip pickle
stream; :class:`MinibatchesLoader` replays such a stream with a loader's
attributes, so that units link to it as to the loader it recorded.  The
records hold numpy arrays only, labels as int32, as the reference's
loaders hold them, so either package reads the other's files.
"""

from __future__ import annotations

import gzip
import pickle
from typing import List, Optional

import numpy as np

from znicz_torch.core.units import Unit
from znicz_torch.loader.base import TRAIN
from znicz_torch.memory import Array


class MinibatchesSaver(Unit):
    """Link ``minibatch_data``, ``minibatch_labels``, ``minibatch_class``
    and ``minibatch_size`` from a loader; the stream is closed by
    :meth:`stop`."""

    def __init__(self, workflow=None, name: str = "saver",
                 file_path: str = "minibatches.pgz", **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.file_path = file_path
        self.minibatch_data: Optional[Array] = None
        self.minibatch_labels: Optional[Array] = None
        self.minibatch_class = TRAIN
        self.minibatch_size = 0
        self._file = None

    def initialize(self, **kwargs) -> None:
        super().initialize(**kwargs)
        self._file = gzip.open(self.file_path, "wb")

    def run(self) -> None:
        labels = self.minibatch_labels
        rec = {
            "data": np.array(self.minibatch_data.map_read()),
            "labels": (np.array(labels.map_read(), np.int32)
                       if labels else None),
            "class": int(self.minibatch_class),
            "size": int(self.minibatch_size),
        }
        pickle.dump(rec, self._file, protocol=pickle.HIGHEST_PROTOCOL)

    def stop(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class MinibatchesLoader(Unit):
    """Replays a saved stream: each run serves the next record as
    ``minibatch_data``/``minibatch_labels`` (labels as int64, the port's
    label dtype) on the device, with ``minibatch_class``,
    ``minibatch_size``, ``class_ended``, ``last_minibatch`` (the stream's
    end, an epoch's) and ``epoch_number``; ``class_lengths`` sums the
    records' sizes per class."""

    def __init__(self, workflow=None, name: str = "loader",
                 file_path: str = "minibatches.pgz", **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.file_path = file_path
        self.records: List[dict] = []
        self._pos = 0
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_class = TRAIN
        self.minibatch_size = 0
        self.last_minibatch = False
        self.class_ended = False
        self.epoch_number = 0
        self.class_lengths = [0, 0, 0]

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(**kwargs)
        self.records = []
        with gzip.open(self.file_path, "rb") as f:
            while True:
                try:
                    self.records.append(pickle.load(f))
                except EOFError:
                    break
        if not self.records:
            raise ValueError(f"{self.name}: empty minibatch stream")
        self.class_lengths = [0, 0, 0]
        for rec in self.records:
            self.class_lengths[rec["class"]] += rec["size"]
        for arr in (self.minibatch_data, self.minibatch_labels):
            arr.initialize(device)

    def run(self) -> None:
        if self.last_minibatch:
            self._pos = 0
            self.epoch_number += 1
            self.last_minibatch = False
        rec = self.records[self._pos]
        self.minibatch_data.mem = rec["data"]
        if rec["labels"] is not None:
            self.minibatch_labels.mem = np.asarray(rec["labels"], np.int64)
        self.minibatch_class = rec["class"]
        self.minibatch_size = rec["size"]
        self._pos += 1
        self.last_minibatch = self._pos == len(self.records)
        nxt = self.records[self._pos] if self._pos < len(self.records) \
            else None
        self.class_ended = nxt is None or nxt["class"] != self.minibatch_class

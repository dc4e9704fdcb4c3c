"""Pickled-array loaders (port of ``znicz_tpu/loader/pickles.py``).

:class:`FullBatchPicklesLoader` takes up to three pickle files (test,
valid, train; ``.gz`` ones gzipped), each holding a ``(data, labels)``
tuple or a dict with ``data`` and ``labels`` arrays, and serves them as
a device-resident full batch."""

from __future__ import annotations

import gzip
import pickle
from typing import Optional

import numpy as np

from znicz_torch.loader.fullbatch import FullBatchLoader


def load_pickle(path: str):
    """(float32 data, int32 labels) of one pickle file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict):
        data, labels = obj["data"], obj["labels"]
    else:
        data, labels = obj
    return np.asarray(data, np.float32), np.asarray(labels, np.int32)


class FullBatchPicklesLoader(FullBatchLoader):
    def __init__(self, workflow=None, name: str = "loader",
                 test_pickle: Optional[str] = None,
                 valid_pickle: Optional[str] = None,
                 train_pickle: Optional[str] = None, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.test_pickle = test_pickle
        self.valid_pickle = valid_pickle
        self.train_pickle = train_pickle

    def load_data(self):
        if not self.train_pickle:
            raise ValueError(f"{self.name}: train_pickle required")
        splits = [load_pickle(p) if p else None for p in
                  (self.test_pickle, self.valid_pickle, self.train_pickle)]
        sample_shape = splits[2][0].shape[1:]
        splits = [s if s is not None else
                  (np.zeros((0,) + sample_shape, np.float32),
                   np.zeros(0, np.int32)) for s in splits]
        self.original_data = np.concatenate([d for d, _ in splits], axis=0)
        self.original_labels = np.concatenate([lab for _, lab in splits],
                                              axis=0)
        self.class_lengths = [len(d) for d, _ in splits]
        super().load_data()

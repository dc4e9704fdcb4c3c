"""FullBatchLoader: the whole dataset resident on the device, minibatches
gathered by index (port of ``znicz_tpu/loader/fullbatch.py``).

Subclasses set ``original_data`` / ``original_labels`` (numpy,
sample-major) in ``load_data``, or callers set them before
``initialize``.  ``initialize(device)`` copies both to the device once;
:meth:`gather` takes a minibatch's rows there, as the reference's
``jnp.take`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from znicz_torch.loader.base import Loader


class FullBatchLoader(Loader):
    def __init__(self, name: str = "loader", minibatch_size: int = 100,
                 shuffle: bool = True):
        super().__init__(name=name, minibatch_size=minibatch_size,
                         shuffle=shuffle)
        self.original_data: Optional[np.ndarray] = None
        self.original_labels: Optional[np.ndarray] = None
        #: device copies, set by initialize
        self.data: Optional[torch.Tensor] = None
        self.labels: Optional[torch.Tensor] = None

    def load_data(self) -> None:
        if self.original_data is None:
            raise ValueError(f"{self.name}: original_data not set")
        if sum(self.class_lengths) == 0:
            self.class_lengths = [0, 0, len(self.original_data)]

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return tuple(int(d) for d in self.original_data.shape[1:])

    def initialize(self, device=None) -> None:
        super().initialize(device)
        dev = torch.device("cpu" if device is None else device)
        self.data = torch.from_numpy(
            np.ascontiguousarray(self.original_data)).to(dev)
        if self.original_labels is not None:
            self.labels = torch.from_numpy(np.ascontiguousarray(
                self.original_labels, np.int64)).to(dev)

    def gather(self, idx) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(data rows, label rows) for the index row ``idx`` (numpy or a
        tensor), on the data's device."""
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.data.device)
        return (self.data.index_select(0, idx),
                None if self.labels is None
                else self.labels.index_select(0, idx))

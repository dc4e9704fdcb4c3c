"""FullBatchLoader: the whole dataset resident on the device, minibatches
gathered by index (port of ``znicz_tpu/loader/fullbatch.py``).

Subclasses set ``original_data`` / ``original_labels`` (numpy,
sample-major) in ``load_data``, or callers set them before
``initialize``.  ``initialize(device)`` copies both to the device once and sizes
``minibatch_data`` as the reference's ``create_minibatch_data`` does
(zeros of one full minibatch), so a unit linked to it knows the sample
shape before the first fill;
:meth:`gather` takes a minibatch's rows there, as the reference's
``jnp.take`` does, and :meth:`fill_minibatch` puts them in the
minibatch Arrays.  :class:`FullBatchLoaderMSE` adds per-sample regression
targets (``original_targets``), gathered into ``minibatch_targets`` (and
by :meth:`FullBatchLoaderMSE.gather_targets` for the fused trainer); an
autoencoder's are its input data (``targets_from_data``).

A ``normalizer`` (``znicz_torch.normalization``) is fitted on the TRAIN
rows of ``original_data`` and applied to the whole array in place by
``load_data``, before the device copy, as the reference's does; its
state goes into snapshots (``snapshotter.collect_meta``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from znicz_torch.loader.base import Loader
from znicz_torch.memory import Array


def device_index(idx, device) -> torch.Tensor:
    """The index row ``idx`` (numpy, a list or a tensor) as an int64
    tensor on ``device``."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx, np.int64)).to(device)


class FullBatchLoader(Loader):
    def __init__(self, workflow=None, name: str = "loader",
                 minibatch_size: int = 100, shuffle: bool = True,
                 normalizer=None, **kwargs):
        super().__init__(workflow=workflow, name=name,
                         minibatch_size=minibatch_size, shuffle=shuffle,
                         **kwargs)
        self.normalizer = normalizer
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
        if self.normalizer is not None:
            data = self.original_data
            self.normalizer.fit(data[self.class_end_offsets[1]:])
            self.normalizer.apply_inplace(data)

    def train_labels(self):
        return self.original_labels

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return tuple(int(d) for d in self.original_data.shape[1:])

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        dev = torch.device("cpu" if device is None else device)
        self.data = torch.from_numpy(
            np.ascontiguousarray(self.original_data)).to(dev)
        if self.original_labels is not None:
            self.labels = torch.from_numpy(np.ascontiguousarray(
                self.original_labels, np.int64)).to(dev)
        self.minibatch_data.mem = np.zeros(
            (self.max_minibatch_size,) + self.sample_shape, np.float32)

    def gather(self, idx) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(data rows, label rows) for the index row ``idx`` (numpy or a
        tensor), on the data's device.  A tensor already there is used as
        it is: no copy, no wait on the host."""
        idx = device_index(idx, self.data.device)
        return (self.data.index_select(0, idx),
                None if self.labels is None
                else self.labels.index_select(0, idx))

    def fill_minibatch(self) -> None:
        data, labels = self.gather(self.minibatch_indices)
        self.minibatch_data.devmem = data
        if labels is not None:
            self.minibatch_labels.devmem = labels


class FullBatchLoaderMSE(FullBatchLoader):
    """A full-batch loader with regression targets: ``original_targets``
    (numpy, sample-major, set in ``load_data`` or before ``initialize``),
    or the data itself under ``targets_from_data``, which then shares the
    data's device copy."""

    def __init__(self, workflow=None, name: str = "loader",
                 targets_from_data: bool = False, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.targets_from_data = bool(targets_from_data)
        self.original_targets: Optional[np.ndarray] = None
        self.minibatch_targets = Array()
        self.targets: Optional[torch.Tensor] = None   # the device copy

    def load_data(self) -> None:
        super().load_data()
        if self.original_targets is None:
            if not self.targets_from_data:
                raise ValueError(
                    f"{self.name}: original_targets not set "
                    "(pass targets_from_data=True for autoencoders)")
            self.original_targets = self.original_data

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        self.minibatch_targets.initialize(device)
        self.targets = (self.data if self.original_targets is
                        self.original_data else torch.from_numpy(
                            np.ascontiguousarray(self.original_targets,
                                                 np.float32))
                        .to(self.data.device))

    def gather_targets(self, idx, rows: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """The target rows for the index row ``idx``: ``rows``, the data
        rows just gathered for it, when the targets are the data."""
        if self.targets is self.data and rows is not None:
            return rows
        return self.targets.index_select(
            0, device_index(idx, self.targets.device))

    def fill_minibatch(self) -> None:
        super().fill_minibatch()
        self.minibatch_targets.devmem = self.gather_targets(
            self.minibatch_indices, self.minibatch_data.devmem)

"""The loader's epoch/minibatch index state machine (port of
``znicz_tpu/loader/base.py``, without the unit engine).

  - three sample classes TEST=0, VALID=1, TRAIN=2 with ``class_lengths``;
    one epoch is one pass over test, then valid, then train;
  - minibatches never straddle a class boundary; a class's tail
    minibatch is short (``minibatch_size < max_minibatch_size``) and its
    index row is padded with its last valid index;
  - only the TRAIN segment is reshuffled, once per epoch, from the seeded
    ``loader`` prng stream — the reference's stream, so the order is the
    reference's bit for bit;
  - ``last_minibatch`` marks the end of an epoch, ``class_ended`` the end
    of a class; ``epoch_number`` increments when the next epoch begins.

The fused trainer consumes indices only and gathers rows on the device
(``FullBatchLoader.gather``), so nothing here fills minibatch buffers.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from znicz_torch.core import prng

TEST, VALID, TRAIN = 0, 1, 2


class Loader:
    def __init__(self, name: str = "loader", minibatch_size: int = 100,
                 shuffle: bool = True):
        self.name = name
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle = bool(shuffle)
        self.class_lengths: List[int] = [0, 0, 0]
        self.minibatch_indices = np.zeros(0, np.int32)
        self.minibatch_size = 0
        self.minibatch_class = TRAIN
        self.last_minibatch = False
        self.class_ended = False
        self.epoch_number = 0
        self._shuffled_indices: Optional[np.ndarray] = None
        self._pos = 0

    @property
    def total_samples(self) -> int:
        return int(sum(self.class_lengths))

    @property
    def class_end_offsets(self) -> List[int]:
        ends, acc = [], 0
        for n in self.class_lengths:
            acc += n
            ends.append(acc)
        return ends

    def class_of_offset(self, offset: int) -> int:
        for klass, end in enumerate(self.class_end_offsets):
            if offset < end:
                return klass
        raise ValueError(f"offset {offset} out of range")

    def load_data(self) -> None:
        """Set ``class_lengths`` and the data.  Subclasses override."""
        raise NotImplementedError

    def initialize(self, device=None) -> None:
        self.load_data()
        if self.total_samples == 0:
            raise ValueError(f"{self.name}: empty dataset")
        if self.class_lengths[TRAIN] == 0:
            raise ValueError(f"{self.name}: no TRAIN samples")
        self._shuffled_indices = np.arange(self.total_samples, dtype=np.int32)
        self.minibatch_indices = np.zeros(self.max_minibatch_size, np.int32)
        self._shuffle_train()

    def _shuffle_train(self) -> None:
        start = self.class_end_offsets[VALID]
        if self.shuffle:
            seg = self._shuffled_indices[start:]
            perm = prng.get("loader").permutation(len(seg))
            self._shuffled_indices[start:] = seg[perm]

    def reset(self) -> None:
        """Restart from epoch 0 with a fresh TRAIN shuffle (from the
        ``loader`` stream's current state)."""
        self._pos = 0
        self.epoch_number = 0
        self.last_minibatch = False
        self.class_ended = False
        self.minibatch_size = 0
        self.minibatch_class = TRAIN
        self._shuffled_indices = np.arange(self.total_samples, dtype=np.int32)
        self._shuffle_train()

    def run(self) -> None:
        """Advance to the next minibatch."""
        if self.last_minibatch:
            # the previous call served the epoch tail: begin the next epoch
            self._pos = 0
            self.epoch_number += 1
            self.last_minibatch = False
            self._shuffle_train()
        klass = self.class_of_offset(self._pos)
        class_end = self.class_end_offsets[klass]
        end = min(self._pos + self.max_minibatch_size, class_end)
        count = end - self._pos
        idx = np.empty(self.max_minibatch_size, np.int32)
        chunk = self._shuffled_indices[self._pos:end]
        idx[:count] = chunk
        idx[count:] = chunk[-1] if count else 0   # pad with a valid index
        self.minibatch_indices = idx
        self.minibatch_size = count
        self.minibatch_class = klass
        self.class_ended = (end == class_end)
        self.last_minibatch = (end == self.total_samples)
        self._pos = end

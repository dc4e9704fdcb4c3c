"""Loader: the epoch/minibatch index state machine as a unit (port of
``znicz_tpu/loader/base.py``).

  - three sample classes TEST=0, VALID=1, TRAIN=2 with ``class_lengths``;
    one epoch is one pass over test, then valid, then train;
  - minibatches never straddle a class boundary; a class's tail
    minibatch is short (``minibatch_size < max_minibatch_size``) and its
    index row is padded with its last valid index;
  - only the TRAIN segment is reshuffled, once per epoch, from the seeded
    ``loader`` prng stream — the reference's stream, so the order is the
    reference's bit for bit; with ``native_shuffle`` (the keyword, or
    ``root.common.engine.native_shuffle`` when it is None) by the host
    runtime's xorshift128+ Fisher-Yates shuffle instead
    (``native.XorShift128P``), seeded once from the ``loader`` stream's
    seed, as the reference seeds it;
  - with ``balance_classes`` each epoch's TRAIN segment is then
    resampled from the ``loader.balance`` stream so that every label
    gets an equal share of the slots (:meth:`Loader._balance_train`), for
    a subclass that knows its labels (:meth:`Loader.train_labels`);
  - ``last_minibatch`` marks the end of an epoch, ``class_ended`` the end
    of a class; ``epoch_number`` increments when the next epoch begins.

Each ``run()`` advances to the next minibatch and, unless
``indices_only`` is set (the fused trainer gathers rows itself), fills
``minibatch_data`` and ``minibatch_labels`` (``memory.Array``s) on the
device (:meth:`fill_minibatch`).  ``minibatch_indices`` stays a numpy
row.

Unlike the reference, which shuffles with numpy when the host runtime
does not build, a ``native_shuffle`` loader raises ``RuntimeError``
then: the training order would otherwise change without a word.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from znicz_torch.core import prng
from znicz_torch.core.config import root
from znicz_torch.core.units import Unit
from znicz_torch.memory import Array

TEST, VALID, TRAIN = 0, 1, 2


class Loader(Unit):
    def __init__(self, workflow=None, name: str = "loader",
                 minibatch_size: int = 100, shuffle: bool = True,
                 balance_classes: bool = False, native_shuffle=None,
                 **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle = bool(shuffle)
        self.balance_classes = bool(balance_classes)
        #: True/False, or None to follow root.common.engine.native_shuffle
        self.native_shuffle = native_shuffle
        self._native_rng = None
        self.class_lengths: List[int] = [0, 0, 0]
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_indices = np.zeros(0, np.int32)
        self.minibatch_size = 0
        self.minibatch_class = TRAIN
        self.last_minibatch = False
        self.class_ended = False
        self.epoch_number = 0
        self.samples_served = 0
        #: samples served per class since construction (run statistics)
        self.class_samples_served = [0, 0, 0]
        #: advance the indices only; the fused trainer gathers the rows
        self.indices_only = False
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

    def fill_minibatch(self) -> None:
        """Fill ``minibatch_data``/``minibatch_labels`` for the current
        ``minibatch_indices``.  Subclasses override."""
        raise NotImplementedError

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(**kwargs)
        self.load_data()
        if self.total_samples == 0:
            raise ValueError(f"{self.name}: empty dataset")
        if self.class_lengths[TRAIN] == 0:
            raise ValueError(f"{self.name}: no TRAIN samples")
        self._shuffled_indices = np.arange(self.total_samples, dtype=np.int32)
        self.minibatch_indices = np.zeros(self.max_minibatch_size, np.int32)
        for arr in (self.minibatch_data, self.minibatch_labels):
            arr.initialize(device)
        self._shuffle_train()

    def _use_native_shuffle(self) -> bool:
        if self.native_shuffle is not None:
            return bool(self.native_shuffle)
        return bool(root.common.engine.get("native_shuffle", False))

    def _shuffle_train(self) -> None:
        start = self.class_end_offsets[VALID]
        if self.shuffle:
            seg = self._shuffled_indices[start:]
            if self._use_native_shuffle():
                if self._native_rng is None:
                    from znicz_torch import native

                    self._native_rng = native.XorShift128P(
                        prng.get("loader").seed)
                seg = np.ascontiguousarray(seg)
                self._native_rng.shuffle(seg)
                self._shuffled_indices[start:] = seg
            else:
                perm = prng.get("loader").permutation(len(seg))
                self._shuffled_indices[start:] = seg[perm]
        self._balance_train(start)

    def train_labels(self):
        """Labels indexable by sample index, for ``balance_classes``;
        None here (a subclass that knows its labels overrides it)."""
        return None

    def _balance_train(self, start: int) -> None:
        """With ``balance_classes``, fill the TRAIN segment (from offset
        ``start``) afresh from the whole TRAIN population: the slots are a
        permutation split into one equal block per label, each block
        drawn with replacement from that label's samples, all from the
        ``loader.balance`` stream in the reference's order of draws."""
        if not self.balance_classes:
            return
        labels = self.train_labels()
        if labels is None:
            return
        population = np.arange(start, self.total_samples,
                               dtype=self._shuffled_indices.dtype)
        lab = np.asarray(labels)[population]
        rng = prng.get("loader.balance").state
        classes = np.unique(lab)
        n = len(population)
        members = {c: population[lab == c] for c in classes}
        slots = rng.permutation(n)
        out = np.empty(n, population.dtype)
        i = 0
        for c, block in zip(classes,
                            np.array_split(np.arange(n), len(classes))):
            k = len(block)
            pick = members[c][rng.integers(0, len(members[c]), size=k)]
            out[slots[i:i + k]] = pick
            i += k
        self._shuffled_indices[start:] = out

    def reset(self) -> None:
        """Restart from epoch 0 with a fresh TRAIN shuffle (from the
        ``loader`` stream's current state)."""
        self._pos = 0
        self.epoch_number = 0
        self.last_minibatch = False
        self.class_ended = False
        self.minibatch_size = 0
        self.minibatch_class = TRAIN
        self.samples_served = 0
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
        self.samples_served += count
        self.class_samples_served[klass] += count
        if not self.indices_only:
            self.fill_minibatch()

"""Training control (port of ``DecisionBase``/``DecisionGD`` in
``znicz_tpu/decision.py``, without the unit engine and telemetry).

Fed once per minibatch.  Accumulates per-class epoch statistics (loss,
n_err, err%, confusion); at the epoch's end (the loader's TRAIN tail) it
tracks the best validation error, sets ``improved``, and sets
``complete`` when ``epoch_number + 1 >= max_epochs`` or validation has
not improved for ``fail_iterations`` epochs.  ``gd_skip`` — whether this
minibatch's update is skipped — is ``klass != TRAIN or complete``.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np

from znicz_torch.loader.base import TEST, TRAIN, VALID

CLASS_NAMES = ("test", "valid", "train")
log = logging.getLogger("znicz_torch.decision")


class DecisionBase:
    def __init__(self, name: str = "decision", max_epochs: int = 10,
                 fail_iterations: int = 0):
        self.name = name
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        self.improved = False
        self.epoch_ended = False
        self.gd_skip = False
        # fed from the loader
        self.minibatch_class = TRAIN
        self.last_minibatch = False
        self.class_ended = False
        self.epoch_number = 0
        self.class_lengths: List[int] = [0, 0, 0]
        # fed from the loss head
        self.minibatch_loss = 0.0
        self.epoch_metrics = [None, None, None]   # last finished epoch
        self._acc_loss = [0.0, 0.0, 0.0]
        self._acc_batches = [0, 0, 0]
        self.best_metric = np.inf
        self.best_epoch = -1
        self._fails = 0
        self.on_epoch_end: List[Callable] = []    # callbacks(decision)

    def _accumulate(self, klass: int) -> None:
        self._acc_loss[klass] += float(self.minibatch_loss)
        self._acc_batches[klass] += 1

    def _class_metric(self, klass: int) -> float:
        return self._acc_loss[klass] / max(1, self._acc_batches[klass])

    def _reset_class(self, klass: int) -> None:
        self._acc_loss[klass] = 0.0
        self._acc_batches[klass] = 0

    def _validation_class(self) -> int:
        """Improvement is judged on VALID if present, else TRAIN."""
        return VALID if self.class_lengths[VALID] else TRAIN

    def improvement_metric(self) -> float:
        return self._class_metric(self._validation_class())

    def run(self) -> None:
        klass = int(self.minibatch_class)
        self._accumulate(klass)
        self.epoch_ended = False
        if self.class_ended:
            self.epoch_metrics[klass] = self._summarize(klass)
        if self.last_minibatch:            # end of TRAIN == end of epoch
            metric = self.improvement_metric()
            if metric < self.best_metric - 1e-12:
                self.best_metric = metric
                self.best_epoch = int(self.epoch_number)
                self.improved = True
                self._fails = 0
            else:
                self.improved = False
                self._fails += 1
            self.complete = bool(
                self.epoch_number + 1 >= self.max_epochs or
                (self.fail_iterations and
                 self._fails >= self.fail_iterations))
            self.epoch_ended = True
            self._log_epoch()
            for cb in self.on_epoch_end:
                cb(self)
            for k in (TEST, VALID, TRAIN):
                self._reset_class(k)
        self.gd_skip = klass != TRAIN or self.complete

    def _summarize(self, klass: int):
        return {"loss": self._class_metric(klass)}

    def _log_epoch(self) -> None:
        parts = []
        for k in (TEST, VALID, TRAIN):
            m = self.epoch_metrics[k]
            if self.class_lengths[k] and m is not None:
                parts.append(CLASS_NAMES[k] + ": " + ", ".join(
                    f"{key}={val:.6g}" for key, val in m.items()
                    if isinstance(val, (int, float))))
        log.info("epoch %d  %s%s", self.epoch_number, "  ".join(parts),
                 "  *" if self.improved else "")


class DecisionGD(DecisionBase):
    """Classification: n_err, err% and confusion per class; improvement
    is judged on the validation error count."""

    def __init__(self, name: str = "decision", **kwargs):
        super().__init__(name=name, **kwargs)
        self.minibatch_n_err = 0
        self.minibatch_size = 0
        self.confusion_matrix = None
        self._acc_n_err = [0, 0, 0]
        self._acc_samples = [0, 0, 0]
        self._acc_confusion: List[Optional[object]] = [None, None, None]

    def _accumulate(self, klass: int) -> None:
        super()._accumulate(klass)
        self._acc_n_err[klass] += int(self.minibatch_n_err)
        self._acc_samples[klass] += int(self.minibatch_size)
        conf = self.confusion_matrix
        # None: already summed with an earlier minibatch; size <= 1: off
        if conf is not None and conf.numel() > 1:
            acc = self._acc_confusion[klass]
            self._acc_confusion[klass] = conf.clone() if acc is None \
                else acc + conf

    def _reset_class(self, klass: int) -> None:
        super()._reset_class(klass)
        self._acc_n_err[klass] = 0
        self._acc_samples[klass] = 0
        self._acc_confusion[klass] = None

    def improvement_metric(self) -> float:
        k = self._validation_class()
        return self._acc_n_err[k] / max(1, self._acc_samples[k])

    def _summarize(self, klass: int):
        n = max(1, self._acc_samples[klass])
        return {"loss": self._class_metric(klass),
                "n_err": self._acc_n_err[klass],
                "err_pct": 100.0 * self._acc_n_err[klass] / n,
                "confusion": self._acc_confusion[klass]}

"""Training control (port of ``DecisionBase``, ``DecisionGD`` and
``DecisionMSE`` in ``znicz_tpu/decision.py``, with its telemetry gauges:
the ``decision`` scope's ``epoch_number``, ``best_metric`` and
``train_complete``, sampled at collect time).

A unit run once per minibatch, after the evaluator.  Its inputs are
linked from the loader (``minibatch_class``, ``last_minibatch``,
``class_ended``, ``epoch_number``, ``class_lengths``,
``minibatch_size``) and the evaluator (``minibatch_loss``,
``minibatch_n_err``, ``confusion_matrix``); ``FusedTrainer`` sets them
itself.  It accumulates per-class epoch statistics (loss, n_err, err%,
confusion; the mean loss alone for ``DecisionMSE``); at the epoch's end
(the loader's TRAIN tail) it tracks the best validation error (mean
loss for ``DecisionMSE``), sets ``improved``, and sets ``complete`` when
``epoch_number + 1 >= max_epochs`` or validation has not improved for
``fail_iterations`` epochs.  ``gd_skip`` — whether this minibatch's
update is skipped — is ``klass != TRAIN or complete``.  ``complete``,
``improved``, ``epoch_ended`` and ``gd_skip`` are ``Bool``s: the graph's
gates are expressions over them.  ``train_losses`` keeps every TRAIN
minibatch's loss, in order.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np

from znicz_torch import telemetry
from znicz_torch.core.mutable import Bool
from znicz_torch.core.units import Unit
from znicz_torch.loader.base import TEST, TRAIN, VALID
from znicz_torch.memory import Array

CLASS_NAMES = ("test", "valid", "train")
log = logging.getLogger("znicz_torch.decision")


class DecisionBase(Unit):
    def __init__(self, workflow=None, name: str = "decision",
                 max_epochs: int = 10, fail_iterations: int = 0, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.epoch_ended = Bool(False)
        self.gd_skip = Bool(False)
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
        self.train_losses: List[float] = []
        # the decision loop's live state as collect-time gauges: no
        # hot-path writes; weak_fn, so the process-wide registry does not
        # pin the decision (and the workflow behind it) after the run
        _sc = telemetry.scope("decision")
        _sc.gauge("epoch_number", "current epoch",
                  fn=telemetry.weak_fn(
                      self, lambda d: float(d.epoch_number)))
        _sc.gauge("best_metric", "best validation metric so far",
                  fn=telemetry.weak_fn(
                      self, lambda d: float(d.best_metric)))
        _sc.gauge("train_complete", "1 once training stopped",
                  fn=telemetry.weak_fn(
                      self, lambda d: float(bool(d.complete))))

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
        if klass == TRAIN:
            self.train_losses.append(float(self.minibatch_loss))
        self.epoch_ended.set(False)
        if self.class_ended:
            self.epoch_metrics[klass] = self._summarize(klass)
        if self.last_minibatch:            # end of TRAIN == end of epoch
            metric = self.improvement_metric()
            if metric < self.best_metric - 1e-12:
                self.best_metric = metric
                self.best_epoch = int(self.epoch_number)
                self.improved.set(True)
                self._fails = 0
            else:
                self.improved.set(False)
                self._fails += 1
            self.complete.set(
                self.epoch_number + 1 >= self.max_epochs or
                (self.fail_iterations and
                 self._fails >= self.fail_iterations))
            self.epoch_ended.set(True)
            self._log_epoch()
            for cb in self.on_epoch_end:
                cb(self)
            for k in (TEST, VALID, TRAIN):
                self._reset_class(k)
        self.gd_skip.set(klass != TRAIN or bool(self.complete))

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
                 "  *" if bool(self.improved) else "")


class DecisionGD(DecisionBase):
    """Classification: n_err, err% and confusion per class; improvement
    is judged on the validation error count."""

    def __init__(self, workflow=None, name: str = "decision", **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.minibatch_n_err = 0
        self.minibatch_size = 0
        self.confusion_matrix = None
        self.max_err_output_sum = 0.0
        self._acc_n_err = [0, 0, 0]
        self._acc_samples = [0, 0, 0]
        self._acc_confusion: List[Optional[object]] = [None, None, None]

    def _accumulate(self, klass: int) -> None:
        super()._accumulate(klass)
        self._acc_n_err[klass] += int(self.minibatch_n_err)
        self._acc_samples[klass] += int(self.minibatch_size)
        conf = self.confusion_matrix
        if isinstance(conf, Array):           # the unit path's evaluator
            conf = conf.devmem
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


class DecisionMSE(DecisionBase):
    """Regression and autoencoders: improvement is judged on the
    validation mean loss."""

    def _summarize(self, klass: int):
        return {"loss": self._class_metric(klass),
                "mse": self._class_metric(klass)}

"""The evaluators (port of ``EvaluatorSoftmax``, ``EvaluatorSeqSoftmax``
and ``EvaluatorMSE`` in ``znicz_tpu/evaluator.py``).

As a unit of the unit engine it reads the softmax head's ``output``
(probabilities), the minibatch ``labels`` and ``batch_size`` (the count
of real rows), and gives, with the reference's reductions:

  - ``err_output = (probs - onehot(labels)) * valid / batch_size``, the
    cross-entropy cotangent at the logits, which seeds the GD chain;
  - ``loss``: the mean of ``-log(max(p_label, tiny))`` over the real rows;
  - ``n_err``, ``confusion_matrix`` (:func:`confusion`, the one home of
    the counting) and ``max_err_output_sum``.

The three scalars come back to the host in one read a minibatch: the
Decision needs them.  ``FusedTrainer`` computes the same metrics from
the logits in its own loss head; there the evaluator only selects the
softmax loss and says whether the confusion counts are collected.

:class:`EvaluatorMSE` reads the regression head's ``output`` and the
minibatch ``target`` (the loader's ``minibatch_targets``) and gives
``err_output = (y - t) * valid / batch_size``, the per-sample squared
error ``mse`` and ``loss = 0.5 * sum(se) / batch_size``; with ``labels``
linked and ``class_targets`` set, ``n_err`` counts the real rows whose
nearest class target (L2) is not their label.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from znicz_torch.core.units import Unit
from znicz_torch.memory import Array


class EvaluatorBase(Unit):
    """What both losses share: the linked head ``output`` and
    ``batch_size`` (the count of real rows), and the ``err_output``
    cotangent and ``loss`` they give."""

    def __init__(self, workflow=None, name: str = "evaluator", **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.output: Optional[Array] = None      # linked: the head
        self.batch_size = 0                      # linked: minibatch_size
        self.err_output = Array()
        self.loss = 0.0

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        self.err_output.initialize(device)


class EvaluatorSoftmax(EvaluatorBase):
    #: heads wider than this collect no confusion matrix unless
    #: ``compute_confusion`` is set
    CONFUSION_AUTO_LIMIT = 128

    def __init__(self, workflow=None, name: str = "evaluator",
                 compute_confusion=None, n_classes: int = 0, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.labels: Optional[Array] = None      # linked: minibatch_labels
        self.n_classes = int(n_classes)
        self.compute_confusion = compute_confusion
        #: whether the user pinned compute_confusion (the fused trainer
        #: collects it unless it was explicitly turned off)
        self.confusion_explicit = compute_confusion is not None
        self.confusion_matrix = Array()
        self.n_err = 0
        self.max_err_output_sum = 0.0

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        self.confusion_matrix.initialize(device)

    @staticmethod
    def compute(probs, labels, batch_size: int, n_classes: int,
                with_confusion: bool):
        """``(err_output, n_err, loss, confusion, max_err_output_sum)`` of
        (n, C) probabilities and (n,) int64 labels whose first
        ``batch_size`` rows are valid, the three scalars as 0-dim
        tensors."""
        denom = max(int(batch_size), 1)
        with torch.no_grad():
            valid = torch.arange(probs.shape[0],
                                 device=probs.device) < batch_size
            onehot = F.one_hot(labels, n_classes).to(probs.dtype)
            err = (probs - onehot) * valid[:, None] / denom
            pred = torch.argmax(probs, dim=-1)
            n_err = torch.sum((pred != labels) & valid)
            tiny = torch.finfo(probs.dtype).tiny
            ce = -torch.log(torch.clamp_min(
                torch.gather(probs, 1, labels[:, None])[:, 0], tiny))
            loss = torch.sum(torch.where(valid, ce, 0.0)) / denom
            conf = confusion(pred, labels, valid,
                             n_classes if with_confusion else 0)
            mes = torch.max(torch.sum(torch.abs(err), dim=-1))
        return err, n_err, loss, conf, mes

    def _compute(self, probs, labels, n_classes: int):
        return self.compute(probs, labels, int(self.batch_size), n_classes,
                            bool(self.compute_confusion))

    def run(self):
        probs = self.output.devmem
        n_classes = self.n_classes or int(probs.shape[-1])
        if self.compute_confusion is None:
            self.compute_confusion = n_classes <= self.CONFUSION_AUTO_LIMIT
        err, n_err, loss, conf, mes = self._compute(
            probs, self.labels.devmem.long(), n_classes)
        self.err_output.devmem = err
        self.confusion_matrix.devmem = conf
        loss, n_err, mes = torch.stack(
            [loss.double(), n_err.double(), mes.double()]).tolist()
        self.loss, self.n_err = loss, int(n_err)
        self.max_err_output_sum = mes


class EvaluatorSeqSoftmax(EvaluatorSoftmax):
    """Per-token softmax-CE over a sequence head: probabilities (batch,
    seq, vocab), labels (batch, seq).  Tokens are flattened into the batch
    axis and :meth:`EvaluatorSoftmax.compute` applies as it is, with
    ``batch_size * seq`` valid rows and that denominator, so ``n_err``
    counts wrong tokens and ``loss`` is the mean per token.  The fused
    trainer's loss head flattens the same way.  The confusion matrix is
    off unless asked for."""

    def __init__(self, workflow=None, name: str = "evaluator", **kwargs):
        kwargs.setdefault("compute_confusion", False)
        super().__init__(workflow=workflow, name=name, **kwargs)

    def _compute(self, probs, labels, n_classes: int):
        n, t = probs.shape[0], probs.shape[1]
        err, *rest = self.compute(
            probs.reshape(n * t, probs.shape[-1]), labels.reshape(n * t),
            int(self.batch_size) * t, n_classes,
            bool(self.compute_confusion))
        return (err.reshape(probs.shape), *rest)


class EvaluatorMSE(EvaluatorBase):
    def __init__(self, workflow=None, name: str = "evaluator", **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.target: Optional[Array] = None      # linked: minibatch_targets
        self.mse = Array()                       # per-sample ||y - t||^2
        #: the classification-through-regression mode: link ``labels`` and
        #: set ``class_targets`` (n_classes, *sample_shape)
        self.labels: Optional[Array] = None
        self.class_targets = Array()
        self.n_err = 0

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        self.mse.initialize(device)
        self.class_targets.initialize(device)

    def run(self):
        out = self.output.devmem
        n = out.shape[0]
        bs = int(self.batch_size)
        denom = max(bs, 1)
        with torch.no_grad():
            y = out.reshape(n, -1)
            valid = torch.arange(n, device=out.device) < bs
            diff = (y - self.target.devmem.reshape(n, -1)) * valid[:, None]
            se = torch.sum(torch.square(diff), dim=-1)
            loss = 0.5 * torch.sum(se) / denom
            scalars = [loss.double()]
            if self.labels is not None and self.class_targets:
                ct = self.class_targets.devmem
                d = torch.sum(torch.square(
                    y[:, None, :] - ct.reshape(1, ct.shape[0], -1)), dim=-1)
                wrong = (torch.argmin(d, dim=-1) != self.labels.devmem) & valid
                scalars.append(torch.sum(wrong).double())
        self.err_output.devmem = (diff / denom).reshape(out.shape)
        self.mse.devmem = se
        scalars = torch.stack(scalars).tolist()
        self.loss = scalars[0]
        if len(scalars) > 1:
            self.n_err = int(scalars[1])


def confusion(pred, labels, valid, n_classes: int):
    """(pred, true) counts of the valid rows as an int32 (C, C) matrix; a
    (1, 1) zero when ``n_classes`` is 0 (collection off)."""
    if not n_classes:
        return torch.zeros((1, 1), dtype=torch.int32, device=pred.device)
    flat = pred.long() * n_classes + labels.long()
    counts = torch.zeros(n_classes * n_classes, dtype=torch.int32,
                         device=pred.device)
    counts.index_add_(0, flat, valid.to(torch.int32))
    return counts.reshape(n_classes, n_classes)

"""The softmax evaluator's metrics (port of the parts of
``EvaluatorSoftmax`` in ``znicz_tpu/evaluator.py`` that the fused trainer
reads).

The fused trainer computes the loss, ``n_err`` and the confusion counts
from the logits in its own loss head, as the reference's does; an
:class:`EvaluatorSoftmax` on a workflow selects that softmax loss and says
whether the confusion counts are collected.  The unit-at-a-time
evaluator, which seeds a GD chain with ``err_output``, comes with the
unit engine.
"""

from __future__ import annotations

import torch


class EvaluatorSoftmax:
    def __init__(self, name: str = "evaluator", compute_confusion=None):
        self.name = name
        self.compute_confusion = compute_confusion
        #: whether the user pinned compute_confusion (the fused trainer
        #: collects it unless it was explicitly turned off)
        self.confusion_explicit = compute_confusion is not None


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

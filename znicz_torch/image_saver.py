"""ImageSaver (port of ``znicz_tpu/image_saver.py``): up to ``limit``
misclassified samples an epoch, written as PNGs named
``<root.common.dirs.image_saver>/epoch_<n>/<true>_as_<pred>_<i>.png``.

Linked after the evaluator, it takes the minibatch's misclassified rows
(pulled to the host, up to the limit) and writes them at the epoch's
last minibatch.  It needs each minibatch's data on the host, which the
fused trainer never pulls, so it runs on the unit engine only, as the
reference's does.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from znicz_torch.core.config import root
from znicz_torch.core.units import Unit
from znicz_torch.plotting_units import host_array

root.common.dirs.defaults({"image_saver": "saved_images"})


class ImageSaver(Unit):
    def __init__(self, workflow=None, name=None, limit=32, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.limit = int(limit)
        # linked attributes
        self.input = None             # the minibatch's data
        self.labels = None            # its labels
        self.output = None            # the softmax's probabilities
        self.batch_size = 0           # its real rows
        self.epoch_number = 0
        self.last_minibatch = False
        self._pending: List[tuple] = []

    def directory(self) -> str:
        d = os.path.join(root.common.dirs.get("image_saver", "saved_images"),
                         f"epoch_{int(self.epoch_number)}")
        os.makedirs(d, exist_ok=True)
        return d

    def run(self):
        if len(self._pending) < self.limit:
            probs = host_array(self.output)
            labels = host_array(self.labels)
            data = host_array(self.input)
            pred = probs.argmax(-1)
            n = int(self.batch_size)
            wrong = np.nonzero(pred[:n] != labels[:n])[0]
            for i in wrong[:self.limit - len(self._pending)]:
                self._pending.append((data[i].copy(), int(labels[i]),
                                      int(pred[i])))
        if self.last_minibatch and self._pending:
            self.flush()

    def flush(self):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        d = self.directory()
        for i, (img, true, pred) in enumerate(self._pending):
            img = np.asarray(img, np.float32)
            if img.ndim == 1:
                side = int(np.sqrt(img.size))
                img = img[:side * side].reshape(side, side)
            if img.ndim == 3 and img.shape[-1] == 1:
                img = img[..., 0]
            lo, hi = float(img.min()), float(img.max())
            if hi > lo:
                img = (img - lo) / (hi - lo)
            plt.imsave(os.path.join(d, f"{true}_as_{pred}_{i}.png"), img,
                       cmap=None if img.ndim == 3 else "gray")
        self.info("saved %d misclassified images -> %s",
                  len(self._pending), d)
        self._pending.clear()

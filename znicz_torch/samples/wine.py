"""Wine (port of ``znicz_tpu/samples/wine.py``): the smallest end-to-end
sample, a tabular MLP from 13 features to 3 classes.

The data are the reference's procedural 3-cluster set with the Wine
dataset's shape (:func:`wine_like`, from the ``dataset.wine`` stream),
130 train and 48 valid rows, normalised by a ``MeanDispNormalizer``
fitted on the train rows.  ``all2all_tanh`` 8 -> ``softmax`` 3, batch 10,
20 epochs, with the ``root.wine`` defaults of the reference entry for
entry and its unit names (``fwd_all2all_tanh_0``, ``fwd_softmax_1``).
"""

from __future__ import annotations

import numpy as np

from znicz_torch.backends import DeviceLike
from znicz_torch.core import prng
from znicz_torch.core.config import root
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.normalization import MeanDispNormalizer
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.standard_workflow import StandardWorkflow

root.wine.defaults({
    "loader": {"minibatch_size": 10, "n_train": 130, "n_valid": 48},
    "layers": [8, 3],
    "learning_rate": 0.3,
    "gradient_moment": 0.5,
    "decision": {"max_epochs": 20, "fail_iterations": 0},
})


def wine_like(n: int, stream: str = "dataset.wine"):
    """``n`` rows of 13 features in 3 gaussian clusters, each feature at
    its own scale (0.1 to 100, as the real Wine set's ranges differ), and
    their labels: the reference's draws from the same named stream."""
    rng = prng.get(stream).state
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    centers = rng.normal(0, 1.0, size=(3, 13)).astype(np.float32)
    scales = np.geomspace(0.1, 100.0, 13).astype(np.float32)
    data = (centers[labels] + rng.normal(0, 0.6, size=(n, 13))) * scales
    return data.astype(np.float32), labels


class WineLoader(FullBatchLoader):
    def load_data(self):
        cfg = root.wine.loader
        n_train = int(cfg.get("n_train"))
        n_valid = int(cfg.get("n_valid"))
        self.original_data, self.original_labels = wine_like(n_train
                                                             + n_valid)
        self.class_lengths = [0, n_valid, n_train]
        super().load_data()


class WineWorkflow(StandardWorkflow):
    """The MLP of ``root.wine`` with its normalising loader on
    ``device``."""

    def __init__(self, device: DeviceLike = None):
        cfg = root.wine
        gd = {"learning_rate": float(cfg.get("learning_rate")),
              "gradient_moment": float(cfg.get("gradient_moment"))}
        widths = list(cfg.get("layers"))
        layers = [{"type": "all2all_tanh",
                   "->": {"output_sample_shape": w}, "<-": dict(gd)}
                  for w in widths[:-1]]
        layers.append({"type": "softmax",
                       "->": {"output_sample_shape": widths[-1]},
                       "<-": dict(gd)})
        super().__init__(
            layers, device=device, name="WineWorkflow",
            loader=WineLoader(
                normalizer=MeanDispNormalizer(),
                minibatch_size=int(cfg.loader.get("minibatch_size"))),
            loss_function="softmax",
            decision_config={
                "max_epochs": int(cfg.decision.get("max_epochs")),
                "fail_iterations": int(cfg.decision.get("fail_iterations"))})


def run(device: DeviceLike = None, snapshot: str = "") -> WineWorkflow:
    """Build :class:`WineWorkflow` on ``device``, resume it from
    ``snapshot`` if one is named, and train it with ``engine.train``
    (the unit graph unless ``root.common.engine.fused``)."""
    wf = WineWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "wine")

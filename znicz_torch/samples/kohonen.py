"""Kohonen (port of ``znicz_tpu/samples/kohonen.py``, BASELINE config 3): a
self-organizing map of 2-D points drawn from gaussian clusters on a
ring.

Unsupervised, with no evaluator and no GD chain: the trainer is the
learning rule, and the forward unit accumulates the hit map.  The
``root.kohonen`` defaults are the reference's, entry for entry, and the
units its names:

    start -> repeater -> loader -> trainer -> forward -> decision
    decision -> repeater

It always trains on the unit engine.  There is no snapshotter.
"""

from __future__ import annotations

import numpy as np

from znicz_torch.backends import DeviceLike, resolve_device
from znicz_torch.core import prng
from znicz_torch.core.config import root
from znicz_torch.core.workflow import Repeater, Workflow
from znicz_torch.kohonen import (KohonenDecision, KohonenForward,
                                 KohonenTrainer)
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.samples import train

root.kohonen.defaults({
    "loader": {"minibatch_size": 50, "n_train": 1000, "n_clusters": 10},
    "som": {"shape": (8, 8), "learning_rate": 0.5, "decay_epochs": 15},
    "decision": {"max_epochs": 10},
})


def cluster_points(n: int, n_clusters: int,
                   stream: str = "dataset.kohonen") -> np.ndarray:
    """(n, 2) float32 points from gaussian clusters on a ring, drawn from
    the named stream as the reference draws them."""
    rng = prng.get(stream).state
    which = rng.integers(0, n_clusters, size=n)
    angles = 2 * np.pi * which / n_clusters
    centers = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    return (centers + rng.normal(0, 0.08, size=(n, 2))).astype(np.float32)


class KohonenLoader(FullBatchLoader):
    """All points TRAIN, no labels."""

    def load_data(self):
        cfg = root.kohonen.loader
        n = int(cfg.get("n_train"))
        self.original_data = cluster_points(n, int(cfg.get("n_clusters")))
        self.class_lengths = [0, 0, n]
        super().load_data()


class KohonenWorkflow(Workflow):
    """The SOM of ``root.kohonen`` on ``device``; its loader is
    initialised here, so the trainer reads the sample width from the
    minibatch it is linked to."""

    def __init__(self, device: DeviceLike = None):
        super().__init__(name="KohonenWorkflow")
        self.device = resolve_device(device)
        cfg = root.kohonen
        shape = tuple(cfg.som.get("shape"))

        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)
        self.loader = KohonenLoader(
            self, name="loader",
            minibatch_size=int(cfg.loader.get("minibatch_size")))
        self.loader.link_from(self.repeater)
        self.loader.initialize(device=self.device)

        self.trainer = KohonenTrainer(
            self, name="trainer", shape=shape,
            learning_rate=float(cfg.som.get("learning_rate")),
            decay_epochs=float(cfg.som.get("decay_epochs")))
        self.trainer.link_from(self.loader)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"),
                                ("batch_size", "minibatch_size"),
                                "epoch_number")

        self.forward = KohonenForward(self, name="forward", shape=shape,
                                      weights_from=self.trainer)
        self.forward.link_from(self.trainer)
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"),
                                ("batch_size", "minibatch_size"))

        self.decision = KohonenDecision(
            self, name="decision",
            max_epochs=int(cfg.decision.get("max_epochs")))
        self.decision.link_from(self.forward)
        self.decision.link_attrs(self.loader, "last_minibatch",
                                 "epoch_number")
        self.decision.link_attrs(self.trainer, "qerror")

        self.repeater.link_from(self.decision)
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete


def run(device: DeviceLike = None) -> KohonenWorkflow:
    """Build :class:`KohonenWorkflow` on ``device`` and train it on the
    unit engine until the Decision completes."""
    return train(KohonenWorkflow(device), "kohonen")
